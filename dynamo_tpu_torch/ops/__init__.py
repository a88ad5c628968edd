"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch
version, written against the paged-KV layout owned by
:mod:`dynamo_tpu_torch.engine.model`.

The kernel wrappers are imported on first access, so that importing the
package (the host library's loader does, for ``_build``) loads no torch."""

__all__ = ["paged_attention_decode", "paged_attention_ragged"]


def __getattr__(name):
    if name in __all__:
        from . import paged_attention

        return getattr(paged_attention, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
