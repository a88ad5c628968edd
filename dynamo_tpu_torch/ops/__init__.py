"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch
version, written against the paged-KV layout owned by
:mod:`dynamo_tpu_torch.engine.model`."""

from .paged_attention import paged_attention_decode, paged_attention_ragged

__all__ = ["paged_attention_decode", "paged_attention_ragged"]
