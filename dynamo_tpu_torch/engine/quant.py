"""Quantized serving: int8/fp8 weights and a quantized paged KV cache.

Port of ``dynamo_tpu.engine.quant`` (its torch-side functions; the numpy
host twins wait for KV movement, which is where the JAX package uses them).
The storage convention is the same, so a tree or a cache quantized by either
package holds the same bytes:

* **Weights**: a quantized leaf is a dict ``{"q": <storage dtype>,
  "s": float32}`` in place of the plain tensor. Scales are per output
  channel: amax over the contraction axis ``-2`` with ``keepdim``, so
  ``q * s`` broadcasts back to the full-precision shape. Norms and the
  embedding table stay in the model dtype.
* **KV cache**: pages hold ``kv_dtype`` elements; per-layer ``"ks"``/
  ``"vs"`` caches ``[num_blocks, KV, block_size]`` float32 hold one scale
  per (slot, head). A token's bytes depend only on its own K/V, never on
  the block it lands in.

A zero amax gives scale 1.0 (q stays 0); int8 rounds half to even and clips
to ±127. fp8 is e4m3fn: torch's cast saturates where ``jnp``'s overflows to
NaN, but ``|q| <= 448`` here, so both give the same bytes. ``"bf16"`` means
unquantized passthrough: the tree comes back as the same object.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

# dtypes accepted by EngineConfig.weight_dtype / kv_dtype
QUANT_DTYPES = ("int8", "fp8")

# largest representable magnitude per storage dtype; amax maps onto it
QMAX = {"int8": 127.0, "fp8": 448.0}  # fp8 = e4m3fn

_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def is_quantized(dtype: str) -> bool:
    """True for the 1-byte storage modes, False for "bf16" passthrough."""
    return dtype in QUANT_DTYPES


def storage_dtype(dtype: str) -> torch.dtype:
    """torch storage dtype of a quantized mode."""
    return _STORAGE[dtype]


def kv_bytes_per_elem(dtype: str,
                      model_dtype: torch.dtype = torch.bfloat16) -> float:
    """KV page bytes per stored element; the f32 scale adds 4/head_dim."""
    return 1.0 if is_quantized(dtype) else float(model_dtype.itemsize)


# matmul weights quantized at load time; everything else stays in the model
# dtype
QUANTIZED_LEAVES = frozenset(
    ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"]
)


def is_weight_leaf(name: str) -> bool:
    return name in QUANTIZED_LEAVES


def _to_storage(q: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        q = torch.clamp(torch.round(q), -127.0, 127.0)
    return q.to(_STORAGE[dtype])


def quantize(w: torch.Tensor, dtype: str) -> Dict[str, torch.Tensor]:
    """Quantize one weight: per-output-channel scales over axis -2."""
    wf = w.float()
    s = torch.amax(torch.abs(wf), dim=-2, keepdim=True) / QMAX[dtype]
    s = torch.where(s == 0.0, 1.0, s)
    return {"q": _to_storage(wf / s, dtype), "s": s}


def dequantize(leaf: Dict[str, torch.Tensor],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (leaf["q"].float() * leaf["s"]).to(dtype)


def quantize_params(params: Dict[str, Any], weight_dtype: str
                    ) -> Dict[str, Any]:
    """Matmul leaves become ``{"q", "s"}`` dicts; the rest pass through.
    Already-quantized leaves (dicts) are kept as they are, so a tree
    quantized beforehand passes unchanged."""
    if not is_quantized(weight_dtype):
        return params
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = {
                k: (quantize(v, weight_dtype)
                    if is_weight_leaf(k) and not isinstance(v, dict) else v)
                for k, v in leaf.items()
            }
        elif is_weight_leaf(name) and not isinstance(leaf, dict):
            out[name] = quantize(leaf, weight_dtype)
        else:
            out[name] = leaf
    return out


def kv_quantize(x: torch.Tensor, kv_dtype: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize fresh K or V rows ``[N, KV, hd]`` with one f32 scale per
    (token, head): returns ``(q [N, KV, hd], s [N, KV])``."""
    xf = x.float()
    s = torch.amax(torch.abs(xf), dim=-1) / QMAX[kv_dtype]
    s = torch.where(s == 0.0, 1.0, s)
    return _to_storage(xf / s[..., None], kv_dtype), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`kv_quantize`: ``q`` [..., hd] times ``s`` [...]."""
    return (q.float() * s[..., None].float()).to(dtype)
