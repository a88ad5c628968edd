"""Parameters from a numpy tree.

``params_from_numpy`` turns the JAX package's parameter tree
(``dynamo_tpu.engine.model.init_params``: ``embed``, stacked ``[L, …]``
``layers`` leaves, ``final_norm``, optional ``lm_head``), converted leaf by
leaf to numpy, into this package's parameters on ``device`` — so both
packages compute the same thing in the tests. bf16 leaves arrive as numpy
``uint16`` views of their bits, because ``torch.from_numpy`` rejects
``ml_dtypes.bfloat16``. A tree quantized by the JAX package
(``quant.quantize_params``) carries ``{"q", "s"}`` leaves: ``q`` int8, or
fp8 e4m3 as a ``uint8`` view of its bits, and ``s`` float32; given the
``weight_dtype`` they become this package's quantized leaves, bit for bit.
The safetensors checkpoint loader waits for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import quant
from .config import ModelConfig
from .model import Params, torch_dtype

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
               "w_gate", "w_up", "w_down")


def _leaf(arr: np.ndarray, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")  # owned, writable, contiguous
    if a.dtype == np.uint16:
        if dtype != torch.bfloat16:
            raise TypeError("uint16 leaves carry bf16 bits; the model "
                            f"dtype is {dtype}")
        t = torch.from_numpy(a).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _quant_leaf(leaf: Dict[str, np.ndarray], weight_dtype: str,
                device: torch.device) -> Dict[str, torch.Tensor]:
    if not quant.is_quantized(weight_dtype):
        raise TypeError("a quantized {q, s} leaf needs weight_dtype int8 "
                        f"or fp8, not {weight_dtype!r}")
    q = np.array(leaf["q"], copy=True, order="C")
    want = np.int8 if weight_dtype == "int8" else np.uint8
    if q.dtype != want:
        raise TypeError(f"{weight_dtype} leaf q arrives as {np.dtype(want)}"
                        f" (fp8 as uint8 bits), got {q.dtype}")
    t = torch.from_numpy(q)
    if weight_dtype == "fp8":
        t = t.view(quant.storage_dtype("fp8"))
    s = torch.from_numpy(np.array(leaf["s"], np.float32, copy=True))
    return {"q": t.to(device), "s": s.to(device)}


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device,
                      weight_dtype: str = "bf16") -> Params:
    """The JAX parameter tree (numpy leaves) as this package's params;
    ``{"q", "s"}`` leaves of a tree quantized to ``weight_dtype`` stay
    quantized."""
    dt = torch_dtype(cfg)
    device = torch.device(device)

    def leaf(x):
        if isinstance(x, dict):
            return _quant_leaf(x, weight_dtype, device)
        return _leaf(x, dt, device)

    layers = tree["layers"]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    if missing:
        raise KeyError(f"layer leaves missing from the tree: {missing}")
    params: Params = {
        "embed": leaf(tree["embed"]),
        "layers": {k: leaf(layers[k]) for k in _LAYER_KEYS},
        "final_norm": leaf(tree["final_norm"]),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf(tree["lm_head"])
    return params
