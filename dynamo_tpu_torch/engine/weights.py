"""Parameters from a numpy tree.

``params_from_numpy`` turns the JAX package's parameter tree
(``dynamo_tpu.engine.model.init_params``: ``embed``, stacked ``[L, …]``
``layers`` leaves, ``final_norm``, optional ``lm_head``), converted leaf by
leaf to numpy, into this package's parameters on ``device`` — so both
packages compute the same thing in the tests. bf16 leaves arrive as numpy
``uint16`` views of their bits, because ``torch.from_numpy`` rejects
``ml_dtypes.bfloat16``. The safetensors checkpoint loader waits for a later
slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device) -> Params:
    """The JAX parameter tree (numpy leaves) as this package's params."""
    dt = torch_dtype(cfg)
    device = torch.device(device)
    layers = tree["layers"]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    if missing:
        raise KeyError(f"layer leaves missing from the tree: {missing}")
    params: Params = {
        "embed": _leaf(tree["embed"], dt, device),
        "layers": {k: _leaf(layers[k], dt, device) for k in _LAYER_KEYS},
        "final_norm": _leaf(tree["final_norm"], dt, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _leaf(tree["lm_head"], dt, device)
    return params
