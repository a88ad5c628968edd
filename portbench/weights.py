"""Random weights from the seed, made on the device in the layout that
``InferenceEngine(params=...)`` takes, in the type they are served in.

One ``torch.Generator`` on the device, one draw per leaf, in a fixed order:
the same seed gives the same tensors, bit for bit, so the reference can be
handed the very tensors the program serves, or a second copy made anew.
Matmul weights are ``[in, out]`` (``x @ w``); per-layer leaves are stacked
``[L, ...]``, expert leaves ``[L, E, ...]``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from .flops import Shapes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_shapes(s: Shapes) -> Iterator[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every leaf, in draw order; fan_in 0 marks a
    norm weight. Names under ``layers/`` are the stacked per-layer leaves."""
    D, F, L, E = s.hidden, s.ffn, s.layers, s.experts
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    yield "embed", (s.vocab, D), D
    yield "layers/attn_norm", (L, D), 0
    yield "layers/wq", (L, D, q), D
    yield "layers/wk", (L, D, kv), D
    yield "layers/wv", (L, D, kv), D
    yield "layers/wo", (L, q, D), q
    yield "layers/mlp_norm", (L, D), 0
    if E:
        yield "layers/w_router", (L, D, E), D
        yield "layers/w_gate", (L, E, D, F), D
        yield "layers/w_up", (L, E, D, F), D
        yield "layers/w_down", (L, E, F, D), F
    else:
        yield "layers/w_gate", (L, D, F), D
        yield "layers/w_up", (L, D, F), D
        yield "layers/w_down", (L, F, D), F
    yield "final_norm", (D,), 0
    if not s.tied:
        yield "lm_head", (D, s.vocab), D


def draw_leaf(gen: torch.Generator, shape: tuple, fan_in: int,
              dtype: torch.dtype) -> torch.Tensor:
    """One leaf: N(0, 1/fan_in) for a matmul weight, N(1, 0.01) for a norm
    weight, generated in ``dtype`` on the device, in place. A leaf of more
    than 2**30 elements is drawn one slice of its first axis at a time."""
    t = torch.empty(shape, device=gen.device, dtype=dtype)
    mean, std = (0.0, 1.0 / math.sqrt(fan_in)) if fan_in else (1.0, 0.1)
    parts = t if t.numel() > 2 ** 30 else [t]
    for part in parts:
        part.normal_(mean, std, generator=gen)
    return t


def make_params(s: Shapes, seed: int, dtype: str,
                device) -> Dict[str, object]:
    """The whole tree from ``seed``."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params: Dict[str, object] = {"layers": {}}
    for name, shape, fan_in in leaf_shapes(s):
        leaf = draw_leaf(gen, shape, fan_in, dt)
        if name.startswith("layers/"):
            params["layers"][name[len("layers/"):]] = leaf
        else:
            params[name] = leaf
    return params
