"""Random weights from the seed, made on the device in the layout that
``InferenceEngine(params=...)`` takes, in the type they are served in.

One ``torch.Generator`` on the device, one draw per leaf, in the order the
architecture's ``leaf_shapes`` gives (``arch/<model_type>.py``): the same
seed gives the same tensors, bit for bit, so the reference can be handed
the very tensors the program serves, or a second copy made anew. Matmul
weights are ``[in, out]`` (``x @ w``); per-layer leaves are stacked
``[L, ...]``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def make_params(leaves: Iterable[Tuple[str, tuple, int]], seed: int,
                dtype: str, device) -> Dict[str, object]:
    """The whole tree from ``seed``: ``leaves`` are (name, shape, fan_in)
    in draw order; a name under ``layers/`` goes to ``params["layers"]``."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params: Dict[str, object] = {"layers": {}}
    for name, shape, fan_in in leaves:
        leaf = draw_leaf(gen, shape, fan_in, dt)
        if name.startswith("layers/"):
            params["layers"][name[len("layers/"):]] = leaf
        else:
            params[name] = leaf
    return params
