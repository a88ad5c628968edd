"""What runs the plain reference for every architecture: it runs an
architecture's float32 block (``reference/<model_type>.py``) over whole
sequences and reads the served tokens' logit gaps.

Float32 throughout, TF32 off, no cache and no batching: each sequence runs
whole, one layer at a time for all sequences, so one layer's weights are
widened to float32 once. It imports nothing of the program.

The block is a module that gives ``num_layers(cfg)``, ``embedding(params,
cfg, ids)`` (float32 ``[T, D]``), ``layer_weights(params, cfg, li)``
(float32), ``layer(h, w, cfg)`` over one sequence, ``output_norm(h, params,
cfg)``, ``head(params, cfg)`` (float32 ``[D, V]``) and ``MATMULS``, the
names of the layer weights that are matmuls: the float8 control rounds
those and the head.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Sequence

import torch


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """A float32 weight ``[..., in, out]`` rounded through float8 e4m3
    with one scale per output channel (amax over ``in`` mapped to 448)."""
    s = w.abs().amax(dim=-2, keepdim=True) / 448.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (w / s).to(torch.float8_e4m3fn).float() * s


def served_logit_gaps(block: ModuleType, params: Dict, cfg: Dict,
                      seqs: Sequence[tuple], lowp=None):
    """For each (prompt ids, served ids): at every served position, how far
    the served token's logit lies below the best logit, in float32 ``[n]``.
    The sequence run is the prompt followed by the served tokens but the
    last; position ``P - 1 + i`` predicts served token ``i``.

    With ``lowp`` (a function of a float32 matmul weight, such as
    :func:`fp8_weights`) it returns a second list too: at the same
    positions, the gap of the token that the reference computed with
    ``lowp`` weights puts first (the control of the comparison)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _gaps(block, params, cfg, seqs, lowp)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _device(tree) -> torch.device:
    """The device of the first tensor in a tree of dicts."""
    for leaf in tree.values():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
        if isinstance(leaf, dict) and leaf:
            return _device(leaf)
    raise ValueError("a tree without tensors")


@torch.no_grad()
def logits(block: ModuleType, params: Dict, cfg: Dict,
           ids: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``[T, V]`` of one whole sequence."""
    h = block.embedding(params, cfg, ids)
    for li in range(block.num_layers(cfg)):
        h = block.layer(h, block.layer_weights(params, cfg, li), cfg)
    return block.output_norm(h, params, cfg) @ block.head(params, cfg)


@torch.no_grad()
def _gaps(block, params, cfg, seqs, lowp):
    dev = _device(params)
    ids = [torch.tensor(list(p) + list(s[:-1]), device=dev) for p, s in seqs]
    chains = [[block.embedding(params, cfg, t) for t in ids]]
    if lowp is not None:
        chains.append([h.clone() for h in chains[0]])
    for li in range(block.num_layers(cfg)):
        w = block.layer_weights(params, cfg, li)
        chains[0] = [block.layer(h, w, cfg) for h in chains[0]]
        if lowp is not None:
            w = {k: lowp(v) if k in block.MATMULS else v
                 for k, v in w.items()}
            chains[1] = [block.layer(h, w, cfg) for h in chains[1]]
        del w
    head = block.head(params, cfg)
    heads_ = [head] + ([lowp(head)] if lowp is not None else [])
    gaps, control = [], []
    for i, (p, s) in enumerate(seqs):
        rows = block.output_norm(chains[0][i][len(p) - 1:], params, cfg)
        low = (block.output_norm(chains[1][i][len(p) - 1:], params, cfg)
               if lowp is not None else None)
        served = torch.tensor(list(s), device=dev)
        out, out_c = [], []
        for b in range(0, rows.shape[0], 1024):
            lg = rows[b:b + 1024] @ head
            best = lg.max(-1).values
            tok = served[b:b + 1024]
            out.append(best - lg.gather(1, tok[:, None])[:, 0])
            if low is not None:
                first = (low[b:b + 1024] @ heads_[1]).argmax(-1)
                out_c.append(best - lg.gather(1, first[:, None])[:, 0])
        gaps.append(torch.cat(out))
        if low is not None:
            control.append(torch.cat(out_c))
    return (gaps, control) if lowp is not None else gaps
