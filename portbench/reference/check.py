"""The comparison that decides ``correct``: served tokens against the plain
reference, on a sample of the requests the window finished.

At every served position of the sample, the gap is how far the served
token's reference logit lies below the reference's best. Greedy serving
that follows the model keeps it near 0 (a near-tie may go either way under
rounding); a wrong token or a wrong cache entry opens it wide. A cell
compares ``max_logit_gap``, the widest gap, or where rounding alone reaches
as wide (an expert layer, whose top-k choice flips at near-ties)
``mean_logit_gap``, the mean over the positions.
"""

from __future__ import annotations

from types import ModuleType
from typing import List, Sequence

import numpy as np

from .model import fp8_weights, served_logit_gaps


def pick(results: Sequence, n: int, seed: int) -> List:
    """``n`` finished requests drawn from the seed, the one with the most
    served tokens among them."""
    done = [r for r in results if r.complete]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), r.req.isl))
    rest = [r for r in done if r is not longest]
    rng = np.random.Generator(np.random.PCG64(int(seed) + 7919))
    k = min(n - 1, len(rest))
    others = [rest[i] for i in sorted(rng.choice(len(rest), k,
                                                 replace=False))]
    return [longest] + others


def gap_stats(gaps) -> dict:
    """The number compared (``max``) and, to read beside it, how the gaps
    spread over the served positions."""
    import torch

    g = torch.cat(list(gaps)).float()
    return {"max": float(g.max()), "p99": float(g.quantile(0.99)),
            "mean": float(g.mean()), "positions": int(g.numel()),
            "nonzero": int((g > 0).sum())}


def numbers(stats) -> dict:
    """The numbers a cell may compare (``cells/<cell>.json`` ``limits``):
    the widest served-token gap, and the mean gap over the positions."""
    if stats is None:
        return {}
    return {"max_logit_gap": stats["max"], "mean_logit_gap": stats["mean"]}


def compare(block: ModuleType, params, cfg, picked: Sequence,
            control: bool = False):
    """Gap statistics of the served tokens under the architecture's plain
    block (``reference/<model_type>.py``); with ``control`` also those of
    the reference computed with float8 weights, at the same positions."""
    seqs = [(r.req.token_ids, r.tokens) for r in picked]
    if not control:
        return gap_stats(served_logit_gaps(block, params, cfg, seqs)), None
    gaps, low = served_logit_gaps(block, params, cfg, seqs,
                                  lowp=fp8_weights)
    return gap_stats(gaps), gap_stats(low)
