"""Prompt-lookup drafting: n-gram suffix match over on-device token history.

A copy of ``dynamo_tpu.spec.ngram``. Each decode seat keeps a per-sequence
token history row ``hist[0..pos0]`` (``hist[p]`` = token at position ``p``;
-1 marks unknown positions, e.g. prefix-cache gaps or unused tail).
Drafting finds the most recent earlier occurrence of the current suffix
n-gram — trying the largest n first — and proposes the k tokens that
followed it. Proposals are *always* verified by the target model, so a bad
match costs throughput, never correctness.

``propose_drafts`` is the batched tensor version used inside the spec
window; ``propose_drafts_reference`` is a plain-numpy oracle for tests.
The JAX drafter maps a one-row function over the batch; here every step
works on the whole ``[B, H, n]`` window stack with static shapes (``where``,
``gather``, ``cumprod``, reductions) and no host sync or data-dependent
shape, so it is captured inside the spec window's CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hotpath import hot_path


@hot_path
def propose_drafts(hist: torch.Tensor, pos0: torch.Tensor, k: int,
                   ngram_min: int, ngram_max: int) -> torch.Tensor:
    """Batched drafter: hist [B, H], pos0 [B] -> drafts [B, k] int32,
    -1-padded; valid drafts form a contiguous prefix of each row."""
    B, H = hist.shape
    dev = hist.device
    hist = hist.long()
    pos0 = pos0.long()[:, None]                               # [B, 1]
    idx = torch.arange(H, device=dev)                         # [H]
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    best_q = torch.full((B,), -1, dtype=torch.long, device=dev)
    # largest n first: a longer context match is the better prediction
    for n in range(ngram_max, ngram_min - 1, -1):
        offs = torch.arange(n, device=dev)
        sidx = torch.clamp(pos0 - n + 1 + offs[None, :], 0, H - 1)  # [B, n]
        suf = torch.gather(hist, 1, sidx)
        suffix_ok = (pos0[:, 0] - n + 1 >= 0) & (suf >= 0).all(dim=1)
        # every candidate end position q gets its n-token window [q-n+1, q]
        widx = torch.clamp(idx[:, None] - n + 1 + offs[None, :], 0, H - 1)
        win = hist[:, widx]                                   # [B, H, n]
        match = (
            (win == suf[:, None, :]).all(dim=2)
            & (win >= 0).all(dim=2)
            & (idx >= n - 1)[None, :] & (idx[None, :] < pos0)
            & suffix_ok[:, None]
        )                                                     # [B, H]
        # prefer the most recent match with a FULL k-token continuation
        # inside known history (on periodic content the nearest match sits
        # right at the suffix and only has 1-2 known followers); fall back
        # to the nearest match otherwise
        q_full = torch.where(match & (idx[None, :] + k <= pos0), idx,
                             -1).amax(dim=1)
        q_any = torch.where(match, idx, -1).amax(dim=1)
        q = torch.where(q_full >= 0, q_full, q_any)
        use = (q >= 0) & ~found
        best_q = torch.where(use, q, best_q)
        found = found | use
    didx = best_q[:, None] + 1 + torch.arange(k, device=dev)[None, :]
    d = torch.gather(hist, 1, torch.clamp(didx, 0, H - 1))    # [B, k]
    # a draft chain stops at the first unknown/overrun position
    ok = torch.cumprod(
        (found[:, None] & (didx <= pos0) & (d >= 0)).to(torch.int32), dim=1
    ).bool()
    return torch.where(ok, d, -1).to(torch.int32)


def propose_drafts_reference(hist, pos0: int, k: int,
                             ngram_min: int, ngram_max: int) -> np.ndarray:
    """Plain-python oracle for one row (tests compare the batched fn to
    this)."""
    hist = np.asarray(hist)
    out = np.full(k, -1, dtype=np.int32)
    for n in range(ngram_max, ngram_min - 1, -1):
        if pos0 - n + 1 < 0:
            continue
        suf = hist[pos0 - n + 1:pos0 + 1]
        if (suf < 0).any():
            continue
        best = best_full = -1
        for q in range(n - 1, min(pos0, hist.shape[0])):
            win = hist[q - n + 1:q + 1]
            if (win >= 0).all() and (win == suf).all():
                best = q
                if q + k <= pos0:
                    best_full = q
        if best_full >= 0:
            best = best_full
        if best < 0:
            continue
        for j in range(k):
            p = best + 1 + j
            if p > pos0 or hist[p] < 0:
                break
            out[j] = hist[p]
        return out
    return out
