"""Ulysses-style sequence parallelism: an all-to-all head scatter.

Port of ``dynamo_tpu.parallel.ulysses``. Where ring attention passes K/V
chunks around, one ``all_to_all`` turns the sequence-split ``[B, T/n, H,
hd]`` tensors into head-split ``[B, T, H/n, hd]`` ones, each rank runs
full-sequence attention over its head group, and a second ``all_to_all``
restores the sequence split: two collectives where the ring makes n - 1
hops, at the cost of ``H % n == 0``, ``KV % n == 0`` and full-T
activations per rank during attention. The engine never calls it (its
sequence-parallel prefill runs the ring), as in the JAX package; it is
held against the JAX version in the tests and timed on the card.
"""

from __future__ import annotations

import math

import torch

from . import comm

Q_BLOCK = 512   # query rows per block of _full_attention: caps the scores


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """Plain attention with f32 accumulation: q ``[B, T, H, hd]``, k/v
    ``[B, T, KV, hd]`` (GQA: ``H % KV == 0``); out in q's dtype. Query
    rows run in blocks of :data:`Q_BLOCK` (independent rows, so the same
    function with the score tensor capped at ``[B, Q_BLOCK, H, T]``)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)
    outs = []
    for t0 in range(0, T, Q_BLOCK):
        qb = q[:, t0:t0 + Q_BLOCK].float()
        Tq = qb.shape[1]
        s = torch.einsum("btkgh,bskh->btkgs", qb.reshape(B, Tq, KV, G, hd),
                         kf) / math.sqrt(hd)
        if causal:
            qpos = t0 + torch.arange(Tq, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            s = torch.where(mask[None, :, None, None, :], s, -math.inf)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("btkgs,bskh->btkgh", p, vf).reshape(
            B, Tq, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: comm.Group, causal: bool = True) -> torch.Tensor:
    """The per-rank Ulysses body over ``group``: q ``[B, C, H, hd]``, k/v
    ``[B, C, KV, hd]``, the rank's chunk of ``T = n * C``. Needs
    ``H % n == 0`` and ``KV % n == 0``."""
    n = group.size
    B, C, H, hd = q.shape
    KV = k.shape[2]
    if H % n or KV % n:
        raise ValueError(f"heads ({H}, kv {KV}) must divide sp={n}")

    def seq_to_heads(x):
        # [B, C, Hx, hd] -> [B, n*C, Hx/n, hd]: head group j to rank j,
        # the sequence chunks received concatenated in rank order
        Hx = x.shape[2]
        x = x.reshape(B, C, n, Hx // n, hd).permute(2, 0, 1, 3, 4)
        x = comm.all_to_all(x, group)       # [n (source), B, C, Hx/n, hd]
        return x.permute(1, 0, 2, 3, 4).reshape(B, n * C, Hx // n, hd)

    def heads_to_seq(x, Hx):
        # [B, n*C, Hx/n, hd] -> [B, C, Hx, hd]: sequence chunk j back to
        # rank j, the head groups received concatenated in rank order
        x = x.reshape(B, n, C, Hx // n, hd).permute(1, 0, 2, 3, 4)
        x = comm.all_to_all(x, group)       # [n (head group), B, C, ., hd]
        return x.permute(1, 2, 0, 3, 4).reshape(B, C, Hx, hd)

    out = _full_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal)
    return heads_to_seq(out, H)


def make_ulysses_attention(group: comm.Group, causal: bool = True):
    """Global-tensor Ulysses attention, the contract of
    ``ring_attention.make_ring_attention``."""
    def f(q, k, v):
        n, i = group.size, group.index
        T = q.shape[1]
        if T % n:
            raise ValueError(f"T={T} does not split over {n} ranks")
        C = T // n
        sl = slice(i * C, (i + 1) * C)
        out = ulysses_attention(q[:, sl], k[:, sl], v[:, sl], group, causal)
        return comm.all_gather(out, group, dim=1)

    return f
