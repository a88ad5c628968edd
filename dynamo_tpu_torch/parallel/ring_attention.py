"""Ring attention: sequence parallelism over a group of ranks.

Port of ``dynamo_tpu.parallel.ring_attention``. The sequence is split over
the ranks of a group (``parallel/comm.py``); each rank computes blockwise
attention for its query chunk while the K/V chunks travel around the ring,
one ``ppermute`` hop per step, so the activations each rank holds are
O(T / n). Softmax is accumulated online (flash-attention ``m``/``l``/``acc``
in f32), so the result is exact: full attention over the unsplit sequence,
up to summation order.

The JAX version is f32 einsum work outside any Pallas kernel, so this is
plain PyTorch too. Two things differ from it, neither in the function
computed:

- the K/V chunks travel in their own dtype and are widened to f32 at each
  step (the widening is exact, so a bf16 hop carries half the bytes of the
  JAX version's f32 one for the same values);
- each step runs over query blocks of :data:`Q_BLOCK` rows (rows are
  independent, so this only caps the f32 score tensor at ``[B, Q_BLOCK, H,
  C]``), and under ``causal`` a step whose whole key chunk lies after every
  query of this rank is skipped — its update is ``alpha = 1``, ``p = 0``,
  which leaves ``m``, ``l`` and ``acc`` bitwise unchanged — though its hop
  still runs.

Layout contract: per rank ``q [B, C, H, hd]``, ``k``/``v [B, C, KV, hd]``,
the rank's chunk ``index`` of the group (positions ``[index*C,
(index+1)*C)``); output ``[B, C, H, hd]`` in q's dtype. Causal masking is by
absolute position derived from each chunk's place on the ring.
"""

from __future__ import annotations

import math

import torch

from . import comm

Q_BLOCK = 256   # query rows per block step: caps the f32 scores


def _block_attend(q, k, v, qpos, kpos, m, l, acc, scale: float,
                  causal: bool):
    """One blockwise attention accumulation step (all f32).

    q: [B, Tq, H, hd]   k/v: [B, Tk, KV, hd]   qpos: [Tq]   kpos: [Tk]
    m, l: [B, Tq, H, 1]  acc: [B, Tq, H, hd]. Returns (m, l, acc).
    """
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, Tq, KV, G, hd)
    s = torch.einsum("btkgh,bskh->btkgs", qf, k) * scale   # [B,Tq,KV,G,Tk]
    if causal:
        mask = kpos[None, :] <= qpos[:, None]               # [Tq, Tk]
        s = torch.where(mask[None, :, None, None, :], s, -math.inf)
    s = s.reshape(B, Tq, H, Tk)

    m_cur = torch.amax(s, dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -math.inf))
    p = torch.exp(s - m_safe)                               # [B,Tq,H,Tk]
    l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
    pv = torch.einsum("btkgs,bskh->btkgh", p.reshape(B, Tq, KV, G, Tk),
                      v).reshape(B, Tq, H, hd)
    acc_new = acc * alpha + pv
    return m_new, l_new, acc_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: comm.Group, causal: bool = True) -> torch.Tensor:
    """The per-rank ring body. Rank ``i`` of the group starts holding
    chunk ``i``; at step ``s`` it attends over the chunk that started on
    rank ``(i - s) mod n`` while passing its current chunk to rank
    ``i + 1``. The last step forwards nothing. The engine's ``group`` is
    the rank's dp column (``Mesh.dp_group``). Rows whose ``l`` stays 0
    (no key reached them) come out as zeros."""
    n, i = group.size, group.index
    B, C, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qf = q.float()
    qpos = i * C + torch.arange(C, device=dev)
    m = torch.full((B, C, H, 1), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, C, H, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, C, H, hd), dtype=torch.float32, device=dev)

    cur_k, cur_v = k.contiguous(), v.contiguous()
    for s in range(n):
        owner = (i - s) % n              # whose chunk we hold this step
        if not (causal and owner > i):   # a wholly masked chunk: no-op
            kf, vf = cur_k.float(), cur_v.float()
            kpos = owner * C + torch.arange(C, device=dev)
            for t0 in range(0, C, Q_BLOCK):
                sl = slice(t0, t0 + Q_BLOCK)
                m[:, sl], l[:, sl], acc[:, sl] = _block_attend(
                    qf[:, sl], kf, vf, qpos[sl], kpos, m[:, sl], l[:, sl],
                    acc[:, sl], scale, causal)
        if s != n - 1:                   # the final chunk needs no hop
            cur_k = comm.ppermute(cur_k, group)
            cur_v = comm.ppermute(cur_v, group)

    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)


def make_ring_attention(group: comm.Group, causal: bool = True):
    """Ring attention for a caller that holds the whole ``[B, T, H|KV,
    hd]`` tensors on every rank (the JAX ``make_ring_attention`` contract
    over global arrays): ``f(q, k, v) -> out [B, T, H, hd]``, each rank
    computing its T/n slice on the ring and the slices gathered back."""
    def f(q, k, v):
        n, i = group.size, group.index
        T = q.shape[1]
        if T % n:
            raise ValueError(f"T={T} does not split over a ring of {n}")
        C = T // n
        sl = slice(i * C, (i + 1) * C)
        out = ring_attention(q[:, sl], k[:, sl], v[:, sl], group, causal)
        return comm.all_gather(out, group, dim=1)

    return f
