"""Mixture-of-Experts FFN, on one device or with experts over ranks.

Port of ``dynamo_tpu.parallel.moe``: GShard-style capacity-based dispatch
built from one-hot products and batched expert matmuls, with no per-token
gather or scatter and no data-dependent shape, so a decode window that runs
it is captured in a CUDA graph like any other. Routing is the reference's,
row for row: router logits in f32, softmax, top-k with ties to the lower
expert index (``jax.lax.top_k``'s order), renormalised gates, and capacity
slots handed out in token-major, slot-minor order, padded rows included.

Expert parallelism (``expert_offset``): a rank holding experts
``[e0, e0 + E/ep)`` of the stacks routes every token over all E experts
(the router is replicated), dispatches to its own experts only, and returns
its f32 partial output; the caller's one ``all_reduce`` sums the ranks'
partials. That is the contraction over ``e`` the JAX layout splits over
``ep`` (``SpecLayout.expert_stacked``), split the same way.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity (static per shape)."""
    return max(1, math.ceil(num_tokens * top_k / num_experts
                            * capacity_factor))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (as ``jax.nn.one_hot``). A comparison, so
    no device-to-host check runs (``F.one_hot`` validates its indices)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def topk_lower_first(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties to the lower index first, as ``jax.lax.top_k`` orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(
    x: torch.Tensor,          # [N, D] tokens (flattened batch)
    w_router: torch.Tensor,   # [D, E]
    w_gate: torch.Tensor,     # [E, D, F]
    w_up: torch.Tensor,       # [E, D, F]
    w_down: torch.Tensor,     # [E, F, D]
    *,
    top_k: int,
    capacity_factor: float = 2.0,
    expert_offset: Optional[int] = None,
) -> torch.Tensor:
    """Top-k routed SwiGLU experts; returns [N, D] in x's dtype.

    A (token, slot) past its expert's capacity loses that expert's
    contribution (its gate is zeroed; the other gates keep their
    renormalised values), as in the reference.

    With ``expert_offset`` the stacks hold experts ``[expert_offset,
    expert_offset + w_gate.shape[0])`` of the router's E: routing and
    capacity are the whole model's, only those experts are run, and the
    result is their f32 partial sum (one term of the expert-parallel
    ``all_reduce``)."""
    N, D = x.shape
    E = w_router.shape[1]
    C = moe_capacity(N, E, top_k, capacity_factor)
    dt = x.dtype

    logits = x.float() @ w_router.float()                  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = topk_lower_first(probs, top_k)     # [N, k]
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)

    # one-hot expert per (token, slot), and each one's place in its
    # expert's buffer: the count of earlier assignments to that expert in
    # token-major, slot-minor order
    assign = _one_hot(top_idx, E)                          # [N, k, E]
    flat = assign.reshape(N * top_k, E)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(dim=-1).reshape(N, top_k)       # [N, k]
    in_cap = pos < C
    gates = torch.where(in_cap, top_vals, 0.0)

    pos_hot = _one_hot(torch.where(in_cap, pos, float(C)).long(), C)
    dispatch = torch.einsum("nke,nkc->nec", assign, pos_hot)
    combine = torch.einsum("nke,nkc,nk->nec", assign, pos_hot, gates)

    if expert_offset is not None:
        local = slice(expert_offset, expert_offset + w_gate.shape[0])
        dispatch, combine = dispatch[:, local], combine[:, local]
    xin = torch.einsum("nec,nd->ecd", dispatch, x.float()).to(dt)
    gate = F.silu(torch.bmm(xin, w_gate).float())          # [E, C, F]
    up = torch.bmm(xin, w_up).float()
    h = (gate * up).to(dt)
    out = torch.bmm(h, w_down)                             # [E, C, D]
    y = torch.einsum("nec,ecd->nd", combine, out.float())
    return y if expert_offset is not None else y.to(dt)
