"""Pipeline parallelism: GPipe-style microbatched stage execution, one
stage per rank.

Port of ``dynamo_tpu.parallel.pipeline``. The JAX package lays the stages
along a ``pp`` mesh axis inside one ``shard_map``; here every stage is a
rank of a ``torch.distributed`` world (``parallel/comm.py``) running its own
copy of the schedule, and activations hop stage to stage by
``comm.ppermute`` (one ``[mb, ...]`` tensor per microbatch per stage
boundary). Classic
GPipe: with S stages and M microbatches the schedule takes M + S - 1 ticks
and stage s holds microbatch ``t - s`` at tick t, so the bubble fraction is
(S - 1) / (S + M - 1).

Two differences from the JAX body, neither in the function:

- each rank knows its schedule on the host, so it computes only on the
  ticks of its window and posts only the hops that carry data: stage s
  sends microbatch m to stage s + 1 on the tick it finished it and
  receives microbatch m + 1 from stage s - 1 on the same tick. Each send
  meets a receive its peer posts at the same tick, so no bubble tick
  sends a blank and the last stage sends nothing back to stage 0 (the
  JAX ``ppermute`` is a ring, every stage to the next on every tick);
- the final output is replicated from the last stage by one exact
  ``broadcast`` of its bytes, where the JAX body sums a masked copy over
  the axis (a sum of one nonzero term per element, exact too).

Contract, as in JAX: ``stage_fn(stage_params, x) -> y`` with ``x``/``y``
of one shape and dtype (a residual-block stack); the parameters of the
stack carry a leading stage axis, which :func:`stage_slice` cuts to this
rank's part (in place of the JAX ``stage_shardings``).

Serving (``parallel/pp_serving.py``) calls :func:`stage_slice`,
:func:`gpipe` and :func:`broadcast_last` directly; :func:`pipeline_stages`
and :func:`make_pipeline` are the JAX module's API over whole microbatch
stacks, kept for parity and held against it by
``tests/test_torch_pipeline.py``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from . import comm


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor leaf of nested dicts (a quantized
    ``{"q", "s"}`` leaf is two leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_slice(params: Any, stage: int, num_stages: int) -> Any:
    """This stage's part of every leaf's leading axis: rows ``[stage * n /
    S, (stage + 1) * n / S)`` of a leading axis of ``n`` (a stacked-per-
    stage tree, ``n == S``, gives each stage a leading axis of 1; a
    stacked-per-layer one its ``n / S`` layers). Views: the caller clones
    what must outlive the full tree."""
    def cut(p: torch.Tensor) -> torch.Tensor:
        n = p.shape[0]
        if n % num_stages:
            raise ValueError(f"a leading axis of {n} does not split over "
                             f"{num_stages} stages")
        per = n // num_stages
        return p[stage * per:(stage + 1) * per]

    return tree_map(cut, params)


def gpipe(group: comm.Group, M: int, feed: Callable[[int], torch.Tensor],
          stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
          blank: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """The schedule, on this rank: stage ``group.index`` of ``group.size``.

    ``feed(m)`` is microbatch m's input (called on stage 0 only),
    ``stage_fn(m, x)`` this stage's output for microbatch m, and ``blank``
    a tensor of the activation's shape and dtype (what a receive fills).
    Returns the last stage's M outputs in microbatch order on the last
    stage, ``None`` on the others. Each of the M microbatches crosses each
    of the S - 1 stage boundaries once: the first and last stages post M
    hops, a middle stage M + 1 (its receive of microbatch m + 1 shares a
    tick with its send of m)."""
    S, stage = group.size, group.index
    act = blank
    banked: List[torch.Tensor] = []
    for t in range(M + S - 1):
        if stage == 0 and t < M:
            act = feed(t)
        m = t - stage               # the microbatch this stage holds now
        if 0 <= m < M:
            act = stage_fn(m, act)
            if stage == S - 1:
                banked.append(act)
        send = stage < S - 1 and 0 <= m < M
        recv = stage > 0 and 0 <= m + 1 < M
        act = comm.ppermute(act, group, send=send, recv=recv)
    return banked if stage == S - 1 else None


def broadcast_last(out: Optional[torch.Tensor], group: comm.Group,
                   like: torch.Tensor) -> torch.Tensor:
    """The last stage's ``out`` on every stage, bit for bit (its bytes
    travel, so gloo's dtype table never matters); the others pass
    ``None`` and a tensor ``like`` it."""
    if out is None:
        out = torch.empty_like(like)
    out = out.contiguous()
    comm.broadcast(out.view(torch.uint8), group, src=group.size - 1)
    return out


def pipeline_stages(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stage_params: Any, x: torch.Tensor,
                    group: comm.Group) -> torch.Tensor:
    """Per-rank pipeline body: ``x [M, mb, ...]`` all microbatches (the
    same on every rank), ``stage_params`` this rank's stage. Returns the
    final-stage outputs ``[M, mb, ...]``, replicated to every stage."""
    M = x.shape[0]
    banked = gpipe(group, M, lambda m: x[m],
                   lambda m, a: stage_fn(stage_params, a),
                   torch.zeros_like(x[0]))
    out = torch.stack(banked) if banked is not None else None
    return broadcast_last(out, group, x)


def make_pipeline(group: comm.Group,
                  stage_fn: Callable[[Any, torch.Tensor], torch.Tensor]):
    """The pipelined forward ``f(params, x[M, mb, ...]) -> y`` of this
    rank: ``params`` is this rank's :func:`stage_slice` of a tree whose
    leaves carry a leading stage axis of ``group.size`` (so a leading axis
    of 1 here, dropped before ``stage_fn`` sees it, as the JAX
    ``shard_map`` drops it)."""

    def run(params: Any, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return pipeline_stages(stage_fn, tree_map(lambda p: p[0], params),
                                   x, group)

    return run
