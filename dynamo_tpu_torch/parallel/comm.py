"""The collectives of tensor- and expert-parallel serving.

One ``all_reduce`` (sum) and one ``broadcast`` over the rank's process
group, and nothing else: no module of the package calls a
``torch.distributed`` collective except through here, and none needs
``all_gather``, ``all_to_all`` or ``reduce_scatter`` (gloo has none of them
for CUDA tensors, and two ranks on one card run over gloo). Every call is
counted with its bytes (:data:`STATS`), so a run can report the collectives
per step.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for the
CPU. ``DYNTPU_DIST_BACKEND`` overrides it (``gloo`` puts two ranks on one
card, each collective staged through the host). NCCL refuses two ranks on
one device, so :func:`check_backend` refuses that at init with a message,
never switching backend behind the caller's back.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log = get_logger("parallel.comm")

BACKEND_ENV = "DYNTPU_DIST_BACKEND"

# calls, bytes and host microseconds per collective since the last reset
# (host ints; the time is the blocking call's, launch to return)
STATS: Dict[str, int] = {"all_reduce_calls": 0, "all_reduce_bytes": 0,
                         "all_reduce_us": 0, "broadcast_calls": 0,
                         "broadcast_bytes": 0}

_state: Dict[str, object] = {"rank": 0, "size": 1, "group": None,
                             "backend": ""}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def default_backend(device: torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise, unless
    ``DYNTPU_DIST_BACKEND`` names one."""
    return os.environ.get(BACKEND_ENV) or (
        "nccl" if device.type == "cuda" else "gloo")


def check_backend(backend: str, device: torch.device, local_ranks: int,
                  device_count: int) -> None:
    """Refuse a backend that cannot carry this host's ranks: NCCL wants
    CUDA tensors and one device per rank, so ``local_ranks`` ranks on
    ``device_count`` cards under ``nccl`` raise when they would share a
    card (use ``DYNTPU_DIST_BACKEND=gloo`` for that)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl|gloo)")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"nccl needs CUDA devices, not {device}")
    if local_ranks > device_count:
        raise RuntimeError(
            f"nccl cannot run {local_ranks} ranks on {device_count} "
            f"device(s): two ranks on one device need "
            f"{BACKEND_ENV}=gloo")


def init(rank: int, world_size: int, init_method: str, backend: str,
         timeout_s: float) -> None:
    """Join the world: ``torch.distributed.init_process_group`` over a TCP
    store at ``init_method`` (``tcp://host:port``). ``timeout_s`` bounds
    the rendezvous and every later collective, so a rank whose peer died
    inside one is freed after it."""
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(rank=rank, size=world_size, group=dist.group.WORLD,
                  backend=backend)
    log.info("joined a world of %d ranks as rank %d over %s", world_size,
             rank, backend)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(rank=0, size=1, group=None, backend="")


def rank() -> int:
    return int(_state["rank"])


def world_size() -> int:
    return int(_state["size"])


def group():
    return _state["group"]


def backend() -> str:
    return str(_state["backend"])


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the world, in place; returns ``t``. A one-rank
    world returns it untouched and counts nothing."""
    if world_size() == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group())
    STATS["all_reduce_us"] += int((time.perf_counter() - t0) * 1e6)
    STATS["all_reduce_calls"] += 1
    STATS["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if world_size() == 1:
        return t
    dist.broadcast(t, src=src, group=group())
    STATS["broadcast_calls"] += 1
    STATS["broadcast_bytes"] += t.numel() * t.element_size()
    return t


def stats_line() -> str:
    """The counters as ``key=value`` pairs."""
    return " ".join(f"{k}={v}" for k, v in STATS.items())
