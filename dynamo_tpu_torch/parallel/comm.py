"""The collectives of tensor-, expert- and sequence-parallel serving.

No module of the package calls a ``torch.distributed`` collective except
through here. Every collective takes the :class:`Group` it runs over
explicitly: a group of the serving mesh (``parallel/layout.py``
``make_mesh`` hands them out on its ``Mesh``: the rank's tp row, its dp
column) or the world. ``all_reduce`` (sum) and ``broadcast`` carry the
Megatron sums of ``engine/model.py`` over the tp row, ``ppermute`` the
ring attention's hop and a pipeline's stage-to-stage one, ``all_gather``
the sp prefill's K/V for the cache and ``all_to_all`` Ulysses. The
single-rank paths on a mesh move their payloads counted apart (``op``):
a ``gather`` over the tp row joins each rank's KV heads of an extracted
block payload on the row's first member (``kv_gather``), and a
``broadcast`` over the world hands every rank a payload the leader holds
(an injected KV payload, ``kv_deliver``, or a multimodal chunk's
embeddings, ``mm_deliver``). On an fsdp mesh the ``all_gather`` of each
stored parameter shard over the rank's fsdp group, just before the
layer (or the embedding, or the head) that uses it, is counted apart
too (``fsdp_gather``). Every call is counted with its bytes and
the host microseconds it blocked (:data:`STATS`), so a run can report
the collectives per step.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for the
CPU. ``DYNTPU_DIST_BACKEND`` overrides it (``gloo`` puts two ranks on one
card). NCCL refuses two ranks on one device, so :func:`check_backend`
refuses that at init with a message, never switching backend behind the
caller's back. Under ``nccl`` every collective here runs natively, and so
does every one under gloo but the ring hop: gloo's ``all_reduce``,
``broadcast``, ``all_gather``, ``gather`` and ``all_to_all`` take CUDA
tensors (they copy through the host themselves), its send/recv does not
(an H100 run of ``chip_smoke.py`` phase 18 probes all six). :func:`ppermute` therefore
copies a CUDA tensor to the host on purpose under gloo, and counts those
bytes as ``staged_bytes`` — a named path, never a silent switch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log = get_logger("parallel.comm")

BACKEND_ENV = "DYNTPU_DIST_BACKEND"

# calls, bytes and host microseconds per collective since the last reset
# (host ints; the time is the blocking call's, launch to return), plus the
# bytes the ring hop copied through the host (gloo's send/recv takes no
# CUDA tensor)
_OPS = ("all_reduce", "broadcast", "ppermute", "all_gather", "all_to_all",
        "kv_gather", "kv_deliver", "mm_deliver", "fsdp_gather")
STATS: Dict[str, int] = {f"{op}_{what}": 0 for op in _OPS
                         for what in ("calls", "bytes", "us")}
STATS["staged_bytes"] = 0


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group of the mesh: its global ``ranks`` in group order,
    this rank's ``index`` in it, and the ``torch.distributed`` group
    (``None`` for a group of one rank, which needs none)."""

    ranks: Tuple[int, ...]
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


SOLO = Group((0,), 0)

_state: Dict[str, object] = {"rank": 0, "size": 1, "world": SOLO,
                             "backend": "", "timeout_s": 1800.0,
                             "meshes": {}}


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
    the rendezvous and every later collective (a ring hop's wait too), so
    a rank whose peer died inside one is freed after it."""
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    world = Group(tuple(range(world_size)), rank, dist.group.WORLD)
    _state.update(rank=rank, size=world_size, world=world, backend=backend,
                  timeout_s=float(timeout_s), meshes={})
    log.info("joined a world of %d ranks as rank %d over %s", world_size,
             rank, backend)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(rank=0, size=1, world=SOLO, backend="", meshes={})


def rank() -> int:
    return int(_state["rank"])


def world_size() -> int:
    return int(_state["size"])


def group():
    """The world's ``torch.distributed`` group (``None`` alone)."""
    return world_group().pg


def world_group() -> Group:
    return _state["world"]


def backend() -> str:
    return str(_state["backend"])


def mesh_groups(dp: int, fsdp: int, tp: int
                ) -> Tuple[Group, Group, Group, Group]:
    """(tp row, dp column, fsdp group, seq column) of this rank on a
    ``(dp, fsdp, tp)`` mesh over the world, mesh-major: rank ``r = (d *
    fsdp + f) * tp + t``. The tp row varies ``t``, the dp column ``d``,
    the fsdp group ``f``; the seq column holds the ranks of equal ``t``
    (``dp * fsdp`` of them, in rank order) that split a
    sequence-parallel prefill's prompt. A ``(dp, tp)`` mesh is ``fsdp``
    1, its seq column its dp column.

    ``torch.distributed.new_group`` is collective: EVERY rank must create
    EVERY group, in the same order, even those it is not in — so every
    rank makes all tp rows, then all dp columns, all fsdp groups and all
    seq columns, each distinct member set once (a set of one rank needs
    none, the whole world is the world's group). The groups of a shape
    are made once per world and reused."""
    n = world_size()
    if dp * fsdp * tp != n:
        raise RuntimeError(f"mesh ({dp}, {fsdp}, {tp}) needs a world of "
                           f"{dp * fsdp * tp} ranks; torch.distributed "
                           f"has {n}")
    meshes = _state["meshes"]
    if (dp, fsdp, tp) not in meshes:
        r = rank()
        world = world_group()
        pgs: Dict[Tuple[int, ...], object] = {}

        def at(d: int, f: int, t: int) -> int:
            return (d * fsdp + f) * tp + t

        def make(members_list):
            mine = None
            for members in members_list:
                if members not in pgs:
                    if len(members) == n:
                        pgs[members] = world.pg
                    elif len(members) == 1:
                        pgs[members] = None
                    else:
                        pgs[members] = dist.new_group(list(members))
                if r in members:
                    mine = Group(members, members.index(r), pgs[members])
            return mine

        rows = [tuple(at(d, f, t) for t in range(tp))
                for d in range(dp) for f in range(fsdp)]
        cols = [tuple(at(d, f, t) for d in range(dp))
                for f in range(fsdp) for t in range(tp)]
        fsdps = [tuple(at(d, f, t) for f in range(fsdp))
                 for d in range(dp) for t in range(tp)]
        seqs = [tuple(at(d, f, t) for d in range(dp) for f in range(fsdp))
                for t in range(tp)]
        meshes[(dp, fsdp, tp)] = (make(rows), make(cols), make(fsdps),
                                  make(seqs))
    return meshes[(dp, fsdp, tp)]


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(_state["timeout_s"]))


def _count(op: str, t0: float, nbytes: int) -> None:
    STATS[f"{op}_us"] += int((time.perf_counter() - t0) * 1e6)
    STATS[f"{op}_calls"] += 1
    STATS[f"{op}_bytes"] += nbytes


def all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over ``group``, in place; returns ``t``. A one-rank group
    returns it untouched and counts nothing."""
    if group.size == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group.pg)
    _count("all_reduce", t0, t.numel() * t.element_size())
    return t


def broadcast(t: torch.Tensor, group: Group, src: int = 0,
              op: str = "broadcast") -> torch.Tensor:
    """The ``t`` of the group's member ``src`` (an index into the group)
    on every member, in place; returns ``t``. Counted under ``op``."""
    if group.size == 1:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src=group.ranks[src], group=group.pg)
    _count(op, t0, t.numel() * t.element_size())
    return t


def ppermute(t: torch.Tensor, group: Group, shift: int = 1, *,
             send: bool = True, recv: bool = True) -> torch.Tensor:
    """Send ``t`` to the member ``shift`` places after this rank in the
    group and return what the member ``shift`` places before sent (the
    JAX ``ppermute`` with ``perm = [(j, (j + shift) % n)]``).

    One-way hops: ``send=False`` posts no send (``t`` then gives only the
    received tensor's shape and dtype), ``recv=False`` no receive (the
    call returns ``t``). A schedule that knows on the host which hops
    carry data (``parallel/pipeline.py``) posts only those; each send it
    posts meets the receive its peer posts at the same point of its own
    schedule. ``ppermute_bytes`` counts the bytes sent.

    Ring deadlock: two gloo ranks that both block in ``send`` wait for
    each other forever. The send and the receive are posted together
    (``batch_isend_irecv``) before either is waited on, and the wait has
    the process group's timeout, so a hop whose peer died raises.

    Host staging: gloo's send/recv takes no CUDA tensor (its transport
    reads the pointer on the host; probed on an H100 by ``chip_smoke.py``
    phase 18), so under gloo a CUDA ``t`` goes out from a host copy and
    the received one comes back to the device, both counted as
    ``staged_bytes``. Under nccl, and for CPU tensors, nothing stages."""
    n = group.size
    if n == 1 or not (send or recv):
        return t
    t0 = time.perf_counter()
    staged = t.is_cuda and backend() == "gloo"
    nbytes = t.numel() * t.element_size()
    ops = []
    if send:
        out = t.contiguous()
        if staged:
            STATS["staged_bytes"] += nbytes
            out = out.cpu()
        ops.append(dist.P2POp(dist.isend, out,
                              group.ranks[(group.index + shift) % n],
                              group.pg))
    if recv:
        got = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if staged else t.device)
        ops.append(dist.P2POp(dist.irecv, got,
                              group.ranks[(group.index - shift) % n],
                              group.pg))
    for w in dist.batch_isend_irecv(ops):
        w.wait(_timeout())
    _count("ppermute", t0, nbytes if send else 0)
    if not recv:
        return t
    if staged:
        STATS["staged_bytes"] += nbytes
        got = got.to(t.device)
    return got


def all_gather(t: torch.Tensor, group: Group, dim: int = 0,
               op: str = "all_gather") -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim`` in group order,
    counted under ``op``. Exact: each element is copied, never summed (a
    gather built as a zero-padded ``all_reduce`` would turn ``-0.0`` into
    ``+0.0``)."""
    n = group.size
    if n == 1:
        return t
    t0 = time.perf_counter()
    src = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts, dim=dim)
    _count(op, t0, src.numel() * src.element_size())
    return out


def gather(t: torch.Tensor, group: Group, dim: int, op: str):
    """The members' ``t`` concatenated along ``dim`` in group order on the
    group's first member, None on the others; counted under ``op`` with
    the bytes of this member's ``t``. Exact, as :func:`all_gather` is;
    only the first member receives."""
    n = group.size
    if n == 1:
        return t
    t0 = time.perf_counter()
    src = t.contiguous()
    parts = ([torch.empty_like(src) for _ in range(n)]
             if group.index == 0 else None)
    dist.gather(src, parts, dst=group.ranks[0], group=group.pg)
    out = None if parts is None else torch.cat(parts, dim=dim)
    _count(op, t0, src.numel() * src.element_size())
    return out


def all_to_all(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Split ``t`` along dim 0 into ``n`` equal parts, send part ``j`` to
    member ``j``, and return the parts received, in member order, along
    dim 0 (``all_to_all_single``)."""
    n = group.size
    if n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    t0 = time.perf_counter()
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group.pg)
    _count("all_to_all", t0, src.numel() * src.element_size())
    return out


def stats_line() -> str:
    """The counters as ``key=value`` pairs (zero counters of collectives
    that never ran are left out, ``all_reduce`` and ``broadcast`` always
    shown)."""
    keep = [k for k, v in STATS.items()
            if v or k.startswith(("all_reduce", "broadcast"))]
    return " ".join(f"{k}={STATS[k]}" for k in keep)
