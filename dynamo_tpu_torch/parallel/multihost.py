"""Multi-rank serving as multi-controller SPMD: torch.distributed +
step-plan replication.

Port of ``dynamo_tpu.parallel.multihost``. The JAX package runs one
controller per host and one ``Mesh`` over the slice; every host must issue
the same jitted calls in the same order. In PyTorch each GPU is a rank in
its own process, so here every *rank* is what a JAX host is:

- every rank joins one ``torch.distributed`` world of every rank of the
  mesh, or of ``pp`` ranks for a pipeline (:func:`initialize_distributed`,
  a TCP store at the coordinator address, in place of
  ``jax.distributed.initialize``) and holds its shard of the model on the
  ``(dp, tp)`` or ``(dp, fsdp, tp)`` mesh (``engine/model.py``:
  column/row-sharded projections, experts over ``ep``, each row-sharded
  product followed by one ``all_reduce`` over the tp row; parameters
  stored over fsdp and gathered layer by layer; replicated over dp and
  fsdp otherwise, those replicas splitting only a sequence-parallel
  prefill's prompt), or its pipeline
  stage's layers (``parallel/pp_serving.py``: activations hop stage to
  stage by ``ppermute``);
- scheduling happens once, on rank 0 (the leader); followers replay the
  leader's step plans, so every rank launches the same steps in the same
  order and meets the others in the same collectives.

In the worker, plan replication rides the runtime's TCP response-stream
transport: each follower opens one long-lived request to the leader's
``step_stream`` endpoint and the leader streams one plan per step.
Bring-up is gated by the store barrier (``runtime/barrier.py``): the
leader serves ``step_stream``, waits for every follower to connect, and
only then registers the model. The launchers that run no runtime
(``run.py --mesh``, the profiler's ``--mesh``) start their followers with
:func:`spawn_local_ranks` and hand them the plans through a
``TCPStore`` queue of their own (:class:`StorePlanChannel`).

A plan carries the small host-side arrays of one device call (the packed
prefill ints, control-state deltas, a seat map, a few KB); model state
never moves. Step keys stay in sync because every rank's engine draws them
from a generator seeded alike, one draw per prefill, and windows derive
theirs on device from the control state the plans keep equal.

One trap the JAX version does not have: the leader must emit each plan
*before* it launches the step. JAX emits after dispatch, which is harmless
there because its collectives are asynchronous on the device; a gloo
``all_reduce`` blocks the host, so a leader that launched first would wait
inside the collective for a follower that waits for the plan.

The single-rank paths ride the same stream: a KV extract (``kx``) and
inject (``ki``) carry only the padded block ids, an ``emb`` plan one
embedding group's tokens and positions, an ``mrp`` plan a multimodal
prefill chunk's packed ints. Payloads never ride it: the KV blocks and a
chunk's image embeddings move by a collective the plan leads into
(``comm.gather`` / ``comm.broadcast``, counted as ``kv_gather``,
``kv_deliver`` and ``mm_deliver``). As in the JAX multi-host worker,
a worker that spans hosts serves neither disaggregation nor the KVBM
tiers (``worker.check_supported``).
"""

from __future__ import annotations

import asyncio
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..multimodal.wire import array_from_wire, array_to_wire
from ..runtime.barrier import LeaderBarrier, WorkerBarrier
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..runtime.transport import EngineError
from ..utils.logging import get_logger
from . import comm

log = get_logger("multihost")


@dataclass
class MultihostConfig:
    """One rank's place in a world of ``world_size`` ranks (``dp * tp``
    of the mesh, or the ``pp`` stages of a pipeline) over ``num_hosts``
    hosts (``world_size / num_hosts``
    ranks per host). Rank ``host_index * per_host + local_rank``; rank 0
    leads."""

    coordinator: Optional[str] = None   # "host0:port" of the TCP store
    num_hosts: int = 1
    host_index: int = 0
    world_size: int = 1                 # dp * tp of the mesh, or pp stages
    local_rank: int = 0                 # this process's rank on its host
    barrier_timeout_s: float = 300.0
    # failure detection on the step stream, as in JAX: the leader beats
    # every idle interval; a follower that sees nothing for
    # heartbeat_timeout_s exits so a supervisor restarts the group
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 10.0
    # bounds the rendezvous and every collective: a follower blocked in a
    # collective whose leader died is freed after this (gloo's default is
    # 30 minutes); near the heartbeat deadline, with room for the ranks'
    # different weight-load times before the first collective
    collective_timeout_s: float = 30.0

    @property
    def enabled(self) -> bool:
        return self.world_size > 1

    @property
    def per_host(self) -> int:
        return self.world_size // self.num_hosts

    @property
    def rank(self) -> int:
        return self.host_index * self.per_host + self.local_rank

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def check(self) -> None:
        if self.world_size % self.num_hosts:
            raise ValueError(
                f"{self.world_size} ranks do not split over "
                f"{self.num_hosts} hosts")
        if not 0 <= self.host_index < self.num_hosts:
            raise ValueError(f"--host-index {self.host_index} outside "
                             f"0..{self.num_hosts - 1}")
        if not 0 <= self.local_rank < self.per_host:
            raise ValueError(f"local rank {self.local_rank} outside "
                             f"0..{self.per_host - 1}")
        if self.enabled and not self.coordinator:
            raise ValueError("a world of more than one rank needs a "
                             "coordinator address")


def rank_device(device: Optional[str], local_rank: int) -> str:
    """The device of a host's ``local_rank``: ``cuda:i mod count`` unless
    the CPU (or an explicit index) was asked for."""
    if device is not None and device != "cuda":
        return device
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return "cuda"      # resolve_device raises, by name
    return f"cuda:{local_rank % n}"


def initialize_distributed(cfg: MultihostConfig,
                           device: torch.device) -> bool:
    """Join the world (``init_process_group`` over a TCP store at
    ``cfg.coordinator``; the backend from ``comm.default_backend``, checked
    against this host's ranks). Returns True when a world of more than
    one rank is active."""
    if not cfg.enabled:
        return False
    cfg.check()
    backend = comm.default_backend(device)
    comm.check_backend(
        backend, device, cfg.per_host,
        torch.cuda.device_count() if device.type == "cuda" else 0)
    comm.init(cfg.rank, cfg.world_size, f"tcp://{cfg.coordinator}", backend,
              cfg.collective_timeout_s)
    return True


def free_port() -> int:
    """A free TCP port on localhost (for a one-host world's store)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_ranks(argv: List[str], cfg: MultihostConfig,
                      module: str = "dynamo_tpu_torch.worker"
                      ) -> List[subprocess.Popen]:
    """Start this host's other ranks (local ranks 1..per_host-1) as child
    processes running ``python -m module`` (the worker, the one-process
    launcher or the profiler) with ``argv`` plus their local rank and
    the coordinator; they write to this process's stdout and stderr."""
    procs = []
    for lr in range(1, cfg.per_host):
        args = [sys.executable, "-m", module, *argv,
                "--coordinator", cfg.coordinator,
                "--num-hosts", str(cfg.num_hosts),
                "--host-index", str(cfg.host_index),
                "--local-rank", str(lr)]
        procs.append(subprocess.Popen(args, env=dict(os.environ)))
    log.info("started local ranks %s (pids %s)",
             list(range(cfg.rank + 1, cfg.rank + cfg.per_host)),
             [p.pid for p in procs])
    return procs


def add_local_world_args(p) -> None:
    """The flags a launcher's spawned follower ranks are started with
    (:class:`LocalWorld`), hidden from ``--help``."""
    import argparse

    for flag, kw in (("--coordinator", {}),
                     ("--num-hosts", {"type": int, "default": 1}),
                     ("--host-index", {"type": int, "default": 0}),
                     ("--local-rank", {"type": int, "default": 0}),
                     ("--plan-store", {})):
        p.add_argument(flag, help=argparse.SUPPRESS, **kw)


def parse_mesh_flag(text: str) -> Tuple[int, int]:
    """``(dp, tp)`` of a launcher's ``--mesh dp,tp`` (the worker, ``run.py``,
    the profiler), unpacked as the JAX launchers unpack it: three numbers
    raise their ``ValueError`` (a 3-D ``(dp, fsdp, tp)`` mesh is served
    through ``EngineConfig(mesh_shape=)``, as in JAX)."""
    dp, tp = (int(x) for x in text.replace(" ", "").split(","))
    return dp, tp


class LocalWorld:
    """A one-host world of ``dp * tp`` ranks for a launcher with no
    runtime (``run.py``, the profiler), as a context: on entry a mesh of
    more than one rank joins the world. The leader (``--local-rank`` 0,
    the process the user started) hosts the plan channel, spawns the
    followers as ``python -m module`` with its own ``args.argv`` plus their
    rank, the coordinator and the channel's address, then joins them; a
    follower joins the channel and the world. ``args.device`` becomes the
    rank's device (:func:`rank_device`). Enter it before any weight is
    loaded: the rendezvous waits for every rank. :meth:`serve` then runs
    the rank's part; on exit the leader closes the channel, its followers
    are stopped and the world destroyed, however the run ended."""

    def __init__(self, args, module: str, mesh: Tuple[int, int]):
        self.args, self.module = args, module
        self.size = mesh[0] * mesh[1]
        self.children: List[subprocess.Popen] = []
        self.channel: Optional[StorePlanChannel] = None

    @property
    def leader(self) -> bool:
        return self.channel is None or self.args.local_rank == 0

    def __enter__(self) -> "LocalWorld":
        if self.size == 1:
            return self
        args = self.args
        mh = MultihostConfig(coordinator=args.coordinator,
                             world_size=self.size,
                             local_rank=args.local_rank)
        if mh.local_rank == 0:
            mh.coordinator = f"127.0.0.1:{free_port()}"
            self.channel = StorePlanChannel.host(self.size - 1)
            # into self.children as each starts: __exit__ stops them even
            # when the rendezvous fails
            self.children.extend(spawn_local_ranks(
                list(args.argv) + ["--plan-store", self.channel.addr], mh,
                self.module))
        else:
            self.channel = StorePlanChannel.join(args.plan_store,
                                                 self.size - 1)
        mh.check()
        args.device = rank_device(args.device, mh.local_rank)
        initialize_distributed(mh, torch.device(args.device))
        return self

    def serve(self, engine, lead):
        """The rank's part on ``engine``: a follower replays the leader's
        plans until the leader closes the channel and returns None; the
        leader sends its step plans to the followers and returns
        ``lead(engine)``."""
        if not self.leader:
            n = self.channel.follow(engine)
            log.info("%s rank %d exiting after %d plans", self.module,
                     self.args.local_rank, n)
            return None
        if self.channel is not None:
            engine.step_sink = self.channel.sink
        return lead(engine)

    def __exit__(self, *exc) -> None:
        try:
            if self.channel is not None and self.leader:
                self.channel.close()
        finally:
            if self.children:
                stop_local_ranks(self.children)
            if self.channel is not None:
                comm.destroy()


def stop_local_ranks(procs: List[subprocess.Popen],
                     grace_s: float = 15.0) -> None:
    """Stop the child ranks: they exit by themselves once this leader's
    step stream closes (logging their counts); those still alive after
    ``grace_s`` are terminated, then killed."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.terminate()
    for p in procs:
        try:
            p.wait(5.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


# --------------------------- plan encoding -------------------------------


def encode_plan(kind: str, arrays: Dict[str, np.ndarray]) -> dict:
    return {"k": kind,
            "a": {n: array_to_wire(np.asarray(v)) for n, v in arrays.items()}}


def decode_plan(plan: dict):
    return plan["k"], {n: array_from_wire(v) for n, v in plan["a"].items()}


# ------------------------- store plan channel ----------------------------


class StorePlanChannel:
    """Step plans from the leader to the followers of one host through a
    ``torch.distributed.TCPStore`` of their own, for the launchers that
    run no runtime (``run.py``, the SLA profiler; the worker keeps its
    ``step_stream`` endpoint).

    The store is a queue: plan ``i`` is the key ``plans/i`` (the codec's
    bytes of :func:`encode_plan`); each follower waits for the next key,
    reads it and counts itself on ``plans/i/n``, and the last reader
    deletes both. A follower waits in the store, never in a collective: a
    gloo collective on the step group would time out after the world's
    collective timeout while the leader is idle, and would interleave
    with the step's own collectives. Its wait polls every ``poll_s``; the
    store lives in the leader's process, so a leader that died fails the
    poll and frees the follower."""

    def __init__(self, store, followers: int, poll_s: float = 1.0):
        self.store = store
        self.followers = followers
        self.poll_s = poll_s
        self.seq = 0
        self.kinds: Dict[str, int] = {}   # the leader's plans per kind

    @classmethod
    def host(cls, followers: int) -> "StorePlanChannel":
        """The leader's end: a store on a free localhost port
        (:attr:`addr`)."""
        import datetime

        import torch.distributed as dist

        store = dist.TCPStore("127.0.0.1", free_port(), None, True,
                              datetime.timedelta(seconds=300),
                              wait_for_workers=False)
        return cls(store, followers)

    @classmethod
    def join(cls, addr: str, followers: int) -> "StorePlanChannel":
        """A follower's end, on the leader's store at ``host:port``."""
        import datetime

        import torch.distributed as dist

        host, port = addr.rsplit(":", 1)
        return cls(dist.TCPStore(host, int(port), None, False,
                                 datetime.timedelta(seconds=300)),
                   followers)

    @property
    def addr(self) -> str:
        return f"{self.store.host}:{self.store.port}"

    def _put(self, msg: dict) -> None:
        from ..runtime import codec

        self.seq += 1
        self.store.set(f"plans/{self.seq}", codec.packb(msg))

    def sink(self, kind: str, arrays: Dict[str, np.ndarray]) -> None:
        """The leader engine's ``step_sink``: one plan, before the launch
        (device-step thread)."""
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self._put(encode_plan(kind, arrays))

    def close(self) -> None:
        """The leader's last message: the followers' loops end."""
        self._put({"closed": True})

    def next_plan(self):
        """The next ``(kind, arrays)``, or None once the leader closed."""
        import datetime

        from ..runtime import codec

        self.seq += 1
        key = f"plans/{self.seq}"
        poll = datetime.timedelta(seconds=self.poll_s)
        while True:
            try:
                self.store.wait([key], poll)
                break
            except Exception:   # noqa: BLE001 — a timeout, or a dead store
                if self.store.check([key]):   # raises if the store is gone
                    break
        msg = codec.unpackb(self.store.get(key))
        if self.store.add(f"{key}/n", 1) == self.followers:
            self.store.delete_key(key)
            self.store.delete_key(f"{key}/n")
        return None if msg.get("closed") else decode_plan(msg)

    def follow(self, engine) -> int:
        """Replay the leader's plans on ``engine`` until it closes the
        channel; returns the plans replayed."""
        n = 0
        while True:
            plan = self.next_plan()
            if plan is None:
                return n
            replay_plan(engine, *plan)
            n += 1


# ------------------------------ leader -----------------------------------


class StepBroadcaster:
    """Fans step plans out to connected followers. ``sink`` is the
    engine's ``step_sink``, called on the device-step thread before each
    launch; delivery hops to the event loop."""

    # a follower this many plans behind is wedged
    MAX_LAG = 10_000

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        self._loop = loop or asyncio.get_event_loop()
        self._queues: Dict[int, asyncio.Queue] = {}
        self.num_plans = 0
        self.num_dropped_followers = 0
        self.kinds: Dict[str, int] = {}     # plans emitted per kind

    def sink(self, kind: str, arrays: Dict[str, np.ndarray]) -> None:
        plan = encode_plan(kind, arrays)
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self._loop.call_soon_threadsafe(self._fanout, plan)

    def _fanout(self, plan: dict) -> None:
        self.num_plans += 1
        for rank, q in list(self._queues.items()):
            if q.qsize() > self.MAX_LAG:
                log.error("follower %d wedged (%d plans behind) — dropping"
                          " it; the group must restart", rank, q.qsize())
                self.unsubscribe(rank)
                self.num_dropped_followers += 1
                while not q.empty():
                    q.get_nowait()
                q.put_nowait({"closed": True})
                continue
            q.put_nowait(plan)

    def subscribe(self, rank: int) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rank] = q
        return q

    def unsubscribe(self, rank: int,
                    queue: Optional[asyncio.Queue] = None) -> None:
        """With ``queue`` given, remove only if that queue is still the
        registered one (a stale handler must not evict a fresh one)."""
        if queue is None or self._queues.get(rank) is queue:
            self._queues.pop(rank, None)

    @property
    def num_followers(self) -> int:
        return len(self._queues)


class StepStreamHandler(AsyncEngine):
    """Leader endpoint: one long-lived stream of step plans per follower,
    idle gaps filled with heartbeats."""

    def __init__(self, broadcaster: StepBroadcaster,
                 heartbeat_interval_s: float = 2.0):
        self.broadcaster = broadcaster
        self.heartbeat_interval_s = heartbeat_interval_s

    async def generate(self, request: Any,
                       context: Context) -> AsyncIterator[dict]:
        rank = int(request["rank"])
        queue = self.broadcaster.subscribe(rank)
        log.info("follower %d connected to step stream", rank)
        try:
            yield {"hello": True}
            while True:
                try:
                    msg = await asyncio.wait_for(
                        queue.get(), timeout=self.heartbeat_interval_s)
                except asyncio.TimeoutError:
                    yield {"hb": True}
                    continue
                yield msg
                if msg.get("closed"):
                    return
        finally:
            self.broadcaster.unsubscribe(rank, queue)
            log.warning("follower %d disconnected", rank)


async def leader_gate(store, cfg: MultihostConfig,
                      broadcaster: StepBroadcaster, name: str) -> None:
    """Barrier: every follower is on the step stream before the model is
    registered (a follower still joining would miss plans)."""
    n = cfg.world_size - 1
    barrier = LeaderBarrier(f"multihost/{name}", n,
                            timeout_s=cfg.barrier_timeout_s)
    await barrier.sync(store, {"model": name, "world_size": cfg.world_size})
    if broadcaster.num_followers != n:
        raise RuntimeError(
            f"barrier passed but only {broadcaster.num_followers}/{n} "
            "followers on the step stream")
    log.info("multihost bring-up complete: %d followers", n)


# ------------------------------ follower ---------------------------------


def replay_plan(engine, kind: str, arrays: Dict[str, np.ndarray]) -> None:
    """Execute one leader plan with the calls the leader's engine made for
    it. Runs on the engine's device-step thread; draws step keys exactly
    as the leader did.

    Kinds: ``pp`` packed prefill, ``rsp`` the sequence-parallel prefill
    (the packed contract on ``engine._sp_prefill_fn``), ``ctl``
    control-state delta, ``cols`` seat map, ``w``/``sw`` decode/spec
    window, ``sph`` spec history fill, and ``p``/``d`` the unified step (a
    prefill chunk / a decode batch with host arrays: a pipeline-parallel
    leader emits them, as the JAX engine's synchronous path does, and a
    follower runs its stage's part of the GPipe step,
    ``engine.unified_step``), and the single-rank paths on a mesh:
    ``kx``/``ki`` a KV block extract / inject of the padded ids (the
    leader joins the heads / broadcasts the payload by a collective the
    follower meets here), ``emb`` one embedding group, ``mrp`` a
    multimodal prefill chunk (the ``pp`` contract with the image mask;
    its ``[T, D]`` embeddings arrive by broadcast from the leader)."""
    engine.num_replayed[kind] = engine.num_replayed.get(kind, 0) + 1
    up = engine._upload
    if kind in ("w", "sw"):
        engine.cache, engine._ctl, _ = engine._ap_window_fn(
            engine.params, engine.cache, engine._ctl, engine._ap_rows_dev,
            bool(arrays["st"][0]), spec=kind == "sw")
    elif kind == "sph":
        engine._ctl = engine._spec_hist_fill_fn(
            engine._ctl, up(arrays["slots"]), up(arrays["hist"]))
    elif kind == "ctl":
        engine._ctl = engine._ap_delta_fn(engine._ctl, up(arrays["di"]),
                                          up(arrays["df"]))
    elif kind == "cols":
        engine._ap_cols = [int(x) for x in arrays["rows"]]
        engine._ap_rows_dev = engine._ap_window_fn.load_rows(engine._ap_cols)
    elif kind in ("pp", "rsp"):
        T, W = (int(x) for x in arrays["tw"])
        if kind == "pp":
            fn = engine._prefill_fn(T, W, False)
        elif engine._sp_prefill_fn is None:
            raise RuntimeError("an rsp plan reached an engine without "
                               "sp_prefill_threshold")
        else:
            fn = engine._sp_prefill_fn(T, W)
            engine.num_sp_prefills += 1
        engine.cache, _, _ = fn(
            engine.params, engine.cache, engine._ctl["last_tok"],
            up(arrays["pint"]), engine._next_key(), bool(arrays["st"][0]))
    elif kind == "mrp":
        T, W = (int(x) for x in arrays["tw"])
        emb = torch.zeros((T, engine.model_config.hidden_size),
                          dtype=torch.float32, device=engine.device)
        comm.broadcast(emb, engine._world_group, op="mm_deliver")
        engine.num_mm_prefills += 1
        engine.cache, _, _ = engine._prefill_fn(T, W, True)(
            engine.params, engine.cache, engine._ctl["last_tok"],
            up(arrays["pint"]), engine._next_key(), bool(arrays["st"][0]),
            emb)
    elif kind == "kx":
        engine._gather_blocks(arrays["ids"])
    elif kind == "ki":
        engine._scatter_blocks(
            arrays["ids"], engine._kv_payload_like(len(arrays["ids"])))
    elif kind == "emb":
        engine._encode_group(arrays["tokens"], arrays["positions"],
                             fetch=False)
    elif kind in ("p", "d"):
        # this stage's part of the GPipe step (its hops meet the
        # leader's); an engine without pp_stages refuses the plan
        engine.unified_step(arrays)
    else:
        raise ValueError(f"unknown plan kind {kind!r}")


async def follower_loop(runtime, engine, cfg: MultihostConfig, name: str,
                        component: str = "backend") -> None:
    """Connect to the leader's step stream, pass the barrier, replay plans
    until the stream closes or goes silent past the heartbeat deadline
    (leader death: exit so the supervisor restarts the group)."""
    client = await (runtime.namespace().component(component)
                    .endpoint("step_stream").client())
    await client.wait_for_instances(1, timeout_s=cfg.barrier_timeout_s)
    loop = asyncio.get_running_loop()
    stream = client.round_robin({"rank": cfg.rank}, Context()).__aiter__()
    replayed = 0
    while True:
        try:
            msg = await asyncio.wait_for(stream.__anext__(),
                                         timeout=cfg.heartbeat_timeout_s)
        except (StopAsyncIteration, EngineError) as e:
            # EOF, or the connection dropped: the leader exited or died
            log.warning("step stream ended after %d plans (%s) — leader "
                        "gone, exiting", replayed,
                        type(e).__name__)
            return
        except asyncio.TimeoutError:
            log.error("no plan or heartbeat for %.0fs after %d plans — "
                      "leader presumed dead, exiting",
                      cfg.heartbeat_timeout_s, replayed)
            return
        if msg.get("hb"):
            continue
        if msg.get("closed"):
            log.error("leader dropped this follower (wedged) — exiting")
            return
        if msg.get("hello"):
            await WorkerBarrier(
                f"multihost/{name}", f"rank-{cfg.rank}",
                timeout_s=cfg.barrier_timeout_s,
            ).sync(runtime.store, {"rank": cfg.rank})
            log.info("follower %d ready (barrier passed)", cfg.rank)
            continue
        kind, arrays = decode_plan(msg)
        await loop.run_in_executor(engine._step_executor(), replay_plan,
                                   engine, kind, arrays)
        replayed += 1
        if replayed == 1 or replayed % 1000 == 0:
            log.info("follower %d: %d plans replayed", cfg.rank, replayed)
