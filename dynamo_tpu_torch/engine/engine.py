"""The async inference engine: scheduler + step functions + token streaming.

Port of ``dynamo_tpu.engine.engine`` (role-equivalent to vLLM's ``AsyncLLM``
in the reference's workers, ref: components/backends/vllm/src/dynamo/vllm/
main.py:97). An asyncio step loop plans batches with the continuous-batching
scheduler, enqueues the PyTorch step functions on the device from one
dedicated executor thread (so the event loop never blocks on the device),
and streams sampled tokens into per-request queues. KV events are surfaced
in-process.

The loop is the JAX engine's: at ``pipeline_depth`` > 1 (the default, 2)
the run-ahead loop dispatches window N+1 while window N's tokens are still
on their way to the host — decode input tokens ride the device token ring,
so no dispatch waits on a fetch — and a fetch thread waits on each window's
CUDA event; at 1 the synchronous loop. On a card each decode window is a
CUDA graph replay (``model.AutopilotWindow``), and so is each packed
prefill chunk that ``model.prefill_graphed`` takes (``model.PrefillGraphs``:
one graph per prefill bucket and sampling mode, at the widest block table;
multimodal, sp and einsum-route chunks run eager). Speculative decoding
(``spec_mode="ngram"``) is the JAX engine's: it forces the synchronous loop
and replaces each decode window with a draft + verify window (a graph
replay too), with acceptance accounting, auto-disable and the pressure
ladder's rung-2 pause. The stall watchdog, the HBM-pressure ladder, the
flight recorder (``observability``) and the engine's stage spans are the
JAX engine's too, and so are its tuning and instruments: attention
autotune at construction (``engine/autotune.py``; ``attention_impl_choice``),
adaptive bucket ladders (``engine/ladder.py``; a new rung is a graph
captured at its first call) and the graph-capture watch
(``observability/compilewatch.py``) in the obs snapshot.

KV movement is the JAX engine's seams: disaggregated prefill/decode
(``prefill_held`` / ``reserve_sequence`` / ``resume_prefilled``, epoch-guarded
reservations), block extract/inject (``extract_kv_blocks`` /
``inject_kv_blocks``, on the device-step thread, so in stream order after
every window already enqueued; the inject writes the cache in place), the
KVBM tiers (``attach_kvbm``; offload ticks in both loops, onboarding at
admission), the radix prefix cache (``attach_prefix_cache``) and the
preemption coordinator's evacuation hooks (``evacuable_seats`` …
``finish_evacuated``).

Embeddings and multimodal prompts are the JAX engine's too: ``embed`` (the
encode-only step behind ``/v1/embeddings``, on the device-step thread) and
requests whose ``mm_*`` fields splice an encode worker's embeddings over
placeholder rows in the prefill chunks that hold them (an image may span
two chunks), with KV block hashes chained over the content-addressed
``mm_hash_token_ids``.

Tensor, expert and data parallelism (``mesh_shape=(dp, tp)``, one engine
per rank, ``parallel/multihost.py``), and parameter storage over fsdp
(``mesh_shape=(dp, fsdp, tp)``): each rank's engine holds its shard of
the params (its fsdp slices, gathered layer by layer as the steps run)
and of the cache (replicated over dp and fsdp); the leader's engine schedules
and hands every device call's host arrays to ``step_sink`` *before*
launching it (the JAX emission sites), and the followers' engines replay
them (``replay_plan``). Attention choices and launch parameters come from
the leader (autotune runs on rank 0 and is broadcast), and decode windows
run eager (no CUDA graphs on a mesh of more than one rank). With
``sp_prefill_threshold`` a fresh prompt at least that long is prefilled as
one sequence-parallel chunk (``rsp`` plans; ``engine/model.py``).

The single-rank paths run on such a mesh through the same plans, each
emitted on the device-step thread before the collective it leads to:
a KV extract (``kx``) gathers every rank's heads and joins them on the
leader over its tp row (a ``gather``, ``kv_gather``; the other tp rows,
replicas over dp and fsdp, join nothing), so the payload
that leaves the engine is the JAX one, every KV head in head order; an
inject (``ki``)
broadcasts the leader's full payload to every rank (``kv_deliver``),
which writes its head slice, every dp and fsdp replica alike (the cache
is replicated over both). The leader checks a reservation's epoch and the payload's
shapes and dtypes before it emits the ``ki`` plan, so a stale or
ill-fitting inject raises there and no follower enters a collective the
leader skips. KV bytes never ride the plan stream. Disagg,
the KVBM tiers, prefix demotion and preemption evacuation reach the cache
only through these two. ``embed`` emits one ``emb`` plan per (B, T)
group and every rank runs the group-aware encode step; a multimodal
prefill chunk emits ``mrp`` and the leader then broadcasts the chunk's
``[T, D]`` embeddings to every rank (``mm_deliver``), which splices them
as the leader does.

Pipeline parallelism (``pp_stages=S``, one engine per stage, each a rank
of a world of S, ``parallel/pp_serving.py``) is the JAX engine's pp
branch: the engine holds its stage's layers and their cache planes only,
runs the synchronous loop, and takes every prefill chunk and decode batch
through the GPipe-microbatched unified step (``unified_step``; the leader
emits ``p``/``d`` plans before each, the other stages replay them). It
builds no autopilot windows, control state, CUDA graphs, KV block ops or
ladders; KV transfer, preemption evacuation, the KVBM tiers and
multimodal prefill are refused with the JAX engine's messages. ``embed``
runs on the stages together (``emb`` plans; ``pp_serving``'s encode
step).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Any, AsyncIterator, Callable, Deque, Dict, List, Optional, Tuple,
)

import numpy as np
import torch

from .. import tracing
from ..parallel.layout import check_divisible, check_mesh_shape, make_mesh
from ..observability import compilewatch
from ..observability import flops as obs_flops
from ..observability import profiling
from ..observability.flops import FlopsModel
from ..parallel import comm
from ..observability.stepstats import (
    DECODE, PREFILL, SPEC_VERIFY, StepRecord, StepStats,
)
from ..runtime import faults
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..spec.stats import SpecDecodeStats
from ..tokens import TokenBlockSequence
from ..utils.config import env_flag, env_float, env_str
from ..utils.device import resolve_device
from ..utils.hotpath import hot_path
from ..utils.logging import TraceContext, get_logger
from . import model as model_lib
from . import quant
from .config import EngineConfig, ModelConfig, check_supported
from .scheduler import (
    KvEvent, PrefillChunk, SchedSeq, Scheduler, SchedulerStats, SeqStatus,
)

log = get_logger("engine")


@dataclass
class Request:
    """One generation request (preprocessed: token ids in)."""

    request_id: str
    token_ids: List[int]
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    eos_token_ids: Tuple[int, ...] = ()
    ignore_eos: bool = False
    # multimodal EPD: precomputed vision embeddings spliced over
    # placeholder prompt positions, plus the content-addressed ids used
    # for KV block hashing (never as model inputs) so the prefix cache
    # can't serve one image's KV for another
    mm_positions: Optional[List[int]] = None
    mm_embeddings: Optional[np.ndarray] = None   # [len(mm_positions), D]
    mm_hash_token_ids: Optional[List[int]] = None


@dataclass
class _Landing:
    """One dispatched window's sampled tokens on their way to the host: a
    flat int32 host tensor (pinned on a card) that a device→host copy
    fills, the CUDA event recorded after that copy (None on the CPU, where
    the copy is done when the dispatch returns), and how to unpack it."""

    n_prefill: int
    decode_shape: Optional[Tuple[int, int]]   # samples [K, B] or [k+3, B]
    cols: Optional[List[int]]                 # slot of each decode column
    host: Optional[torch.Tensor]
    event: Any = None
    spec: bool = False                        # a packed spec-window output
    stamps: Any = None                        # the batch's _LoopStamps


@dataclass
class _LoopStamps:
    """One scheduled batch's loop phases on the host's monotonic clock,
    stamped only while the tracer has a sink; ``_record_loop_spans`` makes
    them spans once the batch is post-processed. On a card the device gap
    before the batch comes from two timing CUDA events: the previous
    batch's landing event and one recorded before this batch's first
    enqueue."""

    t_schedule: float
    t_scheduled: float
    after_idle: bool          # the loop waited on _wake for work before it
    # (start, end, tokens, bucket, graphed) of each prefill chunk's enqueue
    prefills: List[Tuple[float, float, int, int, bool]] = field(
        default_factory=list)
    decode: Optional[Tuple[float, float]] = None
    t_enqueue: float = 0.0    # the batch's first enqueue
    gap_prev: Any = None      # the previous batch's landing event
    gap_start: Any = None     # recorded before this batch's first enqueue
    queued: bool = False      # gap_prev had not completed by then
    prev_prefill_tokens: int = 0
    t_ready: float = 0.0      # the wait on the landing returned

    def device_gap_ms(self) -> Optional[float]:
        """The device's idle time before this batch (0 when it was queued
        behind the previous one); None after an idle wait for work, for
        the first batch, or off a card. Read after the batch landed, when
        both events are complete: no host sync."""
        if self.after_idle or self.gap_prev is None or self.gap_start is None:
            return None
        if self.queued:
            return 0.0
        try:
            return max(0.0, self.gap_prev.elapsed_time(self.gap_start))
        except RuntimeError:   # an event of a window the watchdog dropped
            return None


@dataclass
class _StepParent:
    """What ``SpanCollector.record`` parents a child span under: the
    ``engine.step`` span's trace context."""

    trace: TraceContext


class _BatchingFetcher:
    """The JAX engine's ``_BatchingFetcher`` on the card's primitives: one
    thread drains a queue of (batch, landing, future), waits on each
    window's CUDA event (the copy to pinned memory was enqueued at
    dispatch, right after the window's last call), unpacks its tokens and
    resolves the future on the event loop. One wait per WINDOW keeps
    inter-token latency real: each window's tokens flush to the streams as
    that window lands. On the CPU a landing has no event: its tokens are
    already on the host, so it lands at submit."""

    def __init__(self, unpack, on_sync=None):
        self._q: Any = queue.Queue()
        self._unpack = unpack
        self._on_sync = on_sync   # () -> None, counts host syncs
        self._thread: Optional[threading.Thread] = None

    def ensure_started(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, args=(self._q,), daemon=True,
                name="device-fetch",
            )
            self._thread.start()

    def submit(self, loop, batch, landing: _Landing):
        fut = loop.create_future()
        if landing.event is None:
            res, exc = self._land(batch, landing)
            _fut_set(fut, res, exc)
            return fut
        self.ensure_started()
        self._q.put((loop, batch, landing, fut))
        return fut

    def stop(self) -> None:
        """End the thread after what is queued; a later submit starts a new
        one on a fresh queue (the engine can start again after stop)."""
        if self._thread is not None:
            self._q.put(None)
            self._q = queue.Queue()
            self._thread = None

    def _land(self, batch, landing: _Landing):
        try:
            if landing.event is not None:
                # THE designed host sync: one wait per window, on this
                # thread, off the dispatch path
                landing.event.synchronize()  # dynalint: disable=DT102
            if landing.stamps is not None:
                landing.stamps.t_ready = time.monotonic()
            if landing.host is not None and self._on_sync is not None:
                self._on_sync()
            return self._unpack(batch, landing), None
        except Exception as e:  # device fault surfacing at the sync
            return None, e

    def _run(self, q) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            loop, batch, landing, fut = item
            res, exc = self._land(batch, landing)
            try:
                loop.call_soon_threadsafe(_fut_set, fut, res, exc)
            except RuntimeError:
                # the loop closed under us (engine torn down mid-flight);
                # keep draining so the remaining futures get resolved
                pass


def _launching(fn, *args, **kwargs):
    with profiling.LAUNCH_GATE.launching():
        return fn(*args, **kwargs)


class _StepExecutor(concurrent.futures.ThreadPoolExecutor):
    """The device-step thread. Each task holds the profiler's launch gate,
    so ``/debug/profile`` never starts or stops the profiler while the
    engine launches (a stop deadlocked against a graph launch)."""

    def submit(self, fn, /, *args, **kwargs):
        return super().submit(_launching, fn, *args, **kwargs)


def _fut_set(fut, res, exc) -> None:
    if fut.cancelled():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(res)


@dataclass
class StepOutput:
    """One streamed generation step for a request."""

    request_id: str
    token_id: int
    index: int                 # 0-based output token index
    finished: bool = False
    finish_reason: Optional[str] = None
    num_prompt_tokens: int = 0


def _seed31(seed) -> int:
    """Map an arbitrary user seed into the int32-safe [0, 2^31) range the
    device tensors carry (-1 = unseeded)."""
    return -1 if seed is None else int(seed) & 0x7FFFFFFF


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    b = 1
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


class EngineCore(AsyncEngine):
    """Device-agnostic continuous-batching engine core.

    Owns the scheduler, the asyncio step loop, per-request streaming queues,
    KV-event surfacing, the stall watchdog and the HBM-pressure ladder.
    Subclasses provide the batch execution. ``generate`` accepts
    wire-format dict requests (token_ids + sampling options) and yields
    wire-format dict outputs.
    """

    def __init__(self, engine_config: EngineConfig):
        self.config = engine_config
        self.scheduler = Scheduler(engine_config, on_event=self._on_kv_event)
        self._queues: Dict[str, asyncio.Queue] = {}
        self._seqs: Dict[str, SchedSeq] = {}
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = False
        self._ids = itertools.count(1)
        self.kv_event_sink: Optional[Callable[[dict], None]] = None
        self._pending_events: List[dict] = []
        # disagg reservation epochs: seq_id -> epoch while the reservation
        # is live (reserve_sequence .. resume_prefilled/cancel_reservation).
        # Transfers stamped with an older epoch are rejected before write.
        self._kv_epoch = itertools.count(1)
        self._kv_reservations: Dict[str, int] = {}
        self.kvbm = None  # multi-tier block manager (attach_kvbm)
        self.prefix = None  # radix prefix cache (attach_prefix_cache)
        # tensor-parallel degree, pipeline stages and the world's ranks,
        # dp * tp * pp (InferenceEngine sets them from its config)
        self.tp = 1
        self.pp = 1
        self.world = 1
        # run-ahead depth: how many scheduled windows may be in flight
        # before the loop waits for a landing. 1 = classic synchronous
        # schedule→execute→postprocess; InferenceEngine takes the config's.
        self.pipeline_depth = 1
        # counters
        self.num_generated_tokens = 0
        self.num_steps = 0
        # host syncs (one wait per landed window)
        self.num_fetch_syncs = 0
        # flight recorder (observability.StepStats) when enabled;
        # InferenceEngine builds it
        self.obs = None
        # SpecDecodeStats when spec decode is active (InferenceEngine sets
        # it up when spec_mode="ngram")
        self.spec_stats = None
        # -- stall watchdog state (engine_config.stall_timeout_s > 0) --
        # per-seq recovery attempts; a seq over stall_seq_retries is failed
        # instead of requeued so one poisoned prompt can't loop forever
        self._stall_retries: Dict[str, int] = {}
        self._stall_streak = 0       # consecutive stalled landings
        self.num_stalls = 0
        self.stall_dead = False      # streak hit stall_dead_threshold
        # quarantined (kind, bucket) shape classes: dispatch planning routes
        # around them (next bucket up / einsum impl) after a stall
        self._shape_quarantine: set = set()
        # adaptive bucket ladders (engine/ladder.py), kind -> BucketLadder;
        # InferenceEngine builds them when enabled, {} keeps every bucketing
        # call on the static grid
        self._ladders: Dict[str, Any] = {}
        self._window_seq = itertools.count(1)  # fault key for engine.stall
        # -- HBM-pressure ladder state (pressure_*_threshold > 0) --
        self.pressure_level = 0          # 0 idle .. 3 shedding
        self.pressure_shedding = False   # rung 3: submit() rejects
        self._pressure_spec_paused = False  # rung 2: spec decode paused
        self._pressure_spec_saved = None    # spec_plan_window to restore
        self._pressure_spill_cool = 0    # min ticks between rung-1 spills
        self.num_pressure_spills = 0
        self.num_pressure_shed = 0
        self.pressure_peak = 0       # highest rung reached this lifetime
        # loop spans: whether the loop waited on _wake for work since the
        # last batch it scheduled (the next one gets no device-gap span)
        self._loop_idle = True

    # ------------------------- lifecycle -------------------------------

    async def start(self) -> None:
        """Start the step loop; after ``stop`` this starts it again (on
        the running event loop, which may be another than the first)."""
        if self._loop_task is None:
            self._stopped = False
            self._wake = asyncio.Event()
            self._loop_idle = True
            self._loop_task = asyncio.create_task(self._run_loop())

    async def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        # fail everything still queued/running so no submit() consumer hangs
        for seq in list(self._seqs.values()):
            if seq.status != SeqStatus.FINISHED:
                self.scheduler.abort(seq, "shutdown")
                self._emit_finish(seq, "shutdown")
        self._shutdown_executor()

    def _shutdown_executor(self) -> None:
        pass

    @property
    def stats(self) -> SchedulerStats:
        return self.scheduler.stats

    def clear_kv_blocks(self) -> None:
        """Drop the prefix cache (ref: http clear_kv_blocks endpoint)."""
        self.scheduler.pool.clear()

    def attach_prefix_cache(self, config=None, worker_id: int = 0,
                            plane=None):
        """Enable the radix-tree prefix index on this engine. Works with
        or without a KVBM (index-only mode still gives the scheduler-hit
        cross-check accounting); attach AFTER ``attach_kvbm`` so tier
        transitions (offload/G4/drop) are hooked too."""
        from ..prefix.manager import PrefixCacheManager

        self.prefix = PrefixCacheManager(
            self, kvbm=self.kvbm, config=config, worker_id=worker_id,
            plane=plane,
        )
        self.scheduler.on_prefix_match = self.prefix.on_scheduler_match
        return self.prefix

    # ------------------------- submission ------------------------------

    async def submit(self, request: Request) -> AsyncIterator[StepOutput]:
        """Submit a request; yields StepOutputs as tokens are generated."""
        await self.start()
        if self.pressure_shedding:
            # the loop only ticks the ladder while seats are live; if the
            # pool drained since the last pass, re-evaluate here so an idle
            # engine doesn't shed forever on a stale flag
            self._pressure_tick()
        if self.pressure_shedding:
            # rung 3 of the HBM-pressure ladder: refuse new admissions
            # while resident seats drain; the router retries elsewhere
            self.num_pressure_shed += 1
            raise RuntimeError(
                "admission shed: HBM pressure over pressure_shed_threshold"
            )
        if self.stall_dead:
            raise RuntimeError(
                "engine declared dead after repeated dispatch stalls"
            )
        if not request.token_ids:
            raise ValueError("empty prompt")
        if len(request.token_ids) >= self.config.max_model_len:
            raise ValueError(
                f"prompt length {len(request.token_ids)} exceeds "
                f"max_model_len {self.config.max_model_len}"
            )
        if request.mm_positions:
            # admission-time rejection fails only THIS request; a raise in
            # the step would abort every co-scheduled request (and, under
            # tensor parallelism, after parts of the batch reached the
            # followers)
            if self.pp > 1:
                raise ValueError(
                    "multimodal prefill unsupported on a pipeline-parallel "
                    "engine"
                )
            model_cfg = getattr(self, "model_config", None)
            if (model_cfg is not None and request.mm_embeddings is not None
                    and np.asarray(request.mm_embeddings).shape[-1]
                    != model_cfg.hidden_size):
                raise ValueError(
                    f"mm embedding width "
                    f"{np.asarray(request.mm_embeddings).shape[-1]} != "
                    f"model hidden size {model_cfg.hidden_size} — is the "
                    f"encode worker's --model-dim wrong?"
                )
        seq = SchedSeq(
            seq_id=request.request_id or f"seq-{next(self._ids)}",
            prompt_ids=list(request.token_ids),
            max_tokens=max(1, request.max_tokens),
            eos_token_ids=(frozenset() if request.ignore_eos
                           else frozenset(request.eos_token_ids)),
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            seed=_seed31(request.seed),
            mm_positions=(list(request.mm_positions)
                          if request.mm_positions else None),
            mm_embeddings=request.mm_embeddings,
        )
        if request.mm_positions:
            # content-addressed KV hashing: block hashes chain over ids
            # that fold in the image content, so the prefix cache can't
            # serve one image's KV for a prompt carrying another; built
            # here, so the scheduler does not build one from prompt_ids
            hash_ids = request.mm_hash_token_ids
            if hash_ids is None or len(hash_ids) != len(request.token_ids):
                raise ValueError(
                    "multimodal requests need mm_hash_token_ids aligned "
                    "with token_ids"
                )
            if (request.mm_embeddings is None
                    or len(request.mm_embeddings)
                    != len(request.mm_positions)):
                raise ValueError(
                    "mm_embeddings rows must match mm_positions"
                )
            seq.token_seq = TokenBlockSequence.from_tokens(
                list(hash_ids), self.config.block_size
            )
        if self.kvbm is not None or self.prefix is not None:
            # promote host-tier prefix blocks into G1 before admission so
            # the scheduler's prefix match serves them as native hits;
            # the token sequence is built once here and reused by the
            # scheduler (hash-chaining the prompt is O(prompt_len))
            if seq.token_seq is None:  # mm requests pre-built theirs
                seq.token_seq = TokenBlockSequence.from_tokens(
                    seq.prompt_ids, self.config.block_size
                )
            try:
                if self.prefix is not None:
                    # peer-G1 device-plane pull, then the KVBM tier chain
                    await self.prefix.onboard(seq.token_seq)
                else:
                    await self.kvbm.onboard_prefix(seq.token_seq)
            except Exception:
                log.exception("kvbm onboard failed — prefilling from scratch")
        out_queue: asyncio.Queue = asyncio.Queue()
        self._queues[seq.seq_id] = out_queue
        self._seqs[seq.seq_id] = seq
        self.scheduler.add(seq)
        self._wake.set()
        try:
            while True:
                out = await out_queue.get()
                yield out
                if out.finished:
                    return
        finally:
            self._drop(seq)

    def _ap_mark_dead(self, slot: int) -> None:
        """Autopilot hook (overridden by the device engine): a seat whose
        seq finished must be killed on device before its blocks recycle."""

    def abort(self, seq_id: str, reason: str = "cancelled") -> None:
        seq = self._seqs.get(seq_id)
        if seq is not None and seq.status != SeqStatus.FINISHED:
            self._ap_mark_dead(seq.slot)
            self.scheduler.abort(seq, reason)
            self._emit_finish(seq, reason)

    # --------------- disaggregated prefill/decode hooks ----------------
    # (ref: the decode/prefill handler split in components/backends/vllm/
    #  src/dynamo/vllm/handlers.py:89,207 — here the engine itself exposes
    #  the hold/reserve/resume seams the reference gets from vLLM's
    #  kv_transfer connector)

    async def prefill_held(self, request: Request):
        """Prefill-worker side: run the prompt to its first token, keeping
        the KV blocks alive for extraction. Returns (seq, first_token);
        caller must ``release_held(seq)`` after extracting."""
        await self.start()
        if not request.token_ids:
            raise ValueError("empty prompt")
        seq = SchedSeq(
            seq_id=request.request_id or f"seq-{next(self._ids)}",
            prompt_ids=list(request.token_ids),
            max_tokens=1,
            eos_token_ids=frozenset(),
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            seed=_seed31(request.seed),
            hold_blocks=True,
        )
        out_queue: asyncio.Queue = asyncio.Queue()
        self._queues[seq.seq_id] = out_queue
        self._seqs[seq.seq_id] = seq
        self.scheduler.add(seq)
        self._wake.set()
        try:
            out = await out_queue.get()
        except asyncio.CancelledError:
            # Hard-cancelled mid-prefill (queue worker killed, caller
            # torn down): the held handle never reaches the caller, so
            # nobody can release_held — drop the hold ourselves. With
            # hold_blocks cleared, _finish/reap free the blocks the
            # moment no in-flight window can still scatter into them.
            seq.hold_blocks = False
            if seq.status == SeqStatus.FINISHED:
                if (seq.pending_total == 0
                        and seq not in self.scheduler.zombies):
                    self.scheduler.release_held(seq)
            else:
                self.abort(seq.seq_id, "cancelled")
            self._queues.pop(seq.seq_id, None)
            self._seqs.pop(seq.seq_id, None)
            raise
        if out.finish_reason not in ("length", "stop"):
            self.release_held(seq)
            raise RuntimeError(
                f"remote prefill failed: {out.finish_reason}"
            )
        return seq, out.token_id

    def release_held(self, seq: SchedSeq) -> None:
        self.scheduler.release_held(seq)
        self._queues.pop(seq.seq_id, None)
        self._seqs.pop(seq.seq_id, None)

    def reserve_sequence(self, request: Request) -> Optional[SchedSeq]:
        """Decode-worker side: pre-allocate prompt blocks for KV injection.
        Returns None when the pool can't host the prompt right now (caller
        falls back to local prefill)."""
        seq = SchedSeq(
            seq_id=request.request_id or f"seq-{next(self._ids)}",
            prompt_ids=list(request.token_ids),
            max_tokens=max(1, request.max_tokens),
            eos_token_ids=(frozenset() if request.ignore_eos
                           else frozenset(request.eos_token_ids)),
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            seed=_seed31(request.seed),
        )
        if not self.scheduler.reserve(seq):
            return None
        # epoch-guard the reservation: any transfer targeting these blocks
        # must present this epoch, so a delayed write aimed at a recycled
        # reservation (same seq id, new blocks) is rejected, not scattered
        seq.kv_epoch = next(self._kv_epoch)
        self._kv_reservations[seq.seq_id] = seq.kv_epoch
        self._queues[seq.seq_id] = asyncio.Queue()
        self._seqs[seq.seq_id] = seq
        return seq

    def cancel_reservation(self, seq: SchedSeq) -> None:
        self._kv_reservations.pop(seq.seq_id, None)
        self.scheduler.release_held(seq)  # reserved blocks, same release
        self._queues.pop(seq.seq_id, None)
        self._seqs.pop(seq.seq_id, None)

    def reservation_valid(self, seq_id: str, epoch: int) -> bool:
        """True while ``seq_id``'s reservation is live *and* carries
        ``epoch``. Both the device-plane scatter and the wire-relay inject
        check this immediately before writing; it also tells the orphan
        sweeper a reservation is still safe to cancel."""
        return self._kv_reservations.get(seq_id) == epoch

    async def resume_prefilled(
        self, seq: SchedSeq, first_token: int
    ) -> AsyncIterator[StepOutput]:
        """Decode-worker side: activate a reserved sequence whose KV was
        injected; streams from the remotely-sampled first token onward.
        Its first decode row has no token in flight on the device
        (``tok_src`` 0), so the window takes ``first_token`` from the
        host as its input."""
        await self.start()
        # the reservation window closes here: late transfers must not write
        # into a sequence that is actively decoding
        self._kv_reservations.pop(seq.seq_id, None)
        self.scheduler.admit_prefilled(seq, first_token)
        self._emit_token(seq)
        self._wake.set()
        out_queue = self._queues[seq.seq_id]
        try:
            while True:
                out = await out_queue.get()
                yield out
                if out.finished:
                    return
        finally:
            self._drop(seq)

    def _drop(self, seq: SchedSeq) -> None:
        if seq.status != SeqStatus.FINISHED:
            self.scheduler.abort(seq, "cancelled")
        self._queues.pop(seq.seq_id, None)
        self._seqs.pop(seq.seq_id, None)

    # --------------------- AsyncEngine (wire) --------------------------

    async def generate(self, request: Any,
                       context: Context) -> AsyncIterator[dict]:
        """Wire-format adapter: dict in, dict stream out. A multimodal
        request's ``mm`` field ({positions, embeddings as a wire array,
        hash_token_ids}) rides into the :class:`Request`."""
        mm = request.get("mm") or {}
        mm_embeddings = None
        if mm:
            from ..multimodal.wire import array_from_wire

            mm_embeddings = array_from_wire(mm["embeddings"])
        req = Request(
            request_id=context.id,
            token_ids=list(request["token_ids"]),
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0) or 1.0),
            seed=request.get("seed"),
            eos_token_ids=tuple(request.get("eos_token_ids", ())),
            ignore_eos=bool(request.get("ignore_eos", False)),
            mm_positions=(list(mm["positions"]) if mm else None),
            mm_embeddings=mm_embeddings,
            mm_hash_token_ids=(list(mm["hash_token_ids"]) if mm else None),
        )

        async def _on_stop() -> None:
            await context.wait_stopped()
            self.abort(req.request_id,
                       "killed" if context.is_killed() else "cancelled")

        watcher = asyncio.create_task(_on_stop())
        t_submit = time.monotonic()
        seq_ref: Optional[SchedSeq] = None
        try:
            async for out in self.submit(req):
                if seq_ref is None:
                    # grab the scheduler-side state before _drop can pop it;
                    # its t_scheduled/t_first_token stamps feed the spans
                    seq_ref = self._seqs.get(req.request_id)
                if context.is_killed():
                    return
                yield {
                    "token_ids": [out.token_id],
                    "index": out.index,
                    "finished": out.finished,
                    "finish_reason": out.finish_reason,
                    "num_prompt_tokens": out.num_prompt_tokens,
                }
                if out.finished:
                    return
        finally:
            watcher.cancel()
            self._record_stage_spans(context, t_submit, seq_ref)

    def _record_stage_spans(
        self, context: Context, t_submit: float, seq: Optional[SchedSeq]
    ) -> None:
        """Attribute engine time to worker.queue / engine.prefill /
        engine.decode spans from the scheduler's monotonic stamps. Recorded
        after the fact (no live span objects in the step loop) so the
        per-token hot path carries zero tracing overhead."""
        tracer = tracing.get_tracer()
        end = time.monotonic()
        t_sched = seq.t_scheduled if seq is not None else None
        t_first = seq.t_first_token if seq is not None else None
        tracer.record("worker.queue", context,
                      start_mono=t_submit, end_mono=(t_sched or end))
        if t_sched is not None:
            tracer.record("engine.prefill", context,
                          start_mono=t_sched, end_mono=(t_first or end))
        if t_first is not None:
            attrs = {"num_tokens": len(seq.output_ids)}
            if self.spec_stats is not None:
                attrs["spec_drafted"] = seq.spec_drafted
                attrs["spec_accepted"] = seq.spec_accepted
            tracer.record("engine.decode", context, start_mono=t_first,
                          end_mono=end, attrs=attrs)

    def _record_loop_spans(self, batch, t_taken: float) -> None:
        """One batch's loop spans, from the stamps it carries: a trace of
        its own under ``engine.step``, kept out of the collector's ring.
        ``t_taken``: the loop took the landing up (postprocess starts)."""
        st = batch.loop_stamps
        tracer = tracing.get_tracer()
        end = time.monotonic()
        step = TraceContext.new()
        parent = _StepParent(step)

        def child(name, t0, t1, attrs=None):
            tracer.record(name, parent, start_mono=t0, end_mono=t1,
                          attrs=attrs, buffered=False)

        child("engine.schedule", st.t_schedule, st.t_scheduled)
        gap = st.device_gap_ms()
        if gap is not None:
            child("engine.device_gap", st.t_enqueue - gap / 1e3, st.t_enqueue,
                  {"prev_prefill_tokens": st.prev_prefill_tokens})
        for t0, t1, tokens, bucket, graphed in st.prefills:
            child("engine.enqueue_prefill", t0, t1,
                  {"tokens": tokens, "bucket": bucket, "graphed": graphed})
        if st.decode is not None:
            child("engine.enqueue_decode", *st.decode)
        if st.t_ready:
            child("engine.land", st.t_ready, t_taken)
        child("engine.postprocess", t_taken, end)
        tracer.record("engine.step", trace=step, start_mono=st.t_schedule,
                      end_mono=end, buffered=False, attrs={
                          "live_rows": len(batch.decode_rows),
                          "prefill_tokens": sum(c.length
                                                for c in batch.prefills)})

    # --------------------- flight recorder surface ---------------------

    def obs_snapshot(self) -> dict:
        """One merged dict of live recorder gauges (stepstats window), the
        graph-capture watch's counters and the watchdog's and the ladders'
        counters; {} when the recorder is disabled."""
        if self.obs is None:
            return {}
        snap = self.obs.snapshot()
        snap.update(compilewatch.snapshot())
        snap["stalls_total"] = self.num_stalls
        snap["stall_dead"] = int(self.stall_dead)
        snap["stall_quarantined_shapes"] = len(self._shape_quarantine)
        snap["pressure_level"] = self.pressure_level
        snap["pressure_peak"] = self.pressure_peak
        snap["pressure_spills_total"] = self.num_pressure_spills
        snap["pressure_shed_total"] = self.num_pressure_shed
        # adaptive bucket ladders: scalar gauges by the exact keys
        # observability.gauges reads; the rungs tuple is non-scalar and
        # stays off the wire dict
        for kind, lad in self._ladders.items():
            ls = lad.snapshot()
            snap[f"ladder_{kind}_rungs"] = ls["rungs"]
            snap[f"ladder_{kind}_rungs_n"] = len(ls["rungs"])
            snap[f"ladder_{kind}_splits_total"] = ls["splits_total"]
            snap[f"ladder_{kind}_retires_total"] = ls["retires_total"]
            snap[f"ladder_{kind}_budget_remaining"] = ls["budget_remaining"]
            snap[f"ladder_{kind}_converged"] = int(ls["converged"])
        return snap

    def mark_obs_warmup_done(self) -> None:
        """Drop warmup steps from the recorder's window and arm the
        steady-state graph-capture watch. Call after warmup traffic has
        drained."""
        if self.obs is not None:
            self.obs.mark_warmup_done()
            compilewatch.mark_warmup_done()

    # ------------------------- step loop -------------------------------

    async def _execute_batch_async(self, batch) -> Tuple[List[int],
                                                          List[List[int]]]:
        """Execute one scheduled batch; returns (prefill, decode) samples."""
        raise NotImplementedError

    async def _run_loop(self) -> None:
        if self.pipeline_depth > 1:
            await self._run_loop_pipelined()
        else:
            await self._run_loop_sync()

    async def _run_loop_pipelined(self) -> None:
        """Run-ahead loop: schedule and dispatch window N+1 while window N
        is still computing/fetching. Decode input tokens ride the device
        token ring, so no dispatch ever waits on a host fetch; sampled
        tokens are observed one-plus windows behind for emission and stop
        checks. Landings are applied strictly in dispatch order."""
        inflight: Deque[Tuple[Any, Any]] = deque()

        async def land_next() -> None:
            batch0, fut = inflight.popleft()
            try:
                results = await asyncio.wait_for(
                    self._landing(batch0, fut), self._stall_deadline(batch0)
                )
            except asyncio.TimeoutError:
                # the head landing blew its deadline: every younger window
                # reads the wedged window's ring state, so the whole
                # run-ahead pipeline is cancelled and recovered together
                wedged = [batch0]
                self._swallow_future(fut)
                while inflight:
                    b, f = inflight.popleft()
                    wedged.append(b)
                    self._swallow_future(f)
                self._on_stall(wedged)
                return
            except Exception:
                log.exception("window failed; aborting its seqs")
                self._abort_batch(batch0)
                return
            self._stall_streak = 0
            self._apply_landing(batch0, results)

        while not self._stopped:
            while inflight and inflight[0][1].done():
                await land_next()
            batch = self._schedule()
            if batch.is_empty:
                if inflight:
                    await land_next()
                    continue
                if self.scheduler.waiting and not self.scheduler.running:
                    seq = self.scheduler.waiting[0]
                    log.error("seq %s cannot fit in KV pool — failing",
                              seq.seq_id)
                    self.scheduler.abort(seq, "error")
                    self._emit_finish(seq, "error")
                    continue
                self._wake.clear()
                await self._kvbm_idle_drain()
                if self._stopped:
                    break
                self._loop_idle = True
                await self._wake.wait()
                continue
            self._arm_stall_fault(batch)
            try:
                fut = await self._dispatch_batch_async(batch)
            except Exception:
                log.exception("dispatch failed; aborting scheduled seqs")
                self._abort_batch(batch)
                continue
            inflight.append((batch, fut))
            while len(inflight) >= self.pipeline_depth:
                await land_next()
            await self._kvbm_tick()
        while inflight:  # drain so stop() leaves consistent bookkeeping
            await land_next()

    async def _run_loop_sync(self) -> None:
        """The synchronous loop: schedule → execute → postprocess."""
        while not self._stopped:
            batch = self._schedule()
            if batch.is_empty:
                # a waiting request that can never fit (pool smaller than its
                # prompt) would hang forever — fail it rather than deadlock
                if self.scheduler.waiting and not self.scheduler.running:
                    seq = self.scheduler.waiting[0]
                    log.error("seq %s cannot fit in KV pool — failing",
                              seq.seq_id)
                    self.scheduler.abort(seq, "error")
                    self._emit_finish(seq, "error")
                    continue
                # clear BEFORE the kvbm drain: a submit() arriving during the
                # drain's awaits sets _wake, which must survive to the wait()
                self._wake.clear()
                await self._kvbm_idle_drain()
                if self._stopped:
                    return
                self._loop_idle = True
                await self._wake.wait()
                continue
            self._arm_stall_fault(batch)
            inner = asyncio.ensure_future(self._execute_batch_async(batch))
            try:
                results = await asyncio.wait_for(
                    self._landing(batch, inner), self._stall_deadline(batch)
                )
            except asyncio.TimeoutError:
                self._swallow_future(inner)
                self._on_stall([batch])
                continue
            except Exception:
                log.exception("engine step failed; aborting scheduled seqs")
                self._abort_batch(batch)
                continue
            self._stall_streak = 0
            self._apply_landing(batch, results)
            await self._kvbm_tick()

    def _schedule(self):
        """One schedule pass: the pressure ladder's tick, the scheduler,
        the preempted seats' kills. While the tracer has a sink (read on
        every pass: a sink may come or go at any time) a batch carries the
        stamps of its loop phases."""
        traced = tracing.get_tracer().active
        t0 = time.monotonic() if traced else 0.0
        self._pressure_tick()
        batch = self.scheduler.schedule()
        self._mark_preempted_seats(batch)
        if not batch.is_empty:
            if traced:
                batch.loop_stamps = _LoopStamps(t0, time.monotonic(),
                                                self._loop_idle)
            self._loop_idle = False
        return batch

    def _apply_landing(self, batch, results) -> None:
        """Post-process a landed batch and flush its KV events, then record
        its loop spans if it carries stamps."""
        t_taken = time.monotonic() if batch.loop_stamps is not None else 0.0
        try:
            self._postprocess(batch, results)
        except Exception:
            # bookkeeping must never kill the step loop — every queued
            # request would hang forever
            log.exception("postprocess failed")
        self._flush_kv_events()
        if batch.loop_stamps is not None:
            self._record_loop_spans(batch, t_taken)

    async def _kvbm_tick(self) -> None:
        """One batched offload of sealed blocks to the host tier, between
        windows (its gather is enqueued on the device-step thread behind
        every window already dispatched)."""
        if self.kvbm is not None:
            try:
                await self.kvbm.tick()
            except Exception:
                log.exception("kvbm offload tick failed")

    async def _kvbm_idle_drain(self) -> None:
        """Going idle: drain the offload backlog until work arrives."""
        if self.kvbm is not None:
            try:
                while not self._wake.is_set() and await self.kvbm.tick():
                    pass
            except Exception:
                log.exception("kvbm idle drain failed")

    def _abort_batch(self, batch) -> None:
        """Fail every seq a batch touches and clear the pendings it
        registered. Seats are marked dead BEFORE the abort releases blocks —
        otherwise the device autopilot keeps scattering into recycled
        blocks."""
        for chunk in batch.prefills:
            seq = chunk.seq
            self.scheduler.on_tokens_discarded(
                seq, 0, first=chunk.final, prompt=chunk.length
            )
            if seq.status != SeqStatus.FINISHED:
                self._ap_mark_dead(seq.slot)
                self.scheduler.abort(seq, "error")
                self._emit_finish(seq, "error")
        for row in batch.decode_rows:
            seq = row.seq
            self.scheduler.on_tokens_discarded(seq, row.accepted)
            if seq.status != SeqStatus.FINISHED:
                self._ap_mark_dead(row.slot)
                self.scheduler.abort(seq, "error")
                self._emit_finish(seq, "error")

    async def _dispatch_batch_async(self, batch):
        """Enqueue the batch's device work; resolve to a future of fetched
        results. Overridden by the device engine; the base class executes
        synchronously."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        try:
            fut.set_result(await self._execute_batch_async(batch))
        except Exception as e:  # pragma: no cover
            fut.set_exception(e)
        return fut

    def _mark_preempted_seats(self, batch) -> None:
        """A preempted seq's blocks were just released — its device seat
        must die before they recycle, even if this batch is otherwise
        empty (the kill rides the next dispatch, which in stream order
        precedes any reuse)."""
        for seq in batch.preempted:
            if seq.preempted_slot >= 0:
                self._ap_mark_dead(seq.preempted_slot)
                seq.preempted_slot = -1

    # ----------------------- stall watchdog ----------------------------
    # A wedged device dispatch (a hung kernel, a driver hang) would
    # otherwise freeze the loop forever: every queued request hangs and the
    # worker looks alive to the router. The watchdog bounds each landing by
    # a deadline scaled to the window's token count, cancels the wedged
    # window, quarantines the shape class that wedged, and replays the
    # touched seats from their journal (prompt + emitted tokens) — bounded
    # retries per seat, bounded streak per worker.

    def _stall_deadline(self, batch) -> Optional[float]:
        """Deadline for one landing; None disables (stall_timeout_s <= 0).
        Scales with scheduled work so big prefill windows aren't false
        positives at the same setting that catches a wedged decode."""
        base = self.config.stall_timeout_s
        if base <= 0:
            return None
        n = sum(c.length for c in batch.prefills)
        n += sum(r.accepted for r in batch.decode_rows)
        return base + self.config.stall_timeout_per_token_s * n

    def _arm_stall_fault(self, batch) -> None:
        """Fault-registry seam: a ``delay`` rule on ``engine.stall`` wedges
        this window's landing for delay_s, as a hung device dispatch would.
        The key leads with the window kind (``decode``/``prefill``/``mixed``)
        so a rule can pin the wedge to a window class."""
        if batch.prefills:
            kind = "mixed" if batch.decode_rows else "prefill"
        else:
            kind = "decode"
        rule = faults.active(
            "engine.stall", f"{kind}:{next(self._window_seq)}")
        if rule is not None and rule.kind == faults.DELAY:
            batch.stall_inject_s = rule.delay_s

    async def _landing(self, batch, fut):
        inject = getattr(batch, "stall_inject_s", 0.0)
        if inject:
            await asyncio.sleep(inject)  # seeded engine.stall wedge
        return await fut

    @staticmethod
    def _swallow_future(fut) -> None:
        """Detach from a wedged future: request cancellation and retrieve
        any late exception so abandoned windows never log
        'exception was never retrieved'."""
        fut.cancel()
        fut.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None
        )

    def _shape_bucket(self, kind: str, n: int) -> int:
        """Bucket used for stall attribution; the device engine maps
        through its dispatch buckets."""
        return n

    def _quarantine_shape(self, cls) -> None:
        if cls not in self._shape_quarantine:
            self._shape_quarantine.add(cls)
            log.warning(
                "stall watchdog: quarantined shape class %s:%s", *cls
            )

    def _batch_shape_classes(self, batch) -> set:
        classes = set()
        for chunk in batch.prefills:
            classes.add(
                ("prefill", self._shape_bucket("prefill", chunk.length))
            )
        if batch.decode_rows:
            classes.add(
                ("decode", self._shape_bucket("decode",
                                              len(batch.decode_rows)))
            )
        return classes

    def _last_graph_key(self) -> str:
        """The key of the last program built for the device (the device
        engine's last captured decode graph)."""
        return ""

    def _on_stall(self, batches) -> None:
        """A landing blew its deadline. Attribute the wedge to the head
        window's shape classes (cross-checked against the last captured
        graph's key in the log line), quarantine them, recover every
        touched seat, and track the streak toward declaring the worker
        dead."""
        self.num_stalls += 1
        self._stall_streak += 1
        classes = self._batch_shape_classes(batches[0])
        log.error(
            "dispatch stall: landing blew its deadline (shape classes %s, "
            "last graph %r, streak %d/%d)",
            sorted(classes), self._last_graph_key(), self._stall_streak,
            self.config.stall_dead_threshold,
        )
        for cls in classes:
            self._quarantine_shape(cls)
        self._recover_batches(batches)
        if self._stall_streak >= self.config.stall_dead_threshold:
            self.stall_dead = True
            log.error(
                "stall streak hit %d — declaring worker dead",
                self._stall_streak,
            )
            for seq in list(self._seqs.values()):
                if seq.status != SeqStatus.FINISHED:
                    self._ap_mark_dead(seq.slot)
                    self.scheduler.abort(seq, "error")
                    self._emit_finish(seq, "error")

    def _recover_batches(self, batches) -> None:
        """Cancel wedged windows: discard every pending they registered
        (mirroring _abort_batch), then requeue each touched live seat for
        journal replay — a recompute preemption whose 'journal' is the
        seq's own prompt + emitted tokens, giving byte-identical resumption
        under the seq's seed. Seats over stall_seq_retries fail instead."""
        touched: Dict[str, SchedSeq] = {}
        for batch in batches:
            for chunk in batch.prefills:
                self.scheduler.on_tokens_discarded(
                    chunk.seq, 0, first=chunk.final, prompt=chunk.length
                )
                touched[chunk.seq.seq_id] = chunk.seq
            for row in batch.decode_rows:
                self.scheduler.on_tokens_discarded(row.seq, row.accepted)
                touched[row.seq.seq_id] = row.seq
        for seq in touched.values():
            if seq.status == SeqStatus.FINISHED or seq.pending_total != 0:
                continue
            retries = self._stall_retries.get(seq.seq_id, 0) + 1
            self._stall_retries[seq.seq_id] = retries
            if retries > self.config.stall_seq_retries:
                self._ap_mark_dead(seq.slot)
                self.scheduler.abort(seq, "error")
                self._emit_finish(seq, "error")
                continue
            if seq.status is SeqStatus.WAITING:
                continue  # never held blocks — already queued for replay
            slot = self.scheduler.preempt_recompute(seq)
            self._ap_mark_dead(slot)

    # ---------------------- HBM-pressure ladder ------------------------

    def _pressure_tick(self) -> None:
        """Graduated response to KV-pool pressure, one check per loop pass:
        rung 1 spills the coldest seat (recompute preemption — its sealed
        blocks stay evictable in the prefix cache), rung 2 pauses
        speculative decoding, rung 3 sheds new admissions. Rungs release
        with pressure_release hysteresis so the ladder doesn't flap at a
        threshold."""
        cfg = self.config
        spill_t = cfg.pressure_spill_threshold
        spec_t = cfg.pressure_spec_threshold
        shed_t = cfg.pressure_shed_threshold
        if spill_t <= 0 and spec_t <= 0 and shed_t <= 0:
            return
        usage = self.scheduler.pool.usage
        release = cfg.pressure_release
        if shed_t > 0:
            if not self.pressure_shedding and usage >= shed_t:
                self.pressure_shedding = True
                log.warning(
                    "pressure ladder: shedding admissions "
                    "(pool usage %.2f >= %.2f)", usage, shed_t,
                )
            elif self.pressure_shedding and usage < shed_t - release:
                self.pressure_shedding = False
                log.info(
                    "pressure ladder: admissions reopened (pool usage %.2f)",
                    usage,
                )
        if spec_t > 0:
            if not self._pressure_spec_paused and usage >= spec_t:
                self._pressure_spec_paused = True
                self._pause_spec()
            elif self._pressure_spec_paused and usage < spec_t - release:
                self._pressure_spec_paused = False
                self._resume_spec()
        if self._pressure_spill_cool > 0:
            self._pressure_spill_cool -= 1
        if (spill_t > 0 and usage >= spill_t
                and self._pressure_spill_cool == 0):
            victim = self.scheduler._pick_victim(None)
            if victim is not None and victim.pending_total == 0:
                slot = self.scheduler.preempt_recompute(victim)
                self._ap_mark_dead(slot)
                self.num_pressure_spills += 1
                # cooldown bounds churn: the spilled seat re-prefills
                # (mostly prefix hits) before another spill is considered
                self._pressure_spill_cool = 4
                log.info(
                    "pressure ladder: spilled seq %s (pool usage %.2f)",
                    victim.seq_id, usage,
                )
        self.pressure_level = (
            3 if self.pressure_shedding
            else 2 if self._pressure_spec_paused
            else 1 if (spill_t > 0 and usage >= spill_t)
            else 0
        )
        if self.pressure_level > self.pressure_peak:
            self.pressure_peak = self.pressure_level

    def _pause_spec(self) -> None:
        """Rung 2 hook; the device engine narrows the spec plan window."""

    def _resume_spec(self) -> None:
        pass

    # --------------------- preemption / evacuation ---------------------
    # (runtime.preemption drives these: park a decoding seat, wait for its
    #  inflight windows to land, stream its KV to a peer, finish it here)

    def evacuable_seats(self) -> List[SchedSeq]:
        """Decoding seats whose KV is worth moving (prefill complete).
        PREFILL/WAITING seats are cheaper to re-prefill at the destination
        than to stream mid-build. A pipeline-parallel engine lists them
        too, as the JAX engine does: the coordinator journals them, and
        the transfer it then tries refuses (``extract_kv_blocks``), so
        each seat ends as a fallback."""
        return [s for s in self.scheduler.running
                if s.status is SeqStatus.RUNNING and s.prefill_done]

    def park_for_evacuation(self, seq_id: str) -> Optional[SchedSeq]:
        """Freeze a seat for KV evacuation: the scheduler plans no new
        windows for it and never picks it as a recompute victim, so its
        blocks stay byte-stable while the transfer reads them."""
        seq = self._seqs.get(seq_id)
        if seq is None or seq.status is not SeqStatus.RUNNING:
            return None
        seq.status = SeqStatus.EVACUATING
        return seq

    def unpark(self, seq: SchedSeq) -> None:
        """Abort an evacuation: the seat resumes decoding locally."""
        if seq.status is SeqStatus.EVACUATING:
            seq.status = SeqStatus.RUNNING
            self._wake.set()

    async def wait_quiesced(
        self, seq: SchedSeq, timeout_s: float = 10.0
    ) -> bool:
        """Wait until none of the seat's tokens are in an inflight window —
        only then is its KV byte-stable and safe to read."""
        deadline = time.monotonic() + timeout_s
        while seq.pending_total > 0:
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(0.005)
        return True

    def finish_evacuated(self, seq: SchedSeq) -> None:
        """The seat now lives on the receiving worker: kill the device seat
        and close the local stream with finish_reason ``evacuated``."""
        if seq.status is SeqStatus.FINISHED:
            return
        self._ap_mark_dead(seq.slot)
        self.scheduler.abort(seq, "evacuated")
        self._emit_finish(seq, "evacuated")

    def _postprocess(self, batch, results) -> None:
        """Apply step results. Decode samples are per-seq token WINDOWS
        (length >= 1); tokens after a mid-window finish are discarded (and
        their speculative pendings cleared so zombie seqs get reaped)."""
        prefill_samples, decode_samples = results
        self.num_steps += 1
        for chunk, sampled in zip(batch.prefills, prefill_samples):
            seq = chunk.seq
            if seq.status == SeqStatus.FINISHED:
                # aborted while the chunk was in flight
                self.scheduler.on_tokens_discarded(
                    seq, 0, first=chunk.final, prompt=chunk.length
                )
                continue
            self.scheduler.on_prefill_executed(
                chunk, sampled if chunk.final else None
            )
            if chunk.final:
                self._emit_token(seq)
        for i, row in enumerate(batch.decode_rows):
            seq = row.seq
            window = decode_samples[i]
            applied = 0
            for tok in window[:row.accepted]:
                if seq.status == SeqStatus.FINISHED:
                    break  # aborted / stopped mid-window
                self.scheduler.on_decode_executed(seq, tok)
                applied += 1
                self._emit_token(seq)
            if applied < row.accepted:
                self.scheduler.on_tokens_discarded(
                    seq, row.accepted - applied
                )
            if seq.status == SeqStatus.FINISHED:
                self._ap_mark_dead(row.slot)

    def _emit_token(self, seq: SchedSeq) -> None:
        self.num_generated_tokens += 1
        if seq.t_first_token is None:
            seq.t_first_token = time.monotonic()
        reason = self.scheduler.check_stop(seq)
        out = StepOutput(
            request_id=seq.seq_id,
            token_id=seq.output_ids[-1],
            index=len(seq.output_ids) - 1,
            finished=reason is not None,
            finish_reason=reason,
            num_prompt_tokens=seq.prompt_len,
        )
        if reason is not None:
            self.scheduler.finish(seq, reason)
        q = self._queues.get(seq.seq_id)
        if q is not None:
            q.put_nowait(out)

    def _emit_finish(self, seq: SchedSeq, reason: str) -> None:
        q = self._queues.get(seq.seq_id)
        if q is not None:
            q.put_nowait(StepOutput(
                request_id=seq.seq_id,
                token_id=seq.output_ids[-1] if seq.output_ids else -1,
                index=max(0, len(seq.output_ids) - 1),
                finished=True,
                finish_reason=reason,
                num_prompt_tokens=seq.prompt_len,
            ))

    # ------------------------- kv events -------------------------------

    def _on_kv_event(self, event: KvEvent) -> None:
        self._pending_events.append(event.to_dict())
        if len(self._pending_events) > 10000:
            del self._pending_events[:5000]
        if self.kvbm is not None:
            self.kvbm.on_pool_event(event)
        if self.prefix is not None:
            self.prefix.on_pool_event(event)

    def _flush_kv_events(self) -> None:
        if self.kv_event_sink is None:
            return
        events, self._pending_events = self._pending_events, []
        for e in events:
            try:
                self.kv_event_sink(e)
            except Exception:
                log.exception("kv event sink failed")

    def drain_kv_events(self) -> List[dict]:
        events, self._pending_events = self._pending_events, []
        return events


class InferenceEngine(EngineCore):
    """The PyTorch device engine: packed prefills and autopilot decode
    windows over a paged KV cache on ``device``, enqueued from one executor
    thread so the event loop never blocks on the device. On a card every
    decode window replays a CUDA graph captured here, at construction, one
    per (decode bucket, stochastic); a fetch thread waits on each window's
    CUDA event. With ``spec_mode="ngram"`` the same window object also
    captures the spec windows, one per (decode bucket, stochastic), and the
    loop is the synchronous one.

    ``device`` defaults to ``cuda``; with no GPU present and no device
    given, construction raises (pass ``device="cpu"`` to run on the CPU).

    With ``mesh_shape=(dp, tp)`` or ``(dp, fsdp, tp)`` the engine is one
    rank of a world of every rank of the mesh (``parallel/comm.py``
    initialised first): ``params`` may be the full tree (each rank keeps
    its slice; ``None`` builds the full tree from ``seed`` on every rank,
    so the weights equal the one-rank engine's) or this rank's shard
    (``weights.load_hf_params_sharded``).
    ``sp_prefill_threshold > 0`` on such a mesh turns on the
    sequence-parallel prefill (``_sp_prefill_fn``).

    With ``pp_stages=S`` the engine is stage ``rank`` of a world of S:
    ``params`` may be the full tree (each stage keeps its layers) or the
    stage's (``weights.load_hf_params(..., layers=)``).
    """

    def __init__(
        self,
        model_config: ModelConfig,
        engine_config: EngineConfig,
        params: Optional[model_lib.Params] = None,
        seed: int = 0,
        device=None,
    ):
        check_supported(engine_config)
        self.device = resolve_device(device)
        tp = model_lib.tp_size(engine_config)
        check_divisible(model_config, tp,
                        check_mesh_shape(engine_config.mesh_shape)[1])
        # this rank's coordinates and process groups (one rank: no group)
        self.mesh = make_mesh(engine_config.mesh_shape)
        # pipeline parallelism: this rank is stage pp_group.index of the
        # world (parallel/pp_serving.py)
        pp = engine_config.pp_stages
        self.pp_group = None
        self.stage_layers = (0, model_config.num_layers)
        if pp > 1:
            from ..parallel import pp_serving

            self.pp_group = pp_serving.make_pp_mesh(pp)
            self.stage_layers = pp_serving.stage_layers(
                model_config, pp, self.pp_group.index)
        # attention autotune, BEFORE any step function is built or graph
        # captured: the impl probe (attention_impl="auto" times the kernel
        # against einsum per shape class on the card) plus each class's
        # launch parameters: explicit config > persisted cache
        # (DYNTPU_AUTOTUNE_CACHE) > the sweep on the card > the defaults.
        # Under tp > 1 rank 0 tunes at the shard's head counts and the
        # others take its choice (two ranks timing one card at once could
        # choose differently)
        from .autotune import autotune_attention, share_choice
        engine_config, self.attention_impl_choice = share_choice(
            engine_config, lambda: autotune_attention(
                model_lib.shard_model_config(model_config, tp),
                engine_config, self.device), self.device)
        super().__init__(engine_config)
        self.tp = tp
        self.pp = pp
        self.world = model_lib.mesh_ranks(engine_config)
        self.model_config = model_config
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init_params(gen, model_config)
        if pp > 1:
            # this stage's layers, embed / final_norm / lm_head replicated
            # (a tree loaded for the stage passes unchanged); pp serving is
            # unquantized, as in JAX
            self.params = pp_serving.pp_param_shardings(
                params, model_config, self.pp_group.index, pp)
            del params
            self.cache = pp_serving.init_pp_cache(model_config,
                                                  engine_config, self.device)
        else:
            # quantize at init (a tree quantized beforehand passes
            # unchanged), then keep this rank's slice (a sharded tree
            # passes unchanged)
            self.params = model_lib.shard_params(
                quant.quantize_params(params, engine_config.weight_dtype),
                model_config, engine_config)
            del params          # on a rank of a world: the full tree
            self.cache = model_lib.init_cache(model_config, engine_config,
                                              self.device)
        # packed prefill + autopilot decode windows running on
        # device-resident control state
        self._window_K = max(1, engine_config.decode_steps)
        self._ap_Wcap = engine_config.max_blocks_per_seq
        # speculative decoding: drafter history + draft/verify window
        self._spec_k = 0
        self._spec_hist_cap = 0
        self._spec_auto_disabled = False
        if engine_config.spec_mode == "ngram":
            self._spec_k = engine_config.spec_k
            self._spec_hist_cap = (engine_config.spec_hist_cap
                                   or engine_config.max_model_len)
            self._spec_hist_fill_fn = model_lib.raw_spec_hist_fill_fn()
            self.spec_stats = SpecDecodeStats()
            # a spec window lands a DATA-DEPENDENT 1..k+1 tokens, so
            # run-ahead scheduling (which predicts the next window's base)
            # is off the table: force the synchronous loop
            if engine_config.pipeline_depth > 1:
                log.info("spec_mode=ngram forces pipeline_depth=1")
            self.scheduler.spec_plan_window = self._spec_k + 1
        self._packed_prefill_fns: Dict[Tuple[int, int, bool], Any] = {}
        # the encode-only step of embed(): on a tp rank the group-aware
        # one, on a pipeline stage the stages' encode together
        if pp > 1:
            self._encode_fn = pp_serving.make_pp_encode_fn(model_config,
                                                           self.pp_group)
        else:
            self._encode_fn = model_lib.make_encode_fn(
                model_config, self.mesh,
                model_lib.param_specs(model_config, engine_config))
        # the world a single-rank path's payload is delivered over (the
        # leader is its member 0); one rank alone needs none
        self._world_group = (comm.world_group() if self.world > 1
                             else comm.SOLO)
        if pp > 1:
            # the GPipe-microbatched unified step on the synchronous loop
            # (the JAX engine's legacy path): no autopilot windows, control
            # state, decode graphs or KV block ops
            self._ap_window_fn = self._ap_delta_fn = None
            self._ctl = None
            self._kv_extract = self._kv_inject = None
            self._step_fn = pp_serving.make_pp_step_fn(
                model_config, engine_config, self.pp_group,
                engine_config.pp_microbatches)
            if engine_config.decode_steps > 1:
                log.warning("decode_steps > 1 is unsupported with "
                            "pp_stages — running single-step decode")
        else:
            self._ap_window_fn, self._ap_delta_fn = (
                model_lib.make_autopilot_fns(
                    model_config, engine_config, self._window_K,
                    self._ap_Wcap, self.device, spec_k=self._spec_k))
            self._ctl = model_lib.init_ctl(
                engine_config, engine_config.max_num_seqs, self._ap_Wcap,
                self.device, seed=seed + 2, hist_cap=self._spec_hist_cap,
            )
            self._step_fn = None        # the unified step is pp's alone
            # KV block gather/scatter (disagg, KVBM, prefix onboarding,
            # evacuation); the scatter writes self.cache in place; on a
            # tp rank they read and write the rank's heads
            self._kv_extract, self._kv_inject = model_lib.make_kv_ops(
                engine_config, self.mesh)
        # tensor parallelism: the leader's plan sink (parallel/multihost.py
        # StepBroadcaster.sink), called on the device-step thread BEFORE
        # each launch — a gloo all_reduce blocks the host, so a leader
        # that launched first would wait in the collective for a follower
        # still waiting for the plan; and the plans a follower replayed,
        # per kind
        self.step_sink: Optional[Callable[[str, Dict[str, np.ndarray]],
                                          None]] = None
        self.num_replayed: Dict[str, int] = {}
        # sequence-parallel prefill (the JAX engine builds it when the
        # mesh has more than one device and the threshold is above 0)
        self._sp_prefill_fn = None
        self.num_sp_prefills = 0
        if (self.world > 1 and pp == 1
                and engine_config.sp_prefill_threshold > 0):
            self._sp_prefill_fn = model_lib.make_sp_ring_prefill_fn(
                model_config, engine_config)
            self.scheduler.sp_enabled = True
        if pp > 1:
            log.info("pp stage %d of %d: layers %d..%d, %d microbatches, "
                     "the synchronous loop; KV movement, KVBM, evacuation "
                     "and mm are refused", self.pp_group.index, pp,
                     self.stage_layers[0], self.stage_layers[1] - 1,
                     engine_config.pp_microbatches)
        elif self.world > 1:
            log.info("mesh %s rank %s: decode windows run eager (no CUDA "
                     "graphs on a multi-rank mesh); sp prefill %s",
                     tuple(engine_config.mesh_shape), self.mesh.coords,
                     f"from {engine_config.sp_prefill_threshold} tokens"
                     if self._sp_prefill_fn is not None else "off")
        # dispatch counters
        self.num_windows = 0
        self.num_prefill_dispatches = 0
        self.num_prefill_graph_replays = 0  # of them, CUDA graph replays
        self.num_mm_prefills = 0
        self.num_einsum_rebuilds = 0
        # host mirror of per-slot device state + seat map
        self._ap: Dict[int, Dict[str, Any]] = {}
        self._ap_cols: List[int] = []       # device slot_rows content
        self._ap_rows_dev: Optional[torch.Tensor] = None
        self._ap_dead: set = set()          # slots to kill next dispatch
        # the last batch's landing event while traced (the start of the
        # next batch's device gap) and its prefill tokens; step thread only
        self._gap_prev: Any = None
        self._gap_prev_prefill = 0
        self.pipeline_depth = max(1, engine_config.pipeline_depth)
        if engine_config.spec_mode == "ngram" or pp > 1:
            self.pipeline_depth = 1
        # step keys for prefills come from this generator, on the device
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # one-shot einsum rebuild when the largest decode bucket stalls
        self._stall_einsum_fallback = False
        # flight recorder: per-step MFU/goodput accounting. Records are
        # stamped at dispatch/landing with host ints only — no extra syncs.
        if env_flag("DYNTPU_OBS_ENABLED", True):
            self.obs = StepStats(
                FlopsModel(model_config),
                # MFU per card: the whole model's flops over the world
                n_chips=self.world,
                peak_flops=obs_flops.peak_flops(
                    (torch.cuda.get_device_name(self.device)
                     if self.device.type == "cuda" else ""),
                    self.device.type,
                    # quantized weights run the matmuls at the int8/fp8
                    # roofline — MFU against the bf16 peak would flatter
                    engine_config.weight_dtype
                    if quant.is_quantized(engine_config.weight_dtype)
                    else model_config.dtype,
                ),
                window_s=env_float("DYNTPU_OBS_WINDOW_S", 10.0),
                jsonl_path=env_str("DYNTPU_OBS_STEPSTATS_PATH", ""),
            )
        # waste-driven adaptive bucket ladders: consume the recorder's
        # per-bucket occupancy, split hot rungs / retire cold ones under an
        # explicit compile budget (a new decode rung is a graph captured at
        # its first call). Needs the recorder (the occupancy source) and the
        # single-engine path (a pp engine keeps static buckets, as in JAX).
        if self.obs is not None and pp == 1 and (
                engine_config.adaptive_buckets
                or env_flag("DYNTPU_LADDER_ENABLED", False)):
            from .ladder import BucketLadder
            budget = engine_config.ladder_compile_budget
            self._ladders = {
                # decode windows and spec verify windows share the row
                # bucket grid (and its graphs' buckets)
                "decode": BucketLadder(
                    "decode", engine_config.decode_buckets,
                    kinds=(DECODE, SPEC_VERIFY),
                    compile_budget=budget, step=8,
                ),
                "prefill": BucketLadder(
                    "prefill", engine_config.prefill_buckets,
                    kinds=(PREFILL,),
                    compile_budget=budget, step=16,
                ),
            }
            # the scheduler snaps chunked-prefill caps onto live rungs
            self.scheduler.prefill_ladder = self._ladders["prefill"]
            log.info(
                "adaptive bucket ladders on: budget=%d rungs decode=%r "
                "prefill=%r", budget, engine_config.decode_buckets,
                engine_config.prefill_buckets,
            )
        # the one device-step thread, made at the first batch after start
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # fetches (waits on each window's CUDA event) run OFF the dispatch
        # thread, so a fetch never delays the next window's enqueue
        self._fetcher = _BatchingFetcher(
            self._unpack_results, on_sync=self._count_fetch_sync
        )
        # packed prefill chunks replay CUDA graphs where the decode windows
        # do, in their pool (model_lib.prefill_graphed says which chunks)
        self._prefill_graphs: Optional[model_lib.PrefillGraphs] = None
        if self._ap_window_fn is not None and self._ap_window_fn.graphed:
            # every decode (and spec) graph, then every prefill bucket's
            # greedy graph, before the loop starts
            self._ap_window_fn.capture_all(
                self.params, self.cache, self._ctl, engine_config.decode_buckets)
            self._prefill_graphs = model_lib.PrefillGraphs(
                model_config, engine_config, self._ap_window_fn.pool)
            self._prefill_graphs.capture_all(
                self.params, self.cache, self._ctl["last_tok"],
                self._prefill_graph_buckets())

    def _shutdown_executor(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        self._fetcher.stop()
        if self.obs is not None:
            self.obs.close()

    def _ap_mark_dead(self, slot: int) -> None:
        if self.pp == 1 and slot >= 0 and (
                slot in self._ap or slot in self._ap_cols):
            self._ap_dead.add(slot)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host→device copy, asynchronous from pinned memory on a
        card (a pageable copy could wait for the stream to drain)."""
        return self._upload_tensor(torch.from_numpy(arr))

    def _upload_tensor(self, t: torch.Tensor) -> torch.Tensor:
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------ KV block transfer (disagg) ---------------------
    # Gathers and scatters run on the single device-step thread, so they
    # are enqueued on the engine's stream strictly after every window
    # already dispatched (and before any later one) — at pipeline_depth 2
    # windows may still be in flight when one is asked for. The scatter
    # writes the cache tensors in place: the decode graphs read them at
    # their captured addresses. The host side of a payload is a dict of CPU
    # tensors (pinned when they came off a card).

    def _padded_ids(self, block_ids) -> Tuple[np.ndarray, int]:
        """Block ids padded to a power of two with the trash block 0, so
        pads gather it and scatter into it, and (padded, n)."""
        n = len(block_ids)
        padded = np.zeros((_pow2_bucket(n),), np.int32)
        padded[:n] = block_ids
        return padded, n

    def _gather_blocks(self, padded: np.ndarray):
        """Device-step thread: enqueue the gather of ``padded``; returns
        (device payload, CUDA event after it or None on the CPU).

        On a multi-rank engine the leader emits a ``kx`` plan first, every
        rank gathers its heads and the leader's tp row joins them on the
        leader (a ``gather`` along the head axis), so the leader's payload
        holds every KV head in head order. A follower's payload is None
        (the leader's tp row) or its own heads (another tp row, a replica
        over dp or fsdp), which nobody reads."""
        if self.step_sink is not None:
            self.step_sink("kx", {"ids": padded})
        data = self._kv_extract(self.cache, self._upload(padded))
        if self.world > 1 and self.mesh.seq_group.index == 0:
            # as bytes: gloo has no float8, and a copy is exact for all
            joined = {key: comm.gather(
                a.contiguous().view(torch.uint8), self.mesh.tp_group,
                dim=2, op="kv_gather") for key, a in data.items()}
            data = (None if self.mesh.tp_group.index else
                    {key: joined[key].view(a.dtype)
                     for key, a in data.items()})
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return data, event

    def _scatter_blocks(self, padded: np.ndarray, data, event=None,
                        seq_id: Optional[str] = None,
                        epoch: Optional[int] = None) -> None:
        """Device-step thread: re-check the reservation epoch, then enqueue
        the in-place scatter of ``data`` (host or device tensors, every KV
        head) into ``padded``, after ``event`` (a gather on another
        engine's stream).

        On a multi-rank engine the leader decides the epoch and checks the
        payload's keys, shapes and dtypes first, then emits a ``ki`` plan
        and broadcasts its payload's bytes to every rank (``kv_deliver``);
        each writes its head slice. A stale epoch or a payload that does
        not fit raises before the plan, so no follower waits in a
        collective the leader skips. A follower replays with ``data`` the
        buffers :meth:`_kv_payload_like` makes, which the broadcast fills."""
        if epoch is not None and not self.reservation_valid(seq_id, epoch):
            from ..disagg.ici import StaleEpochError

            raise StaleEpochError(
                f"reservation {seq_id!r} epoch {epoch} is stale"
            )
        want = self._kv_payload_shapes(padded.shape[0])
        got = {key: (tuple(a.shape), a.dtype) for key, a in data.items()}
        if got != want:
            raise ValueError(f"KV payload {got} does not fit this engine's "
                             f"{padded.shape[0]}-block payload {want}")
        if self.step_sink is not None:
            self.step_sink("ki", {"ids": padded})
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if event is not None:
                stream.wait_event(event)
        dev = {key: self._upload_tensor(a) for key, a in data.items()}
        if self.world > 1:
            dev = {key: comm.broadcast(
                a.contiguous().view(torch.uint8), self._world_group,
                op="kv_deliver").view(a.dtype) for key, a in dev.items()}
        if self.device.type == "cuda":
            for a in dev.values():
                if a.device == self.device:
                    # made on another engine's stream: keep its memory
                    # until this stream has read it
                    a.record_stream(stream)
        self._kv_inject(self.cache, self._upload(padded), dev)

    def _kv_payload_shapes(self, m: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                             torch.dtype]]:
        """Key -> (shape, dtype) of a full ``m``-block payload (every KV
        head, the cache's dtypes): what an inject takes."""
        cfg = self.model_config
        shape = (cfg.num_layers, m, cfg.num_kv_heads, self.config.block_size)
        return {key: (shape + (() if key in ("ks", "vs")
                               else (cfg.head_dim_,)),
                      self.cache[key][0].dtype)
                for key in model_lib.cache_payload_keys(self.config)}

    def _kv_payload_like(self, m: int) -> Dict[str, torch.Tensor]:
        """Empty device buffers of a full ``m``-block payload: what a
        follower's ``ki`` replay receives the leader's payload into."""
        return {key: torch.empty(shape, dtype=dt, device=self.device)
                for key, (shape, dt) in self._kv_payload_shapes(m).items()}

    async def extract_kv_blocks(self, block_ids) -> Dict[str, torch.Tensor]:
        """Gather arbitrary physical blocks to host memory ([L, N, KV, bs,
        hd], plus [L, N, KV, bs] scales for a quantized cache). The id list
        is padded to a power of two (pads gather the trash block) and the
        pad is sliced off. On a card the copy lands in pinned memory and
        this waits on its CUDA event off the device-step thread."""
        if self._kv_extract is None:
            raise RuntimeError("KV block transfer unsupported on a "
                               "pipeline-parallel engine")
        loop = asyncio.get_running_loop()
        padded, n = self._padded_ids(block_ids)

        def _ex():
            data, event = self._gather_blocks(padded)
            if event is None:
                return {key: a.to("cpu") for key, a in data.items()}, None
            host = {}
            for key, a in data.items():
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                host[key] = h
            done = torch.cuda.Event()
            done.record()
            return host, done

        host, done = await loop.run_in_executor(self._step_executor(), _ex)
        if done is not None:
            await loop.run_in_executor(None, done.synchronize)
        return {key: a[:, :n] for key, a in host.items()}

    async def inject_kv_blocks(
        self, block_ids, data: Dict[str, torch.Tensor],
        *, seq_id: Optional[str] = None, epoch: Optional[int] = None,
    ) -> None:
        """Scatter per-block KV into physical blocks, in place (pads
        scatter into the trash block, which absorbs garbage by design).

        With ``seq_id``/``epoch`` the reservation is re-validated *inside*
        the device-step callable — immediately before the write — so a
        reservation recycled mid-flight is rejected, never scattered."""
        if self._kv_inject is None:
            raise RuntimeError("KV block transfer unsupported on a "
                               "pipeline-parallel engine")
        loop = asyncio.get_running_loop()
        padded, n = self._padded_ids(block_ids)
        m = padded.shape[0]
        if m != n:

            def _pad(a: torch.Tensor) -> torch.Tensor:
                pad_shape = list(a.shape)
                pad_shape[1] = m - n
                return torch.cat(
                    [a, torch.zeros(pad_shape, dtype=a.dtype,
                                    device=a.device)], dim=1)

            data = {key: _pad(a) for key, a in data.items()}

        await loop.run_in_executor(
            self._step_executor(),
            lambda: self._scatter_blocks(padded, data, seq_id=seq_id,
                                         epoch=epoch))

    async def extract_kv(self, seq) -> Dict[str, torch.Tensor]:
        """Gather a held sequence's KV blocks to host memory."""
        return await self.extract_kv_blocks(seq.block_table)

    async def inject_kv(self, seq, data: Dict[str, torch.Tensor],
                        epoch: Optional[int] = None) -> None:
        """Scatter received KV into a reserved sequence's blocks."""
        await self.inject_kv_blocks(
            seq.block_table, data, seq_id=seq.seq_id, epoch=epoch
        )

    def attach_kvbm(self, config=None, remote=None):
        """Enable the multi-tier block manager on this engine (optionally
        with a G4 remote tier)."""
        if self.pp > 1:
            # the JAX engine's words (its pp cache is stacked; a stage's
            # here has no transfer ops either)
            raise RuntimeError("KVBM unsupported on a pipeline-parallel "
                               "engine (stacked cache has no transfer ops)")
        from ..kvbm.manager import KvbmConfig, KvbmManager

        self.kvbm = KvbmManager(self, config or KvbmConfig(), remote=remote)
        return self.kvbm

    # ----------------------- embeddings (encode) -----------------------

    async def embed(self, token_ids_batch: List[List[int]]
                    ) -> List[List[float]]:
        """Encode-only step for ``/v1/embeddings``: mean-pooled, normalised
        final hidden states. Runs on the device-step thread, so it is
        serialised with the windows and prefills the engine enqueues there,
        on the same stream. Inputs are grouped by power-of-two (B, T)
        buckets, as the JAX engine groups them for its programs: one
        batched forward and one device→host copy per group. On a
        multi-rank engine every group runs on every rank
        (:meth:`_encode_group`)."""
        loop = asyncio.get_running_loop()

        for ids in token_ids_batch:
            if not ids:
                raise ValueError("empty embedding input")
            if len(ids) >= self.config.max_model_len:
                raise ValueError(
                    f"embedding input length {len(ids)} exceeds "
                    f"max_model_len {self.config.max_model_len}"
                )

        def _run() -> List[List[float]]:
            out: List[Optional[List[float]]] = [None] * len(token_ids_batch)
            groups: Dict[int, List[int]] = {}
            for i, ids in enumerate(token_ids_batch):
                groups.setdefault(_pow2_bucket(len(ids)), []).append(i)
            for T, idxs in groups.items():
                B = _pow2_bucket(len(idxs))
                tokens = np.zeros((B, T), np.int32)
                positions = np.full((B, T), -1, np.int32)
                for row, i in enumerate(idxs):
                    ids = token_ids_batch[i]
                    tokens[row, :len(ids)] = ids
                    positions[row, :len(ids)] = np.arange(len(ids))
                vecs = self._encode_group(tokens, positions)
                for row, i in enumerate(idxs):
                    out[i] = vecs[row].tolist()
            return out  # type: ignore[return-value]

        return await loop.run_in_executor(self._step_executor(), _run)

    def _encode_group(self, tokens: np.ndarray, positions: np.ndarray,
                      fetch: bool = True) -> Optional[np.ndarray]:
        """Device-step thread: one ``(B, T)`` group's pooled vectors as
        numpy. A multi-rank leader emits an ``emb`` plan with the group's
        tokens and positions first; a follower replays it here with
        ``fetch`` False (nobody reads its vectors: None), so every rank
        runs the group's collectives (the tp row's sums, a pipeline's
        hops) in the same order."""
        if self.step_sink is not None:
            self.step_sink("emb", {"tokens": tokens, "positions": positions})
        vecs = self._encode_fn(self.params, self._upload(tokens),
                               self._upload(positions))
        # the embeddings are the endpoint's answer: fetched once per group,
        # off the decode loop
        return vecs.cpu().numpy() if fetch else None  # dynalint: disable=DT102

    async def embed_endpoint(self, request: Any, context: Context):
        """Wire adapter for the worker's ``embed`` endpoint."""
        vectors = await self.embed(
            [list(ids) for ids in request["token_ids_batch"]]
        )
        yield {"embeddings": vectors}

    # --------------------- device execution ----------------------------

    def _step_executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._executor is None:
            self._executor = _StepExecutor(
                max_workers=1, thread_name_prefix="device-step"
            )
        return self._executor

    async def _execute_batch_async(self, batch):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._step_executor(), self._execute_batch, batch
        )

    async def _dispatch_batch_async(self, batch):
        """Pipelined path: enqueue the batch's calls and the copy of its
        tokens on the dispatch thread (no sync), then hand the landing to
        the fetcher. Returns the asyncio future of the results."""
        loop = asyncio.get_running_loop()
        landing = await loop.run_in_executor(
            self._step_executor(), self._dispatch_batch, batch
        )
        return self._fetcher.submit(loop, batch, landing)

    def _execute_batch(self, batch):
        """Synchronous execution (pipeline_depth=1): dispatch, then wait
        for the batch's tokens, in one executor turn. A pp engine runs
        the unified step per prefill chunk and once for the decode rows
        (the JAX engine's legacy path)."""
        if self.pp > 1:
            obs_out = batch.obs_records if self.obs is not None else None
            prefill_samples = [self._run_prefill(c, obs_out)
                               for c in batch.prefills]
            decode_samples = (self._run_decode(batch.decode_rows, obs_out)
                              if batch.decode_rows else [])
            if self.obs is not None:
                self._obs_on_land(batch, decode_samples)
            return prefill_samples, decode_samples
        landing = self._dispatch_batch(batch)
        if landing.event is not None:
            # designed sync point of the synchronous loop: one wait per
            # executed batch, counted in num_fetch_syncs
            landing.event.synchronize()  # dynalint: disable=DT102
        if landing.stamps is not None:
            landing.stamps.t_ready = time.monotonic()
        if landing.host is not None:
            self._count_fetch_sync()
        return self._unpack_results(batch, landing)

    def _dispatch_batch(self, batch) -> _Landing:
        """Build inputs + enqueue every device call for this batch, then the
        copy of its sampled tokens to the host. NO host sync in here. Seat
        kills flush FIRST so the in-order stream applies them before any
        work that could touch reused blocks. A batch with loop stamps gets
        its enqueue stamps and, on a card, the events of its device gap."""
        st = batch.loop_stamps
        if st is not None:
            self._stamp_first_enqueue(st)
        self._ap_flush_kills()
        obs_out = batch.obs_records if self.obs is not None else None
        prefill_handles = [self._dispatch_prefill(c, obs_out, st)
                           for c in batch.prefills]
        decode_handle = (
            self._dispatch_decode(batch.decode_rows, obs_out, st)
            if batch.decode_rows else None
        )
        landing = self._start_fetch(prefill_handles, decode_handle, st)
        # the next batch's gap starts at this landing's event (timed only)
        self._gap_prev = landing.event if st is not None else None
        if st is not None:
            self._gap_prev_prefill = sum(c.length for c in batch.prefills)
        return landing

    def _stamp_first_enqueue(self, st: _LoopStamps) -> None:
        """Before the batch's first enqueue: on a card, whether the last
        batch's landing event is still pending (a query, no wait) and a
        timing event on the stream; then the host stamp of the enqueue."""
        prev = self._gap_prev
        if self.device.type == "cuda":
            st.gap_prev = prev
            st.prev_prefill_tokens = self._gap_prev_prefill
            st.queued = prev is not None and not prev.query()
            st.gap_start = torch.cuda.Event(enable_timing=True)
            st.gap_start.record()
        st.t_enqueue = time.monotonic()

    @hot_path
    def _start_fetch(self, prefill_handles, decode_handle,
                     stamps: Optional[_LoopStamps] = None) -> _Landing:
        """Enqueue the ONE device→host copy of every sampled token of the
        batch, into pinned memory on a card, right after the batch's last
        call: a decode graph's samples live in its pool and its next replay
        overwrites them, and no replay can come before this copy in stream
        order. An event after the copy marks the landing (with ``stamps``:
        one that times the device gap before the next batch)."""
        flat = list(prefill_handles)
        if decode_handle is not None:
            flat.append(decode_handle[0])
        landing = _Landing(
            n_prefill=len(prefill_handles),
            decode_shape=(tuple(decode_handle[0].shape)
                          if decode_handle is not None else None),
            cols=decode_handle[1] if decode_handle is not None else None,
            host=None,
            spec=decode_handle is not None and decode_handle[2],
            stamps=stamps,
        )
        if not flat:
            return landing
        dev = (flat[0].reshape(-1) if len(flat) == 1
               else torch.cat([t.reshape(-1) for t in flat]))
        if self.device.type != "cuda":
            # the batched fetch off the card: no stream to wait for
            landing.host = dev.to("cpu")  # dynalint: disable=DT102
            return landing
        landing.host = torch.empty(dev.shape, dtype=dev.dtype,
                                   pin_memory=True)
        landing.host.copy_(dev, non_blocking=True)
        landing.event = torch.cuda.Event(enable_timing=stamps is not None)
        landing.event.record()
        return landing

    def _ap_flush_kills(self) -> None:
        """Kill dead autopilot seats (one packed delta call). The dead-set
        swap is GIL-atomic against _ap_mark_dead calls from the event loop;
        anything added after the swap rides the next dispatch."""
        dead, self._ap_dead = self._ap_dead, set()
        if not dead:
            return
        deltas = {}
        for slot in dead:
            deltas[slot] = {
                "pos": 0, "vu": 0, "tk": 0, "seed": -1, "lt": -1,
                "table": (), "temp": 0.0, "tp": 1.0,
            }
            self._ap.pop(slot, None)
        self._ap_apply_deltas(deltas)

    def _count_fetch_sync(self) -> None:
        self.num_fetch_syncs += 1

    @hot_path
    def _unpack_results(self, batch, landing: _Landing):
        """Map a landed window's host tokens back to per-seat sample lists.
        Decode sample columns follow the device seat map captured at
        dispatch, which may order (and pad) differently than the batch's
        row list."""
        # landing.host is the landed host copy: a view, no transfer
        got = (landing.host.numpy()  # dynalint: disable=DT102
               if landing.host is not None else None)
        n = landing.n_prefill
        prefill_samples = [int(got[i]) for i in range(n)]
        decode_samples: List[List[int]] = []
        if landing.decode_shape is not None:
            col_of: Dict[int, int] = {}
            for col, slot in enumerate(landing.cols):
                col_of.setdefault(slot, col)
            # [K, B] (spec: [k+3, B] packed)
            out = got[n:].reshape(landing.decode_shape)
            if landing.spec:
                decode_samples = self._unpack_spec(batch, out, col_of)
            else:
                for row in batch.decode_rows:
                    col = col_of[row.slot]
                    decode_samples.append([
                        int(out[k, col])
                        for k in range(min(row.accepted, out.shape[0]))
                    ])
        if self.obs is not None:
            self._obs_on_land(batch, decode_samples)
        return prefill_samples, decode_samples

    @hot_path
    def _obs_on_land(self, batch, decode_samples) -> None:
        """Stamp landing time + realized goodput on this window's records
        and commit them to the flight recorder. Runs right after the
        window's one designed wait, on already-fetched host ints — no extra
        syncs."""
        recs = getattr(batch, "obs_records", None)
        if not recs:
            return
        t_land = time.monotonic()
        emitted = sum(len(w) for w in decode_samples)
        for rec in recs:
            rec.t_land = t_land
            if rec.kind != PREFILL:
                rec.goodput_tokens = emitted
            self.obs.commit(rec)
        recs.clear()
        if self._ladders:
            self._ladder_tick()

    @hot_path
    def _ladder_tick(self) -> None:
        """Feed the recorder's occupancy histogram to the bucket ladders
        and run one (cheap, host-int) adaptation check. Called on every
        landing; BucketLadder.min_dispatches gates actual epochs."""
        occ = self.obs.bucket_occupancy()
        for lad in self._ladders.values():
            lad.ingest(occ)
            lad.maybe_adapt()

    @hot_path
    def _unpack_spec(self, batch, out, col_of) -> List[List[int]]:
        """Spec verify window landing: packed rows 0..k are emitted token
        candidates, row k+1 n_emitted, row k+2 n_drafted. Runs on the
        device-step thread — spec forces the synchronous loop — so
        correcting the host mirror's pessimistic pos here is ordered
        strictly before the next dispatch."""
        kk = self._spec_k
        stats = self.spec_stats
        decode_samples: List[List[int]] = []
        win_drafted = win_accepted = 0
        for row in batch.decode_rows:
            col = col_of[row.slot]
            n = int(out[kk + 1, col])
            ndraft = int(out[kk + 2, col])
            n_use = min(n, row.accepted)
            decode_samples.append([int(out[j, col]) for j in range(n_use)])
            row.seq.spec_drafted += ndraft
            row.seq.spec_accepted += max(n - 1, 0)
            win_drafted += ndraft
            win_accepted += max(n - 1, 0)
            stats.drafted += ndraft
            stats.accepted += max(n - 1, 0)
            stats.emitted += n_use
            st = self._ap.get(row.slot)
            if st is not None and st["seq_id"] == row.seq.seq_id:
                st["pos"] = row.base + n
        stats.windows += 1
        if self.obs is not None:
            for rec in getattr(batch, "obs_records", ()):
                if rec.kind == SPEC_VERIFY:
                    rec.spec_drafted += win_drafted
                    rec.spec_accepted += win_accepted
        th = self.config.spec_auto_disable_threshold
        if (th > 0.0 and not self._spec_auto_disabled
                and stats.drafted >= self.config.spec_auto_disable_window
                and stats.acceptance_rate < th):
            # one-way: drafting is costing more verify compute than it
            # saves in syncs on this workload; fall back to plain windows
            self._spec_auto_disabled = True
            self.scheduler.spec_plan_window = None
            log.info(
                "spec decode auto-disabled: acceptance %.3f < %.3f after "
                "%d drafts", stats.acceptance_rate, th, stats.drafted,
            )
        return decode_samples

    def _pause_spec(self) -> None:
        if self._spec_k <= 0 or self._spec_auto_disabled:
            return
        self._pressure_spec_saved = self.scheduler.spec_plan_window
        self.scheduler.spec_plan_window = None
        log.warning("pressure ladder: speculative decoding paused")

    def _resume_spec(self) -> None:
        if self._pressure_spec_saved is None:
            return
        if not self._spec_auto_disabled:
            self.scheduler.spec_plan_window = self._pressure_spec_saved
        self._pressure_spec_saved = None
        log.info("pressure ladder: speculative decoding resumed")

    def _next_key(self) -> torch.Tensor:
        """A fresh step key on the device (no host sync)."""
        return torch.randint(0, 1 << 31, (), generator=self._gen,
                             device=self.device, dtype=torch.int64)

    def _bucket_for(self, kind: str, n: int) -> int:
        """Bucket ``n`` on the live grid for ``kind`` (the ladder's rungs
        when it is on, the static config grid otherwise).
        Stall-quarantined buckets route to the next rung up — another
        captured graph (or prefill shape) doing the same work with
        padding."""
        grid = self._grid(kind)
        b = _bucket(n, grid)
        if self._shape_quarantine and (kind, b) in self._shape_quarantine:
            for g in grid:
                if g >= b and (kind, g) not in self._shape_quarantine:
                    return g
        return b

    def _grid(self, kind: str) -> Tuple[int, ...]:
        lad = self._ladders.get(kind)
        if lad is not None:
            return lad.buckets()
        return (self.config.decode_buckets if kind == "decode"
                else self.config.prefill_buckets)

    def _shape_bucket(self, kind: str, n: int) -> int:
        return self._bucket_for(kind, n)

    def _last_graph_key(self) -> str:
        if self._ap_window_fn is None:
            return "pp_step"
        return self._ap_window_fn.last_key

    def _quarantine_shape(self, cls) -> None:
        """When the LARGEST decode bucket wedges there is no rung to route
        to — rebuild the decode window on the einsum attention impl instead
        (another graph for the same shape class, captured at its first
        call), once."""
        kind, bucket = cls
        if (self.pp == 1 and kind == "decode"
                and not self._stall_einsum_fallback):
            cfg = self.config
            if bucket >= max(self._grid("decode")):
                fb_cfg = dataclasses.replace(
                    cfg, attention_impl_decode="einsum"
                )
                self._ap_window_fn, self._ap_delta_fn = (
                    model_lib.make_autopilot_fns(
                        self.model_config, fb_cfg, self._window_K,
                        self._ap_Wcap, self.device, spec_k=self._spec_k,
                    )
                )
                # the new window's seat-map buffers start empty
                self._ap_rows_dev = None
                self._stall_einsum_fallback = True
                self.num_einsum_rebuilds += 1
                compilewatch.note("decode_window:einsum_rebuild")
                log.warning(
                    "stall watchdog: decode:%d is the largest rung — "
                    "rebuilt the decode window on the einsum attention "
                    "impl instead of quarantining it", bucket,
                )
                return
        super()._quarantine_shape(cls)

    def _prefill_graph_buckets(self) -> List[int]:
        """The prefill buckets whose greedy graphs are captured at
        construction: those a chunk under the token budget can take, on
        the graphs' route."""
        cfg = self.config
        top = _bucket(cfg.max_num_batched_tokens, cfg.prefill_buckets)
        return [T for T in cfg.prefill_buckets if T <= top
                and model_lib.prefill_graphed(cfg, self.device, T)]

    def _prefill_bucket(self, chunk: PrefillChunk, use_sp: bool) -> int:
        if chunk.length <= max(self.config.prefill_buckets) and not use_sp:
            return self._bucket_for("prefill", chunk.length)
        # sp full-prompt chunks (and any oversized chunk) bucket to the
        # next power of two, which a power-of-two seq column (dp * fsdp
        # ranks) always divides
        return max(_pow2_bucket(chunk.length),
                   self.mesh.seq_group.size if use_sp else 1)

    def _prefill_arrays(self, chunk: PrefillChunk, T: int,
                        wide: bool = False):
        cfg = self.config
        seq = chunk.seq
        # only the blocks this chunk can touch: W is a function of the
        # chunk shape alone; ``wide`` (a graphed chunk) pads the table to
        # the widest, where the kernel reads no more than it would
        bs = cfg.block_size
        nb = min((chunk.start + chunk.length + bs - 1) // bs,
                 len(seq.block_table))
        W = (cfg.max_blocks_per_seq if wide
             else _pow2_bucket(nb, cfg.max_blocks_per_seq))
        tokens = np.zeros((T,), np.int32)
        tokens[:chunk.length] = seq.all_tokens()[
            chunk.start:chunk.start + chunk.length
        ]
        tables = np.zeros((W,), np.int32)
        tables[:nb] = seq.block_table[:nb]
        return tokens, tables

    @hot_path
    def _dispatch_prefill(self, chunk: PrefillChunk, obs_out=None,
                          stamps: Optional[_LoopStamps] = None):
        """Enqueue one prefill chunk; returns the sampled handle [1]
        (garbage unless ``chunk.final``). Every int input rides ONE
        host→device copy. No host sync. On a card a chunk that
        ``model_lib.prefill_graphed`` takes replays its T's graph at the
        widest table (``num_prefill_graph_replays``); others run their
        eager function. ``stamps`` gets the chunk's enqueue, from its first
        host work to its last launch's return, and whether it replayed."""
        t0 = time.monotonic() if stamps is not None else 0.0
        cfg = self.config
        seq = chunk.seq
        self.num_prefill_dispatches += 1
        use_sp = (
            self._sp_prefill_fn is not None
            and chunk.start == 0 and chunk.final
            and chunk.length >= cfg.sp_prefill_threshold
            and not seq.mm_positions  # the sp path has no mm splicing
        )
        mm_rows = self._mm_chunk_rows(chunk)
        mm = bool(mm_rows)
        T = self._prefill_bucket(chunk, use_sp)
        graphed = self._prefill_graphs is not None and \
            model_lib.prefill_graphed(cfg, self.device, T, mm, use_sp)
        tokens, tables = self._prefill_arrays(chunk, T, wide=graphed)
        W = tables.shape[0]
        self._obs_prefill(chunk, T, obs_out)
        fn = (self._prefill_graphs if graphed
              else self._sp_prefill_fn(T, W) if use_sp
              else self._prefill_fn(T, W, mm))
        slot = seq.slot if seq.slot >= 0 else cfg.max_num_seqs
        M = T + W + model_lib.PP_SCALARS
        pint = np.zeros((1, M + (T if mm else 0)), np.int32)
        pint[0, :T] = tokens
        pint[0, T:T + W] = tables
        pint[0, T + W:M] = (
            chunk.length, chunk.start, slot, 1 if chunk.final else 0,
            seq.top_k, seq.seed,
            int(round(seq.temperature * model_lib.PP_QUANT)),
            int(round(seq.top_p * model_lib.PP_QUANT)),
        )
        extra = ()
        if mm:
            # the chunk's part of the image(s): its embedding rows into a
            # [T, D] f32 block, the mask after the scalars
            mm_embeds = np.zeros((T, self.model_config.hidden_size),
                                 np.float32)
            emb = np.asarray(seq.mm_embeddings, np.float32)
            for row, k in mm_rows:
                mm_embeds[row] = emb[k]
                pint[0, M + row] = 1
            self.num_mm_prefills += 1
            extra = (self._upload(mm_embeds),)
        stochastic = seq.temperature > 0.0
        if self.step_sink is not None:
            self.step_sink("rsp" if use_sp else "mrp" if mm else "pp", {
                "pint": pint, "tw": np.array([T, W], np.int32),
                "st": np.array([stochastic], np.int32)})
        if mm and self.world > 1:
            # after the mrp plan: the chunk's embeddings ride a broadcast
            # over the world, never the plan stream
            comm.broadcast(extra[0], self._world_group, op="mm_deliver")
        if use_sp:
            self.num_sp_prefills += 1
        # the prefill posts its sample into ctl["last_tok"] in place; the
        # cache and ctl it returns are the same objects (the decode graphs
        # read them at their captured addresses)
        self.cache, _, sampled = fn(
            self.params, self.cache, self._ctl["last_tok"],
            (self._prefill_graphs.load(torch.from_numpy(pint)) if graphed
             else self._upload(pint)), self._next_key(), stochastic, *extra,
        )
        self.num_prefill_graph_replays += int(graphed)
        if stamps is not None:
            stamps.prefills.append((t0, time.monotonic(), chunk.length, T,
                                    graphed))
        return sampled

    @staticmethod
    def _obs_prefill(chunk: PrefillChunk, T: int, obs_out) -> None:
        """The recorder's record of a prefill chunk padded to T, stamped at
        dispatch from host-known ints only — prompt tokens are goodput at
        dispatch; context_sum = Σ attended context over its positions."""
        if obs_out is None:
            return
        L, S = chunk.length, chunk.start
        obs_out.append(StepRecord(
            kind=PREFILL, t_dispatch=time.monotonic(),
            bucket=T, rows=1, live_rows=1,
            padded_tokens=T, real_tokens=L,
            goodput_tokens=L,
            context_sum=L * S + L * (L + 1) // 2,
        ))

    @staticmethod
    def _obs_decode(rows, B: int, K: int, spec: bool, obs_out) -> None:
        """The recorder's record of a decode (or spec verify) window of K
        steps over B padded rows; realized goodput (emitted tokens) is
        stamped at landing — only padded/real shapes are known here."""
        if obs_out is None:
            return
        ctx = sum(K * r.base + K * (K + 1) // 2 for r in rows)
        obs_out.append(StepRecord(
            kind=SPEC_VERIFY if spec else DECODE,
            t_dispatch=time.monotonic(), bucket=B,
            rows=B, live_rows=len(rows),
            padded_tokens=B * K, real_tokens=len(rows) * K,
            context_sum=ctx,
        ))

    def _prefill_fn(self, T: int, W: int, mm: bool):
        """The packed prefill of a (T, W[, mm]) chunk shape, built once."""
        fn = self._packed_prefill_fns.get((T, W, mm))
        if fn is None:
            fn = model_lib.raw_packed_prefill_fn(
                self.model_config, self.config, T, W, mm=mm)
            self._packed_prefill_fns[(T, W, mm)] = fn
        return fn

    def _mm_chunk_rows(self, chunk: PrefillChunk):
        """(chunk-relative row, embedding index) of multimodal placeholder
        positions inside this chunk (decode never needs this — placeholders
        live in the prompt only). An image split over two chunks gives each
        chunk its own rows."""
        seq = chunk.seq
        if not seq.mm_positions:
            return []
        lo, hi = chunk.start, chunk.start + chunk.length
        return [
            (p - lo, k) for k, p in enumerate(seq.mm_positions)
            if lo <= p < hi
        ]

    @hot_path
    def _ap_apply_deltas(self, deltas: Dict[int, Dict[str, Any]]) -> None:
        """Pack + enqueue one control-state delta call (two host→device
        copies in all). The delta updates ctl in place and hands back the
        same dict."""
        Wcap = self._ap_Wcap
        n = _pow2_bucket(len(deltas))
        trash = self.config.max_num_seqs
        di = np.zeros((n, model_lib.CTL_I32_FIELDS + Wcap), np.int32)
        di[:, 0] = trash               # pad rows scatter to the trash slot
        di[:, 5] = -1                  # pad rows keep last_tok
        df = np.zeros((n, 2), np.float32)
        for i, (slot, d) in enumerate(sorted(deltas.items())):
            di[i, 0] = slot
            di[i, 1] = d["pos"]
            di[i, 2] = d["vu"]
            di[i, 3] = d["tk"]
            di[i, 4] = d["seed"]
            di[i, 5] = d["lt"]
            table = d["table"]
            di[i, 6:6 + len(table)] = table
            df[i, 0] = d["temp"]
            df[i, 1] = d["tp"]
        if self.step_sink is not None:
            self.step_sink("ctl", {"di": di, "df": df})
        self._ctl = self._ap_delta_fn(self._ctl, self._upload(di),
                                      self._upload(df))

    @hot_path
    def _dispatch_decode(self, rows, obs_out=None,
                         stamps: Optional[_LoopStamps] = None):
        """Enqueue one autopilot decode window (a graph replay on a card).
        Steady state (same seats, no growth) dispatches with ZERO fresh
        host tensors — all control state is device-resident; the host sends
        packed deltas only on joins, block growth, resumes, and seat-map
        changes. Returns (samples_handle [K, B], col_map, spec) where
        col_map[device column] is the slot computed there and ``spec``
        marks a packed spec-window handle. ``stamps`` gets the enqueue:
        deltas, seat map and the replay call."""
        t0 = time.monotonic() if stamps is not None else 0.0
        cfg = self.config
        bs = cfg.block_size
        spec = self._spec_active()
        # spec windows land a data-dependent 1..k+1 tokens; mirror the
        # device's advance pessimistically here (max) and correct it in
        # _unpack_spec before the next dispatch (synchronous loop)
        K = (self._spec_k + 1) if spec else self._window_K
        deltas: Dict[int, Dict[str, Any]] = {}
        reset_rows: List[Any] = []
        for r in rows:
            s = r.seq
            vu = min(len(s.block_table) * bs, cfg.max_model_len)
            tlen = len(s.block_table)
            params_key = (s.temperature, s.top_k, s.top_p, s.seed)
            st = self._ap.get(r.slot)
            if (st is None or st["seq_id"] != s.seq_id
                    or st["pos"] != r.base or st["params"] != params_key):
                # join / resume / drift: reset the whole slot. lt = -1
                # keeps the ring token the producer wrote on device; a
                # host-known token (resume) is pushed instead.
                deltas[r.slot] = {
                    "pos": r.base, "vu": vu, "tk": s.top_k,
                    "seed": s.seed,
                    "lt": -1 if r.tok_src else r.tok_host,
                    "table": s.block_table, "temp": s.temperature,
                    "tp": s.top_p,
                }
                reset_rows.append(r)
            elif st["vu"] != vu or st["tlen"] != tlen:
                deltas[r.slot] = {
                    "pos": r.base, "vu": vu, "tk": s.top_k,
                    "seed": s.seed, "lt": -1,
                    "table": s.block_table, "temp": s.temperature,
                    "tp": s.top_p,
                }
            # mirror the device's own advance: acc = clip(vu - pos, 0, K)
            self._ap[r.slot] = {
                "seq_id": s.seq_id, "params": params_key,
                "pos": r.base + min(max(vu - r.base, 0), K),
                "vu": vu, "tlen": tlen,
            }
        if deltas:
            self._ap_apply_deltas(deltas)
            if spec and reset_rows:
                self._spec_fill_hist(reset_rows)
        # seat map: reuse the device map only when the LIVE seats it holds
        # are exactly the scheduled set. A LIVE slot the scheduler skipped
        # this round must not keep its column — the window would advance
        # its device pos/ring token behind the host mirror's back. On a
        # card the map is written into the bucket's captured buffer.
        needed = [r.slot for r in rows]
        B = self._bucket_for("decode", len(needed))
        live = {s for s in self._ap_cols if s in self._ap}
        if (self._ap_rows_dev is None or len(self._ap_cols) != B
                or live != set(needed)):
            cols = needed + [cfg.max_num_seqs] * (B - len(needed))
            if self.step_sink is not None:
                self.step_sink("cols", {"rows": np.asarray(cols, np.int32)})
            self._ap_cols = cols
            self._ap_rows_dev = self._ap_window_fn.load_rows(cols)
        self.num_windows += 1
        self._obs_decode(rows, B, K, spec, obs_out)
        stochastic = any(r.seq.temperature > 0.0 for r in rows)
        if self.step_sink is not None:
            self.step_sink("sw" if spec else "w",
                           {"st": np.array([stochastic], np.int32)})
        self.cache, self._ctl, samples = self._ap_window_fn(
            self.params, self.cache, self._ctl, self._ap_rows_dev,
            stochastic, spec=spec,
        )
        if stamps is not None:
            stamps.decode = (t0, time.monotonic())
        return samples, list(self._ap_cols), spec

    def _spec_active(self) -> bool:
        return (self._spec_k > 0 and not self._spec_auto_disabled
                and not self._pressure_spec_paused)

    def _spec_fill_hist(self, rows) -> None:
        """Inject full token histories for joining/reset seats so the
        on-device drafter has context immediately — including resumed and
        migrated sequences, whose carried tokens arrive with the request.
        One [n, Hcap+1] upload per join delta; steady-state windows extend
        the history on device with no uploads at all."""
        Hcap = self._spec_hist_cap
        trash = self.config.max_num_seqs
        n = _pow2_bucket(len(rows))
        slots = np.full((n,), trash, np.int32)
        hrows = np.full((n, Hcap + 1), -1, np.int32)
        for i, r in enumerate(rows):
            toks = r.seq.all_tokens()[:min(r.base + 1, Hcap)]
            slots[i] = r.slot
            hrows[i, :len(toks)] = toks
        if self.step_sink is not None:
            self.step_sink("sph", {"slots": slots, "hist": hrows})
        self._ctl = self._spec_hist_fill_fn(
            self._ctl, self._upload(slots), self._upload(hrows))

    # ---- the unified step: pipeline-parallel engines, "p"/"d" plans ----

    def unified_step(self, arrays: Dict[str, np.ndarray]) -> torch.Tensor:
        """Launch this stage's part of the GPipe step
        (``parallel/pp_serving.py``) on a ``p`` (prefill chunk) or ``d``
        (decode batch) plan's host arrays, drawing one step key; returns
        the sampled tokens ``[B]`` on the device. The leader runs it after
        emitting the plan, a follower from ``replay_plan``. Only a
        pipeline-parallel engine has the unified step: every other engine
        takes the packed and autopilot paths, and emits no such plan."""
        if self._step_fn is None:
            raise RuntimeError("a 'p'/'d' plan reached an engine without "
                               "pp_stages")
        a = {k: self._upload(v) for k, v in arrays.items()}
        self.cache, sampled = self._step_fn(
            self.params, self.cache, a["tokens"], a["positions"],
            a["tables"], a["last_idx"], self._next_key(), a["temp"],
            a["top_k"], a["top_p"], a["seeds"],
            bool((arrays["temp"] > 0).any()))
        return sampled

    def _run_prefill(self, chunk: PrefillChunk, obs_out=None) -> int:
        """One prefill chunk through the unified step (B = 1), its plan
        emitted first; returns its sample (garbage unless ``chunk.final``).
        Waits for the token: the synchronous loop's one sync per step."""
        seq = chunk.seq
        self.num_prefill_dispatches += 1
        T = self._prefill_bucket(chunk, False)
        tokens, tables = self._prefill_arrays(chunk, T)
        self._obs_prefill(chunk, T, obs_out)
        positions = np.full((1, T), -1, np.int32)
        positions[0, :chunk.length] = np.arange(
            chunk.start, chunk.start + chunk.length)
        a = {"tokens": tokens[None], "positions": positions,
             "tables": tables[None],
             "last_idx": np.array([chunk.length - 1], np.int32),
             "temp": np.array([seq.temperature], np.float32),
             "top_k": np.array([seq.top_k], np.int32),
             "top_p": np.array([seq.top_p], np.float32),
             "seeds": np.array([seq.seed], np.int32)}
        if self.step_sink is not None:
            self.step_sink("p", a)
        # the synchronous path's one fetch per step, counted
        sampled = self.unified_step(a).cpu()  # dynalint: disable=DT102
        self._count_fetch_sync()
        return int(sampled[0])

    def _run_decode(self, rows, obs_out=None) -> List[List[int]]:
        """One decode step of every row through the unified step (T = 1,
        B bucketed; pad rows at position -1 scatter to the trash block),
        its plan emitted first; returns one token per row."""
        cfg = self.config
        B = self._bucket_for("decode", len(rows))
        W = _pow2_bucket(max(len(r.seq.block_table) for r in rows),
                         cfg.max_blocks_per_seq)
        tokens = np.zeros((B, 1), np.int32)
        positions = np.full((B, 1), -1, np.int32)
        tables = np.zeros((B, W), np.int32)
        temp = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        seeds = np.full((B,), -1, np.int32)
        for i, r in enumerate(rows):
            s = r.seq
            tokens[i, 0] = r.tok_host
            positions[i, 0] = r.base
            tables[i, :len(s.block_table)] = s.block_table
            temp[i] = s.temperature
            top_k[i] = s.top_k
            top_p[i] = s.top_p
            seeds[i] = s.seed
        self.num_windows += 1
        self._obs_decode(rows, B, 1, False, obs_out)
        a = {"tokens": tokens, "positions": positions, "tables": tables,
             "last_idx": np.zeros((B,), np.int32), "temp": temp,
             "top_k": top_k, "top_p": top_p, "seeds": seeds}
        if self.step_sink is not None:
            self.step_sink("d", a)
        # the synchronous path's one fetch per step, counted
        out = self.unified_step(a).cpu()  # dynalint: disable=DT102
        self._count_fetch_sync()
        return [[int(out[i])] for i in range(len(rows))]
