"""The async inference engine: scheduler + step functions + token streaming.

Port of ``dynamo_tpu.engine.engine`` (role-equivalent to vLLM's ``AsyncLLM``
in the reference's workers, ref: components/backends/vllm/src/dynamo/vllm/
main.py:97). An asyncio step loop plans batches with the continuous-batching
scheduler, runs the PyTorch step functions on the device from one dedicated
executor thread (so the event loop never blocks on the device), and streams
sampled tokens into per-request queues. KV events are surfaced in-process.

This slice keeps the synchronous loop (schedule → execute → postprocess,
one host sync per batch) over packed prefills and autopilot decode windows.
The run-ahead loop and its batching fetcher, the stall watchdog, the
pressure ladder, evacuation, KVBM, the radix prefix cache, disaggregated
reservations, tracing spans and the flight recorder wait for later slices.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import time
from dataclasses import dataclass
from typing import (
    Any, AsyncIterator, Callable, Dict, List, Optional, Tuple,
)

import numpy as np
import torch

from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..utils.device import resolve_device
from ..utils.hotpath import hot_path
from ..utils.logging import get_logger
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
    and KV-event surfacing. Subclasses provide the batch execution.
    ``generate`` accepts wire-format dict requests (token_ids + sampling
    options) and yields wire-format dict outputs.
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

    # ------------------------- lifecycle -------------------------------

    async def start(self) -> None:
        """Start the step loop; after ``stop`` this starts it again (on
        the running event loop, which may be another than the first)."""
        if self._loop_task is None:
            self._stopped = False
            self._wake = asyncio.Event()
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

    # ------------------------- submission ------------------------------

    async def submit(self, request: Request) -> AsyncIterator[StepOutput]:
        """Submit a request; yields StepOutputs as tokens are generated."""
        await self.start()
        if not request.token_ids:
            raise ValueError("empty prompt")
        if len(request.token_ids) >= self.config.max_model_len:
            raise ValueError(
                f"prompt length {len(request.token_ids)} exceeds "
                f"max_model_len {self.config.max_model_len}"
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
        )
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[seq.seq_id] = queue
        self._seqs[seq.seq_id] = seq
        self.scheduler.add(seq)
        self._wake.set()
        try:
            while True:
                out = await queue.get()
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

    def _drop(self, seq: SchedSeq) -> None:
        if seq.status != SeqStatus.FINISHED:
            self.scheduler.abort(seq, "cancelled")
        self._queues.pop(seq.seq_id, None)
        self._seqs.pop(seq.seq_id, None)

    # --------------------- AsyncEngine (wire) --------------------------

    async def generate(self, request: Any,
                       context: Context) -> AsyncIterator[dict]:
        """Wire-format adapter: dict in, dict stream out."""
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
        )

        async def _on_stop() -> None:
            await context.wait_stopped()
            self.abort(req.request_id,
                       "killed" if context.is_killed() else "cancelled")

        watcher = asyncio.create_task(_on_stop())
        try:
            async for out in self.submit(req):
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

    # ------------------------- step loop -------------------------------

    async def _execute_batch_async(self, batch) -> Tuple[List[int],
                                                          List[List[int]]]:
        """Execute one scheduled batch; returns (prefill, decode) samples."""
        raise NotImplementedError

    async def _run_loop(self) -> None:
        """The synchronous loop: schedule → execute → postprocess."""
        while not self._stopped:
            batch = self.scheduler.schedule()
            self._mark_preempted_seats(batch)
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
                self._wake.clear()
                if self._stopped:
                    return
                await self._wake.wait()
                continue
            try:
                results = await self._execute_batch_async(batch)
            except Exception:
                log.exception("engine step failed; aborting scheduled seqs")
                self._abort_batch(batch)
                continue
            try:
                self._postprocess(batch, results)
            except Exception:
                # bookkeeping must never kill the step loop — every queued
                # request would hang forever
                log.exception("postprocess failed")
            self._flush_kv_events()

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

    def _mark_preempted_seats(self, batch) -> None:
        """A preempted seq's blocks were just released — its device seat
        must die before they recycle (the kill rides the next dispatch,
        which in stream order precedes any reuse)."""
        for seq in batch.preempted:
            if seq.preempted_slot >= 0:
                self._ap_mark_dead(seq.preempted_slot)
                seq.preempted_slot = -1

    def _postprocess(self, batch, results) -> None:
        """Apply step results. Decode samples are per-seq token WINDOWS
        (length >= 1); tokens after a mid-window finish are discarded."""
        prefill_samples, decode_samples = results
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
    windows over a paged KV cache on ``device``, run from one executor
    thread so the event loop never blocks on the device.

    ``device`` defaults to ``cuda``; with no GPU present and no device
    given, construction raises (pass ``device="cpu"`` to run on the CPU).
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
        super().__init__(engine_config)
        self.model_config = model_config
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init_params(gen, model_config)
        # quantize at init; a tree quantized beforehand passes unchanged
        self.params = quant.quantize_params(params,
                                            engine_config.weight_dtype)
        self.cache = model_lib.init_cache(model_config, engine_config,
                                          self.device)
        # packed prefill + autopilot decode windows running on
        # device-resident control state
        self._window_K = max(1, engine_config.decode_steps)
        self._ap_Wcap = engine_config.max_blocks_per_seq
        self._ap_window_fn = model_lib.raw_autopilot_window_fn(
            model_config, engine_config, self._window_K)
        self._ap_delta_fn = model_lib.raw_ctl_delta_fn(self._ap_Wcap)
        self._ctl = model_lib.init_ctl(
            engine_config, engine_config.max_num_seqs, self._ap_Wcap,
            self.device, seed=seed + 2,
        )
        self._packed_prefill_fns: Dict[Tuple[int, int], Any] = {}
        # dispatch counters
        self.num_windows = 0
        self.num_prefill_dispatches = 0
        # host mirror of per-slot device state + seat map
        self._ap: Dict[int, Dict[str, Any]] = {}
        self._ap_cols: List[int] = []       # device slot_rows content
        self._ap_rows_dev: Optional[torch.Tensor] = None
        self._ap_dead: set = set()          # slots to kill next dispatch
        # step keys for prefills come from this generator, on the device
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # the one device-step thread, made at the first batch after start
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def _shutdown_executor(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def _ap_mark_dead(self, slot: int) -> None:
        if slot >= 0 and (slot in self._ap or slot in self._ap_cols):
            self._ap_dead.add(slot)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host→device copy, asynchronous from pinned memory on a
        card (a pageable copy could wait for the stream to drain)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # --------------------- device execution ----------------------------

    async def _execute_batch_async(self, batch):
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-step"
            )
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor, self._execute_batch, batch
        )

    def _execute_batch(self, batch):
        """Executor thread: dispatch every step of the batch, then fetch its
        sampled tokens with one host sync."""
        return self._fetch_results(batch, self._dispatch_batch(batch))

    def _dispatch_batch(self, batch):
        """Build inputs + enqueue every device call for this batch. NO host
        sync in here. Seat kills flush FIRST so the in-order stream applies
        them before any work that could touch reused blocks."""
        self._ap_flush_kills()
        prefill_handles = [self._dispatch_prefill(c) for c in batch.prefills]
        decode_handle = (
            self._dispatch_decode(batch.decode_rows)
            if batch.decode_rows else None
        )
        return prefill_handles, decode_handle

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

    @hot_path
    def _fetch_results(self, batch, handles):
        """The designed host sync: one device→host copy of every sampled
        token of the batch, unpacked per seat."""
        prefill_handles, decode_handle = handles
        to_get = list(prefill_handles)
        if decode_handle is not None:
            to_get.append(decode_handle[0])
        got: List[np.ndarray] = []
        if to_get:
            flat = torch.cat([t.reshape(-1) for t in to_get]).cpu().numpy()
            off = 0
            for t in to_get:
                got.append(flat[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
        return self._unpack_results(batch, handles, got)

    @hot_path
    def _unpack_results(self, batch, handles, got):
        """Map fetched arrays back to per-seat sample lists. Decode sample
        columns follow the device seat map captured at dispatch, which may
        order (and pad) differently than the batch's row list."""
        prefill_handles, decode_handle = handles
        prefill_samples = [int(g[0]) for g in got[:len(prefill_handles)]]
        decode_samples: List[List[int]] = []
        if decode_handle is not None:
            col_of: Dict[int, int] = {}
            for col, slot in enumerate(decode_handle[1]):
                col_of.setdefault(slot, col)
            out = got[-1]  # [K, B]
            for row in batch.decode_rows:
                col = col_of[row.slot]
                decode_samples.append([
                    int(out[k, col])
                    for k in range(min(row.accepted, out.shape[0]))
                ])
        return prefill_samples, decode_samples

    def _next_key(self) -> torch.Tensor:
        """A fresh step key on the device (no host sync)."""
        return torch.randint(0, 1 << 31, (), generator=self._gen,
                             device=self.device, dtype=torch.int64)

    def _prefill_arrays(self, chunk: PrefillChunk):
        cfg = self.config
        seq = chunk.seq
        if chunk.length <= max(cfg.prefill_buckets):
            T = _bucket(chunk.length, cfg.prefill_buckets)
        else:
            T = _pow2_bucket(chunk.length)
        # only the blocks this chunk can touch: W is a function of the
        # chunk shape alone
        bs = cfg.block_size
        nb = min((chunk.start + chunk.length + bs - 1) // bs,
                 len(seq.block_table))
        W = _pow2_bucket(nb, cfg.max_blocks_per_seq)
        tokens = np.zeros((T,), np.int32)
        tokens[:chunk.length] = seq.all_tokens()[
            chunk.start:chunk.start + chunk.length
        ]
        tables = np.zeros((W,), np.int32)
        tables[:nb] = seq.block_table[:nb]
        return tokens, tables

    @hot_path
    def _dispatch_prefill(self, chunk: PrefillChunk):
        """Enqueue one prefill chunk; returns the sampled handle [1]
        (garbage unless ``chunk.final``). Every int input rides ONE
        host→device copy. No host sync."""
        cfg = self.config
        seq = chunk.seq
        self.num_prefill_dispatches += 1
        tokens, tables = self._prefill_arrays(chunk)
        T, W = tokens.shape[0], tables.shape[0]
        fn = self._packed_prefill_fns.get((T, W))
        if fn is None:
            fn = model_lib.raw_packed_prefill_fn(
                self.model_config, cfg, T, W)
            self._packed_prefill_fns[(T, W)] = fn
        slot = seq.slot if seq.slot >= 0 else cfg.max_num_seqs
        pint = np.zeros((1, T + W + model_lib.PP_SCALARS), np.int32)
        pint[0, :T] = tokens
        pint[0, T:T + W] = tables
        pint[0, T + W:] = (
            chunk.length, chunk.start, slot, 1 if chunk.final else 0,
            seq.top_k, seq.seed,
            int(round(seq.temperature * model_lib.PP_QUANT)),
            int(round(seq.top_p * model_lib.PP_QUANT)),
        )
        # the prefill posts its sample into ctl["last_tok"] in place
        self.cache, _, sampled = fn(
            self.params, self.cache, self._ctl["last_tok"],
            self._upload(pint), self._next_key(), seq.temperature > 0.0,
        )
        return sampled

    @hot_path
    def _ap_apply_deltas(self, deltas: Dict[int, Dict[str, Any]]) -> None:
        """Pack + enqueue one control-state delta call (two host→device
        copies in all)."""
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
        self._ctl = self._ap_delta_fn(self._ctl, self._upload(di),
                                      self._upload(df))

    @hot_path
    def _dispatch_decode(self, rows):
        """Enqueue one autopilot decode window. Steady state (same seats,
        no growth) dispatches with ZERO fresh host tensors — all control
        state is device-resident; the host sends packed deltas only on
        joins, block growth, resumes, and seat-map changes. Returns
        (samples_handle [K, B], col_map) where col_map[device column] is the
        slot computed there."""
        cfg = self.config
        bs = cfg.block_size
        K = self._window_K
        deltas: Dict[int, Dict[str, Any]] = {}
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
        # seat map: reuse the device map only when the LIVE seats it holds
        # are exactly the scheduled set. A LIVE slot the scheduler skipped
        # this round must not keep its column — the window would advance
        # its device pos/ring token behind the host mirror's back.
        needed = [r.slot for r in rows]
        B = _bucket(len(needed), cfg.decode_buckets)
        live = {s for s in self._ap_cols if s in self._ap}
        if (self._ap_rows_dev is None or len(self._ap_cols) != B
                or live != set(needed)):
            cols = needed + [cfg.max_num_seqs] * (B - len(needed))
            self._ap_cols = cols
            self._ap_rows_dev = self._upload(np.asarray(cols, np.int32))
        self.num_windows += 1
        stochastic = any(r.seq.temperature > 0.0 for r in rows)
        self.cache, self._ctl, samples = self._ap_window_fn(
            self.params, self.cache, self._ctl, self._ap_rows_dev,
            stochastic,
        )
        return samples, list(self._ap_cols)
