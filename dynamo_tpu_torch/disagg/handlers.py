"""Decode/prefill worker handlers for disaggregated serving
(ref: components/backends/vllm/src/dynamo/vllm/handlers.py:89 Decode, :207
Prefill; conditional thresholds ref: lib/llm/src/disagg_router.rs:230).

Flow (decode-orchestrated, matching the reference):

  DecodeHandler.generate(request)
    ├─ below threshold / no prefill workers / pool full → local engine path
    ├─ reserve blocks on the decode engine (epoch-stamped)
    ├─ push prefill request to a prefill worker (round-robin), carrying
    │  kv_transfer params {addr, request_id, epoch, deadline} — our
    │  kv_inject ingress addr
    ├─ PrefillHandler: engine.prefill_held → extract_kv → push blocks to
    │  decode's kv_inject endpoint → respond {token_id}
    ├─ inject arrives concurrently; decode awaits its completion event
    └─ engine.resume_prefilled(seq, first_token) → decode stream

The prefill worker *pushes* KV into pre-allocated decode blocks (the NIXL
write direction); bulk bytes ride the TCP transport's binary frames while
control messages carry only block metadata.

Fault model (see README "Operations"):

- every reservation carries an epoch; both the device-plane scatter and
  the wire-relay inject validate epoch-before-write, so a delayed
  transfer aimed at a recycled reservation is rejected, never scattered;
- relay frames are integrity-checked (``protocol.KvIntegrityError``) —
  corrupt/truncated payloads are rejected and retried, not injected;
- the push is retried with exponential backoff inside the request's
  remaining deadline budget; per-prefill-worker failures feed circuit
  breakers, and repeated handoff failures flip the decode handler to
  local-prefill for a cooldown window (DynaServe-style unified fallback);
- orphan sweepers reap deadline-expired pending handoffs and held
  prefill sequences so a crashed peer never pins KV blocks forever.

Injectable fault sites: ``disagg.prefill``, ``disagg.transfer``,
``disagg.inject`` (see runtime/faults.py).

A copy of ``dynamo_tpu.disagg.handlers`` on this package's engine, codec
(``runtime/codec.py`` where the JAX module packs with msgpack), breaker
(``runtime/circuit.py``) and transport, so a JAX prefill worker can feed a
port decode worker and the reverse: the control messages, the queue items
and the relay frames are the same bytes.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional

import uuid

from ..engine.engine import EngineCore, InferenceEngine, Request
from ..runtime import codec, faults
from ..runtime.circuit import (
    OPEN, BreakerConfig, CircuitBreaker, CircuitBreakerRegistry,
)
from ..runtime.component import Client
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..tracing import get_tracer, trace_span
from ..utils.logging import TraceContext, get_logger
from .ici import DevicePlane, StaleEpochError, default_plane, multi_rank
from .protocol import KvIntegrityError, kv_from_wire, kv_to_wire

log = get_logger("disagg")


class PermanentHandoffError(RuntimeError):
    """The decode side rejected the handoff for good (stale epoch, unknown
    request) — retrying the push cannot succeed."""


@dataclass
class DisaggConfig:
    """Conditional-disagg thresholds (ref: disagg_router.rs:230 — remote
    prefill only when the *new* work is long enough to be worth the
    transfer) plus the handoff fault-tolerance knobs.

    Every ``*_s``/retry/breaker field is plumbed from ``RuntimeConfig``
    (``DYNTPU_DISAGG_*`` env) via :meth:`from_runtime`."""

    min_remote_prefill_tokens: int = 32
    # refuse remote prefill when the decode pool is above this usage
    max_reserve_usage: float = 0.95
    # queue mode (ref: the JetStream pull-queue "Prefill Queue" in
    # docs/architecture/disagg_serving.md; nats.rs:426): decode workers
    # q_push prefill work onto the store work queue and prefill workers
    # q_pop it — slow prefill workers naturally take fewer items than fast
    # ones, and the queue depth is a direct backlog signal for the planner.
    # False = direct round-robin push (the legacy/fallback path).
    use_queue: bool = False
    queue_name: str = "prefill_queue"
    # how long decode waits for the queued prefill before falling back to
    # a local prefill
    queue_wait_s: float = 60.0
    # total wall budget for one handoff (reserve → inject complete); the
    # request's own remaining deadline caps it further
    handoff_timeout_s: float = 120.0
    # extra wait granted when a device-plane transfer is already mid-write
    # into our reserved blocks at timeout (freeing them would corrupt)
    inflight_grace_s: float = 30.0
    # per-attempt cap on one KV push (device transfer or relay inject ack)
    inject_timeout_s: float = 10.0
    # transfer retries after the first attempt, exponential backoff,
    # always bounded by the remaining handoff deadline
    transfer_max_retries: int = 2
    retry_backoff_base_s: float = 0.05
    # handoff-failure breaker: this many consecutive remote-prefill
    # failures flip the decode handler to local prefill for the cooldown
    breaker_failure_threshold: int = 3
    breaker_cooldown_s: float = 10.0
    # orphan GC cadence and how far past its deadline an entry must be
    orphan_sweep_interval_s: float = 5.0
    orphan_grace_s: float = 5.0

    @classmethod
    def from_runtime(cls, rc, **overrides) -> "DisaggConfig":
        """Build from a ``RuntimeConfig`` (``DYNTPU_DISAGG_*`` env knobs),
        with explicit keyword overrides winning."""
        cfg = cls(
            queue_wait_s=rc.disagg_queue_wait_s,
            handoff_timeout_s=rc.disagg_handoff_timeout_s,
            inflight_grace_s=rc.disagg_inflight_grace_s,
            inject_timeout_s=rc.disagg_inject_timeout_s,
            transfer_max_retries=rc.disagg_transfer_max_retries,
            retry_backoff_base_s=rc.disagg_retry_backoff_base_s,
            breaker_failure_threshold=rc.disagg_breaker_failure_threshold,
            breaker_cooldown_s=rc.disagg_breaker_cooldown_s,
            orphan_sweep_interval_s=rc.disagg_orphan_sweep_interval_s,
            orphan_grace_s=rc.disagg_orphan_grace_s,
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    def breaker_config(self) -> BreakerConfig:
        return BreakerConfig(
            failure_threshold=self.breaker_failure_threshold,
            open_timeout_s=self.breaker_cooldown_s,
        )


@dataclass
class PendingHandoff:
    """Decode-side state of one in-flight handoff."""

    seq: Any
    done: asyncio.Future
    epoch: int
    # monotonic instant after which the orphan sweeper may reap this entry
    deadline: float


class PrefillHandler(AsyncEngine):
    """Prefill worker: bounded prefill + KV push-back
    (ref: handlers.py:207 PrefillWorkerHandler)."""

    def __init__(self, engine: InferenceEngine,
                 plane: Optional[DevicePlane] = None,
                 config: Optional[DisaggConfig] = None):
        self.engine = engine
        self.plane = plane if plane is not None else default_plane
        self.config = config or DisaggConfig()
        self.num_device_transfers = 0
        self.num_relay_transfers = 0
        self.num_transfer_retries = 0
        self.num_orphans_reaped = 0
        # rid -> (held seq, monotonic reap deadline): KV awaiting push;
        # the orphan sweeper releases entries whose decode peer vanished
        self._held: Dict[str, tuple] = {}
        self._sweep_task: Optional[asyncio.Task] = None

    def metrics_extra(self) -> dict:
        """Merged into the worker's load-metrics snapshot."""
        return {"disagg": {
            "transfer_retries_total": float(self.num_transfer_retries),
            "orphans_reaped_total": float(self.num_orphans_reaped),
        }}

    # ----------------------- orphan GC ---------------------------------

    def start_orphan_sweeper(self) -> None:
        if self._sweep_task is None:
            from ..runtime.tasks import spawn_logged

            self._sweep_task = spawn_logged(
                self._sweep_loop(), name="disagg-prefill-sweep"
            )

    def close(self) -> None:
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.orphan_sweep_interval_s)
            self.sweep_orphans()

    def sweep_orphans(self) -> int:
        """Release held sequences whose handoff deadline long passed —
        the decode peer crashed or gave up; its epoch guard makes a
        late write impossible anyway, so pinning the blocks helps nobody."""
        now = time.monotonic()
        reaped = 0
        for rid, (seq, deadline) in list(self._held.items()):
            if now <= deadline + self.config.orphan_grace_s:
                continue
            if self._held.pop(rid, None) is None:
                continue
            self.engine.release_held(seq)
            self.num_orphans_reaped += 1
            reaped += 1
            log.warning("reaped orphaned held prefill %s", rid)
        return reaped

    # ----------------------- handoff -----------------------------------

    async def _still_pending(self, xfer: Dict[str, Any]) -> bool:
        """Ask the decode worker whether the request is still waiting.

        The epoch guard (validated again inside the scatter) is what makes
        a stale write *impossible*; this query is the cheap early-out for
        queue items decode already gave up on, and it marks the request
        transfer-in-flight so decode's timeout path waits for completion
        instead of freeing blocks mid-transfer.
        """
        try:
            transport = self.engine_runtime_transport(None)
            async for ack in transport.generate(
                xfer["addr"],
                {"request_id": xfer["request_id"], "query": True},
                Context(),
            ):
                return bool(ack.get("ok"))
        except Exception:
            log.exception("liveness query to decode failed")
        return False

    async def execute(
        self, request: Dict[str, Any], *, include_token: bool
    ) -> int:
        """Run one bounded prefill and push its KV into the decode worker's
        reserved blocks. Returns the first sampled token; with
        ``include_token`` the token rides the inject payload (queue mode has
        no response stream to carry it).

        The push is attempted up to ``1 + transfer_max_retries`` times with
        exponential backoff, each attempt capped by ``inject_timeout_s``
        and the whole loop by the handoff deadline the decode side stamped
        into the transfer params (wall clock — it crosses processes)."""
        xfer: Dict[str, Any] = request.get("kv_transfer") or {}
        rid = xfer.get("request_id") or f"prefill-{uuid.uuid4().hex}"
        rule = await faults.maybe_delay(faults.active("disagg.prefill", rid))
        if rule is not None and rule.kind != faults.DELAY:
            raise RuntimeError(
                f"injected disagg.prefill fault ({rule.kind})"
            )
        deadline = xfer.get("deadline")  # wall clock, stamped by decode

        def _remaining() -> Optional[float]:
            return None if deadline is None else float(deadline) - time.time()

        trace = None
        if xfer.get("traceparent"):
            trace = TraceContext.parse(xfer["traceparent"])
        span_ctx = Context(request_id=rid, trace=trace)

        req = Request(
            request_id=rid,
            token_ids=list(request["token_ids"]),
            max_tokens=1,
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0) or 1.0),
            seed=request.get("seed"),
        )
        with trace_span("disagg.prefill", span_ctx,
                        attrs={"request_id": rid,
                               "prompt_tokens": len(req.token_ids)}):
            seq, first_token = await self.engine.prefill_held(req)
        hold_budget = _remaining()
        if hold_budget is None or hold_budget < 0:
            hold_budget = self.config.handoff_timeout_s
        self._held[rid] = (seq, time.monotonic() + hold_budget)
        try:
            # a multi-rank prefill engine never gathers on the device
            # plane: its extract brings every rank in (the relay path)
            dst_engine = (None if multi_rank(self.engine)
                          else self.plane.get(xfer.get("plane_id")))
            dst_ids = list(xfer.get("block_ids") or [])
            use_device = dst_engine is not None and bool(dst_ids)
            if (use_device and include_token
                    and not await self._still_pending(xfer)):
                # queue mode: the item may be stale (decode gave up and its
                # reserved blocks were recycled) — don't bother prefetching
                # a transfer the epoch guard would reject anyway
                raise PermanentHandoffError(
                    "decode no longer waiting — dropping item"
                )
            if use_device and len(seq.block_table) < len(dst_ids):
                raise PermanentHandoffError(
                    f"held {len(seq.block_table)} blocks < "
                    f"{len(dst_ids)} reserved"
                )
            data = None
            if not use_device:
                data = await self.engine.extract_kv(seq)
            await self._push_with_retry(
                xfer, rid, seq, dst_engine if use_device else None, dst_ids,
                data, first_token, include_token, _remaining, span_ctx,
            )
            if use_device:
                self.num_device_transfers += 1
            else:
                self.num_relay_transfers += 1
        finally:
            if self._held.pop(rid, None) is not None:
                self.engine.release_held(seq)
        return first_token

    async def _push_with_retry(
        self, xfer, rid, seq, dst_engine, dst_ids, data, first_token,
        include_token, remaining, span_ctx,
    ) -> None:
        attempts = 1 + max(0, self.config.transfer_max_retries)
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt:
                self.num_transfer_retries += 1
                backoff = self.config.retry_backoff_base_s * (
                    2 ** (attempt - 1)
                )
                rem = remaining()
                if rem is not None:
                    if rem <= 0:
                        break
                    backoff = min(backoff, rem)
                await asyncio.sleep(backoff)
            timeout = self.config.inject_timeout_s
            rem = remaining()
            if rem is not None:
                if rem <= 0:
                    break
                timeout = min(timeout, rem)
            try:
                with trace_span(
                    "disagg.transfer", span_ctx,
                    attrs={"request_id": rid, "attempt": attempt,
                           "path": "device" if dst_engine else "relay"},
                ):
                    await self._push_once(
                        xfer, rid, seq, dst_engine, dst_ids, data,
                        first_token, include_token, timeout,
                    )
                return
            except (StaleEpochError, PermanentHandoffError):
                raise
            except Exception as exc:
                last_exc = exc
                log.warning("kv push attempt %d/%d for %s failed: %r",
                            attempt + 1, attempts, rid, exc)
        raise last_exc if last_exc is not None else TimeoutError(
            f"handoff deadline exhausted for {rid}"
        )

    async def _push_once(
        self, xfer, rid, seq, dst_engine, dst_ids, data, first_token,
        include_token, timeout,
    ) -> None:
        rule = await faults.maybe_delay(faults.active("disagg.transfer", rid))
        corrupt = rule is not None and rule.kind == faults.TRUNCATE
        if rule is not None and rule.kind not in (faults.DELAY,
                                                  faults.TRUNCATE):
            raise RuntimeError(
                f"injected disagg.transfer fault ({rule.kind})"
            )
        epoch = xfer.get("epoch")
        if dst_engine is not None:
            if corrupt:
                # device transfers are atomic (one scatter) — a truncation
                # can only manifest as a failed attempt
                raise RuntimeError("injected disagg.transfer truncate")
            await asyncio.wait_for(
                self.plane.transfer(
                    self.engine, list(seq.block_table)[: len(dst_ids)],
                    dst_engine, dst_ids,
                    dst_seq_id=rid, dst_epoch=epoch,
                ),
                timeout=timeout,
            )
            payload: Dict[str, Any] = {"device_done": True}
        else:
            payload = kv_to_wire(data)
            if corrupt:
                # chop the frame mid-tensor: the decode-side integrity
                # check must reject it before anything touches the cache
                payload["k"] = payload["k"][: len(payload["k"]) // 2]
        payload["request_id"] = rid
        if epoch is not None:
            payload["epoch"] = epoch
        if include_token:
            payload["first_token"] = first_token
        transport = self.engine_runtime_transport(None)

        async def _push() -> None:
            async for ack in transport.generate(
                xfer["addr"], payload, Context()
            ):
                if not ack.get("ok", False):
                    if ack.get("permanent"):
                        raise PermanentHandoffError(
                            f"kv inject rejected: {ack}"
                        )
                    raise RuntimeError(f"kv inject rejected: {ack}")

        await asyncio.wait_for(_push(), timeout=timeout)

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[dict]:
        request = dict(request)
        xfer = dict(request.get("kv_transfer") or {})
        xfer.setdefault("request_id", context.id)
        request["kv_transfer"] = xfer
        first_token = await self.execute(request, include_token=False)
        yield {"token_ids": [first_token], "finished": True,
               "finish_reason": "remote_prefill"}

    # seam for tests / runtime injection
    def engine_runtime_transport(self, context: Optional[Context]):
        from ..runtime.transport import TransportClient

        if not hasattr(self, "_transport"):
            self._transport = TransportClient()
        return self._transport


class PrefillQueueWorker:
    """Pull-mode prefill consumer (ref: the JetStream prefill queue,
    lib/runtime/src/transports/nats.rs:426): pops work items from the store
    work queue and executes them via :class:`PrefillHandler`. A worker only
    takes what it can chew (``max_inflight``), so heterogeneous prefill
    workers self-balance and the queue length is the backlog signal.
    On failure it reports the error to the decode worker's inject endpoint
    so decode falls back to local prefill immediately instead of timing
    out."""

    def __init__(self, handler: PrefillHandler, store,
                 queue_name: str = "prefill_queue", max_inflight: int = 2):
        self.handler = handler
        self.store = store
        self.queue_name = queue_name
        self.max_inflight = max_inflight
        self.num_pulled = 0
        self.num_failed = 0
        self.num_expired = 0
        self._task: Optional[asyncio.Task] = None
        self._inflight: set = set()

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._pull_loop())

    async def stop(self) -> None:
        tasks: List[asyncio.Task] = list(self._inflight)
        if self._task is not None:
            tasks.append(self._task)
            self._task = None
        for t in tasks:
            t.cancel()
        if tasks:
            # await the cancellations: leaving them mid-flight leaks tasks
            # and races test teardown (a cancelled _run_one may still be
            # touching the engine)
            await asyncio.gather(*tasks, return_exceptions=True)
        self._inflight.clear()

    async def _pull_loop(self) -> None:
        sem = asyncio.Semaphore(self.max_inflight)
        while True:
            await sem.acquire()
            try:
                raw = await self.store.q_pop(self.queue_name, timeout_s=30.0)
            except Exception:
                sem.release()
                log.exception("prefill queue pop failed — retrying")
                await asyncio.sleep(0.5)
                continue
            if raw is None:
                sem.release()
                continue
            try:
                item = codec.unpackb(raw)
            except Exception:
                sem.release()
                log.exception("bad prefill queue item — dropping")
                continue
            deadline = item.get("queue_deadline")
            if deadline is not None and time.time() > float(deadline):
                # decode already gave up on this item — don't prefill into
                # block ids that may have been recycled
                sem.release()
                self.num_expired += 1
                log.warning("dropping expired prefill item %s",
                            (item.get("kv_transfer") or {}).get("request_id"))
                continue
            task = asyncio.create_task(self._run_one(item, sem))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    async def _run_one(self, item: dict, sem: asyncio.Semaphore) -> None:
        try:
            self.num_pulled += 1
            await self.handler.execute(item, include_token=True)
        except Exception as exc:
            self.num_failed += 1
            log.exception("queued prefill failed — notifying decode")
            await self._report_failure(item, exc)
        finally:
            sem.release()

    async def _report_failure(self, item: dict, exc: Exception) -> None:
        xfer = item.get("kv_transfer") or {}
        addr, rid = xfer.get("addr"), xfer.get("request_id")
        if not addr or not rid:
            return
        try:
            transport = self.handler.engine_runtime_transport(None)
            async for _ in transport.generate(
                addr, {"request_id": rid, "error": str(exc)}, Context()
            ):
                break
        except Exception:
            log.exception("failure report to decode failed")


class KvInjectHandler(AsyncEngine):
    """Decode-worker ingress for pushed KV blocks: verifies the frame's
    epoch + integrity envelope, scatters the payload into the reserved
    sequence's blocks, and signals the waiting decode handler. Rejections
    are answered, never raised — the prefill side decides whether the
    failure is retryable (``permanent`` flag)."""

    def __init__(self, decode: "DecodeHandler"):
        self.decode = decode

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[dict]:
        rid = request["request_id"]
        rule = await faults.maybe_delay(faults.active("disagg.inject", rid))
        if rule is not None and rule.kind != faults.DELAY:
            yield {"ok": False,
                   "error": f"injected disagg.inject fault ({rule.kind})"}
            return
        pending = self.decode.pending.get(rid)
        if pending is None:
            yield {"ok": False, "error": f"unknown request {rid}",
                   "permanent": True}
            return
        epoch = request.get("epoch")
        if epoch is not None and (
            int(epoch) != pending.epoch
            or not self.decode.engine.reservation_valid(rid, int(epoch))
        ):
            # the reservation these bytes were aimed at no longer exists —
            # rejecting here (and again inside the scatter) is what turns
            # the recycled-block corruption race into a clean refusal
            self.decode.num_epoch_rejects += 1
            yield {"ok": False, "error": f"stale epoch {epoch} for {rid}",
                   "permanent": True}
            return
        if request.get("query"):
            # prefill worker asking "still waiting?" before a device-plane
            # write; marking in-flight makes decode's timeout path wait for
            # the transfer instead of freeing the target blocks under it
            self.decode.inflight.add(rid)
            yield {"ok": True}
            return
        if request.get("error"):
            # queue-mode prefill worker reporting failure: wake the waiting
            # decode handler so it falls back to local prefill immediately
            if not pending.done.done():
                pending.done.set_exception(RuntimeError(
                    f"remote prefill failed: {request['error']}"
                ))
            yield {"ok": True}
            return
        # queue mode has no response stream — the first token rides here
        result = request.get("first_token", True)
        if request.get("device_done"):
            # blocks already arrived over the device plane — this is just
            # the completion signal
            if not pending.done.done():
                pending.done.set_result(result)
            yield {"ok": True}
            return
        t0 = time.monotonic()
        try:
            data = kv_from_wire(request)
        except KvIntegrityError as exc:
            # corrupt/truncated frame: refuse before anything touches the
            # cache; the prefill side re-sends (per-attempt fault), so
            # this is retryable — the waiting decode future stays live
            self.decode.num_integrity_rejects += 1
            log.warning("rejecting corrupt KV frame for %s: %s", rid, exc)
            yield {"ok": False, "error": f"integrity: {exc}"}
            return
        try:
            await self.decode.engine.inject_kv(
                pending.seq, data,
                epoch=int(epoch) if epoch is not None else None,
            )
        except StaleEpochError as exc:
            self.decode.num_epoch_rejects += 1
            yield {"ok": False, "error": str(exc), "permanent": True}
            return
        except Exception as exc:
            if not pending.done.done():
                pending.done.set_exception(exc)
            yield {"ok": False, "error": str(exc), "permanent": True}
            return
        get_tracer().record(
            "disagg.inject", context, start_mono=t0,
            end_mono=time.monotonic(), attrs={"request_id": rid},
        )
        if not pending.done.done():
            pending.done.set_result(result)
        yield {"ok": True}


class DecodeHandler(AsyncEngine):
    """Decode worker: conditional remote prefill + resume
    (ref: handlers.py:89 DecodeWorkerHandler)."""

    def __init__(
        self,
        engine: InferenceEngine,
        prefill_client: Optional[Client] = None,
        config: Optional[DisaggConfig] = None,
        plane: Optional[DevicePlane] = None,
        store=None,
    ):
        self.engine = engine
        self.prefill_client = prefill_client
        self.config = config or DisaggConfig()
        self.store = store  # required for queue mode (use_queue)
        self.pending: Dict[str, PendingHandoff] = {}
        # request ids with a device-plane transfer in flight (the prefill
        # worker's liveness query marks these; our timeout path then grants
        # a grace period instead of freeing blocks mid-write)
        self.inflight: set = set()
        self._depth_task: Optional[asyncio.Task] = None
        self._sweep_task: Optional[asyncio.Task] = None
        self.kv_inject_addr: Optional[str] = None  # set after serving
        self.num_remote_prefills = 0
        self.num_local_prefills = 0
        self.num_fallbacks = 0
        self.num_epoch_rejects = 0
        self.num_integrity_rejects = 0
        self.num_orphans_reaped = 0
        # handoff-failure breaker: OPEN = unified-fallback cooldown, all
        # prefills run locally until the window passes (DynaServe-style)
        self.fallback_breaker = CircuitBreaker(self.config.breaker_config())
        # per-prefill-worker breakers (push mode): a flapping worker is
        # skipped by the round-robin pick while its breaker is open
        self.prefill_breakers = CircuitBreakerRegistry(
            self.config.breaker_config()
        )
        self._rr = 0
        # backlog signal for the planner, refreshed on every enqueue
        # (published via WorkerMetricsPublisher extra_fn)
        self.last_queue_depth = 0
        # advertise this engine on the device plane so a same-process
        # prefill worker transfers KV device-to-device instead of relaying
        self.plane = plane if plane is not None else default_plane
        self.plane_id: Optional[str] = None
        # device engines of one rank only: a multi-rank engine's inject
        # must bring every rank in, so its KV arrives by the relay
        if hasattr(engine, "cache") and not multi_rank(engine):
            self.plane_id = uuid.uuid4().hex
            self.plane.register(self.plane_id, engine)

    def close(self) -> None:
        """Drop the device-plane registration (the registry would otherwise
        pin the engine — and its KV cache — for the process lifetime)."""
        if self.plane_id is not None:
            self.plane.unregister(self.plane_id)
            self.plane_id = None
        if self._depth_task is not None:
            self._depth_task.cancel()
            self._depth_task = None
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None

    def inject_handler(self) -> KvInjectHandler:
        return KvInjectHandler(self)

    def _should_remote_prefill(self, token_ids: list) -> bool:
        if self.kv_inject_addr is None:
            return False
        if not self.fallback_breaker.allow():
            # unified-fallback cooldown: recent handoffs kept failing, so
            # prefill locally until the breaker half-opens a probe slot
            return False
        if self.config.use_queue:
            if self.store is None:
                return False
            # with zero live prefill workers nobody will ever pop the
            # queue — go local immediately rather than stalling every
            # long prompt for queue_wait_s (the client is optional so
            # store-only test rigs still work)
            if (self.prefill_client is not None
                    and not self.prefill_client.instance_ids()):
                return False
        else:
            if (self.prefill_client is None
                    or not self.prefill_client.instance_ids()):
                return False
        if len(token_ids) < self.config.min_remote_prefill_tokens:
            return False
        if self.engine.stats.kv_usage > self.config.max_reserve_usage:
            return False
        return True

    def metrics_extra(self) -> dict:
        """Merged into the worker's load-metrics snapshot (planner input)."""
        return {
            "prefill_queue_depth": self.last_queue_depth,
            "disagg": {
                "fallback_total": float(self.num_fallbacks),
                "breaker_open": (
                    1.0 if self.fallback_breaker.state == OPEN else 0.0
                ),
                "orphans_reaped_total": float(self.num_orphans_reaped),
                "epoch_rejects_total": float(self.num_epoch_rejects),
            },
        }

    def start_depth_monitor(self, interval_s: float = 1.0) -> None:
        """Keep ``last_queue_depth`` fresh even when no pushes happen —
        a metric sampled only at enqueue time would report phantom backlog
        forever after a burst drains."""
        if self._depth_task is None and self.store is not None:
            self._depth_task = asyncio.create_task(
                self._depth_loop(interval_s)
            )

    async def _depth_loop(self, interval_s: float) -> None:
        while True:
            try:
                self.last_queue_depth = await self.store.q_len(
                    self.config.queue_name
                )
            except Exception:
                pass
            await asyncio.sleep(interval_s)

    # ----------------------- orphan GC ---------------------------------

    def start_orphan_sweeper(self) -> None:
        if self._sweep_task is None:
            from ..runtime.tasks import spawn_logged

            self._sweep_task = spawn_logged(
                self._sweep_loop(), name="disagg-decode-sweep"
            )

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.orphan_sweep_interval_s)
            self.sweep_orphans()

    def sweep_orphans(self) -> int:
        """Reap pending handoffs whose deadline long passed: wake the
        waiter (if any), and cancel the reservation iff its epoch is still
        live — a resumed or already-cancelled sequence is left alone."""
        now = time.monotonic()
        reaped = 0
        for rid, ph in list(self.pending.items()):
            grace = self.config.orphan_grace_s
            if rid in self.inflight:
                grace += self.config.inflight_grace_s
            if now <= ph.deadline + grace:
                continue
            if self.pending.pop(rid, None) is None:
                continue
            self.inflight.discard(rid)
            if not ph.done.done():
                ph.done.set_exception(
                    RuntimeError("handoff orphaned (deadline expired)")
                )
            ph.done.exception()  # mark retrieved if nobody is waiting
            if self.engine.reservation_valid(rid, ph.epoch):
                self.engine.cancel_reservation(ph.seq)
            self.num_orphans_reaped += 1
            reaped += 1
            log.warning("reaped orphaned handoff %s", rid)
        return reaped

    # ----------------------- generate ----------------------------------

    def _pick_prefill_worker(self) -> Optional[int]:
        """Round-robin over prefill instances whose breaker admits traffic
        (push mode). None = caller should use the client's own round_robin
        (test stubs without ``direct``/instance routing)."""
        client = self.prefill_client
        if client is None or not hasattr(client, "direct"):
            return None
        try:
            ids = list(client.instance_ids())
        except Exception:
            return None
        if not ids:
            return None
        allowed = [i for i in ids if self.prefill_breakers.allow(i)]
        # every breaker open: probe anyway rather than deadlocking disagg
        pool = allowed or ids
        self._rr += 1
        target = pool[self._rr % len(pool)]
        self.prefill_breakers.begin(target)
        return target

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[dict]:
        token_ids = list(request["token_ids"])
        if request.get("mm"):
            # multimodal prompts prefill locally: the remote prefill path
            # would need the embeddings shipped and spliced on the prefill
            # worker (future work); local keeps EPD correctness
            self.num_local_prefills += 1
            async for out in self.engine.generate(request, context):
                yield out
            return
        if not self._should_remote_prefill(token_ids):
            self.num_local_prefills += 1
            async for out in self.engine.generate(request, context):
                yield out
            return

        req = Request(
            request_id=context.id,
            token_ids=token_ids,
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0) or 1.0),
            seed=request.get("seed"),
            eos_token_ids=tuple(request.get("eos_token_ids", ())),
            ignore_eos=bool(request.get("ignore_eos", False)),
        )
        seq = self.engine.reserve_sequence(req)
        if seq is None:  # pool can't host it — prefill locally instead
            self.num_local_prefills += 1
            async for out in self.engine.generate(request, context):
                yield out
            return

        # the handoff budget: config cap, tightened by the request's own
        # remaining deadline (deadline propagation) when one is set
        budget = self.config.handoff_timeout_s
        rem = context.time_remaining()
        if rem is not None:
            budget = max(0.0, min(budget, rem))
        t0 = time.monotonic()
        done: asyncio.Future = asyncio.get_running_loop().create_future()
        self.pending[context.id] = PendingHandoff(
            seq=seq, done=done, epoch=seq.kv_epoch, deadline=t0 + budget,
        )
        self.fallback_breaker.begin()
        target: Optional[int] = None
        try:
            xfer = {
                "request_id": context.id,
                "addr": self.kv_inject_addr,
                "plane_id": self.plane_id,
                "block_ids": list(seq.block_table),
                "epoch": seq.kv_epoch,
                "deadline": time.time() + budget,
            }
            if context.trace is not None:
                xfer["traceparent"] = context.trace.traceparent()
            prefill_request = {
                "token_ids": token_ids,
                "temperature": req.temperature,
                "top_k": req.top_k,
                "top_p": req.top_p,
                "seed": req.seed,
                "kv_transfer": xfer,
            }
            first_token: Optional[int] = None
            if self.config.use_queue:
                # queue mode: enqueue and wait — the inject payload carries
                # the first token (or the failure) back to us
                wait_s = min(self.config.queue_wait_s, budget)
                prefill_request["queue_deadline"] = time.time() + wait_s
                await self.store.q_push(
                    self.config.queue_name, codec.packb(prefill_request)
                )
                try:
                    self.last_queue_depth = await self.store.q_len(
                        self.config.queue_name
                    )
                except Exception:
                    pass
                try:
                    result = await asyncio.wait_for(done, timeout=wait_s)
                except asyncio.TimeoutError:
                    if context.id not in self.inflight:
                        raise
                    # a device-plane transfer is mid-write into our
                    # reserved blocks — freeing them now would hand
                    # corrupted blocks to the next request; grant a grace
                    # window for the transfer to land
                    result = await asyncio.wait_for(
                        done, timeout=self.config.inflight_grace_s
                    )
                # bool is an int subclass — require a real token id, not
                # the legacy True completion marker
                if type(result) is not int:
                    raise RuntimeError(
                        "queued prefill completed without a first token"
                    )
                first_token = result
            else:
                target = self._pick_prefill_worker()
                if target is not None:
                    stream = self.prefill_client.direct(
                        target, prefill_request, context
                    )
                else:
                    stream = self.prefill_client.round_robin(
                        prefill_request, context
                    )
                async for item in stream:
                    first_token = item["token_ids"][0]
                if first_token is None:
                    raise RuntimeError("prefill worker returned no token")
                wait_s = max(0.05, budget - (time.monotonic() - t0))
                try:
                    await asyncio.wait_for(done, timeout=wait_s)
                except asyncio.TimeoutError:
                    if context.id not in self.inflight:
                        raise
                    await asyncio.wait_for(
                        done, timeout=self.config.inflight_grace_s
                    )
            self.num_remote_prefills += 1
            self.fallback_breaker.record_success()
            if target is not None:
                self.prefill_breakers.record_success(target)
            get_tracer().record(
                "disagg.handoff", context, start_mono=t0,
                end_mono=time.monotonic(),
                attrs={"request_id": context.id,
                       "prompt_tokens": len(token_ids),
                       "epoch": seq.kv_epoch},
            )
            log.debug("remote prefill complete: %s (%d tokens)",
                      context.id, len(token_ids))
        except asyncio.CancelledError:
            # client went away mid-handoff: free the reservation (the
            # epoch guard rejects any transfer that lands later)
            self.engine.cancel_reservation(seq)
            raise
        except Exception:
            # remote prefill failed — fall back to local so the request
            # still completes (the Migration operator retries above us for
            # stream-level failures); the failure feeds the breakers
            log.exception("remote prefill failed — falling back to local")
            self.fallback_breaker.record_failure()
            if target is not None:
                self.prefill_breakers.record_failure(target)
            self.num_fallbacks += 1
            get_tracer().record(
                "disagg.handoff", context, start_mono=t0,
                end_mono=time.monotonic(), status="error",
                status_detail="fallback_local",
                attrs={"request_id": context.id},
            )
            self.engine.cancel_reservation(seq)
            self.pending.pop(context.id, None)
            self.inflight.discard(context.id)
            self.num_local_prefills += 1
            async for out in self.engine.generate(request, context):
                yield out
            return
        finally:
            self.pending.pop(context.id, None)
            self.inflight.discard(context.id)

        async def _on_stop() -> None:
            await context.wait_stopped()
            self.engine.abort(req.request_id,
                              "killed" if context.is_killed() else "cancelled")

        watcher = asyncio.create_task(_on_stop())
        try:
            async for out in self.engine.resume_prefilled(seq, first_token):
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
            # engine path exhausted without a finished marker (abort):
            # nothing further to yield
        finally:
            watcher.cancel()
