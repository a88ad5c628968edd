"""The KV-aware router and its pipeline sink
(ref: lib/llm/src/kv_router.rs:185 ``KvRouter``, :423 ``KvPushRouter``).

``KvRouter`` owns the prefix indexer (event-fed, with the approximate
fallback), the potential-load tracker, and the event subscription; the
``KvPushRouter`` sink plugs into the LLM pipeline in place of the
round-robin ``PushSink`` and performs route → push → track → free.

A copy of ``dynamo_tpu.router.kv_router`` on this package's own codec
(``runtime/codec.py``, byte-equal to ``msgpack``) and hashes
(``tokens.py``, xxh3 as in the JAX package), so a router of either package
reads the events, load metrics, replica-sync messages and index snapshots
that processes of the other write.
"""

from __future__ import annotations

import asyncio
import random
import uuid
from typing import Any, AsyncIterator, Dict, Optional, Set

from ..runtime import codec
from ..runtime.circuit import CircuitBreakerRegistry
from ..runtime.component import Client, Component
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..runtime.transport import (
    EngineError, ERR_DRAINING, ERR_OVERLOADED, ERR_UNAVAILABLE,
)
from ..tracing import trace_span
from ..utils.logging import get_logger
from ..tokens import compute_block_hashes_for_seq
from ..prefix.radix import TIER_G1, TIER_G2, TIER_G4, RadixPrefixIndex
from .indexer import ApproxKvIndexer, KvIndexer, RouterEvent
from .scheduler import KvRouterConfig, PotentialLoads, Selection, select_worker

log = get_logger("kv_router")

KV_EVENTS_SUBJECT = "kv_events"         # ref: kv_router.rs:60
LOAD_METRICS_SUBJECT = "load_metrics"   # ref: kv_router.rs:57
# inter-replica routing lifecycle sync (ref: kv_router.rs:65-73
# prefill_events + active_sequences_events — one subject here, the event
# carries the lifecycle kind)
ROUTER_SYNC_SUBJECT = "router_sync"


class KvRouter:
    """Routing brain: indexer + scheduler + event subscription
    (ref: kv_router.rs:185).

    ``use_events=False`` selects the ApproxKvIndexer (approx.rs:165): the
    router then learns prefix placement from its own decisions only.
    """

    # class-level default so partially-constructed fakes stay
    # forward-compatible as routing collaborators are added
    prefix_index = None

    def __init__(
        self,
        client: Client,
        component: Component,
        block_size: int,
        config: Optional[KvRouterConfig] = None,
        use_events: bool = True,
        seed: Optional[int] = None,
        breakers: Optional[CircuitBreakerRegistry] = None,
    ):
        self.client = client
        self.component = component
        self.block_size = block_size
        self.config = config or KvRouterConfig()
        self.indexer = KvIndexer(block_size) if use_events else None
        self.approx = None if use_events else ApproxKvIndexer(block_size)
        # cluster replica of the radix prefix index (prefix.radix), fed by
        # the same KV-event stream: find_best_match scores workers by
        # longest cached prefix, tier-weighted, for prefix-bearing requests
        self.prefix_index = (
            RadixPrefixIndex(block_size, tier_weights={
                TIER_G1: 1.0,
                TIER_G2: self.config.prefix_tier_weight_g2,
                TIER_G4: self.config.prefix_tier_weight_g4,
            })
            if use_events and self.config.prefix_routing else None
        )
        self.loads = PotentialLoads(block_size)
        # per-worker circuit breakers: tripped workers are skipped during
        # selection until their half-open probe succeeds
        self.breakers = breakers or CircuitBreakerRegistry()
        # worker_id -> latest ForwardPassMetrics snapshot (kv_usage, queue
        # depths) from the load_metrics subject; drives busy-threshold
        # rejection (ref: push_router.rs:58-63)
        self.worker_stats: Dict[int, dict] = {}
        self._rng = random.Random(seed)
        self._sub_task: Optional[asyncio.Task] = None
        self._stats_task: Optional[asyncio.Task] = None
        self._stream = None
        self._stats_stream = None
        # replica sync (ref: kv_router.rs:65-73)
        self.router_id = uuid.uuid4().hex
        self._sync_out: "asyncio.Queue[dict]" = asyncio.Queue()
        self._sync_pub_task: Optional[asyncio.Task] = None
        self._sync_sub_task: Optional[asyncio.Task] = None
        self._sync_stream = None
        # request ids applied from each peer, so a lost subscription can
        # roll back exactly the load we attributed to that peer
        self._peer_requests: Dict[str, Set[str]] = {}
        self.num_peer_events = 0
        self._events_at_snapshot = 0
        self._snapshot_task: Optional[asyncio.Task] = None
        # workers that answered ``draining``: divert-elsewhere until their
        # instance key is deleted (drain completed) or re-put (re-advertised)
        self.draining: Set[int] = set()
        client.on_instance_removed.append(self._on_worker_removed)
        client.on_instance_added.append(self._on_worker_added)

    # -- lifecycle --

    async def start(self) -> None:
        store = self.client.runtime.store
        if self._stats_task is None:
            self._stats_stream = await store.subscribe(
                self.component.event_subject(LOAD_METRICS_SUBJECT)
            )
            self._stats_task = asyncio.create_task(
                self._stats_loop(self._stats_stream)
            )
        if self.config.replica_sync and self._sync_sub_task is None:
            self._sync_stream = await store.subscribe(
                self.component.event_subject(ROUTER_SYNC_SUBJECT)
            )
            self._sync_sub_task = asyncio.create_task(
                self._sync_loop(self._sync_stream)
            )
            self._sync_pub_task = asyncio.create_task(self._sync_publisher())
        if self.indexer is None or self._sub_task is not None:
            return
        # subscribe BEFORE loading the snapshot: events published while the
        # snapshot is read buffer in the watch stream and are consumed only
        # after the (older) snapshot is applied — so removals that race the
        # warm-start still land on top, in order
        self._stream = await store.subscribe(
            self.component.event_subject(KV_EVENTS_SUBJECT)
        )
        await self._load_snapshot()
        self._sub_task = asyncio.create_task(self._event_loop(self._stream))

    async def stop(self) -> None:
        if self._snapshot_task is not None:
            try:
                await self._snapshot_task
            except Exception:
                pass
            self._snapshot_task = None
        for task_attr, stream_attr in (
            ("_sub_task", "_stream"), ("_stats_task", "_stats_stream"),
            ("_sync_sub_task", "_sync_stream"),
            ("_sync_pub_task", None),
        ):
            task = getattr(self, task_attr)
            if task is not None:
                task.cancel()
                setattr(self, task_attr, None)
            stream = getattr(self, stream_attr) if stream_attr else None
            if stream is not None:
                try:
                    await stream.cancel()
                except Exception:
                    pass
                setattr(self, stream_attr, None)
        try:
            self.client.on_instance_removed.remove(self._on_worker_removed)
        except ValueError:
            pass
        try:
            self.client.on_instance_added.remove(self._on_worker_added)
        except ValueError:
            pass

    async def _resubscribe(self, subject: str):
        store = self.client.runtime.store
        attempt = 0
        while True:
            try:
                return await store.subscribe(subject)
            except Exception as exc:
                # traceback once; during a store outage this retries every
                # 0.5s per topic and repeating it would drown the log
                if attempt == 0:
                    log.exception("resubscribe %s failed — retrying", subject)
                else:
                    log.warning("resubscribe %s failed (attempt %d): %s",
                                subject, attempt + 1, exc)
                attempt += 1
                await asyncio.sleep(0.5)

    async def _event_loop(self, stream) -> None:
        subject = self.component.event_subject(KV_EVENTS_SUBJECT)
        while True:
            event = await stream.next()
            if event is None or event["event"] == "dropped":
                # the store unregisters a shed/closed subscription — our
                # index may have missed events, so drop all state and
                # resubscribe; routing decisions rebuild it organically
                log.warning("kv_events subscription lost — resetting index")
                for w in list(self.client.instances):
                    self.indexer.clear_worker(w)
                    if self.prefix_index is not None:
                        self.prefix_index.drop_worker(w)
                await stream.cancel()
                stream = self._stream = await self._resubscribe(subject)
                continue
            if event["event"] != "msg":
                continue
            try:
                payload = codec.unpackb(event["value"])
                ev = RouterEvent.from_dict(payload)
                self.indexer.apply_event(ev)
                if self.prefix_index is not None:
                    self.prefix_index.apply_event(
                        ev.worker_id, payload["event"])
                self._maybe_snapshot()
            except Exception:
                log.exception("bad kv event")

    async def _stats_loop(self, stream) -> None:
        subject = self.component.event_subject(LOAD_METRICS_SUBJECT)
        while True:
            event = await stream.next()
            if event is None or event["event"] == "dropped":
                await stream.cancel()
                stream = self._stats_stream = await self._resubscribe(subject)
                continue
            if event["event"] != "msg":
                continue
            try:
                snap = codec.unpackb(event["value"])
                self.worker_stats[int(snap["worker_id"])] = snap
            except Exception:
                log.exception("bad load metrics event")

    # -- replica sync (ref: kv_router.rs:65-73) --

    def _sync_emit(self, kind: str, request_id: str, worker_id: int = 0,
                   isl: int = 0, overlap: int = 0) -> None:
        if self.config.replica_sync:
            self._sync_out.put_nowait({
                "router_id": self.router_id, "kind": kind,
                "request_id": request_id, "worker_id": worker_id,
                "isl": isl, "overlap": overlap,
            })

    async def _sync_publisher(self) -> None:
        store = self.client.runtime.store
        subject = self.component.event_subject(ROUTER_SYNC_SUBJECT)
        while True:
            msg = await self._sync_out.get()
            try:
                await store.publish(subject, codec.packb(msg))
            except Exception:
                log.exception("router sync publish failed")

    async def _sync_loop(self, stream) -> None:
        subject = self.component.event_subject(ROUTER_SYNC_SUBJECT)
        while True:
            event = await stream.next()
            if event is None or event["event"] == "dropped":
                # we may have missed peer lifecycle events (including
                # frees) — roll back everything we attributed to peers so
                # load can't leak, then resubscribe
                log.warning("router_sync subscription lost — "
                            "dropping peer-attributed load")
                for rids in self._peer_requests.values():
                    for rid in rids:
                        self.loads.free(rid)
                self._peer_requests.clear()
                await stream.cancel()
                stream = self._sync_stream = await self._resubscribe(subject)
                continue
            if event["event"] != "msg":
                continue
            try:
                msg = codec.unpackb(event["value"])
                self._apply_peer_event(msg)
            except Exception:
                log.exception("bad router sync event")

    def _apply_peer_event(self, msg: dict) -> None:
        if msg.get("router_id") == self.router_id:
            return  # our own publication echoed back
        rid = msg["request_id"]
        kind = msg["kind"]
        peers = self._peer_requests.setdefault(msg["router_id"], set())
        self.num_peer_events += 1
        if kind == "add":
            peers.add(rid)
            self.loads.add(rid, int(msg["worker_id"]), int(msg["isl"]),
                           int(msg["overlap"]))
        elif kind == "prefill_done":
            self.loads.prefill_done(rid)
        elif kind == "free":
            peers.discard(rid)
            self.loads.free(rid)

    # -- index snapshot persistence (ref: kv_router.rs:979, indexer.rs:450) --

    def _snapshot_key(self) -> str:
        return f"v1/router/{self.component.path}/radix-snapshot"

    def _maybe_snapshot(self) -> None:
        thresh = self.config.snapshot_threshold
        if (not thresh or self.indexer is None
                or self._snapshot_task is not None):
            return
        if self.indexer.events_applied - self._events_at_snapshot < thresh:
            return
        self._events_at_snapshot = self.indexer.events_applied
        self._snapshot_task = asyncio.create_task(self._write_snapshot())

    async def _write_snapshot(self) -> None:
        """Persist the prefix index under a store lock so exactly one
        replica writes (ref: the etcd-locked radix-bucket writer)."""
        store = self.client.runtime.store
        lock_name = self._snapshot_key()
        try:
            if not await store.lock(lock_name):
                return  # a peer replica is writing — theirs is as good
            try:
                payload = codec.packb({
                    # str keys: msgpack's strict_map_key rejects int keys
                    "workers": {
                        str(w): sorted(hs)
                        for w, hs in self.indexer._hashes_of.items() if hs
                    },
                    "router_id": self.router_id,
                })
                await store.put(self._snapshot_key(), payload)
            finally:
                await store.unlock(lock_name)
        except Exception:
            log.exception("index snapshot write failed")
        finally:
            self._snapshot_task = None

    async def _load_snapshot(self) -> None:
        """Warm-start the prefix index from the persisted snapshot, keeping
        only workers that are still registered."""
        store = self.client.runtime.store
        try:
            raw = await store.get(self._snapshot_key())
        except Exception:
            log.exception("index snapshot read failed")
            return
        if not raw:
            return
        try:
            snap = codec.unpackb(raw)
            try:  # give discovery a moment so the liveness filter is real
                await self.client.wait_for_instances(1, timeout_s=2.0)
            except Exception:
                pass
            live = set(self.client.instance_ids())
            loaded = 0
            for w, hashes in snap.get("workers", {}).items():
                w = int(w)
                if live and w not in live:
                    continue  # dead worker — its blocks are gone
                self.indexer.apply_event(RouterEvent(
                    worker_id=w, kind="stored", blocks=tuple(hashes),
                ))
                if self.prefix_index is not None:
                    # parent links aren't persisted — flat inserts still
                    # match (lookups walk the request's own hash chain)
                    self.prefix_index.apply_event(w, {
                        "kind": "stored",
                        "blocks": [{"seq_hash": h} for h in hashes],
                    })
                loaded += len(hashes)
            self._events_at_snapshot = self.indexer.events_applied
            log.info("index warm-start: %d blocks from snapshot", loaded)
        except Exception:
            log.exception("bad index snapshot — starting cold")

    def _on_worker_removed(self, worker_id: int) -> None:
        if self.indexer is not None:
            self.indexer.remove_worker(worker_id)
        if self.prefix_index is not None:
            self.prefix_index.drop_worker(worker_id)
        if self.approx is not None:
            self.approx.remove_worker(worker_id)
        self.loads.remove_worker(worker_id)
        self.worker_stats.pop(worker_id, None)
        self.breakers.remove(worker_id)
        self.draining.discard(worker_id)

    def _on_worker_added(self, worker_id: int) -> None:
        # a re-put of the instance key (health recovery re-advertisement)
        # means the worker takes traffic again
        self.draining.discard(worker_id)

    def mark_draining(self, worker_id: int) -> None:
        """Divert new work away from a worker that rejected with ``draining``
        (covers the race before its instance-key delete reaches our watch)."""
        self.draining.add(worker_id)

    # -- routing (ref: kv_router.rs:291 find_best_match) --

    def find_best_match(
        self,
        request_id: str,
        token_ids: list,
        *,
        overlap_weight: Optional[float] = None,
        temperature: Optional[float] = None,
    ) -> Selection:
        workers = self.client.instance_ids()
        if not workers:
            raise EngineError(
                f"no instances for {self.client.endpoint.path}",
                ERR_UNAVAILABLE,
            )
        # circuit-breaker filter: a tripped worker takes no traffic until its
        # open timeout elapses, then at most half_open_probes requests probe
        # it (allow() is non-mutating — the probe slot is reserved by begin()
        # only for the worker actually selected)
        admitted = [w for w in workers if self.breakers.allow(w)]
        if not admitted:
            raise EngineError(
                f"all {len(workers)} workers circuit-open",
                ERR_UNAVAILABLE,
            )
        workers = admitted
        # drain filter: a worker that answered ``draining`` takes no new
        # traffic; unlike a breaker this clears the moment its key is
        # deleted (drain done) or re-put (re-advertised)
        if self.draining:
            active = [w for w in workers if w not in self.draining]
            if not active:
                raise EngineError(
                    f"all {len(workers)} workers draining", ERR_UNAVAILABLE
                )
            workers = active
        # busy-threshold rejection (ref: push_router.rs:58-63): drop workers
        # whose published KV usage exceeds the threshold; if every worker is
        # saturated, reject so the frontend returns 503 instead of queueing
        if self.config.busy_threshold is not None:
            free = [
                w for w in workers
                if self.worker_stats.get(w, {}).get("kv_usage", 0.0)
                < self.config.busy_threshold
            ]
            if not free:
                raise EngineError(
                    f"all {len(workers)} workers above busy threshold "
                    f"{self.config.busy_threshold}", ERR_OVERLOADED,
                )
            workers = free
        hashes = compute_block_hashes_for_seq(token_ids, self.block_size)
        prefix_match = None
        if self.prefix_index is not None:
            pm = self.prefix_index.find_matches(hashes)
            if pm.blocks >= self.config.prefix_min_blocks and pm.scores:
                prefix_match = pm
        if prefix_match is not None:
            # tier-weighted longest-cached-prefix scores: a G1 run counts
            # full blocks, a host/store-held run counts fractionally (the
            # onboard copy it implies). Non-prefix-bearing requests (no
            # match, or shorter than prefix_min_blocks) keep the flat
            # block-hash-overlap scoring below.
            overlaps = prefix_match.scores
        elif self.indexer is not None:
            overlaps = self.indexer.find_matches(hashes).scores
        else:
            overlaps = self.approx.find_matches_for_tokens(token_ids).scores
        sel = select_worker(
            workers, len(token_ids), overlaps, self.loads, self.block_size,
            self.config, overlap_weight=overlap_weight,
            temperature=temperature, rng=self._rng,
        )
        if prefix_match is not None:
            # load accounting wants true cached-block counts on the chosen
            # worker, not the tier-weighted score
            sel = Selection(
                worker_id=sel.worker_id,
                overlap_blocks=prefix_match.worker_blocks.get(
                    sel.worker_id, 0),
                logit=sel.logit,
            )
        self.breakers.begin(sel.worker_id)
        self.loads.add(request_id, sel.worker_id, len(token_ids),
                       sel.overlap_blocks)
        self._sync_emit("add", request_id, sel.worker_id, len(token_ids),
                        sel.overlap_blocks)
        if self.approx is not None:
            self.approx.record_routing_decision(sel.worker_id, token_ids)
        log.debug(
            "selected worker %d logit=%.3f overlap=%d blocks",
            sel.worker_id, sel.logit, sel.overlap_blocks,
        )
        return sel

    def prefill_done(self, request_id: str) -> None:
        self.loads.prefill_done(request_id)
        self._sync_emit("prefill_done", request_id)

    def free(self, request_id: str) -> None:
        self.loads.free(request_id)
        self._sync_emit("free", request_id)


class KvPushRouter(AsyncEngine):
    """Pipeline sink: KV-aware route + direct push (ref: kv_router.rs:423).

    Accepts the preprocessed wire dict (``token_ids`` present), picks the
    worker via :class:`KvRouter`, streams from it, and maintains the
    potential-load lifecycle (prefill→decode on first item, free at end).
    Per-request ``router_hints`` override weight/temperature
    (ref: RouterConfigOverride kv_router.rs:87-93).
    """

    def __init__(self, router: KvRouter):
        self.router = router

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[Any]:
        # multimodal prompts route by their CONTENT-ADDRESSED hash ids —
        # the engine's KV events are keyed by those, while token_ids carry
        # only placeholder runs that could never match
        mm = request.get("mm") or {}
        token_ids = list(mm.get("hash_token_ids")
                         or request.get("token_ids", ()))
        hints: Dict[str, Any] = request.get("router_hints") or {}
        with trace_span("router.select", context) as span:
            sel = self.router.find_best_match(
                context.id, token_ids,
                overlap_weight=hints.get("overlap_score_weight"),
                temperature=hints.get("router_temperature"),
            )
            span.set_attr("worker_id", sel.worker_id)
            span.set_attr("overlap_blocks", sel.overlap_blocks)
        first = True
        healthy = False
        try:
            async for item in self.router.client.direct(
                sel.worker_id, request, context
            ):
                if first:
                    self.router.prefill_done(context.id)
                    first = False
                # any delivered frame proves the worker is alive; consumers
                # (e.g. Migration) may close this generator right after the
                # finished item, so success must not wait for exhaustion
                healthy = True
                yield item
        except EngineError as e:
            # only transport-level unavailability feeds the breaker;
            # overload/timeouts are load signals, not worker death, and
            # tripping on them would shrink capacity exactly when it is
            # most needed. A draining rejection is a planned divert: mark
            # the worker so retries route elsewhere, but never punish it
            if e.code == ERR_DRAINING:
                self.router.mark_draining(sel.worker_id)
            elif e.code == ERR_UNAVAILABLE:
                healthy = False
                self.router.breakers.record_failure(sel.worker_id)
                if self.router.approx is not None:
                    # the worker is gone but its lease may not have expired
                    # yet — without this purge the TTL'd decision history
                    # keeps steering retries of the same prefix back at the
                    # dead worker until remove_worker fires
                    self.router.approx.remove_worker(sel.worker_id)
            raise
        finally:
            if healthy:
                self.router.breakers.record_success(sel.worker_id)
            self.router.free(context.id)
