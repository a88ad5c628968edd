"""Distributed KVBM: cluster-shared G2 host tier over the store + direct
TCP block fetch (ref: lib/llm/src/block_manager/distributed/leader.rs:126,
worker.rs:133 — the reference forms a leader/worker group over ZMQ and
moves blocks with NIXL; here group bring-up rides the store barrier and the
data plane is the same TCP transport the disagg KV push uses).

Three pieces:

- :class:`KvbmGroup` — leader/worker bring-up: the leader publishes the
  group's block-layout contract (block_size, num_layers, kv heads, head
  dim, dtype) through the barrier; joining workers must match it exactly,
  because a mismatched layout would scatter garbage into the paged cache.
- presence plane: after offloading a block to local G2, a worker writes
  ``kvbm/g2/{ns}/{seq_hash}/{worker_id} → {addr}`` under its primary lease
  (worker death erases its claims automatically).
- data plane: each worker serves a ``kvbm_fetch`` TCP endpoint returning
  requested blocks from its host pool; peers fetch on onboard miss and
  lazily delete presence keys that turn out stale (evicted from the
  holder's G2 between publish and fetch).

A copy of ``dynamo_tpu.kvbm.distributed`` on this package's codec,
transport and barrier, so JAX and port workers share one presence plane and
fetch blocks from each other (the layout fingerprint hashes the same bytes).
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Any, Dict, Iterable, List, Optional

from ..disagg.protocol import kv_from_wire, kv_to_wire
from ..runtime import codec
from ..runtime.barrier import LeaderBarrier, WorkerBarrier
from ..runtime.context import Context
from ..runtime.engine import FnEngine
from ..runtime.transport import IngressServer, TransportClient
from ..utils.logging import get_logger

log = get_logger("kvbm.dist")


def engine_layout(engine) -> dict:
    """The block-layout contract two engines must share to exchange KV."""
    m, e = engine.model_config, engine.config
    return {
        "block_size": e.block_size,
        "num_layers": m.num_layers,
        "num_kv_heads": m.num_kv_heads,
        "head_dim": m.head_dim_,
        "dtype": m.dtype,
    }


class KvbmGroup:
    """Leader/worker group formation (ref: distributed/leader.rs:126)."""

    @staticmethod
    async def lead(store, name: str, num_workers: int, layout: dict,
                   timeout_s: float = 120.0) -> list:
        """Leader side: publish the layout, wait for every worker."""
        return await LeaderBarrier(
            f"kvbm/{name}", num_workers, timeout_s=timeout_s
        ).sync(store, layout)

    @staticmethod
    async def join(store, name: str, worker_name: str, layout: dict,
                   timeout_s: float = 120.0) -> dict:
        """Worker side: validate layout compatibility BEFORE checking in —
        posting the barrier key first would satisfy the leader's count and
        let it report a 'formed' group missing this worker."""
        from ..runtime.component import BARRIER_ROOT

        [(_k, raw)] = await store.wait_for_key_count(
            f"{BARRIER_ROOT}kvbm/{name}/data", 1, timeout_s=timeout_s
        )
        leader_layout = codec.unpackb(raw)
        if leader_layout != layout:
            raise RuntimeError(
                f"KVBM layout mismatch: leader {leader_layout} != "
                f"worker {layout} — cross-host KV transfer would corrupt "
                f"the paged cache"
            )
        return await WorkerBarrier(
            f"kvbm/{name}", worker_name, timeout_s=timeout_s
        ).sync(store, layout)


class DistributedKvbm:
    """Peer-G2 plane for one worker: presence publishing + block serving +
    onboard-time peer fetch. Attach with ``manager.peers = this`` (or pass
    ``distributed=`` to :func:`attach`)."""

    PREFIX = "kvbm/g2/"

    def __init__(self, manager, store, worker_id: int,
                 namespace: str = "dynamo",
                 advertise_host: str = "127.0.0.1",
                 scope: Optional[str] = None):
        self.manager = manager
        self.store = store
        self.worker_id = worker_id
        # the presence prefix embeds a fingerprint of (scope, layout):
        # workers serving a different model or block layout simply never
        # see each other's keys — token-based seq hashes collide across
        # models, and a foreign-model block with the right shape would be
        # silently-wrong KV (the barrier check alone is opt-in)
        layout = engine_layout(manager.engine)
        digest = hashlib.sha1(codec.packb(
            {"scope": scope or "", **layout}
        )).hexdigest()[:12]
        self.prefix = f"{self.PREFIX}{namespace}/{digest}/"
        self.advertise_host = advertise_host
        self.addr: Optional[str] = None
        self._server: Optional[IngressServer] = None
        self._transport: Optional[TransportClient] = None
        self._dropped: List[int] = []  # evicted hashes pending unpublish
        self.num_published = 0
        self.num_unpublished = 0
        self.num_served = 0
        self.num_peer_hits = 0
        self.num_stale_keys = 0

    # ------------------------- lifecycle -------------------------------

    async def start(self) -> None:
        self._server = IngressServer(
            FnEngine(self._serve_fetch), host="0.0.0.0", port=0
        )
        await self._server.start()
        self.addr = f"{self.advertise_host}:{self._server.port}"
        self._transport = TransportClient()
        self.manager.peers = self
        # G2 eviction must retract the advertisement, or stale keys grow
        # with total offloads instead of G2 capacity
        self.manager.host_pool.on_drop = self._dropped.append
        log.info("distributed KVBM serving G2 fetch at %s", self.addr)

    async def stop(self) -> None:
        if self.manager.peers is self:
            self.manager.peers = None
        if self.manager.host_pool.on_drop == self._dropped.append:
            self.manager.host_pool.on_drop = None
        if self._transport is not None:
            await self._transport.close()
            self._transport = None
        if self._server is not None:
            await self._server.stop()
            self._server = None

    # ------------------------- data plane ------------------------------

    async def _serve_fetch(self, request: Any, context: Context):
        """Peer ingress: return requested blocks from the local host pool."""
        blocks: Dict[str, dict] = {}
        for h in request.get("seq_hashes", ()):
            data = self.manager.host_pool.get(int(h))
            if data is not None:
                blocks[f"{int(h):016x}"] = kv_to_wire(data)
        self.num_served += len(blocks)
        yield {"blocks": blocks}

    def _key(self, seq_hash: int) -> str:
        return f"{self.prefix}{seq_hash:016x}/{self.worker_id}"

    async def publish(self, seq_hash: int) -> None:
        """Advertise one locally-held G2 block (leased: dies with us)."""
        await self.publish_many([seq_hash])

    async def publish_many(self, seq_hashes: Iterable[int]) -> None:
        """Batch-advertise (independent small writes, issued concurrently)
        and retract advertisements for blocks G2 has since dropped.

        Pool membership at publish time is the single source of truth: a
        hash can appear in both lists (evicted then re-offloaded, or
        evicted mid-tick by a later batch member), and a concurrent
        put+delete of the same key would race."""
        payload = codec.packb({"addr": self.addr})
        dropped, self._dropped = self._dropped, []
        pool = self.manager.host_pool
        put_hashes = {h for h in seq_hashes if h in pool}
        drop_hashes = {h for h in dropped if h not in pool} - put_hashes
        puts = [
            self.store.put(self._key(h), payload,
                           lease=self.store.primary_lease)
            for h in put_hashes
        ]
        deletes = [self.store.delete(self._key(h)) for h in drop_hashes]
        results = await asyncio.gather(*puts, *deletes,
                                       return_exceptions=True)
        for r in results:
            if isinstance(r, Exception):
                log.warning("presence update failed: %s", r)
        self.num_published += len(puts)
        self.num_unpublished += len(deletes)

    async def fetch(self, seq_hash: int) -> Optional[Dict[str, Any]]:
        """Fetch one block from any peer that advertises it."""
        return (await self.fetch_many([seq_hash])).get(seq_hash)

    async def fetch_many(
        self, seq_hashes: List[int]
    ) -> Dict[int, Dict[str, Any]]:
        """Resolve presence for every hash concurrently, then fetch one
        per-peer batch over TCP (not one round-trip per block). Stale
        advertisements discovered along the way are deleted."""
        if not seq_hashes:
            return {}
        lookups = await asyncio.gather(
            *(self.store.get_prefix(f"{self.prefix}{h:016x}/")
              for h in seq_hashes),
            return_exceptions=True,
        )
        by_addr: Dict[str, List[int]] = {}
        key_of: Dict[tuple, str] = {}
        for h, kvs in zip(seq_hashes, lookups):
            if isinstance(kvs, Exception):
                continue
            for key, value in kvs:
                try:
                    addr = codec.unpackb(value)["addr"]
                except Exception:
                    continue
                if addr == self.addr:
                    continue  # our own claim
                by_addr.setdefault(addr, []).append(h)
                key_of[(addr, h)] = key
                break  # first live peer is enough
        out: Dict[int, Dict[str, Any]] = {}
        for addr, hs in by_addr.items():
            try:
                async for resp in self._transport.generate(
                    addr, {"seq_hashes": hs}, Context()
                ):
                    blocks = resp.get("blocks", {})
                    for h in hs:
                        block = blocks.get(f"{h:016x}")
                        if block is not None:
                            self.num_peer_hits += 1
                            out[h] = kv_from_wire(block)
                        else:
                            # the peer evicted it — drop the stale key
                            self.num_stale_keys += 1
                            await self.store.delete(key_of[(addr, h)])
                    break
            except Exception:
                log.warning("peer G2 fetch from %s failed", addr,
                            exc_info=True)
        return out
