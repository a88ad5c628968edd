"""Leader/worker barrier: cluster bring-up rendezvous over the store.

The leader posts payload data under ``v1/barrier/{id}/data`` and waits until
``num_workers`` keys exist under ``v1/barrier/{id}/worker/``; each worker
posts its own key, reads the data, then waits for ``v1/barrier/{id}/complete``
(ref: lib/runtime/src/utils/leader_worker_barrier.rs:125,218). Used for
multi-host mesh bring-up and KVBM leader/worker coordination.

A copy of ``dynamo_tpu.runtime.barrier`` on this package's codec.
"""

from __future__ import annotations

from . import codec
from .component import BARRIER_ROOT
from .store import StoreClient


class LeaderBarrier:
    def __init__(self, barrier_id: str, num_workers: int, timeout_s: float = 120.0):
        self.barrier_id = barrier_id
        self.num_workers = num_workers
        self.timeout_s = timeout_s

    async def sync(self, store: StoreClient, data: object) -> list[dict]:
        """Publish data, wait for all workers, mark complete.
        Returns each worker's posted payload."""
        root = f"{BARRIER_ROOT}{self.barrier_id}/"
        await store.put(
            root + "data",
            codec.packb(data),
            lease=store.primary_lease,
        )
        kvs = await store.wait_for_key_count(
            root + "worker/", self.num_workers, timeout_s=self.timeout_s
        )
        await store.put(root + "complete", b"1", lease=store.primary_lease)
        return [codec.unpackb(v) for _k, v in kvs]


class WorkerBarrier:
    def __init__(self, barrier_id: str, worker_id: str, timeout_s: float = 120.0):
        self.barrier_id = barrier_id
        self.worker_id = worker_id
        self.timeout_s = timeout_s

    async def sync(self, store: StoreClient, payload: object = None) -> object:
        """Wait for leader data, post our key, wait for completion.
        Returns the leader's data."""
        root = f"{BARRIER_ROOT}{self.barrier_id}/"
        [( _k, raw)] = await store.wait_for_key_count(
            root + "data", 1, timeout_s=self.timeout_s
        )
        await store.put(
            root + f"worker/{self.worker_id}",
            codec.packb(payload),
            lease=store.primary_lease,
        )
        await store.wait_for_key_count(root + "complete", 1, timeout_s=self.timeout_s)
        return codec.unpackb(raw)
