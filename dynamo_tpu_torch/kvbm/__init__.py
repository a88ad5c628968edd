"""Multi-tier KV block manager (KVBM)
(ref: lib/llm/src/block_manager/ — G1 device / G2 pinned-host / G3 disk
pools, offload manager, sequence-hash reuse).

TPU-first redesign: G1 *is* the engine's paged-cache block pool, so the
"device pool" needs no second implementation. Sealed blocks are offloaded
write-through (batched async gathers between steps — never an
extract-on-evict stall inside the scheduler), and onboarding promotes host
blocks back into the G1 prefix cache, so the scheduler's existing prefix
matching serves G2/G3 hits with zero changes to the hot path.

A copy of ``dynamo_tpu.kvbm``.
"""

from .host_pool import HostBlockPool
from .manager import KvbmConfig, KvbmManager

__all__ = ["HostBlockPool", "KvbmConfig", "KvbmManager"]
