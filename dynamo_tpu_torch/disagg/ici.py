"""Device-native KV block transfer plane.

Paged KV blocks move prefill→decode **device to device** between engines in
one process, with no host round trip (the role of the reference's NIXL
GPU-to-GPU path, ref: lib/llm/src/block_manager/block_manager.rs:93-98;
lib/llm/src/kernels/block_copy.cu:167-309).

A copy of ``dynamo_tpu.disagg.ici`` on one card:

- the source engine gathers the blocks (``engine.model.make_kv_ops``) on
  its device-step thread, in its stream's order, and records a CUDA event
  after the gather;
- the destination engine, on its own device-step thread, re-checks the
  reservation's epoch, makes its stream wait on that event and scatters
  the payload into its reserved blocks in place. Pads of both id lists
  name the trash block 0.

There is no host copy and no device-wide sync. Both engines serve one
layout (one card, no tensor parallelism), so there is nothing to reshard,
as the JAX package's ``device_put`` onto the destination mesh does.
Cross-process transfers ride the host relay (``disagg.protocol``).
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

import numpy as np

from ..engine.engine import _pow2_bucket
from ..utils.logging import get_logger

log = get_logger("disagg.ici")


class StaleEpochError(RuntimeError):
    """The destination reservation was recycled (or resumed) before the
    transfer landed — writing now would corrupt another request's KV."""


class DevicePlane:
    """Process-local registry of engines addressable for device transfer.

    An engine registers under a plane id; a transfer between two registered
    engines is device-to-device. ``plane_id`` values are advertised in the
    ``kv_transfer`` control message next to the host-relay address, so a
    prefill worker sharing the process uses the device plane and any other
    worker falls back to the relay — mirroring the reference's
    NIXL-when-registered / bounce-buffer-otherwise split.
    """

    def __init__(self) -> None:
        self._engines: Dict[str, object] = {}

    def register(self, plane_id: str, engine) -> None:
        self._engines[plane_id] = engine

    def unregister(self, plane_id: str) -> None:
        self._engines.pop(plane_id, None)

    def get(self, plane_id: Optional[str]):
        if plane_id is None:
            return None
        return self._engines.get(plane_id)

    async def transfer(
        self, src_engine, src_block_ids, dst_engine, dst_block_ids,
        *, dst_seq_id: Optional[str] = None, dst_epoch: Optional[int] = None,
    ) -> int:
        """Move whole KV blocks src→dst on device. Returns bytes moved
        (every payload tensor, pads included).

        Block id lists are padded to the same power of two: source pads
        gather the trash block, destination pads scatter back into the
        trash block, so no host-side slicing is ever needed.

        When ``dst_seq_id``/``dst_epoch`` are given, the destination
        reservation is re-validated *inside the scatter callable* — on the
        destination engine's device-step thread, immediately before the
        write — and a stale epoch raises :class:`StaleEpochError` without
        touching the cache.
        """
        n = len(src_block_ids)
        if len(dst_block_ids) != n:
            raise ValueError(
                f"block count mismatch: src {n} dst {len(dst_block_ids)}"
            )
        if n == 0:
            return 0
        m = _pow2_bucket(n)
        src_ids = np.zeros((m,), np.int32)
        src_ids[:n] = src_block_ids
        dst_ids = np.zeros((m,), np.int32)
        dst_ids[:n] = dst_block_ids

        loop = asyncio.get_running_loop()
        data, event = await loop.run_in_executor(
            src_engine._step_executor(), src_engine._gather_blocks, src_ids)
        await loop.run_in_executor(
            dst_engine._step_executor(),
            lambda: dst_engine._scatter_blocks(
                dst_ids, data, event, seq_id=dst_seq_id, epoch=dst_epoch))
        # every payload tensor counts: k + v (+ ks + vs scales), padded
        return sum(a.numel() * a.element_size() for a in data.values())


# A process-wide default plane: workers in one process (launcher-spawned
# P/D engine pairs) find each other without plumbing a registry handle.
default_plane = DevicePlane()
