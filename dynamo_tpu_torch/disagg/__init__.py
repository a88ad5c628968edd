"""Disaggregated prefill/decode serving
(ref: docs/architecture/disagg_serving.md; components/backends/vllm/src/
dynamo/vllm/handlers.py:89,207).

The decode worker orchestrates: it pre-allocates KV blocks, pushes a
bounded-prefill request to a prefill worker, receives the KV blocks over the
transfer plane into those pre-allocated slots, and resumes decoding from the
remotely-sampled first token. Data plane: the block gather/scatter of
``engine.model.make_kv_ops``, device to device between engines of one
process (``ici.DevicePlane``) and host-relayed over the TCP transport
between processes.

Fault model: reservations are epoch-guarded (stale transfers rejected
before write, see ``ici.StaleEpochError``), relay frames are
integrity-checked (``protocol.KvIntegrityError``), and repeated handoff
failures trip a breaker that flips decode to local-prefill for a cooldown
window.

A copy of ``dynamo_tpu.disagg``.
"""

from .handlers import (
    DecodeHandler, DisaggConfig, PrefillHandler, PrefillQueueWorker,
)
from .ici import DevicePlane, StaleEpochError, default_plane
from .protocol import KvIntegrityError, kv_from_wire, kv_to_wire

__all__ = [
    "DecodeHandler",
    "DevicePlane",
    "DisaggConfig",
    "KvIntegrityError",
    "PrefillHandler",
    "PrefillQueueWorker",
    "StaleEpochError",
    "default_plane",
    "kv_from_wire",
    "kv_to_wire",
]
