"""Mock engine: real scheduler, simulated device time
(ref: lib/llm/src/mocker/{engine,scheduler,kv_manager}.rs — the reference
rebuilds vLLM scheduling semantics for its mocker; ours *is* the production
scheduler, so the simulation can't drift from the real engine).

Timing model: a step that prefills P tokens and decodes a batch of D
sequences costs

    dt = (P · prefill_time_per_token + [D>0] · decode_time_per_step
          + D · decode_time_per_token) / speedup_ratio

which captures the two device regimes — prefill is compute-bound (cost ∝
tokens), decode is launch/HBM-bound (flat per step + small per-seq term).
Sampled tokens are deterministic xxh3 draws so runs are reproducible.

A copy of ``dynamo_tpu.mocker.engine``, drawing with the port's own XXH3-64
(``utils/xxh3.py``, equal to ``xxhash.xxh3_64_intdigest``).
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass
from typing import List, Tuple

from ..engine.config import EngineConfig
from ..engine.engine import EngineCore
from ..utils.xxh3 import xxh3_64


@dataclass
class MockerConfig:
    """Timing + shape knobs for the simulated device."""

    vocab_size: int = 512
    prefill_time_per_token_s: float = 50e-6   # ~20k tok/s prefill
    decode_time_per_step_s: float = 5e-3      # flat step launch cost
    decode_time_per_token_s: float = 50e-6
    speedup_ratio: float = 1.0                # >1 accelerates simulated time


class MockEngine(EngineCore):
    """Drop-in AsyncEngine with no device behind it."""

    def __init__(self, engine_config: EngineConfig,
                 mock_config: MockerConfig | None = None):
        super().__init__(engine_config)
        self.mock = mock_config or MockerConfig()

    def _sample(self, seq_id: str, position: int) -> int:
        """Deterministic pseudo-random token; avoids ids < 4 so reserved
        specials (pad/bos/eos) are never emitted and generation runs to
        max_tokens unless the prompt's own eos ids say otherwise."""
        h = xxh3_64(seq_id.encode() + struct.pack("<I", position), seed=7)
        lo = min(4, self.mock.vocab_size - 1)
        return lo + h % max(1, self.mock.vocab_size - lo)

    async def _execute_batch_async(self, batch) -> Tuple[List[int],
                                                          List[List[int]]]:
        m = self.mock
        prefill_tokens = sum(c.length for c in batch.prefills)
        dt = prefill_tokens * m.prefill_time_per_token_s
        if batch.decodes:
            dt += (m.decode_time_per_step_s
                   + len(batch.decodes) * m.decode_time_per_token_s)
        if dt > 0:
            await asyncio.sleep(dt / m.speedup_ratio)
        prefill_samples = [
            self._sample(c.seq.seq_id, c.seq.total_tokens)
            for c in batch.prefills
        ]
        # one-token windows: the port's engine core takes a window per row
        decode_samples = [
            [self._sample(s.seq_id, s.total_tokens)] for s in batch.decodes
        ]
        return prefill_samples, decode_samples
