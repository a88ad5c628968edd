"""Speculative decoding: device-side n-gram drafting + batched verify.

A copy of ``dynamo_tpu.spec``. The subsystem has three pieces:

- :mod:`.ngram` — the prompt-lookup drafter. A batched n-gram match of the
  last suffix of each sequence's on-device token history against that same
  history; no draft model, no extra host uploads during steady-state decode.
- ``raw_spec_window_fn`` in :mod:`..engine.model` — the batched verify
  window: ONE target-model forward over ``[B, k+1]`` ragged query tokens
  against the paged KV cache (the paged-attention kernel's ragged face),
  accepting the longest matching prefix; on a card it replays a CUDA graph.
- :mod:`.stats` — ``SpecDecodeStats`` accounting (drafted / accepted /
  acceptance rate) published worker → metrics aggregator → planner.

Greedy rows have exact parity with ``spec_mode="off"``; sampled rows emit
one token per window with the same position-keyed draws as the non-spec
path when seeded.
"""

from .ngram import propose_drafts, propose_drafts_reference
from .stats import SpecDecodeStats

__all__ = ["propose_drafts", "propose_drafts_reference", "SpecDecodeStats"]
