"""The benchmark's frozen arithmetic that every architecture shares: the
card's published peaks and the causal context sum of a prefill chunk.

What an architecture's steps cost (its FLOPs per landed step, the least
time of its attention launch) lives in ``arch/<model_type>.py``, beside the
sizes those counts take.
"""

from __future__ import annotations

from typing import Optional

# Published peaks of one card (NVIDIA data sheet, dense, no sparsity), by a
# lower-case substring of ``torch.cuda.get_device_name()``. Only the SXM
# part is listed: an unknown card gets no peak, and the metrics that need
# one are left out of the result.
PEAKS = {
    "h100 80gb hbm3": {"bf16_flops": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def card_peaks(device_name: str) -> Optional[dict]:
    kind = (device_name or "").lower()
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def prefill_context_sum(start: int, length: int) -> int:
    """Sum over a causal chunk's positions of the context each attends."""
    return length * start + length * (length + 1) // 2
