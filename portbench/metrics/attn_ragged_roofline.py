"""The ragged (prefill) face of the paged-attention kernel: its bound
over its device time per launch."""

from portbench import readers


def read(r):
    return readers.roofline_pct(r, "ragged")
