"""Useful model FLOPs over window seconds times the bf16 peak, prefill-
heavy traffic."""

from portbench import readers


def read(r):
    return readers.mfu_pct(r)
