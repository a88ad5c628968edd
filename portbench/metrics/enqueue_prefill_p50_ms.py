"""Median host time of one prefill chunk's enqueue on the step thread,
from its first host work to the return of its last launch
(engine.enqueue_prefill spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "engine.enqueue_prefill")
