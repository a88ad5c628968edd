"""Median host time of one decode window's enqueue on the step thread:
control deltas, the seat map and the graph replay call
(engine.enqueue_decode spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "engine.enqueue_decode")
