"""Median time from a request's first scheduled chunk to its first token
(engine.prefill spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "engine.prefill")
