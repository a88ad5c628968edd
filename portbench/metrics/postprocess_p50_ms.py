"""Median host time of one landed batch's post-processing: its tokens into
their streams, stop checks and KV events (engine.postprocess spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "engine.postprocess")
