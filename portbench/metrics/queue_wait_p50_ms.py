"""Median time a request waited between submission and its first
scheduled chunk (worker.queue spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "worker.queue")
