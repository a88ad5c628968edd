"""Median time from the fetch thread's wait on a window's landing event
returning to the engine loop taking that landing up: the loop's time on
other work (engine.land spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "engine.land")
