"""Median host time of one schedule pass that made a batch: the pressure
ladder's tick, ``scheduler.schedule()`` and the preempted seats' kills
(engine.schedule spans)."""

from portbench import readers


def read(r):
    return readers.span_p50_ms(r, "engine.schedule")
