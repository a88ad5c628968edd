"""Share of the traced window with nothing running on the device,
prefill-heavy traffic."""

from portbench import readers


def read(r):
    return readers.idle_pct(r)
