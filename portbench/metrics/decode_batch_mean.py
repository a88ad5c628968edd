"""Mean live rows per decode window (the flight recorder's StepRecords)."""

from portbench import readers


def read(r):
    return readers.decode_batch_mean(r)
