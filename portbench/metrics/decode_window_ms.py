"""Mean device time of one decode window, a CUDA graph replay (device
trace)."""

from portbench import readers


def read(r):
    return readers.decode_window_ms(r)
