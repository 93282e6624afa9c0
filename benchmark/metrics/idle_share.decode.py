"""idle_share.decode: per cent of the traced window in which no operation
ran on the device."""

from benchmark.lib import readers


def read(t):
    return readers.idle_share(t)
