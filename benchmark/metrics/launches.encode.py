"""launches.encode: device operations (kernels, copies, sets) per encode call."""

from benchmark.lib import readers


def read(t):
    return readers.launches(t)
