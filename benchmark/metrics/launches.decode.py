"""launches.decode: device operations (kernels, copies, sets) per decode call."""

from benchmark.lib import readers


def read(t):
    return readers.launches(t)
