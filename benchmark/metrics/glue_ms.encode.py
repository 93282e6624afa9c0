"""glue_ms.encode: device ms per encode call outside the port's csrc kernels
(the device program's torch ops, copies and sets)."""

from benchmark.lib import readers


def read(t):
    return readers.glue_ms(t)
