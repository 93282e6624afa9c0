"""glue_ms.decode: device ms per decode call outside the port's csrc kernels
(the device program's torch ops, copies and sets)."""

from benchmark.lib import readers


def read(t):
    return readers.glue_ms(t)
