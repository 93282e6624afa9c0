"""decode_roofline: the 8-tap decode kernel's launches (one per channel
of a batch), the least seconds their work needs over their measured
seconds, in per cent."""

from benchmark.lib import readers


def read(t):
    return readers.roofline(t, "decode", r"\bdecode_kernel<8>")
