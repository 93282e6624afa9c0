"""decode_hi_roofline: the 16- and 30-tap decode kernel's launches (one
per channel of a batch in ffmpeg30.playback-hi, at 30 taps), the least
seconds their work needs over their measured seconds, in per cent."""

from benchmark.lib import readers


def read(t):
    return readers.roofline(t, "decode_hi", r"\bdecode_kernel<(16|30)>")
