"""readbacks.encode: device-to-host copies per call (the profiler's
``Memcpy DtoH`` rows): the encode's reads of the card, its flags and
scalar syncs and, through the host API, the packets' copy out."""

import re

DTOH = re.compile(r"Memcpy DtoH")


def read(t):
    if not t.calls or not t.device:
        return None
    return sum(1 for _, _, n in t.device if DTOH.search(n)) / t.calls
