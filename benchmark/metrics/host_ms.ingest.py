"""host_ms.ingest: median per request of its wall milliseconds that no
device activity covers (the host API's own time on the encode: the
pinned copies' staging, the packets' serdes, waits, Python)."""

from benchmark.lib import readers


def read(t):
    return readers.host_ms(t, "request")
