"""host_ms.segment: median per request of its wall milliseconds that no
device activity covers (the host API's own time: serdes, copies queued,
waits, Python)."""

from benchmark.lib import readers


def read(t):
    return readers.host_ms(t, "request")
