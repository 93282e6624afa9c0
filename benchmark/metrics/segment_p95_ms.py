"""segment_p95_ms: the nearest-rank 95th percentile of the traced
window's request latencies, ms (the host API's tail; the profiler
records the device's activity meanwhile)."""

from benchmark.lib import readers


def read(t):
    return readers.p95(t.record.get("latency_ms", []))
