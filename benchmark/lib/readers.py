"""The arithmetic the per-layer metric files share; each file under
benchmark/metrics/ names one metric and calls one of these."""

from __future__ import annotations

import math
import statistics

from . import trace


def glue_ms(t):
    """Device milliseconds per call outside the port's csrc kernels."""
    if not t.calls or not t.device:
        return None
    return (t.busy_s - t.kernel_s(trace.CSRC)) / t.calls * 1e3


def launches(t):
    """Device operations (kernels, copies, sets) per call."""
    if not t.calls or not t.device:
        return None
    return len(t.device) / t.calls


def roofline(t, family: str, pattern: str):
    """Per cent: the family's least seconds over its measured seconds."""
    measured = t.kernel_s(pattern)
    bound = t.bounds.get(family)
    if not measured or not bound:
        return None
    return bound / measured * 100


def idle_share(t):
    """Per cent of the traced window with no device activity."""
    if not t.window_s or not t.device:
        return None
    return (1 - t.busy_s / t.window_s) * 100


def host_ms(t, span: str):
    """Median per ``span`` of its milliseconds no device row covers."""
    ms = t.span_uncovered_ms(span)
    return statistics.median(ms) if ms else None


def p95(values):
    """The nearest-rank 95th percentile."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
