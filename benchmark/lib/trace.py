"""The benchmark's spans and the reduction of a torch.profiler trace to
what the per-layer metrics read.

Spans are the benchmark's own, around its calls into the port
(``window``, ``call``, ``request``): host clock readings kept in a list,
on the clock the profiler stamps its rows with (the Unix clock, in ns).
The profiler records the device's activity only (kernels, copies, sets,
and the CUDA runtime calls that launched or waited for them), so that
tracing adds little to the host's time; with tracing off nothing is
recorded."""

from __future__ import annotations

import bisect
import contextlib
import re
import time

# the port's hand-written kernels (alacjax_torch/csrc/*.cu)
CSRC = re.compile(r"\b(cost_tiled|decode_kernel|cursor_kernel|raw_kernel|"
                  r"emit_kernel|merge_scatter|merge_tails|predict_tiled|"
                  r"rice_tiled)\b")
TOP = 10


class _Span:
    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.spans.append((self.t0, time.time_ns(), self.name))


class Tracer:
    """Records the benchmark's spans, and runs the profiler, when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.spans = []

    def span(self, name: str):
        return _Span(self.spans, name) if self.on else contextlib.nullcontext()

    def start(self) -> None:
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                    else [ProfilerActivity.CPU])
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)


def _ns(e, what: str) -> int:
    fn = getattr(e, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, what + "_us")() * 1000)


def _events(prof):
    """(device rows, host rows: the CUDA runtime calls), each a list of
    (start ns, end ns, name)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        row = (start, start + _ns(e, "duration"), e.name())
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        (device if e.device_type() == cuda else host).append(row)
    return device, host


def union(intervals):
    """Disjoint sorted (start, end) covering the intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged, s: int, e: int) -> int:
    """Length of [s, e] that the merged intervals cover."""
    starts = [m[0] for m in merged]
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0
    while i < len(merged) and merged[i][0] < e:
        a, b = max(merged[i][0], s), min(merged[i][1], e)
        if b > a:
            total += b - a
        i += 1
    return total


def _innermost(intervals, times):
    """For each sorted query time, the name of the latest-starting
    interval open at it (intervals of one thread nest), or None."""
    out = []
    stack = []
    k = 0
    iv = sorted(intervals)
    for t in times:
        while k < len(iv) and iv[k][0] <= t:
            while stack and stack[-1][1] < iv[k][0]:
                stack.pop()
            stack.append(iv[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class Trace:
    """What the per-layer readers read: the traced window, its device
    activity, the benchmark's spans, and the kind's counts (``calls``,
    ``bounds``: the least seconds each kernel family could take for the
    window's work; ``record``: what the kind kept of its window, such as
    each request's latency)."""

    def __init__(self, tracer: Tracer, calls: int, bounds: dict,
                 record: dict | None = None):
        device, host = _events(tracer.prof)
        win = [s for s in tracer.spans if s[2] == "window"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0, self.t1 = win[0][0], win[0][1]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device = [(max(s, self.t0), min(e, self.t1), n)
                       for s, e, n in device if e > self.t0 and s < self.t1]
        self.merged = union((s, e) for s, e, _ in self.device)
        self.busy_s = sum(e - s for s, e in self.merged) / 1e9
        self.rows_outside = len(device) - len(self.device)
        self.spans = [s for s in tracer.spans if s[2] != "window"]
        self.host = [h for h in host if h[1] > self.t0 and h[0] < self.t1]
        self.calls = calls
        self.bounds = bounds
        self.record = record or {}

    def kernel_s(self, pattern) -> float:
        """Seconds of device rows whose name matches ``pattern``."""
        rx = re.compile(pattern) if isinstance(pattern, str) else pattern
        return sum(e - s for s, e, n in self.device if rx.search(n)) / 1e9

    def span_uncovered_ms(self, name: str) -> list:
        """Per span ``name``: its milliseconds that no device row covers."""
        return [((e - s) - covered(self.merged, s, e)) / 1e6
                for s, e, n in self.spans if n == name]

    def gaps(self):
        """(start, end) of each stretch of the window with no device row."""
        out, t = [], self.t0
        for s, e in self.merged:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing: the benchmark's span open then, and
        the CUDA runtime call inside it (``python`` where none: the glue's
        Python and torch's dispatch between launches)."""
        ops = {}
        for s, e, n in self.device:
            ops[n] = ops.get(n, 0) + (e - s)
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = self.gaps()
        mids = [(a + b) // 2 for a, b in gaps]
        order = sorted(range(len(mids)), key=mids.__getitem__)
        times = [mids[i] for i in order]
        span_at = _innermost(self.spans, times)
        op_at = _innermost(self.host, times)
        idle = {}
        for j, i in enumerate(order):
            a, b = gaps[i]
            label = f"{span_at[j] or 'between calls'}:{op_at[j] or 'python'}"
            idle[label] = idle.get(label, 0) + (b - a)
        top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in top_ops],
                "idle_gaps": [[n[:160], v / 1e9] for n, v in top_idle]}
