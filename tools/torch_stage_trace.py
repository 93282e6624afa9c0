#!/usr/bin/env python3
"""One traced run of a benchmark cell with the port's span recorder on:
the device time, the idle time and the host's own time of the cell's
calls, put down to the port's stages (``encode.*``, ``decode.*``).

    python3 tools/torch_stage_trace.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the card.  It runs the
cell as ``benchmark/run.py --trace 1`` does (``benchmark.lib.harness``'s
``run_cell``), with the recorder of ``alacjax_torch.utils.metrics`` on
for the window, and prints the run's result line (its ``breakdown``
labels each idle gap with the innermost span open then, the benchmark's
``call`` or a port stage, and the CUDA runtime call inside it), then one
line ``{"stages": ...}``:

- ``host_syncs``: ``*.sync`` spans per ``encode`` / ``decode`` call;
- ``dispatch_ms``: the median over the calls of a call's host ms less
  its ``*.sync`` spans' ms;
- ``stage_ms``: device ms per call launched inside each stage and its
  descendants (``search_ms.encode`` is ``encode.search``'s, and so on);
- ``self_device_ms`` / ``self_host_ms``: per call, the device ms launched
  with each stage innermost, and each stage's host ms less its children's;
- ``search_ops`` / ``assemble_ops``: per encode call, ``encode.search``'s
  and ``encode.assemble``'s own device ms and launches, op by op (kernel
  name), the largest twelve of each;
- ``steps``: packet steps (``encode`` spans) per ``encode.stream`` call,
  and ``banks_ms.stream``: device ms per packet step launched inside
  ``encode.banks`` (the banks' reset, per-order gather and commit);
- ``counters.decode``: per ``decode`` call, the sum of each count the
  port recorded in it (``metrics.count``): ``decode.lanes``, and over
  its elements ``decode.escaped`` (lanes whose element escaped) and
  ``decode.sized`` (lanes whose header carries the sample count);
- ``attributed`` / ``device_rows``: the window's device rows whose launch
  lies inside a port span, of all.

A device row is put down to a stage through its launch: the CUDA runtime
row with the same correlation id (CUPTI's, shared by a kernel, copy or
set and the runtime call that queued it), whose start lies inside the
stage's span on the host's clock.  No device-host clock alignment is
needed, only that the port's spans and the profiler's runtime rows read
the same clock (the Unix clock).  Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

T0 = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import harness, manifest, trace  # noqa: E402

TOPS = ("encode", "decode")


def innermost(intervals, times):
    """For each of the ascending ``times``, the payload of the innermost
    (latest-starting) of the nested (start, end, payload) intervals open
    at it, or None.  Unlike ``trace._innermost`` it returns payloads, and
    of two spans that open in the same nanosecond it takes the shorter,
    the inner one."""
    iv = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, k = [], [], 0
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


class StageTracer(trace.Tracer):
    """The benchmark's tracer, with the port's recorder on while the
    profiler runs; ``program`` holds the port's spans afterwards, and
    ``counts`` its counts."""

    def __init__(self, on: bool):
        super().__init__(on)
        self.program = []
        self.counts = []

    def start(self) -> None:
        if self.on:
            from alacjax_torch.utils import metrics
            metrics.drain()
            metrics.drain_counts()
            metrics.enable()
        super().start()

    def stop(self) -> None:
        super().stop()
        if self.on:
            from alacjax_torch.utils import metrics
            metrics.disable()
            self.program = metrics.drain()
            self.counts = metrics.drain_counts()


class StageTrace(trace.Trace):
    """The benchmark's trace, plus the port's spans (``program``, those
    that overlap the window) and, for each device row of ``device``, the
    index in ``program`` of the stage that launched it (``launched_in``,
    None where the launch lies outside every port span or has no
    runtime row); ``counts``, the port's counts as recorded."""

    last = None

    def __init__(self, tracer, calls, bounds, record=None):
        super().__init__(tracer, calls, bounds, record)
        self.program, keep = [], {}
        for i, s in enumerate(tracer.program):
            if s is not None and s[1] > self.t0 and s[0] < self.t1:
                keep[i] = len(self.program)
                self.program.append(s)
        # parents as indices into self.program (a kept span's parent
        # overlaps the window too)
        self.parent = [keep.get(s[3]) if s[3] is not None else None
                       for s in self.program]
        self.counts = list(getattr(tracer, "counts", []))
        dev, runtime = self._rows(tracer.prof)
        if len(dev) != len(self.device):
            raise RuntimeError(f"{len(dev)} device rows with ids, "
                               f"{len(self.device)} in the trace")
        launch = [runtime.get(c) for c in dev]
        order = sorted(range(len(launch)),
                       key=lambda i: -1 if launch[i] is None else launch[i])
        spans = [(s[0], s[1], i) for i, s in enumerate(self.program)]
        found = innermost(spans, [launch[i] if launch[i] is not None else -1
                                  for i in order])
        self.launched_in = [None] * len(dev)
        for j, i in enumerate(order):
            if launch[i] is not None:
                self.launched_in[i] = found[j]
        self.attributed = sum(x is not None for x in self.launched_in)
        StageTrace.last = self

    def _rows(self, prof):
        """The correlation ids of the window's device rows, in
        ``device``'s order, and the start of each runtime row by its
        correlation id."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, runtime = [], {}
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            start = trace._ns(e, "start")
            end = start + trace._ns(e, "duration")
            if e.device_type() == cuda:
                if end > self.t0 and start < self.t1:
                    dev.append(e.correlation_id())
            else:
                runtime[e.correlation_id()] = start
        return dev, runtime

    def names_up(self, i):
        """The names of span ``i`` and its ancestors."""
        out = set()
        while i is not None:
            out.add(self.program[i][2])
            i = self.parent[i]
        return out

    def tops(self, top: str):
        return [i for i, s in enumerate(self.program) if s[2] == top]

    def syncs_per_call(self, top: str):
        tops = self.tops(top)
        if not tops:
            return None
        n = sum(1 for i, s in enumerate(self.program)
                if s[2].endswith(".sync") and top in self.names_up(i))
        return n / len(tops)

    def dispatch_ms(self, top: str):
        tops = set(self.tops(top))
        if not tops:
            return None
        own = {i: self.program[i][1] - self.program[i][0] for i in tops}
        for i, s in enumerate(self.program):
            if s[2].endswith(".sync"):
                j = self.parent[i]
                while j is not None and j not in tops:
                    j = self.parent[j]
                if j is not None:
                    own[j] -= s[1] - s[0]
        return statistics.median(own.values()) / 1e6

    def stage_device_ms(self, stage: str):
        if not self.calls or not self.attributed:
            return None
        ns = sum(e - s for (s, e, _), i in zip(self.device, self.launched_in)
                 if i is not None and stage in self.names_up(i))
        return ns / self.calls / 1e6

    def stream_steps(self):
        """The ``encode`` spans inside an ``encode.stream``, and the
        number of ``encode.stream`` spans."""
        streams = self.tops("encode.stream")
        steps = [i for i in self.tops("encode")
                 if "encode.stream" in self.names_up(i)]
        return steps, len(streams)

    def banks_ms(self):
        """Device ms per stream packet step launched inside
        ``encode.banks``."""
        steps, _ = self.stream_steps()
        ms = self.stage_device_ms("encode.banks")
        if not steps or ms is None:
            return None
        return ms * self.calls / len(steps)

    def counters(self, top: str) -> dict:
        """Per ``top`` call of the window, the sum of each count recorded
        under its call id."""
        calls = {self.program[i][4] for i in self.tops(top)}
        out = {}
        for name, n, call in self.counts:
            if call in calls:
                out[name] = out.get(name, 0) + n
        return {k: v / len(calls) for k, v in out.items()} if calls else {}

    def self_device_ms(self) -> dict:
        out = {}
        for (s, e, _), i in zip(self.device, self.launched_in):
            name = self.program[i][2] if i is not None else "(no port span)"
            out[name] = out.get(name, 0) + (e - s)
        return {k: v / self.calls / 1e6 for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])}

    def self_device_ops(self, stage: str, top: int = 12) -> dict:
        """Per call, the device ms of each op (by kernel name, cut to 80
        characters) launched with ``stage`` innermost: its ``top`` largest
        and their launches per call."""
        ms, n = {}, {}
        for (s, e, name), i in zip(self.device, self.launched_in):
            if i is not None and self.program[i][2] == stage:
                key = name[:80]
                ms[key] = ms.get(key, 0) + (e - s)
                n[key] = n.get(key, 0) + 1
        rows = sorted(ms.items(), key=lambda kv: -kv[1])[:top]
        return {k: [v / self.calls / 1e6, n[k] / self.calls] for k, v in rows}

    def self_host_ms(self) -> dict:
        own = [s[1] - s[0] for s in self.program]
        for i, p in enumerate(self.parent):
            if p is not None:
                own[p] -= self.program[i][1] - self.program[i][0]
        out = {}
        for s, v in zip(self.program, own):
            out[s[2]] = out.get(s[2], 0) + v
        return {k: v / self.calls / 1e6 for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])}

    def breakdown(self) -> dict:
        """The benchmark's breakdown, with each idle gap labelled by the
        innermost span open at its middle, the benchmark's or the
        port's."""
        out = super().breakdown()
        gaps = self.gaps()
        mids = sorted((a + b) // 2 for a, b in gaps)
        size = {(a + b) // 2: b - a for a, b in gaps}
        named = ([(s, e, n) for s, e, n in self.spans]
                 + [(s[0], s[1], s[2]) for s in self.program])
        span_at = innermost(named, mids)
        op_at = trace._innermost(self.host, mids)
        idle = {}
        for m, sp, op in zip(mids, span_at, op_at):
            label = f"{sp or 'between calls'}:{op or 'python'}"
            idle[label] = idle.get(label, 0) + size[m]
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:trace.TOP]
        out["idle_gaps"] = [[n[:160], v / 1e9] for n, v in top]
        return out


def stages(t: StageTrace) -> dict:
    """What the run's port spans say, per call."""
    out = {"port_spans": len(t.program), "device_rows": len(t.device),
           "attributed": t.attributed,
           "calls": t.calls, "busy_ms_per_call": t.busy_s / t.calls * 1e3}
    for top in TOPS:
        if t.tops(top):
            out[f"host_syncs.{top}"] = t.syncs_per_call(top)
            out[f"dispatch_ms.{top}"] = t.dispatch_ms(top)
    for name, stage in (("search_ms.encode", "encode.search"),
                        ("assemble_ms.encode", "encode.assemble"),
                        ("parse_ms.decode", "decode.parse"),
                        ("pcm_ms.decode", "decode.pcm")):
        if t.tops(stage.split(".")[0]):
            out[name] = t.stage_device_ms(stage)
    if t.tops("decode"):
        out["counters.decode"] = t.counters("decode")
    out["self_device_ms"] = t.self_device_ms()
    out["self_host_ms"] = t.self_host_ms()
    if t.tops("encode"):
        out["search_ops"] = t.self_device_ops("encode.search")
        out["assemble_ops"] = t.self_device_ops("encode.assemble")
    steps, streams = t.stream_steps()
    if streams:
        out["steps"] = len(steps) / streams
        out["banks_ms.stream"] = t.banks_ms()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if not torch.cuda.is_available():
        print("torch_stage_trace: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(), args.workload)
    trace.Tracer, trace.Trace = StageTracer, StageTrace
    print(f"[bench] card: {harness.card_line()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, True, "cuda",
                              T0)
    t = StageTrace.last
    print(f"[bench] trace: {len(t.program)} port spans, {t.attributed} of "
          f"{len(t.device)} device rows in the window attributed to a port "
          f"span", file=sys.stderr)
    print(json.dumps(result))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "stages": stages(t)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
