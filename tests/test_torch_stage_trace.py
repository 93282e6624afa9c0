"""tools/torch_stage_trace.py on a synthetic trace: hand-made device rows,
CUDA runtime rows and port spans, read as the benchmark's
benchmark.lib.trace.Trace reads a torch.profiler trace.

Device rows are put down to the port span open at the start of the
runtime row that shares their correlation id (a row launched outside
every port span to none); the per-call sync count, the dispatch time
and the device ms of a stage; the idle gaps labelled by the innermost
span, the benchmark's or the port's; a stream call's packet steps and
the device ms of its ``encode.banks`` spans a step; and each of the
benchmark's per-layer readers reads the same on the trace with the
port's spans as on the trace without them.
"""

import os
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import torch_stage_trace as st  # noqa: E402
from benchmark.lib import manifest, trace  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
US = 1000        # ns


class Event:
    def __init__(self, name, start, end, corr, device):
        self._row = (name, start, end, corr, device)

    def name(self):
        return self._row[0]

    def start_ns(self):
        return self._row[1]

    def duration_ns(self):
        return self._row[2] - self._row[1]

    def correlation_id(self):
        return self._row[3]

    def device_type(self):
        return self._row[4]

    def is_user_annotation(self):
        return False


class Prof:
    def __init__(self, events):
        k = type("K", (), {"events": lambda self_: events})()
        self.profiler = type("P", (), {"kineto_results": k})()


def launch(name, kernel, t, dur, corr, run=2 * US):
    """A runtime row at ``t`` and the device row it queued, later."""
    return [Event(name, t, t + run, corr, CPU),
            Event(kernel, t + 10 * US, t + 10 * US + dur, corr, CUDA)]


# one window (0-1000 us) holding two benchmark calls of the port's
# ``decode``
WINDOW = [(0, 1000 * US, "window"), (50 * US, 400 * US, "call"),
          (450 * US, 900 * US, "call")]


def port_spans():
    """Two decode calls: parse, a flags readback, scan, pcm."""
    out = []
    for call, base in enumerate((60 * US, 460 * US)):
        top = len(out)
        out.append((base, base + 330 * US, "decode", None, call, 1))
        for name, a, b in (("decode.parse", 0, 80),
                           ("decode.flags.sync", 80, 140),
                           ("decode.scan", 140, 260),
                           ("decode.pcm", 260, 330)):
            out.append((base + a * US, base + b * US, name, top, call, 1))
    return out


def events():
    ev = []
    corr = 1
    for base in (60 * US, 460 * US):
        for t, kern, dur in ((base + 5 * US, "parse_op", 30 * US),
                             (base + 150 * US, "decode_kernel<8>", 90 * US),
                             (base + 270 * US, "unmix_op", 20 * US)):
            ev += launch("cudaLaunchKernel", kern, t, dur, corr)
            corr += 1
        ev += [Event("cudaStreamSynchronize", base + 85 * US,
                     base + 135 * US, corr, CPU)]
        corr += 1
    # a launch between the calls: inside no port span
    ev += launch("cudaMemsetAsync", "Memset", 420 * US, 5 * US, corr)
    # a device row whose runtime row is not in the trace
    ev += [Event("lost_op", 950 * US, 960 * US, 999, CUDA)]
    return ev


class Tracer:
    def __init__(self, program):
        self.prof = Prof(events())
        self.spans = list(WINDOW)
        self.program = program


def read_trace(program):
    cls = st.StageTrace if program is not None else trace.Trace
    return cls(Tracer(program or []), calls=2, bounds={"decode": 1e-4})


def test_rows_are_put_down_to_the_stage_that_launched_them():
    t = read_trace(port_spans())
    names = [None if i is None else t.program[i][2] for i in t.launched_in]
    assert [n for _, _, n in t.device] == [
        "parse_op", "decode_kernel<8>", "unmix_op"] * 2 + ["Memset",
                                                          "lost_op"]
    assert names == ["decode.parse", "decode.scan", "decode.pcm"] * 2 + [
        None, None]
    assert t.attributed == 6


def test_syncs_dispatch_and_stage_device_ms():
    t = read_trace(port_spans())
    assert t.syncs_per_call("decode") == 1.0
    assert t.syncs_per_call("encode") is None
    # 330 us a call, 60 of them in the readback
    assert t.dispatch_ms("decode") == pytest.approx(0.270)
    assert t.stage_device_ms("decode.scan") == pytest.approx(0.090)
    assert t.stage_device_ms("decode.parse") == pytest.approx(0.030)
    assert t.stage_device_ms("decode") == pytest.approx(0.140)
    got = st.stages(t)
    assert got["host_syncs.decode"] == 1.0
    assert got["pcm_ms.decode"] == pytest.approx(0.020)
    assert got["self_device_ms"]["(no port span)"] == pytest.approx(0.0075)
    assert got["self_host_ms"]["decode.scan"] == pytest.approx(0.120)
    assert "search_ms.encode" not in got
    assert "search_ops" not in got
    assert "assemble_ops" not in got


def test_a_stages_own_device_ms_op_by_op():
    t = read_trace(port_spans())
    assert t.self_device_ops("decode.scan") == {
        "decode_kernel<8>": [pytest.approx(0.090), 1.0]}
    assert t.self_device_ops("decode.parse") == {
        "parse_op": [pytest.approx(0.030), 1.0]}
    assert t.self_device_ops("encode.search") == {}
    assert t.self_device_ops("encode.assemble") == {}


def test_idle_gaps_name_the_innermost_span_of_either_list():
    gaps = read_trace(port_spans()).breakdown()["idle_gaps"]
    plain = read_trace(None).breakdown()["idle_gaps"]
    # the readbacks (the device idles from the parse op's end to the
    # scan's kernel), the first call's pcm stage after its unmix op, the
    # calls' ends outside every port span, and between the calls
    assert gaps == [["call:python", 0.0003],
                    ["decode.flags.sync:cudaStreamSynchronize", 0.00023],
                    ["between calls:python", 0.000115],
                    ["decode.pcm:python", 6e-05]]
    assert plain == [["call:python", 0.00036],
                     ["call:cudaStreamSynchronize", 0.00023],
                     ["between calls:python", 0.000115]]


def test_innermost_takes_the_inner_of_two_spans_opened_together():
    iv = [(0, 100, "outer"), (0, 50, "inner"), (60, 70, "later")]
    assert st.innermost(iv, [10, 55, 65, 100, 101]) == [
        "inner", "outer", "later", "outer", None]


class StreamTracer:
    """One benchmark call holding one stream call of two packet steps:
    per step the banks' reset, then an encode with a cost launch and,
    inside it, a bank commit."""

    def __init__(self):
        ev, program, corr = [], [], 100
        program.append((60 * US, 860 * US, "encode.stream", None, 0, 1))
        for base in (70 * US, 470 * US):
            program.append((base, base + 20 * US, "encode.banks", 0, 0, 1))
            enc = len(program)
            program.append((base + 20 * US, base + 380 * US, "encode", 0, 0,
                            1))
            program.append((base + 100 * US, base + 120 * US, "encode.banks",
                            enc, 0, 1))
            for t, kern, dur in ((base + 5 * US, "where_op", 5 * US),
                                 (base + 50 * US, "cost_tiled<true>",
                                  50 * US),
                                 (base + 105 * US, "where_op", 7 * US)):
                ev += launch("cudaLaunchKernel", kern, t, dur, corr)
                corr += 1
        self.prof = Prof(ev)
        self.spans = [(0, 1000 * US, "window"), (50 * US, 900 * US, "call")]
        self.program = program


def test_stream_steps_and_banks_ms():
    t = st.StageTrace(StreamTracer(), calls=2, bounds={})
    got = st.stages(t)
    assert got["steps"] == 2.0
    # (5 + 7) us of the banks' ops a step
    assert got["banks_ms.stream"] == pytest.approx(0.012)
    assert got["host_syncs.encode"] == 0.0
    assert t.stage_device_ms("encode.banks") == pytest.approx(0.012)
    assert t.self_device_ops("encode") == {
        "cost_tiled<true>": [pytest.approx(0.050), 1.0]}
    # no stream call: neither readout
    plain = st.stages(read_trace(port_spans()))
    assert "steps" not in plain and "banks_ms.stream" not in plain


@pytest.mark.parametrize("name", [
    "glue_ms.decode", "glue_ms.encode", "launches.decode", "launches.encode",
    "cost_roofline", "decode_roofline", "idle_share.decode",
    "idle_share.encode", "host_ms.ingest", "readbacks.encode",
    "parse_ms.decode"])
def test_benchmark_readers_read_the_same_with_port_spans(name):
    reader = manifest.load_module(os.path.join(manifest.BENCH_DIR, "metrics",
                                               name + ".py"))
    with_spans, without = read_trace(port_spans()), read_trace(None)
    assert reader.read(with_spans) == reader.read(without)
    for attr in ("spans", "device", "merged", "host", "calls", "bounds",
                 "busy_s", "window_s"):
        assert getattr(with_spans, attr) == getattr(without, attr)


def test_decode_counters_per_call():
    """The port's counts of the window's decode calls, summed per call;
    a count under another call id (outside the window) is left out."""
    tracer = Tracer(port_spans())
    tracer.counts = [("decode.lanes", 8, 0), ("decode.escaped", 2, 0),
                     ("decode.sized", 2, 0), ("decode.lanes", 8, 1),
                     ("decode.escaped", 4, 1), ("decode.sized", 0, 1),
                     ("decode.lanes", 8, 7)]
    got = st.stages(st.StageTrace(tracer, calls=2, bounds={}))
    assert got["counters.decode"] == {"decode.lanes": 8.0,
                                      "decode.escaped": 3.0,
                                      "decode.sized": 1.0}
    # a trace without counts reads none; one without decode calls, no key
    assert st.stages(read_trace(port_spans()))["counters.decode"] == {}
    assert "counters.decode" not in st.stages(
        st.StageTrace(StreamTracer(), calls=2, bounds={}))
