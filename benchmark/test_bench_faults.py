"""The check of each cell, driven through a whole run at a tiny size on
the CPU (the rehearsal: an explicit device argument; the benchmark
itself refuses to run without a card): sound runs are correct, and the
control and every fault the cell can have make them not correct."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import control
from benchmark.lib import harness, manifest

BENCH = manifest.BENCH_DIR

SEED = 2 ** 31 + 977
SMALL = {"ingest": dict(batch=8, distinct=4, batches=2, check_frames=8),
         "playback": dict(batch=8, distinct=4, batches=2),
         "segments": dict(tracks=2, track_seconds=1, segment_packets=9,
                          check_requests=5)}
CELLS = ["cd16.ingest", "cd16.playback", "surround24.playback",
         "cd16.segments"]
ENTRY = {"bulk_encode": "encode_frames_device",
         "bulk_decode": "decode_frames_device"}


def segments_cell() -> dict:
    """cd16.segments, ready under benchmark/ but not in BENCHMARK.json
    (its latency spreads between runs on one card's shared host more
    widely than a regression bound can hold): composed from its files."""
    join = os.path.join
    return {"workload": {"name": "cd16.segments", "traffic": "segments",
                         "chips": 1},
            "config": json.load(open(join(BENCH, "configs", "cd16.json"))),
            "traffic": json.load(open(join(BENCH, "traffic",
                                           "segments.json"))),
            "kind": join(BENCH, "kinds", "segments.py"),
            "end_to_end": [{"name": "segment_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": "ms",
                           "reader": join(BENCH, "metrics", n + ".py")}
                          for n in ("host_ms.segment", "segment_p95_ms",
                                    "idle_share.segment")]}


def small_cell(name: str) -> dict:
    cell = (segments_cell() if name == "cd16.segments"
            else manifest.cell(manifest.load(), name))
    cell["config"] = dict(cell["config"], frame_length=128)
    cell["traffic"] = dict(cell["traffic"],
                           **SMALL[cell["workload"]["traffic"]])
    return cell


def rehearse(name: str, seconds: float = 0.0, traced: bool = False) -> dict:
    return harness.run_cell(small_cell(name), SEED, seconds, traced, "cpu",
                            time.perf_counter())


# -- faults, planted under the timed path ------------------------------------
def stale(fn):
    """Each call returns the previous call's answer: state left unchanged."""
    last = []

    def f(*a, **k):
        out = fn(*a, **k)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return f


def half(fn):
    """Half of the batch left out: its answers zero."""
    def f(*a, **k):
        out = fn(*a, **k)
        if isinstance(out[0], torch.Tensor):
            first = out[0].clone()
            first[first.shape[0] // 2:] = 0
        else:
            first = out[0].copy()
            first[first.shape[0] // 2:] = 0
        return (first,) + tuple(out[1:])
    return f


def flip(fn):
    """One answer altered where it is produced: a bit of one lane."""
    def f(*a, **k):
        out = fn(*a, **k)
        first = out[0].clone() if isinstance(out[0], torch.Tensor) \
            else out[0].copy()
        idx = (first.shape[0] - 1,) + (0,) * (first.ndim - 1)
        first[idx] ^= 1 << 2
        return (first,) + tuple(out[1:])
    return f


def plant(monkeypatch, cell: dict, fault) -> None:
    import alacjax_torch.codec as port
    kind = cell["traffic"]["kind"]
    if kind in ENTRY:
        monkeypatch.setattr(port, ENTRY[kind], fault(getattr(port,
                                                             ENTRY[kind])))
    else:
        monkeypatch.setattr(port.TorchCodec, "decode_frames_ex",
                            fault(port.TorchCodec.decode_frames_ex))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = rehearse(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert "metrics" not in r and "device" not in r
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [stale, half, flip])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    plant(monkeypatch, cell, fault)
    r = harness.run_cell(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    assert not r["correct"], (fault.__name__, r["checks"])
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, monkeypatch):
    import alacjax_torch.codec as port
    for attr in ENTRY.values():
        monkeypatch.setattr(port, attr, getattr(port, attr))
    monkeypatch.setattr(port.TorchCodec, "decode_frames_ex",
                        port.TorchCodec.decode_frames_ex)
    r = control.run(small_cell(name), SEED, "cpu")
    assert not r["correct"], r["checks"]


def test_traced_rehearsal_reads_no_device_metric():
    r = rehearse("cd16.playback", traced=True)
    assert r["correct"]
    assert not any(k.startswith(("decode_roofline", "glue_ms"))
                   for k in r["rehearsal"]["values"])


def test_segments_rehearsal_reads_its_host_metrics():
    r = rehearse("cd16.segments", traced=True)
    assert r["correct"]
    assert {"host_ms.segment", "segment_p95_ms"} <= set(
        r["rehearsal"]["values"])
