"""The whole-track encode cell track16.library and the host-API encode
cell cd16.ingest-host, rehearsed as test_bench_faults.py rehearses the
others: whole runs at a tiny size on the CPU, where sound runs are
correct, and one flipped byte of one compared packet, a stale answer or
the reference's packets of the PCM one bit coarser (the control's
output) make them not correct.  A port whose stream encode takes no
banks fails the whole-track cell at its first call.  cd16.ingest-host
is ready under benchmark/ but not in BENCHMARK.json (its encode_fps
spreads between runs on one card's shared host wider than half its
bound): composed from its files."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import control
from benchmark import test_bench_faults as tf
from benchmark.lib import common, harness, inputs, manifest
from benchmark.ref import codec as rc
from benchmark.ref import stream as rs

SMALL = {"library": dict(lanes=8, packets_per_call=2, track_packets=4,
                         tracks=3, check_lanes=8),
         "ingest-host": dict(batch=8, distinct=4, batches=2, check_frames=8)}
CELLS = ["track16.library", "cd16.ingest-host"]


def ingest_host_cell() -> dict:
    join = os.path.join
    bench = manifest.BENCH_DIR
    return {"workload": {"name": "cd16.ingest-host", "traffic": "ingest-host",
                         "chips": 1},
            "config": json.load(open(join(bench, "configs", "cd16.json"))),
            "traffic": json.load(open(join(bench, "traffic",
                                           "ingest-host.json"))),
            "kind": join(bench, "kinds", "host_encode.py"),
            "end_to_end": [{"name": "encode_fps", "unit": "frames/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "host_ms.ingest", "unit": "ms",
                           "reader": join(bench, "metrics",
                                          "host_ms.ingest.py")}]}


def small_cell(name: str) -> dict:
    cell = (ingest_host_cell() if name == "cd16.ingest-host"
            else manifest.cell(manifest.load(), name))
    cell["config"] = dict(cell["config"], frame_length=128)
    cell["traffic"] = dict(cell["traffic"],
                           **SMALL[cell["workload"]["traffic"]])
    return cell


def run(name: str, traced: bool = False) -> dict:
    return harness.run_cell(small_cell(name), tf.SEED, 0.0, traced, "cpu",
                            time.perf_counter())


def flip_stream(fn):
    """One byte of the last lane's first packet of every call altered."""
    def f(*a, **k):
        words, bits, banks = fn(*a, **k)
        words = words.clone()
        words[-1, 0, 0] ^= 1 << 2
        return words, bits, banks
    return f


def flip_host(fn):
    """One byte of the last packet of every request altered."""
    def f(*a, **k):
        out = list(fn(*a, **k))
        last = bytearray(out[-1])
        last[3] ^= 1 << 2
        out[-1] = bytes(last)
        return out
    return f


def coarse_stream(x, config, num_words, banks=None, fresh=None):
    """The control: the reference's packets of the PCM one bit coarser,
    its banks carried as the port's."""
    lay = common.layout(coarse_stream.config)
    if banks is None:
        banks = rs.fresh_banks(x.shape[0], lay.channels, x.device)
    img, bits, banks, _ = rs.encode_stream(control.coarse(x), lay, banks,
                                           fresh)
    return inputs.as_i32(img), bits.to(torch.int32), banks


def coarse_host(self, pcm):
    lay = common.layout(coarse_host.config)
    img, bits, _ = rc.encode(control.coarse(torch.from_numpy(pcm)), lay)
    return inputs.packet_bytes(inputs.as_i32(img), bits)


def plant(monkeypatch, name: str, stream_fault, host_fault) -> None:
    import alacjax_torch.codec as port
    if name == "track16.library":
        monkeypatch.setattr(port, "encode_stream_device",
                            stream_fault(port.encode_stream_device))
    else:
        monkeypatch.setattr(port.TorchCodec, "encode_frames",
                            host_fault(port.TorchCodec.encode_frames))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["info"]["packets_compared"] >= 8
    assert "metrics" not in r and "device" not in r


@pytest.mark.parametrize("fault", ["flip", "stale"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    faults = {"flip": (flip_stream, flip_host),
              "stale": (tf.stale, tf.stale)}[fault]
    plant(monkeypatch, name, *faults)
    r = run(name)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, monkeypatch):
    config = small_cell(name)["config"]
    coarse_stream.config = coarse_host.config = config
    plant(monkeypatch, name, lambda fn: coarse_stream,
          lambda fn: coarse_host)
    r = run(name)
    assert not r["correct"], r["checks"]


def test_library_starts_tracks_where_the_phases_say():
    """Every lane passes a track start in the warm-up, and a step starts
    about lanes / track_packets tracks."""
    import alacjax_torch.codec as port
    seen = []
    real = port.encode_stream_device

    def spy(x, config, num_words, banks=None, fresh=None):
        seen.append((banks is None, fresh.clone()))
        return real(x, config, num_words, banks=banks, fresh=fresh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "encode_stream_device", spy)
        assert run("track16.library")["correct"]
    p = SMALL["library"]
    warm = p["track_packets"] // p["packets_per_call"]
    assert [s[0] for s in seen] == [True] + [False] * (len(seen) - 1)
    started = torch.cat([f for _, f in seen[:warm]], 1)
    assert started.any(1).all()
    assert started.sum() == p["lanes"]


def test_a_port_without_banks_fails_the_library_cell(monkeypatch):
    import alacjax_torch.codec as port

    def old(pcm, config, num_words, predict_legacy=False):
        return port.encode_frames_device(pcm[:, 0], config, num_words)

    monkeypatch.setattr(port, "encode_stream_device", old)
    with pytest.raises(TypeError):
        run("track16.library")


def test_host_rehearsal_reads_its_host_metric():
    r = run("cd16.ingest-host", traced=True)
    assert r["correct"]
    assert r["rehearsal"]["values"]["host_ms.ingest"] > 0
