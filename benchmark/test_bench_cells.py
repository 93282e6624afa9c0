"""The cells test_bench_faults.py does not list, ffmpeg30.playback-hi and
surround24.ingest, rehearsed the same way: whole runs at a tiny size on
the CPU, where sound runs are correct and the control and every planted
fault make them not correct.  And the high-order writer
(benchmark/ref/highorder.py): its packets decode through the reference
decoder to the PCM they were written from."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control
from benchmark import test_bench_faults as tf
from benchmark.lib import common, harness, inputs, manifest
from benchmark.ref import codec as rc
from benchmark.ref import highorder

CELLS = ["ffmpeg30.playback-hi", "surround24.ingest"]
SMALL = dict(tf.SMALL, **{"playback-hi": dict(batch=8, distinct=4,
                                              batches=2)})
ENTRY = dict(tf.ENTRY, bulk_decode_hi="decode_frames_device")


def small_cell(name: str) -> dict:
    cell = manifest.cell(manifest.load(), name)
    cell["config"] = dict(cell["config"], frame_length=128)
    cell["traffic"] = dict(cell["traffic"],
                           **SMALL[cell["workload"]["traffic"]])
    return cell


def run(cell: dict) -> dict:
    return harness.run_cell(cell, tf.SEED, 0.0, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert "metrics" not in r and "device" not in r


@pytest.mark.parametrize("fault", [tf.stale, tf.half, tf.flip])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    import alacjax_torch.codec as port
    cell = small_cell(name)
    entry = ENTRY[cell["traffic"]["kind"]]
    monkeypatch.setattr(port, entry, fault(getattr(port, entry)))
    r = run(cell)
    assert not r["correct"], (fault.__name__, r["checks"])
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, monkeypatch):
    """benchmark/control.py's control; for bulk_decode_hi its bulk_decode
    control, which reads no ``taps``."""
    import alacjax_torch.codec as port
    for attr in set(ENTRY.values()):
        monkeypatch.setattr(port, attr, getattr(port, attr))
    cell = small_cell(name)
    kind = cell["traffic"]["kind"]
    base = "bulk_decode" if kind == "bulk_decode_hi" else kind
    control.install(dict(cell, traffic=dict(cell["traffic"], kind=base)),
                    common.layout(cell["config"]))
    ctl = port.decode_frames_device
    if kind == "bulk_decode_hi":
        monkeypatch.setattr(port, "decode_frames_device",
                            lambda words, config, n, taps=8:
                            ctl(words, config, n))
    r = run(cell)
    assert not r["correct"], r["checks"]


def test_the_hi_cell_decodes_at_30_taps(monkeypatch):
    import alacjax_torch.codec as port
    seen = []
    real = port.decode_frames_device

    def spy(*a, **k):
        seen.append(k.get("taps", "default"))
        return real(*a, **k)

    monkeypatch.setattr(port, "decode_frames_device", spy)
    assert run(small_cell("ffmpeg30.playback-hi"))["correct"]
    assert seen and set(seen) == {30}


LAYOUTS = {
    "stereo16": dict(bit_depth=16, sample_rate=44100, elements=[["CPE", 2]]),
    "surround24": dict(bit_depth=24, sample_rate=48000,
                       elements=[["SCE", 1], ["CPE", 2], ["CPE", 2],
                                 ["LFE", 1]]),
}


@pytest.mark.parametrize("orders", ["all30", "1to30"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_writer_packets_decode_through_the_reference(name, orders):
    S, F = 96, 5
    cfg = dict(LAYOUTS[name], frame_length=S, mb=10, pb=40, kb=14)
    lay = common.layout(cfg)
    pcm = inputs.music(F, lay, cfg["sample_rate"], 29, 1, "cpu")
    num = torch.full((F,), S, dtype=torch.int64)
    num[-1] = S // 3 + 1
    pcm[-1, :, num[-1]:] = 0
    g = torch.Generator().manual_seed(31)
    if orders == "all30":
        ods = torch.full((F, lay.channels), 30)
    else:
        ods = torch.randint(1, 31, (F, lay.channels), generator=g)
        ods[0] = torch.arange(lay.channels) + 25
    img, bits, st = highorder.encode(pcm, lay, ods, num=num)
    assert torch.equal(st["order"], ods.T)
    assert not st["mode"].any()
    out, n, err = rc.decode(img, lay)
    assert not err.any()
    assert torch.equal(n, num)
    assert torch.equal(out, pcm.to(torch.int64))
    # the packet ends where the writer says it does
    assert ((bits + 31) // 32 <= img.shape[1]).all()


def test_writer_rejects_an_order_outside_its_range():
    cfg = dict(LAYOUTS["stereo16"], frame_length=16, mb=10, pb=40, kb=14)
    lay = common.layout(cfg)
    pcm = torch.zeros((1, 2, 16), dtype=torch.int32)
    for bad in (0, 31):
        with pytest.raises(ValueError):
            highorder.encode(pcm, lay, torch.tensor([[4, bad]]))
