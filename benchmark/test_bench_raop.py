"""The ``airplay16.receive`` cell on the CPU: PulseAudio's packet writer
(benchmark/ref/raop.py) lays its bits out as ``write_ALAC_data`` does;
whole runs of the ``raop_decode`` kind at a tiny size are correct, and
the control, every planted fault of test_bench_faults.py and the faults
this traffic adds (a wrong sample, a wrong count or an error flag on a
PulseAudio lane, a reference that disagrees) make them not correct; the
kind's bound counts Apple's lanes alone; ``parse_ms.decode`` reads the
parse kernel's time a call."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import control
from benchmark import test_bench_faults as tf
from benchmark.kinds import bulk_decode
from benchmark.lib import common, harness, inputs, manifest, trace
from benchmark.ref import raop

CELL = "airplay16.receive"
SMALL = dict(batch=16, distinct=8, batches=2, escape_share=0.5)
S = 352


def small_cell(**traffic) -> dict:
    cell = manifest.cell(manifest.load(), CELL)
    cell["traffic"] = dict(cell["traffic"], **dict(SMALL, **traffic))
    return cell


def run(cell: dict) -> dict:
    return harness.run_cell(cell, tf.SEED, 0.0, False, "cpu",
                            time.perf_counter())


def setup(**traffic):
    cell = small_cell(**traffic)
    config = cell["config"]
    ctx = common.Context(seed=tf.SEED, device="cpu", config=config,
                         params=cell["traffic"],
                         layout=common.layout(config),
                         port_config=common.port_config(config))
    return manifest.load_module(cell["kind"]).setup(ctx)


@pytest.mark.parametrize("end", [False, True], ids=["noend", "end"])
def test_writer_lays_out_write_ALAC_datas_bits(end):
    """Each packet's bytes against a bit string written out by hand: tag
    CPE (3 bits), instance 0 (4), 12 zero bits, hassize 1, bytes shifted
    0 (2), not compressed 1, the 32-bit count, then each sample pair,
    left then right, as 16-bit words; END only where asked."""
    config = manifest.cell(manifest.load(), CELL)["config"]
    lay = common.layout(config)
    pcm = inputs.music(3, lay, 44100, 7, 1, "cpu")
    img = raop.write_uncompressed(pcm, lay, end_tag=end)
    assert img.dtype == torch.int32 and img.shape == (3, lay.image_words())
    nbits = raop.packet_bits(S, end)
    assert nbits == 23 + 32 + 32 * S + 3 * end
    packets = inputs.packet_bytes(img, torch.full((3,), nbits))
    for f in range(3):
        s = "001" + "0000" + "0" * 12 + "1" + "00" + "1" + f"{S:032b}"
        for j in range(S):
            for c in range(2):
                s += f"{int(pcm[f, c, j]) & 0xFFFF:016b}"
        s += "111" * end
        s += "0" * (-len(s) % 8)
        assert packets[f] == int(s, 2).to_bytes(len(s) // 8, "big")
        # nothing past the packet
        tail = inputs.as_u32(img[f])[(nbits + 31) // 32:]
        assert not tail.any()


def test_writer_refuses_another_layout():
    config = dict(manifest.cell(manifest.load(), CELL)["config"],
                  bit_depth=24)
    lay = common.layout(config)
    with pytest.raises(ValueError, match="16-bit stereo"):
        raop.write_uncompressed(torch.zeros((1, 2, S), dtype=torch.int32),
                                lay)


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_sound_run_is_correct(share):
    r = run(small_cell(escape_share=share))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["info"]["ref_lanes_compared"] == SMALL["batch"]
    assert set(r["checks"]) == {"frames_wrong", "frames_flagged",
                                "counts_wrong", "ref_lanes_differ"}


def pulse_lanes(words):
    """The lanes whose header sets the escape flag (PulseAudio's); a batch
    may hold none."""
    return torch.nonzero((inputs.as_u32(words[:, 0]) >> 9) & 1)[:1, 0]


def wrong_sample(fn):
    def f(words, *a, **k):
        pcm, err, num = fn(words, *a, **k)
        pcm = pcm.clone()
        pcm[pulse_lanes(words), 1, S // 2] ^= 1
        return pcm, err, num
    return f


def wrong_count(fn):
    def f(words, *a, **k):
        pcm, err, num = fn(words, *a, **k)
        num = num.clone()
        num[pulse_lanes(words)] -= 1
        return pcm, err, num
    return f


def flags_escaped_lane(fn):
    def f(words, *a, **k):
        pcm, err, num = fn(words, *a, **k)
        err = err.clone()
        err[pulse_lanes(words)] = True
        return pcm, err, num
    return f


@pytest.mark.parametrize("fault", [tf.stale, tf.half, tf.flip, wrong_sample,
                                   wrong_count, flags_escaped_lane])
def test_fault_is_not_correct(fault, monkeypatch):
    import alacjax_torch.codec as port
    monkeypatch.setattr(port, "decode_frames_device",
                        fault(port.decode_frames_device))
    r = run(small_cell())
    assert not r["correct"], (fault.__name__, r["checks"])
    assert r["failed"] >= 1


def test_a_reference_that_disagrees_is_not_correct(monkeypatch):
    """The reference's comparison on its own: one sample of its decode
    altered fails the run."""
    kind = manifest.load_module(small_cell()["kind"])
    real = kind.rc.decode

    def off(img, lay):
        out, num, err = real(img, lay)
        out = out.clone()
        out[0, 0, 0] ^= 1
        return out, num, err
    monkeypatch.setattr(kind.rc, "decode", off)
    c = setup()
    c.run(0.0, trace.Tracer(False))
    checks, _, _, failed = c.check()
    assert checks["ref_lanes_differ"] == (1, 0)
    assert checks["frames_wrong"] == (0, 0) and failed >= 1


def test_control_is_not_correct(monkeypatch):
    """benchmark/control.py's bulk_decode control: the reference one bit
    below the configuration's depth."""
    import alacjax_torch.codec as port
    monkeypatch.setattr(port, "decode_frames_device",
                        port.decode_frames_device)
    cell = small_cell()
    control.install(dict(cell, traffic=dict(cell["traffic"],
                                            kind="bulk_decode")),
                    common.layout(cell["config"]))
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["checks"]["frames_wrong"]["value"] > 0


def test_bound_counts_apples_lanes_alone():
    c = setup(escape_share=0.0)
    c.per_batch = [2, 1]
    assert c.bounds(132, 1.98e9) == bulk_decode.Cell.bounds(c, 132, 1.98e9)
    assert c.bounds(132, 1.98e9)["decode"] > 0
    c = setup(escape_share=1.0)
    c.per_batch = [2, 1]
    assert c.bounds(132, 1.98e9) == {"decode": 0.0}


def test_parse_ms_reads_the_parse_kernel_a_call():
    reader = manifest.load_module(os.path.join(manifest.BENCH_DIR, "metrics",
                                               "parse_ms.decode.py"))

    class T:
        calls = 4
        device = [(0, 30_000, "void alac::parse_kernel<2, 16>(alac::Parse"
                   "Args)"),
                  (0, 90_000, "void alac::decode_kernel<8>(alac::Decode"
                   "Args)")]
        kernel_s = trace.Trace.kernel_s

    assert reader.read(T()) == pytest.approx(0.0075)
    T.device = T.device[1:]
    assert reader.read(T()) is None


def test_configuration_is_the_fmtp_lines():
    config = manifest.cell(manifest.load(), CELL)["config"]
    fields = [int(x) for x in config["fmtp"].split()[1:]]
    assert fields == [config[k] for k in (
        "frame_length", "compatible_version", "bit_depth", "pb", "mb", "kb",
        "num_channels", "max_run", "max_frame_bytes", "avg_bit_rate",
        "sample_rate")]
    entry = {c["name"]: c for c in manifest.load()["configs"]}["airplay16"]
    assert entry["reduced"] == [] and entry["source"] == config["source"]
    assert json.load(open(os.path.join(manifest.ROOT, entry["file"]))) \
        == config
