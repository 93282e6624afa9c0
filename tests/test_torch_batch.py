"""Cross-file batched transcoding in the port (alacjax_torch/batch.py),
after tests/test_batch.py, on backend="torch", device="cpu".

The grouped device batches must equal the port's scalar oracle packet
for packet (the device encoder is independent-frames, so sharing a
batch across files changes nothing), with chunk=2 so the slice budget
(4 * chunk = 8 packets) flushes in the middle of a group; the batch
decode is lossless; resume redoes only missing or broken outputs.
"""

import os
import time

import numpy as np
import pytest

from alacjax_torch.batch import convert_many
from alacjax_torch.containers.caf import read_caf
from alacjax_torch.containers.pcm import pack_pcm, unpack_pcm
from alacjax_torch.containers.wav import WavFile, probe_wav, read_wav, write_wav
from alacjax_torch.convert import convert_file
from alacjax_torch.oracle import ALACEncoder
from alacjax_torch.types import AlacConfig, AlacParamError

S = 64


def _make_wav(path, rng, n, nch=2, depth=16, rate=44100):
    full = 1 << (depth - 1)
    t = np.arange(n)
    base = (np.sin(t * 0.05)[None, :] * (full // 64)).astype(np.int64)
    pcm = np.clip(base + rng.integers(-40, 40, (nch, n)), -full, full - 1)
    write_wav(WavFile(sample_rate=rate, bit_depth=depth, num_channels=nch,
                      data=pack_pcm(pcm, depth)), str(path))
    return pcm


def _expected_packets(pcm, cfg):
    enc = ALACEncoder(cfg, independent_frames=True)
    return [enc.encode_packet(pcm[:, o:o + cfg.frame_length])
            for o in range(0, pcm.shape[1], cfg.frame_length)]


def test_batch_device_grouped_byte_parity(tmp_path):
    """Mixed configurations and tail lengths in ONE call, files grouped
    into shared device batches: every output's packets equal the oracle's
    and the batch decode is lossless."""
    rng = np.random.default_rng(2)
    jobs = [  # two groups: 16/2 (11 packets: flushes mid-group) and 24/1
        (2 * S, 2, 16), (2 * S, 2, 16), (S + 9, 2, 16), (2 * S, 2, 16),
        (7, 2, 16),
        (S + 1, 1, 24), (3 * S, 1, 24),
    ]
    srcs, pcms = [], []
    for i, (n, nch, depth) in enumerate(jobs):
        p = tmp_path / f"g{i}.wav"
        pcms.append(_make_wav(p, rng, n, nch=nch, depth=depth))
        srcs.append(str(p))

    outs = convert_many(srcs, str(tmp_path / "enc"), frame_length=S,
                        backend="torch", chunk=2, device="cpu")
    for (n, nch, depth), src, out, pcm in zip(jobs, srcs, outs, pcms):
        cfg = AlacConfig(frame_length=S, bit_depth=depth, num_channels=nch)
        caf = read_caf(out)
        assert caf.num_valid_frames == n
        assert caf.packets == _expected_packets(pcm, cfg), src
        single = str(tmp_path / "single.caf")
        convert_file(src, single, frame_length=S, backend="oracle",
                     independent_frames=True)
        assert open(out, "rb").read() == open(single, "rb").read(), src

    wavs = convert_many(outs, str(tmp_path / "dec"), backend="torch",
                        chunk=2, device="cpu")
    for (n, nch, depth), pcm, w in zip(jobs, pcms, wavs):
        got = read_wav(w)
        assert (got.bit_depth, got.num_channels) == (depth, nch)
        np.testing.assert_array_equal(
            unpack_pcm(got.data, got.bit_depth, got.num_channels), pcm)


def test_batch_oracle_roundtrip(tmp_path):
    """The planning and IO surface on the oracle backend: batch outputs
    equal single-file convert_file outputs, then a batch decode restores
    every file's PCM."""
    rng = np.random.default_rng(3)
    lens = [2 * S, S + 7, 5, 0]
    srcs, pcms = [], []
    for i, n in enumerate(lens):
        p = tmp_path / f"in{i}.wav"
        pcms.append(_make_wav(p, rng, n))
        srcs.append(str(p))
    outs = convert_many(srcs, str(tmp_path / "enc"), frame_length=S,
                        backend="oracle")
    for i, (src, out) in enumerate(zip(srcs, outs)):
        single = str(tmp_path / f"single{i}.caf")
        convert_file(src, single, frame_length=S, backend="oracle")
        assert open(out, "rb").read() == open(single, "rb").read(), src
    wavs = convert_many(outs, str(tmp_path / "dec"), backend="oracle")
    for pcm, w in zip(pcms, wavs):
        got = read_wav(w)
        np.testing.assert_array_equal(
            unpack_pcm(got.data, got.bit_depth, got.num_channels), pcm)


def test_batch_errors(tmp_path):
    a = tmp_path / "a.wav"
    _make_wav(a, np.random.default_rng(4), S)
    with pytest.raises(AlacParamError, match="collision"):
        convert_many([str(a), str(a)], str(tmp_path / "o"), device="cpu")
    with pytest.raises(AlacParamError, match="not a conversion"):
        convert_many([str(a)], str(tmp_path / "o"), to="wav", device="cpu")
    with pytest.raises(AlacParamError, match="extension"):
        convert_many([str(tmp_path / "x.txt")], str(tmp_path / "o"),
                     device="cpu")


def test_batch_resume_skips_valid_outputs(tmp_path):
    """resume=True redoes only missing or corrupt outputs: completed
    files keep their bytes (and mtimes), a truncated output is
    rewritten, on the torch backend."""
    rng = np.random.default_rng(5)
    srcs = []
    for i in range(3):
        p = tmp_path / f"r{i}.wav"
        _make_wav(p, rng, S + i)
        srcs.append(str(p))
    out = tmp_path / "enc"
    kw = dict(frame_length=S, backend="torch", chunk=4, device="cpu")
    outs = convert_many(srcs, str(out), **kw)
    first = [open(o, "rb").read() for o in outs]
    with open(outs[1], "wb") as f:
        f.write(b"caff\x00\x01trunc")
    os.remove(outs[2])
    mtime0 = os.path.getmtime(outs[0])
    time.sleep(0.05)
    assert convert_many(srcs, str(out), resume=True, **kw) == outs
    assert os.path.getmtime(outs[0]) == mtime0
    assert [open(o, "rb").read() for o in outs] == first


def test_probe_wav_matches_read_wav(tmp_path):
    rng = np.random.default_rng(6)
    for i, (n, nch, depth) in enumerate([(S + 3, 2, 16), (5, 1, 24),
                                         (0, 2, 32), (2 * S, 6, 20)]):
        p = tmp_path / f"p{i}.wav"
        _make_wav(p, rng, n, nch=nch, depth=depth)
        info = probe_wav(str(p))
        w = read_wav(str(p))
        assert (info.bit_depth, info.num_channels, info.sample_rate) == (
            w.bit_depth, w.num_channels, w.sample_rate)
        assert info.num_samples == w.num_frames == n
