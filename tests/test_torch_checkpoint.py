"""Checkpoint/resume in the port (alacjax_torch/checkpoint.py), after
tests/test_checkpoint.py, on backend="torch", device="cpu": an injected
failure resumes without redoing finished chunks, a torn packet journal
rolls back to its last whole packet, and the finished file's packets
equal the port's scalar oracle's.
"""

import os

import numpy as np
import pytest

from alacjax_torch import checkpoint
from alacjax_torch.containers import pack_pcm, read_caf, read_m4a, write_wav
from alacjax_torch.containers.pcm import unpack_pcm
from alacjax_torch.containers.wav import WavFile
from alacjax_torch.convert import decode_caf_to_wav
from alacjax_torch.oracle import ALACEncoder
from alacjax_torch.types import AlacConfig
from conftest import gen_pcm

S = 128
KW = dict(frame_length=S, backend="torch", device="cpu")


def _make_wav(path, n=S * 7 + 50, seed=0):
    x = gen_pcm(np.random.default_rng(seed), "sine", 2, n, 16)
    write_wav(WavFile(44100, 16, 2, pack_pcm(x, 16)), str(path))
    return x


def _oracle_packets(x):
    enc = ALACEncoder(AlacConfig(frame_length=S, bit_depth=16,
                                 num_channels=2), independent_frames=True)
    return [enc.encode_packet(x[:, o:o + S]) for o in range(0, x.shape[1], S)]


def _check(out, x, reader=read_caf):
    caf = reader(str(out))
    assert caf.packets == _oracle_packets(x)
    back = decode_caf_to_wav(caf, backend="torch", device="cpu")
    np.testing.assert_array_equal(unpack_pcm(back.data, 16, 2), x)


def test_resumable_encode_roundtrip(tmp_path):
    wav, out = tmp_path / "in.wav", tmp_path / "out.caf"
    x = _make_wav(wav)
    st = checkpoint.resumable_encode(str(wav), str(out), chunk_frames=2,
                                     **KW)
    assert st.frames_done == st.num_frames == 7
    checkpoint.finalize(str(wav), str(out), backend="torch", device="cpu")
    assert not os.path.exists(str(out) + ".journal")
    _check(out, x)


def test_resume_after_injected_failure(tmp_path):
    wav, out = tmp_path / "in.wav", tmp_path / "out.caf"
    x = _make_wav(wav, seed=1)
    with pytest.raises(RuntimeError, match="injected"):
        checkpoint.resumable_encode(str(wav), str(out), chunk_frames=2,
                                    _fail_after_chunks=2, **KW)
    assert checkpoint.load_state(str(out)).frames_done == 4
    st = checkpoint.resumable_encode(str(wav), str(out), chunk_frames=2,
                                     **KW)
    assert st.frames_done == 7
    checkpoint.finalize(str(wav), str(out), backend="torch", device="cpu")
    _check(out, x)


def test_resume_survives_torn_tail(tmp_path):
    """A crash mid-append (torn packet bytes) rolls back to the last
    consistent packet, and the resumed file is whole."""
    wav, out = tmp_path / "in.wav", tmp_path / "out.m4a"
    x = _make_wav(wav, seed=2)
    with pytest.raises(RuntimeError):
        checkpoint.resumable_encode(str(wav), str(out), chunk_frames=2,
                                    _fail_after_chunks=2, **KW)
    pp = str(out) + ".packets"
    with open(pp, "r+b") as f:
        f.truncate(os.path.getsize(pp) - 3)
    assert checkpoint.load_state(str(out)).frames_done == 3
    checkpoint.resumable_encode(str(wav), str(out), chunk_frames=2, **KW)
    checkpoint.finalize(str(wav), str(out), backend="torch", device="cpu")
    _check(out, x, read_m4a)


def test_config_change_restarts(tmp_path):
    wav, out = tmp_path / "in.wav", tmp_path / "out.caf"
    _make_wav(wav, seed=3)
    with pytest.raises(RuntimeError):
        checkpoint.resumable_encode(str(wav), str(out), chunk_frames=2,
                                    _fail_after_chunks=1, **KW)
    st = checkpoint.resumable_encode(str(wav), str(out), frame_length=64,
                                     backend="torch", chunk_frames=4,
                                     device="cpu")
    assert st.num_frames == (S * 7 + 50) // 64
    assert st.frames_done == st.num_frames
