"""The port's container and cookie copies against alacjax's originals.

alacjax_torch.containers (pcm, wav, caf, mp4) and cookie.cookie_size are
copies of alacjax's: on the same seeded numpy inputs they must write the
same bytes and parse the same fields, and fail on the same malformed
inputs.
"""

import dataclasses

import numpy as np
import pytest

import alacjax.containers as jc
import alacjax_torch.containers as tc
from alacjax import cookie as jcookie
from alacjax.containers import mp4 as jmp4
from alacjax.containers import wav as jwav
from alacjax.types import AlacParamError as JaxParamError
from alacjax_torch import cookie as tcookie
from alacjax_torch.containers import mp4 as tmp4
from alacjax_torch.containers import wav as twav
from alacjax_torch.types import AlacConfig, AlacParamError
from conftest import gen_pcm

DEPTHS = [16, 20, 24, 32]
LAYOUTS = [1, 2, 6, 8]


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("nch", LAYOUTS)
def test_pcm_pack_unpack_equal(depth, nch):
    rng = np.random.default_rng(depth * 10 + nch)
    x = gen_pcm(rng, "noise", nch, 301, depth)
    wire = tc.pack_pcm(x, depth)
    assert wire == jc.pack_pcm(x, depth)
    np.testing.assert_array_equal(tc.unpack_pcm(wire, depth, nch),
                                  jc.unpack_pcm(wire, depth, nch))
    with pytest.raises(AlacParamError):
        tc.unpack_pcm(wire[:-1], depth, nch)


@pytest.mark.parametrize("depth", DEPTHS)
def test_wav_write_read_probe_equal(tmp_path, depth):
    rng = np.random.default_rng(depth)
    x = gen_pcm(rng, "sine", 6, 517, depth)
    data = tc.pack_pcm(x, depth)
    blob = tc.write_wav(twav.WavFile(48000, depth, 6, data))
    assert blob == jc.write_wav(jwav.WavFile(48000, depth, 6, data))
    path = tmp_path / "x.wav"
    path.write_bytes(blob + b"LIST\x04\x00\x00\x00abcd")   # a trailing chunk
    assert _fields(tc.read_wav(str(path))) == _fields(jc.read_wav(str(path)))
    assert _fields(twav.probe_wav(str(path))) == _fields(
        jwav.probe_wav(str(path)))
    for bad in (b"RIFF" + blob[4:8] + b"WAVX" + blob[12:], blob[:30]):
        with pytest.raises(AlacParamError):
            tc.read_wav(bad)
        with pytest.raises(JaxParamError):
            jc.read_wav(bad)


def _caf(rng, nch: int, depth: int, n_pk: int, tail: int):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=4096,
                     sample_rate=44100)
    packets = [rng.integers(0, 256, int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes() for _ in range(n_pk)]
    return tc.CafFile(sample_rate=44100, bit_depth=depth, num_channels=nch,
                      frames_per_packet=4096,
                      cookie=tcookie.serialize_cookie(cfg), packets=packets,
                      num_valid_frames=4096 * (n_pk - 1) + tail)


def _jcaf(caf):
    return jc.CafFile(**_fields(caf))


@pytest.mark.parametrize("nch,depth,n_pk,tail", [
    (2, 16, 5, 4096), (2, 16, 7, 1), (6, 24, 3, 100), (1, 20, 1, 4095),
    (8, 32, 4, 2048)])
def test_caf_and_m4a_write_read_equal(nch, depth, n_pk, tail):
    rng = np.random.default_rng(nch * 100 + depth)
    caf = _caf(rng, nch, depth, n_pk, tail)
    blob = tc.write_caf(caf)
    assert blob == jc.write_caf(_jcaf(caf))
    assert _fields(tc.read_caf(blob)) == _fields(jc.read_caf(blob))
    m4a = tmp4.write_m4a(caf)
    assert m4a == jmp4.write_m4a(_jcaf(caf))
    assert _fields(tmp4.read_m4a(m4a)) == _fields(jmp4.read_m4a(m4a))
    for cut in (len(blob) // 2, 40):
        with pytest.raises(AlacParamError):
            tc.read_caf(blob[:cut])
        with pytest.raises(JaxParamError):
            jc.read_caf(blob[:cut])


def test_ber_encode_decode_equal():
    rng = np.random.default_rng(7)
    vals = ([0, 1, 127, 128, 300, 16383, 16384, 0xFFFFFFFF]
            + rng.integers(0, 1 << 32, 200).tolist())
    enc = tc.ber_encode(vals)
    assert enc == jc.ber_encode(vals)
    assert tc.ber_decode(enc, len(vals)) == jc.ber_decode(enc, len(vals))
    for bad in (b"\x80", b"\xff" * 6 + b"\x00"):
        with pytest.raises(AlacParamError):
            tc.ber_decode(bad, 1)
        with pytest.raises(JaxParamError):
            jc.ber_decode(bad, 1)


@pytest.mark.parametrize("nch", range(1, 9))
def test_cookie_size_equal(nch):
    cfg = AlacConfig(num_channels=nch)
    assert tcookie.cookie_size(nch) == jcookie.cookie_size(nch) == len(
        tcookie.serialize_cookie(cfg))
