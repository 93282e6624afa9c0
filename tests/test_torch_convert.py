"""The converter slice against alacjax's: convert_file, routing, the
codec-cache key.

One stereo-16 WAV whose last frame is partial goes through
alacjax_torch.convert.convert_file(..., backend="torch", device="cpu")
and through alacjax.convert.convert_file(..., backend="jax") on the CPU:
the CAF and M4A bytes are identical, and so are the WAV bytes each
package decodes them to (one JAX configuration: S=64).  The routing
tests fake the torch backend, as tests/test_convert_routing.py fakes
the jax one.
"""

import dataclasses

import numpy as np
import pytest

from alacjax.containers.pcm import pack_pcm as jpack
from alacjax.containers.wav import WavFile as JWavFile
from alacjax.containers.wav import write_wav as jwrite_wav
from alacjax.convert import convert_file as jconvert_file
from alacjax_torch import convert
from alacjax_torch.codec import _codec_key_config
from alacjax_torch.containers.pcm import pack_pcm, unpack_pcm
from alacjax_torch.containers.wav import WavFile, read_wav
from alacjax_torch.oracle import ALACEncoder
from alacjax_torch.types import AlacConfig, AlacParamError

S = 64
N = 5 * S + 23            # a partial tail of 23 samples


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """{name: bytes} of both packages' outputs for one source WAV."""
    d = tmp_path_factory.mktemp("convert")
    rng = np.random.default_rng(64)
    t = np.arange(N)
    pcm = np.clip((np.sin(t * 0.05)[None] * 3000).astype(np.int64)
                  + rng.integers(-60, 60, (2, N)), -32768, 32767)
    pcm[:, 2 * S:3 * S] = rng.integers(-32768, 32768, (2, S))   # escapes
    src = str(d / "src.wav")
    jwrite_wav(JWavFile(44100, 16, 2, jpack(pcm, 16)), src)
    out = {"pcm": pcm, "src": open(src, "rb").read()}
    for ext in ("caf", "m4a"):
        mine, theirs = str(d / f"torch.{ext}"), str(d / f"jax.{ext}")
        convert.convert_file(src, mine, frame_length=S, backend="torch",
                             device="cpu")
        jconvert_file(src, theirs, frame_length=S, backend="jax")
        out[ext] = (open(mine, "rb").read(), open(theirs, "rb").read())
        back_t, back_j = str(d / f"t_{ext}.wav"), str(d / f"j_{ext}.wav")
        convert.convert_file(mine, back_t, backend="torch", device="cpu")
        jconvert_file(theirs, back_j, backend="jax")
        out[ext + ".wav"] = (open(back_t, "rb").read(),
                             open(back_j, "rb").read())
    return out


@pytest.mark.parametrize("ext", ["caf", "m4a"])
def test_encode_bytes_equal_alacjax(converted, ext):
    mine, theirs = converted[ext]
    assert mine[:4] in (b"caff", b"\x00\x00\x00\x1c")
    assert mine == theirs


@pytest.mark.parametrize("ext", ["caf", "m4a"])
def test_decode_bytes_equal_alacjax_and_source(converted, ext):
    mine, theirs = converted[ext + ".wav"]
    assert mine == theirs == converted["src"]
    got = read_wav(mine)
    np.testing.assert_array_equal(unpack_pcm(got.data, 16, 2),
                                  converted["pcm"])


def test_torch_packets_equal_oracle_and_verify(converted, tmp_path):
    from alacjax_torch.containers.caf import read_caf
    caf = read_caf(converted["caf"][0])
    enc = ALACEncoder(AlacConfig(frame_length=S, bit_depth=16,
                                 num_channels=2), independent_frames=True)
    pcm = converted["pcm"]
    assert caf.packets == [enc.encode_packet(pcm[:, o:o + S])
                           for o in range(0, N, S)]
    src = tmp_path / "s.wav"
    src.write_bytes(converted["src"])
    assert convert.verify_lossless(str(src), converted["m4a"][0],
                                   backend="torch", device="cpu") == N


def _wav(rng, n=3 * S + 5):
    pcm = rng.integers(-500, 500, (2, n))
    return WavFile(44100, 16, 2, pack_pcm(pcm, 16))


def _fake_torch_backend(calls):
    def enc(config, pcm, device, devices):
        calls.append((config, device, devices))
        e = ALACEncoder(config, independent_frames=True)
        return [e.encode_packet(pcm[:, o:o + config.frame_length])
                for o in range(0, pcm.shape[1], config.frame_length)]
    return (enc, None)


def test_exhaustive_routes_to_device_when_independent(monkeypatch):
    calls = []
    monkeypatch.setitem(convert._BACKENDS, "torch",
                        _fake_torch_backend(calls))
    caf = convert.encode_wav_to_caf(
        _wav(np.random.default_rng(1)), frame_length=S, backend="torch",
        independent_frames=True, search="exhaustive", device="cpu",
        devices=2)
    assert len(calls) == 1 and calls[0][0].search == "exhaustive"
    assert calls[0][1:] == ("cpu", 2)
    assert len(caf.packets) == 4


def test_exhaustive_stateful_stays_on_host(monkeypatch):
    """Without independent frames the stateful host codec runs (the
    device encoder cannot do stateful exhaustive)."""
    calls = []
    monkeypatch.setitem(convert._BACKENDS, "torch",
                        _fake_torch_backend(calls))
    wav = _wav(np.random.default_rng(2))
    caf = convert.encode_wav_to_caf(wav, frame_length=S, backend="torch",
                                    search="exhaustive")
    assert calls == []
    pcm = unpack_pcm(wav.data, 16, 2)
    enc = ALACEncoder(AlacConfig(frame_length=S, bit_depth=16,
                                 num_channels=2), search="exhaustive")
    assert caf.packets == [enc.encode_packet(pcm[:, o:o + S])
                           for o in range(0, pcm.shape[1], S)]


def test_get_backend_registers_torch_lazily():
    enc, dec = convert.get_backend("torch")
    from alacjax_torch import codec
    assert (enc, dec) == (codec._torch_encode_stream,
                          codec._torch_decode_stream)
    with pytest.raises(AlacParamError, match="unknown backend"):
        convert.get_backend("jax")


def test_codec_key_config_normalizes():
    """Cookie-only fields must not fragment the codec cache."""
    a = AlacConfig(bit_depth=16, num_channels=2, sample_rate=48000,
                   max_frame_bytes=9999, avg_bit_rate=123456)
    b = AlacConfig(bit_depth=16, num_channels=2, sample_rate=96000)
    assert _codec_key_config(a) == _codec_key_config(b)
    c = AlacConfig(bit_depth=16, num_channels=2, search="exhaustive")
    assert _codec_key_config(c) != _codec_key_config(b)
    assert dataclasses.replace(_codec_key_config(a), sample_rate=48000,
                               max_frame_bytes=9999,
                               avg_bit_rate=123456) == a


def test_sniff_and_unsupported_conversions():
    assert convert.sniff_format(b"RIFF\x00\x00\x00\x00WAVE") == "wav"
    assert convert.sniff_format(b"caff\x00\x01") == "caf"
    assert convert.sniff_format(b"\x00\x00\x00\x1cftypM4A ") == "m4a"
    with pytest.raises(AlacParamError):
        convert.sniff_format(b"junk" * 4)
    with pytest.raises(AlacParamError, match="unsupported"):
        convert.convert_file("a.wav", "b.wav")
