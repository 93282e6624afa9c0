"""The port against FFmpeg's independent ALAC codec (libavcodec), through
the shim of tests/test_ffmpeg_interop.py (``_build_lib``, ``FF``): skips,
as that file does, where libavcodec or gcc is missing.

* FFmpeg's encoder -> the port's decoder: 16-bit stereo (with a partial
  tail), 24-bit stereo (FFmpeg's s32p mode, bytesShifted 1), 5.1 (its
  own element layout, a frame and a partial tail) and orders 20..30
  decode through ``TorchCodec(device="cpu").decode_frames_ex`` to
  FFmpeg's input; the high orders also through decode_frames_device at
  30 taps, no lane flagged.
* the port's encoder -> FFmpeg's decoder: every depth (16/20/24/32) in
  mono and stereo, with a partial tail, and every layout of 3 to 8
  channels, lossless (32-bit stereo on tonal content: libavcodec cannot
  decode a 33-bit CPE escape, test_ffmpeg_interop.py says why).
"""

import numpy as np
import pytest
import torch

from alacjax_torch import BitBuffer, TorchCodec
from alacjax_torch.codec import _num_words, decode_frames_device
from alacjax_torch.cookie import parse_cookie
from alacjax_torch.ops import bitpack
from alacjax_torch.types import AlacConfig
from conftest import gen_pcm
from test_ffmpeg_interop import FF, FF_51_ORDER

S_OURS = 256     # the port's encodes: short frames keep them quick


@pytest.fixture(scope="module")
def ff():
    return FF()


def _decode_ex(cookie, packets, fallback=False):
    """(config, the decoded PCM joined) of FFmpeg's stream through
    decode_frames_ex, and the frames that went to the oracle if
    ``fallback``."""
    cfg = parse_cookie(cookie)
    codec = TorchCodec(cfg, chunk=len(packets), device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    got = np.concatenate([out[i, :, :nums[i]]
                          for i in range(len(packets))], axis=1)
    return (cfg, got, codec.fallback_frames) if fallback else (cfg, got)


def test_ffmpeg_16bit_and_high_order_torch_decode(ff, rng):
    """FFmpeg's default orders (with a partial tail) and its orders 20..30
    in one 16-bit stereo batch: decode_frames_ex returns FFmpeg's input,
    and the high-order packets decode at 30 taps with no lane flagged."""
    n = 2 * 4096 + 1000   # partial tail
    pcm = np.concatenate(
        [gen_pcm(rng, k, 2, 4096, 16) for k in ("sine", "noise", "impulse")],
        axis=1)[:, :n]
    cookie, pkts = ff.encode_stream(pcm, 16, 44100, 4096)
    t = np.arange(4096 + 2000)
    hi = np.stack([
        np.clip(9000 * np.sin(t * 0.0043) + 3000 * np.sin(t * 0.071)
                + rng.integers(-50, 50, len(t)), -32768, 32767),
        np.clip(8000 * np.sin(t * 0.0087 + 1), -32768, 32767),
    ]).astype(np.int64)
    _, hi_pkts = ff.encode_stream(hi, 16, 44100, 4096, min_order=20,
                                  max_order=30)
    b = BitBuffer(hi_pkts[0])
    b.advance(23 + 16)
    assert b.read(16) & 31 >= 20        # channel 0's order took effect
    cfg, got = _decode_ex(cookie, pkts + hi_pkts)
    assert cfg.bit_depth == 16 and cfg.frame_length == 4096
    np.testing.assert_array_equal(got, np.concatenate([pcm, hi], axis=1))
    words = torch.from_numpy(bitpack.bytes_to_words(
        hi_pkts, _num_words(cfg)).view(np.int32))
    y, err, num = decode_frames_device(words, cfg, cfg.frame_length, taps=30)
    assert not err.any()
    np.testing.assert_array_equal(
        np.concatenate([y[i, :, :num[i]].numpy()
                        for i in range(len(hi_pkts))], axis=1), hi)


def test_ffmpeg_24bit_torch_decode(ff, rng):
    n = 4096 + 777
    vals = gen_pcm(rng, "sine", 2, n, 24) + gen_pcm(rng, "noise", 2, n, 8)
    vals = np.clip(vals, -(1 << 23), (1 << 23) - 1)
    cookie, pkts = ff.encode_stream(vals << 8, 32, 96000, 4096)
    cfg, got = _decode_ex(cookie, pkts)
    assert cfg.bit_depth == 24
    np.testing.assert_array_equal(got, vals)


def test_ffmpeg_surround51_torch_decode(ff, rng):
    """FFmpeg writes an SCE where the 5.1 layout has its LFE; the device
    decode takes it as the oracle does, and no frame goes to the
    oracle."""
    pcm = gen_pcm(rng, "sine", 6, 600, 16) + np.arange(6)[:, None] * 13
    cookie, pkts = ff.encode_stream(pcm, 16, 48000, 4096)
    cfg, got, fallback = _decode_ex(cookie, pkts, fallback=True)
    assert fallback == 0
    # the port's element-order channel i is FFmpeg's input FF_51_ORDER[i]
    np.testing.assert_array_equal(got, pcm[FF_51_ORDER])


def _torch_encode(cfg, pcm):
    """The port's packets of planar (C, n) PCM, the tail partial."""
    S = cfg.frame_length
    nf = -(-pcm.shape[1] // S)
    frames = np.zeros((nf, cfg.num_channels, S), np.int64)
    nums = np.full(nf, S)
    for i in range(nf):
        blk = pcm[:, i * S:(i + 1) * S]
        frames[i, :, :blk.shape[1]] = blk
        nums[i] = blk.shape[1]
    return TorchCodec(cfg, chunk=nf, device="cpu").encode_frames_ex(
        frames, nums)


@pytest.mark.parametrize("depth", [16, 20, 24, 32])
@pytest.mark.parametrize("nch", [1, 2])
def test_torch_encode_ffmpeg_decodes(ff, rng, depth, nch):
    from alacjax_torch.cookie import serialize_cookie
    kinds = (("sine", "sine", "impulse") if depth == 32 and nch == 2
             else ("sine", "noise", "sine"))
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S_OURS,
                     sample_rate=44100)
    n = 2 * S_OURS + 100
    pcm = np.concatenate([gen_pcm(rng, k, nch, S_OURS, depth)
                          for k in kinds], axis=1)[:, :n]
    pkts = _torch_encode(cfg, pcm)
    outs = ff.decode_stream(serialize_cookie(cfg), pkts, nch, depth, 44100,
                            S_OURS)
    np.testing.assert_array_equal(np.concatenate(outs, axis=1), pcm)


@pytest.mark.parametrize("nch", [3, 4, 5, 6, 7, 8])
def test_torch_encode_every_layout_ffmpeg_decodes(ff, rng, nch):
    """FFmpeg's output order differs per layout tag: the permutation is
    read from distinguishable channels and must be a bijection."""
    from alacjax_torch.cookie import serialize_cookie
    cfg = AlacConfig(bit_depth=16, num_channels=nch, frame_length=S_OURS,
                     sample_rate=48000)
    pcm = gen_pcm(rng, "sine", nch, S_OURS, 16)
    pcm += (np.arange(nch)[:, None] + 1) * 977
    pkts = _torch_encode(cfg, pcm)
    outs = ff.decode_stream(serialize_cookie(cfg), pkts, nch, 16, 48000,
                            S_OURS)
    perm = []
    for row in outs[0]:
        hits = [i for i in range(nch) if (row == pcm[i]).all()]
        assert len(hits) == 1, f"output row matches {len(hits)} inputs"
        perm.append(hits[0])
    assert sorted(perm) == list(range(nch)), perm
