"""The port's decode of every element layout and depth == alacjax's, bit
for bit, and lossless.

Packets of 128-sample frames from the scalar oracle encoder (sine,
noise that escapes, impulse, silence, and partial frames of 50, 70 and
1 samples) go through alacjax_torch.codec.decode_frames_device and
alacjax.codec.decode_frames_jit on the same word image; (pcm, err, num)
must be equal and the frames must come back exactly.  This file holds
20-bit mono and 24-bit SCE+CPE (3 channels); test_torch_layouts_51.py
holds 24-bit 5.1 and 32-bit stereo.  Also here: the two faults the
decode of depths above 16 needed fixed (the Rice escape width of a
24-bit channel, and the shift-byte block), the encoder's coverage of
the same layouts, and its refusal of a malformed bank table.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.codec import decode_frames_jit
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig
from alacjax_torch import TorchCodec
from alacjax_torch.codec import _encode_packet_chunks, decode_frames_device
from alacjax_torch.ops import bitpack
from alacjax_torch.types import AlacParamError
from conftest import gen_pcm
from torch_encode_cases import torch_config

S = 128
KINDS = ["sine", "noise", "impulse", "silence", "sine", "noise", "sine",
         "impulse"]
NUMS = [S, S, S, S, 50, 70, S, 1]


def encode(cfg, seed: int, kinds=KINDS, nums=NUMS):
    """(pcm (B, C, S) with zeros past each frame's length, packets)."""
    rng = np.random.default_rng(seed)
    enc = ALACEncoder(cfg, independent_frames=True)
    pcm = np.stack([gen_pcm(rng, k, cfg.num_channels, S, cfg.bit_depth)
                    for k in kinds])
    for b, n in enumerate(nums):
        pcm[b, :, n:] = 0
    return pcm, [enc.encode_packet(pcm[b][:, :n]) for b, n in enumerate(nums)]


def words_of(cfg, packets):
    num_words = (cfg.max_escape_packet_bytes(S) + 3) // 4 + 2
    return bitpack.bytes_to_words(packets, num_words)


def decode_both(cfg, packets):
    """(torch (pcm, err, num), jax (pcm, err, num)) as numpy arrays."""
    words = words_of(cfg, packets)
    got = decode_frames_device(torch.from_numpy(words.view(np.int32)),
                               torch_config(cfg), S)
    want = decode_frames_jit(jnp.asarray(words), cfg, S, 8)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def layout_case(depth: int, nch: int):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    pcm, packets = encode(cfg, 100 * depth + nch)
    return (pcm,) + tuple(decode_both(cfg, packets))


@pytest.fixture(scope="module", params=[(20, 1), (24, 3)],
                ids=["20bit-mono", "24bit-sce-cpe"])
def case(request):
    return layout_case(*request.param)


def test_decode_matches_jax(case):
    _, got, want = case
    for name, g, w in zip(("pcm", "err", "num"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_decode_is_lossless(case):
    pcm, (dec, err, num), _ = case
    assert not err.any()
    np.testing.assert_array_equal(num, NUMS)
    np.testing.assert_array_equal(dec, pcm)


def test_24bit_rice_escape_reads_chanbits_bits():
    """A 24-bit SCE channel carries 16 bits per sample after its shift
    byte, so a Rice escape holds 16 raw bits (chanbits = depth - 8*bs),
    not 24: an impulse after silence forces escape codewords."""
    cfg = AlacConfig(bit_depth=24, num_channels=1, frame_length=S)
    x = np.zeros((2, 1, S), np.int64)
    x[:, 0, 40] = 0x7F1234
    x[:, 0, 90] = -0x654321
    x[1, 0, 60:] = np.arange(S - 60) * 3001 - 99999
    packets = [ALACEncoder(cfg, independent_frames=True).encode_packet(f)
               for f in x]
    dec, err, num = (t.numpy() for t in decode_frames_device(
        torch.from_numpy(words_of(cfg, packets).view(np.int32)),
        torch_config(cfg), S))
    assert not err.any()
    np.testing.assert_array_equal(dec, x)


def test_24bit_shift_bytes_reinserted():
    """The low byte of every 24-bit sample travels in the shift-byte
    block between the channel parameters and the Rice streams; the
    decode puts it back under the reconstructed high part."""
    cfg = AlacConfig(bit_depth=24, num_channels=2, frame_length=S)
    rng = np.random.default_rng(24)
    t = np.arange(S)
    hi = np.stack([np.round(np.sin(t * 0.05 + p) * 20000) for p in (0, 1)])
    x = (hi.astype(np.int64) << 8) | rng.integers(0, 256, (2, S))
    packets = [ALACEncoder(cfg, independent_frames=True).encode_packet(x)]
    codec = TorchCodec(torch_config(cfg), chunk=1, device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 0
    np.testing.assert_array_equal(nums, [S])
    np.testing.assert_array_equal(out[0], x)


@pytest.mark.parametrize("depth,nch", [(24, 6), (16, 3), (20, 2)])
def test_encode_refuses_a_decode_only_layout(depth, nch):
    """No layout is decode-only any more: the encoder covers every layout
    and depth the decoder does, to the oracle's packets, and the codec
    decodes them back.  What the encoder refuses is a bank table that
    does not hold every channel's banks (here, none at all)."""
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=64)
    codec = TorchCodec(torch_config(cfg), chunk=2, device="cpu")
    pcm = np.zeros((2, nch, 64), np.int32)
    pcm[1, :, ::7] = 5
    packets = codec.encode_frames(pcm)
    enc = ALACEncoder(cfg, independent_frames=True)
    assert packets == [enc.encode_packet(f) for f in pcm]
    with pytest.raises(AlacParamError):
        _encode_packet_chunks(torch.from_numpy(pcm), codec.config,
                              codec.num_words,
                              banks={})
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 0
    np.testing.assert_array_equal(nums, [64, 64])
    np.testing.assert_array_equal(out, pcm)
