"""The port's whole decode slice == alacjax's, bit for bit, and the round
trip is lossless.

Packets of stereo 16-bit frames (1024 samples; sine, silence, impulse and
an escaped noise frame) from the scalar oracle encoder go through TorchCodec's
host API; its device decode (pcm, err, num) equals
alacjax.codec.decode_frames_device on the same word image, and the
frames come back exactly.  An all-escape batch takes the decode's
scan-free arm.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from alacjax.codec import decode_frames_device as jax_decode
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig
from alacjax_torch import TorchCodec
from alacjax_torch.types import AlacParamError
from conftest import gen_pcm
from torch_encode_cases import torch_config

KINDS = ["sine", "silence", "impulse", "noise", "sine", "sine", "impulse",
         "silence"]


class RecordingCodec(TorchCodec):
    """TorchCodec that keeps its last chunk's words and device decode."""

    def _decode(self, words):
        out = super()._decode(words)
        self.last = (words, out)
        return out


def _decode_both(cfg, pcm):
    enc = ALACEncoder(cfg, independent_frames=True)
    return _decode_both_packets(cfg, [enc.encode_packet(f) for f in pcm])


def _decode_both_packets(cfg, packets):
    codec = RecordingCodec(torch_config(cfg), chunk=len(packets),
                           device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    words, tout = codec.last
    jout = jax_decode(jnp.asarray(words.numpy().view(np.uint32)), cfg,
                      cfg.frame_length)
    return codec, out, nums, tout, [np.asarray(a) for a in jout]


@pytest.fixture(scope="module")
def mixed():
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=1024)
    rng = np.random.default_rng(1025)
    pcm = np.stack([gen_pcm(rng, k, 2, cfg.frame_length, 16) for k in KINDS])
    return (cfg, pcm) + _decode_both(cfg, pcm)


def test_decode_matches_jax(mixed):
    _, _, _, _, _, tout, jout = mixed
    for name, g, w in zip(("pcm", "err", "num"), tout, jout):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_roundtrip_lossless(mixed):
    cfg, pcm, codec, out, nums, tout, _ = mixed
    assert not tout[1].numpy().any()
    assert codec.fallback_frames == 0
    np.testing.assert_array_equal(nums, cfg.frame_length)
    np.testing.assert_array_equal(out, pcm)


def test_all_escape_decode_matches_jax():
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=256)
    rng = np.random.default_rng(257)
    pcm = np.stack([gen_pcm(rng, "noise", 2, 256, 16) for _ in range(3)])
    codec, out, nums, tout, jout = _decode_both(cfg, pcm)
    for name, g, w in zip(("pcm", "err", "num"), tout, jout):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(out, pcm)


def test_flagged_frames_go_to_the_oracle():
    """A frame outside the 8-tap device grammar (an order-16 channel,
    built by hand) is flagged by the device decode and decoded by the
    scalar oracle: the codec's policy for such frames.  A partial (tail)
    frame decodes on the device.  The device decode still equals
    alacjax's on the same word image."""
    from test_high_order_decode import build_packet
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=256)
    rng = np.random.default_rng(258)
    pcm = np.stack([gen_pcm(rng, "sine", 2, 256, 16) for _ in range(3)])
    enc = ALACEncoder(cfg, independent_frames=True)
    tail = pcm[2][:, :100]
    packets = [enc.encode_packet(pcm[0]),
               build_packet(cfg, pcm[1], [16, 4], [0, 0]),
               enc.encode_packet(tail)]
    codec, out, nums, tout, jout = _decode_both_packets(cfg, packets)
    for name, g, w in zip(("pcm", "err", "num"), tout, jout):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(tout[1].numpy(), [False, True, False])
    assert codec.fallback_frames == 1
    np.testing.assert_array_equal(nums, [256, 256, 100])
    np.testing.assert_array_equal(out[:2], pcm[:2])
    np.testing.assert_array_equal(out[2][:, :100], tail)
    np.testing.assert_array_equal(out[2][:, 100:], 0)
    with pytest.raises(AlacParamError):
        codec.decode_frames(packets)
