"""The decode's retry ladder (8 -> 16 -> 30 taps), through TorchCodec's
host API, with alacjax's JaxCodec rule and threshold: a chunk of at
least 64 frames in which at least a quarter of the lanes are flagged
decodes again at 16 taps, then at 30; lanes still flagged go to the
scalar oracle.

Packets carry forced predictor orders (tests/test_high_order_decode.py
:: build_packet).  A chunk of orders 12 and 24 decodes entirely on the
device path (orders 12 fixed at 16 taps, 24 at 30), equal to the oracle;
a chunk with one order-24 lane in 64 sends that lane to the oracle.
"""

import numpy as np
import pytest

from alacjax.oracle import ALACDecoder, ALACEncoder
from alacjax.types import AlacConfig
from alacjax_torch import TorchCodec
from alacjax_torch.kernels import decode as k_decode
from conftest import gen_pcm
from test_high_order_decode import build_packet
from torch_encode_cases import torch_config

S = 64
N = 64


@pytest.fixture()
def taps_seen(monkeypatch):
    """The taps of every channel decode the codec asks for."""
    seen = []
    wrapped = k_decode.decode_channel

    def recorder(*args, taps=8, **kwargs):
        seen.append(taps)
        return wrapped(*args, taps=taps, **kwargs)

    monkeypatch.setattr(k_decode, "decode_channel", recorder)
    return seen


def _oracle(cfg, packets):
    dec = ALACDecoder(cfg)
    return np.stack([dec.decode_packet(p)[0] for p in packets])


def test_high_order_chunk_decodes_on_the_ladder(taps_seen):
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    rng = np.random.default_rng(1224)
    packets = []
    for b in range(N):
        order = 12 if b % 2 else 24
        pcm = gen_pcm(rng, "sine", 2, S, 16)
        packets.append(build_packet(cfg, pcm, [order, order],
                                    [15 * (b % 3 == 0)] * 2))
    codec = TorchCodec(torch_config(cfg), chunk=N, device="cpu")
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 0
    assert sorted(set(taps_seen)) == [8, 16, 30]
    np.testing.assert_array_equal(nums, S)
    np.testing.assert_array_equal(out, _oracle(cfg, packets))


def test_few_flagged_lanes_go_to_the_oracle(taps_seen):
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    rng = np.random.default_rng(1)
    enc = ALACEncoder(cfg, independent_frames=True)
    pcm = [gen_pcm(rng, "sine", 1, S, 16) for _ in range(N)]
    packets = [enc.encode_packet(x) for x in pcm]
    packets[17] = build_packet(cfg, pcm[17], [24], [0])
    codec = TorchCodec(torch_config(cfg), chunk=N, device="cpu")
    out, _ = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 1
    assert set(taps_seen) == {8}
    np.testing.assert_array_equal(out, np.stack(pcm))
