"""The port's fused channel decode at 16 and 30 taps (the plain version of
the decode kernel's 16/30-tap instances) == alacjax's
fused_decode.decode_channel at the same taps, bit for bit: samples, end
bits and the error flag.

Lanes are channel 0 of legal packets with forced predictor orders
(tests/test_high_order_decode.py :: build_packet) in four element kinds,
so chanbits is per lane: 16-bit SCE (16), 16-bit CPE (17), 20-bit SCE
(20) and 20-bit CPE (21).  Orders span 0..30 and 31, modes 0 and 15,
and some lanes are partial frames.  At 16 taps the lanes above 16 must
flag err.  Also: the jax-free packet writer (tools/torch_fuzz_soak.py ::
build_packets, which chip_smoke.py calls) writes the same bytes as
build_packet, at the default knobs and over the whole grammar: random
orders 0..31, mode nibbles, denshifts, pb factors, mixbits and mixres,
partial frames, deviant bytesShifted and a DSE/FIL prefix.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import fused_decode as jfd
from alacjax.oracle import ALACDecoder
from alacjax.types import AlacConfig
from alacjax_torch.ops import fused_decode as tfd
from conftest import gen_pcm
from test_high_order_decode import build_packet
from test_torch_port import channel0_lanes

import chip_smoke

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

S = 128
CB_MAX = 21
# (depth, channels, channel 0's order, mode, num)
LANES = [
    (16, 1, 12, 0, S), (16, 2, 30, 15, S), (20, 1, 17, 0, 77),
    (20, 2, 24, 0, S), (16, 1, 9, 15, 100), (20, 1, 30, 0, S),
    (16, 2, 16, 0, S), (20, 2, 31, 0, S), (16, 1, 0, 0, S),
    (20, 1, 4, 15, S), (16, 2, 21, 15, 64), (20, 2, 8, 0, S),
]


@pytest.fixture(scope="module")
def lanes():
    return channel0_lanes(build_packet, LANES, S, 2030)


@pytest.mark.parametrize("taps", [16, 30])
def test_decode_channel_matches_jax(lanes, taps):
    words, lane, _ = lanes
    cfg = AlacConfig()
    wb = (1 << cfg.kb) - 1
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    got = tfd.decode_channel(
        torch.from_numpy(words.view(np.int32)), t["start"], S, t["cb"],
        cfg.mb, t["pb"], cfg.kb, wb, t["coefs"][:, :taps], t["mode"],
        t["order"], t["den"], num=t["num"], taps=taps, chanbits_max=CB_MAX)
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    want = jfd.decode_channel(
        jnp.asarray(words), j["start"], S, j["cb"], cfg.mb, j["pb"], cfg.kb,
        wb, j["coefs"][:, :taps], j["mode"], j["order"], j["den"],
        chanbits_max=CB_MAX, taps=taps, num=j["num"])
    for name, g, w in zip(("samples", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    big = (lane["order"] > taps) & (lane["order"] != 31)
    np.testing.assert_array_equal(got[2].numpy(), big)
    assert big.any() == (taps == 16)


def test_mono_lanes_decode_losslessly_at_30_taps(lanes):
    """Channel 0 of a mono packet is the whole frame: the 30-tap walk
    reproduces the scalar oracle decoder on it."""
    words, lane, packets = lanes
    cfg = AlacConfig()
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    samples, _, err = tfd.decode_channel(
        torch.from_numpy(words.view(np.int32)), t["start"], S, t["cb"],
        cfg.mb, t["pb"], cfg.kb, (1 << cfg.kb) - 1, t["coefs"], t["mode"],
        t["order"], t["den"], num=t["num"], taps=30, chanbits_max=CB_MAX)
    assert not err.any()
    for b, (depth, nch, _, _, num) in enumerate(LANES):
        if nch != 1:
            continue
        dec = ALACDecoder(AlacConfig(bit_depth=depth, num_channels=1,
                                     frame_length=S))
        y, got = dec.decode_packet(packets[b])
        assert got == num
        np.testing.assert_array_equal(samples[b, :num].numpy(), y[0, :num])


@pytest.mark.parametrize("depth,nch,orders,modes,num", [
    (16, 2, [19, 30], [0, 15], S),
    (16, 1, [24], [15], 90),
    (20, 3, [22, 18, 29], [0, 0, 15], S),
])
def test_chip_smoke_builder_matches_build_packet(depth, nch, orders, modes,
                                                 num):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    pcm = gen_pcm(np.random.default_rng(depth + nch), "sine", nch, S,
                  depth)[:, :num]
    assert (chip_smoke.forced_order_packet(cfg, pcm, orders, modes)
            == build_packet(cfg, pcm, orders, modes))


def _dse_fil_wrapped(body: bytes) -> bytes:
    """tests/test_grammar_fuzz.py's DSE/FIL construction: a FIL and a
    DSE element, then the body's bits."""
    from alacjax.bitbuffer import BitBuffer
    from alacjax.types import ElementTag
    bits = BitBuffer(byte_size=len(body) + 64)
    bits.write(int(ElementTag.FIL), 3)
    bits.write(3, 4)
    bits.write(0xABCDEF, 24)
    bits.write(int(ElementTag.DSE), 3)
    bits.write(0, 4)
    bits.write(1, 1)
    bits.write(2, 8)
    bits.byte_align(add_zeros=True)
    bits.write(0xBEEF, 16)
    rd = BitBuffer(body)
    total = len(body) * 8
    while rd.get_position() < total:
        take = min(32, total - rd.get_position())
        bits.write(rd.read(take), take)
    return bits.to_bytes()


@pytest.mark.parametrize("depth,nch", [(16, 1), (16, 2), (16, 3), (16, 6),
                                       (20, 2), (24, 2), (32, 2), (24, 1)])
def test_build_packets_matches_build_packet_over_the_grammar(depth, nch):
    """Twelve packets a shape, every knob random (rand_params at orders
    up to 31), one in three partial, the depth's bytesShifted or a
    deviant one, all built in one build_packets call, then with a
    DSE/FIL prefix: byte for byte build_packet's."""
    from alacjax.oracle.encoder import bytes_shifted_for_depth
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    rng = np.random.default_rng(700 + 10 * depth + nch)
    bs0 = bytes_shifted_for_depth(depth)
    pcms, params = [], []
    for i in range(12):
        num = S if i % 3 else int(rng.integers(1, S))
        pcms.append(gen_pcm(rng, ["sine", "noise", "silence", "impulse"][
            i % 4], nch, S, depth)[:, :num])
        orders, modes, dens, pbfs, mixbits, mixres = soak.rand_params(
            rng, nch, 30)
        bs = bs0 if i % 4 else (bs0 + 1) % 3 if depth < 32 else 1
        params.append(soak.Params(orders, modes, dens, pbfs, mixbits, mixres,
                                  bs))
    got = soak.build_packets(cfg, pcms, params)
    for pcm, p, g in zip(pcms, params, got):
        want = build_packet(cfg, pcm, p.orders, p.modes, mixres=p.mixres,
                            denshifts=p.denshifts, pbfs=p.pbfs,
                            mixbits=p.mixbits, bytes_shifted=p.bytes_shifted)
        assert g == want, p
        assert soak.build_packet(
            cfg, pcm, p.orders, p.modes, p.mixres, p.denshifts, p.pbfs,
            p.mixbits, p.bytes_shifted, dse_fil=True) == _dse_fil_wrapped(
                want), p


def test_build_packets_over_a_pool_matches_build_packet():
    """build_packets mapped over spawned host workers (``host_pool``, the
    card's route) returns build_packet's bytes, in order."""
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
    rng = np.random.default_rng(77)
    pcms, params = [], []
    for i in range(9):
        pcms.append(gen_pcm(rng, ["sine", "noise", "impulse"][i % 3], 2, S,
                            16))
        params.append(soak.Params(*soak.rand_params(rng, 2, 30),
                                  dse_fil=i == 4))
    with soak.host_pool(2) as pool:
        got = soak.build_packets(cfg, pcms, params, pool)
    assert got == soak.build_packets(cfg, pcms, params)
    for pcm, p, g in zip(pcms, params, got):
        if not p.dse_fil:
            assert g == build_packet(cfg, pcm, p.orders, p.modes,
                                     mixres=p.mixres, denshifts=p.denshifts,
                                     pbfs=p.pbfs, mixbits=p.mixbits), p
