"""Persistent-bank stream encode, on the CPU, tolerance 0.

alacjax_torch.codec.encode_streams (its plain torch versions for
device="cpu") against alacjax.codec.encode_streams and against the
stateful scalar oracle ALACEncoder(cfg) (and the port's stateful native
C++ encoder, where it builds), every packet of every stream;
the banks the port's _encode_packet_chunks returns against the arrays of
alacjax's banks= branch after every packet; the cost kernel's plain
version with one starting-coefficient block per order against alacjax's
pc_block_cost2 run once per order.  Packet 1 of a stream starts from the
fresh coefficients in every bank, so only packets 2 and later can show a
bank indexed by the wrong order or channel: every stream here has three
or four packets, and the cases hold an element that escapes mid-stream
(white noise), which must leave its banks as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alacjax.codec import _encode_packet_chunks as jax_chunks
from alacjax.codec import encode_streams as jax_encode_streams
from alacjax.ops import predict as jpred
from alacjax.oracle import ALACEncoder
from alacjax.types import AlacConfig, KB0, MB0, PB0
from alacjax_torch import encode_stream_device, encode_streams, native
from alacjax_torch.codec import TorchCodec, _encode_packet_chunks, _num_words
from alacjax_torch.kernels import cost as k_cost
from alacjax_torch.ops.bitpack import words_to_bytes
from alacjax_torch.state import init_coefs_batched
from alacjax_torch.types import AlacParamError
from conftest import gen_pcm
from torch_encode_cases import torch_config

S = 256
RICE = (MB0, PB0, KB0, (1 << KB0) - 1)
MIXED = (("sine", "noise", "sine", "sine"),
         ("impulse", "sine", "noise", "impulse"))
CASES = {
    # tests/test_device_codec.py's persistent-stream cases ...
    "stereo16": (dict(bit_depth=16, num_channels=2),
                 [["sine"] * 4, ["noise"] * 4, ["impulse"] * 4]),
    "surround24": (dict(bit_depth=24, num_channels=6), [["sine"] * 3]),
    # ... fast mode (one bank per channel), and streams whose elements
    # escape between compressed packets
    "fast": (dict(bit_depth=16, num_channels=2, fast_mode=True),
             [["sine"] * 4, list(MIXED[0]), ["impulse"] * 4]),
    "escape_mid_stream": (dict(bit_depth=16, num_channels=2),
                          [list(k) for k in MIXED]),
}


def streams_pcm(cfg, kinds, seed):
    """(B, N, C, S) int32: stream b's packet n is gen_pcm of kinds[b][n]."""
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([gen_pcm(rng, k, cfg.num_channels, S,
                                       cfg.bit_depth) for k in ks])
                     for ks in kinds]).astype(np.int32)


def escaped(packet: bytes) -> bool:
    """The escape flag of the packet's first element (bit 22)."""
    return bool(packet[2] & 0x02)


def stateful_oracle(cfg, pcm):
    out = []
    for stream in pcm:
        enc = ALACEncoder(cfg)      # persistent banks
        out.append([enc.encode_packet(p) for p in stream])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_encode_streams_match_alacjax_and_the_stateful_oracle(case):
    kw, kinds = CASES[case]
    cfg = AlacConfig(frame_length=S, **kw)
    pcm = streams_pcm(cfg, kinds, seed=len(case))
    got = encode_streams(pcm, torch_config(cfg), device="cpu")
    assert got == jax_encode_streams(pcm, cfg)
    assert got == stateful_oracle(cfg, pcm)
    if native.available():      # the card's reference in chip_smoke.py
        for stream, packets in zip(pcm, got):
            enc = native.NativeEncoder(torch_config(cfg))
            assert packets == [enc.encode_packet(p) for p in stream]
    # the banks are used: some packet differs from an independent frame's
    indep = TorchCodec(torch_config(cfg), chunk=len(pcm) * pcm.shape[1],
                       device="cpu").encode_frames(
        pcm.reshape((-1,) + pcm.shape[2:]))
    one = ALACEncoder(cfg, independent_frames=True)
    assert indep == [one.encode_packet(f) for s in pcm for f in s]
    flat = [p for s in got for p in s]
    assert any(a != b for a, b in zip(flat, indep))
    if case in ("fast", "escape_mid_stream"):
        assert any(escaped(s[n]) and not escaped(s[n + 1])
                   for s in got for n in range(pcm.shape[1] - 1))


def test_predict_legacy_stream_encode_matches():
    """The standalone-predictor route carries the same banks."""
    kw, kinds = CASES["escape_mid_stream"]
    cfg = AlacConfig(frame_length=S, **kw)
    pcm = streams_pcm(cfg, kinds, seed=3)
    tcfg = torch_config(cfg)
    x = torch.from_numpy(pcm)
    want = encode_stream_device(x, tcfg, _num_words(tcfg))
    got = encode_stream_device(x, tcfg, _num_words(tcfg),
                               predict_legacy=True)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for ch, by in want[2].items():
        for od, bank in by.items():
            assert torch.equal(got[2][ch][od], bank)
    words, bits = (t.numpy() for t in got[:2])
    assert [words_to_bytes(words[b], bits[b]) for b in range(len(pcm))] \
        == stateful_oracle(cfg, pcm)


@pytest.mark.parametrize("fast", [False, True], ids=["standard", "fast"])
def test_new_banks_equal_alacjax_after_every_packet(fast):
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     fast_mode=fast)
    tcfg = torch_config(cfg)
    pcm = streams_pcm(cfg, [list(k) for k in MIXED], seed=11)
    B, N = pcm.shape[:2]
    nw = _num_words(tcfg)
    orders = [8] if fast else [4, 8]
    step = jax.jit(lambda p, bk: jax_chunks(p, cfg, nw, banks=bk))
    c0 = init_coefs_batched(B, "cpu")
    banks = {ch: {od: c0 for od in orders} for ch in range(2)}
    jbanks = {ch: {od: jnp.asarray(c0.numpy()) for od in orders}
              for ch in range(2)}
    for n in range(N):
        words, bits, banks = _encode_packet_chunks(
            torch.from_numpy(pcm[:, n]), tcfg, nw, banks=banks)
        jwords, jbits, jbanks = step(jnp.asarray(pcm[:, n]), jbanks)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      np.asarray(jwords))
        assert set(banks) == set(jbanks) == {0, 1}
        for ch in banks:
            assert set(banks[ch]) == set(jbanks[ch]) == set(orders)
            for od in orders:
                np.testing.assert_array_equal(banks[ch][od].numpy(),
                                              np.asarray(jbanks[ch][od]),
                                              err_msg=f"packet {n} ch {ch} "
                                                      f"order {od}")
    assert any(not torch.equal(banks[ch][od], c0)
               for ch in banks for od in orders)


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
def test_per_order_coefs0_cost_equals_alacjax_per_order(dual):
    """kernels/cost.plain with (n_orders, L, 16) starting coefficients:
    each order walks from its own block, as alacjax's pc_block_cost2 (or
    pc_block_cost_coefs) started from that block."""
    rng = np.random.default_rng(7)
    L, n = 33, 100
    x = rng.integers(-30000, 30000, (L, n)).astype(np.int32)
    x[1, ::3] = 0
    x[2] = rng.integers(-2, 3, n)
    orders = (4, 8) if dual else (8,)
    c0 = rng.integers(-400, 400, (len(orders), L, 16)).astype(np.int32)
    c0[:, 0] = 0
    cb = rng.choice([16, 17], L).astype(np.int32)
    num = np.where(rng.random(L) < 0.5, n, rng.integers(1, n + 1, L))
    got = k_cost.plain(torch.from_numpy(x), torch.from_numpy(c0), orders,
                       torch.from_numpy(cb), 9, *RICE, dual=dual,
                       num=torch.from_numpy(num.astype(np.int32)))
    for i, od in enumerate(orders):
        args = (jnp.asarray(x), jnp.asarray(c0[i]), od, jnp.asarray(cb), 9,
                *RICE)
        if dual:
            want = jpred.pc_block_cost2(*args, num=jnp.asarray(num))
            pairs = zip(got, want)
        else:
            res, c1, coefs = jpred.pc_block_cost_coefs(*args,
                                                       num=jnp.asarray(num))
            pairs = zip((got[0], got[1], got[3]), (res, c1, coefs))
        for g, w in pairs:
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_exhaustive_search_with_banks_raises():
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S, search="exhaustive"))
    pcm = np.zeros((1, 2, 2, S), np.int32)
    with pytest.raises(AlacParamError, match="independent-frames only"):
        encode_streams(pcm, cfg, device="cpu")
    c0 = init_coefs_batched(1, "cpu")
    with pytest.raises(AlacParamError, match="independent-frames only"):
        _encode_packet_chunks(torch.from_numpy(pcm[:, 0]), cfg,
                              _num_words(cfg),
                              banks={ch: {4: c0, 8: c0} for ch in range(2)})


def test_stream_entry_points_need_a_card_by_default():
    """encode_streams runs on the card unless asked for the CPU, and
    without a card it raises rather than fall back."""
    import inspect
    assert inspect.signature(encode_streams).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_streams(np.zeros((1, 1, 2, S), np.int32), cfg)
