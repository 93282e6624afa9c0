"""The port's residual-only Rice decode (alacjax_torch.ops.rice.rice_decode,
the decode wrapper's raw mode and the plain version of csrc/decode.cu's
raw instance) == alacjax.ops.rice.rice_decode, bit for bit, and equal to
the residuals the oracle's dyn_comp coded: one bit size for every lane
(16, 17, 32) and a bit size per lane.  The corpus is
tests/test_device_ops.py's: ordinary codewords, silence, zero-run-heavy
and sparse lanes, escapes at full scale and a run to the end."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.bitbuffer import BitBuffer
from alacjax.oracle import ag as oag
from alacjax.ops import bitpack as jbitpack
from alacjax.ops import rice as jrice
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.ops import rice as trice
from alacjax_torch.oracle import ag as tag

WB = (1 << KB0) - 1
S = 300


def _corpus(rng, bit_size):
    full = 1 << (bit_size - 1)
    sp = np.zeros(S, np.int64)
    sp[rng.integers(0, S, 20)] = rng.integers(-5, 6, 20)
    ex = np.zeros(S, np.int64)
    ex[::37] = full - 1
    ex[5::61] = -full
    z = np.zeros(S, np.int64)
    z[0] = 7                                        # a run to the end
    return np.stack([rng.integers(-1500, 1500, S), np.zeros(S, np.int64),
                     rng.integers(-3, 4, S), sp, ex, z])


def _coded(x, bit_sizes):
    """Word image of each lane's Rice stream, coded by the oracle, and
    the bits each took."""
    packed, bits = [], []
    for row, bs in zip(x, bit_sizes):
        bb = BitBuffer(byte_size=64)
        bits.append(oag.dyn_comp(tag.set_standard_ag_params(S, S), bb, row,
                                 S, int(bs)))
        packed.append(bb.to_bytes())
    W = max(len(p) for p in packed) // 4 + 3
    return jbitpack.bytes_to_words(packed, W), np.array(bits)


def _both(words, bit_size, max_bit_size=32):
    B = words.shape[0]
    start = np.zeros(B, np.int32)
    tb = bit_size if isinstance(bit_size, int) else torch.from_numpy(bit_size)
    got = trice.rice_decode(torch.from_numpy(words.view(np.int32)),
                            torch.from_numpy(start), S, tb, MB0, PB0, KB0, WB,
                            max_bit_size=max_bit_size)
    jb = bit_size if isinstance(bit_size, int) else jnp.asarray(bit_size)
    want = jrice.rice_decode(jnp.asarray(words), jnp.asarray(start), S, jb,
                             MB0, PB0, KB0, WB, max_bit_size=max_bit_size)
    return got, want


@pytest.mark.parametrize("bit_size", [16, 17, 32])
def test_rice_decode_matches_jax_and_oracle(rng, bit_size):
    x = _corpus(rng, bit_size)
    words, bits = _coded(x, [bit_size] * len(x))
    got, want = _both(words, bit_size)
    for name, g, w in zip(("residuals", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert not got[2].any()
    np.testing.assert_array_equal(got[0].numpy(), x)
    np.testing.assert_array_equal(got[1].numpy(), bits)


def test_rice_decode_per_lane_bit_size_matches_jax(rng):
    """Lanes coded at 16, 17, 20 and 24 bits in one call (max 24)."""
    sizes = np.array([16, 17, 20, 24] * 3, np.int32)
    x = np.stack([_corpus(rng, int(bs))[i % 6] for i, bs in enumerate(sizes)])
    words, bits = _coded(x, sizes)
    got, want = _both(words, sizes, max_bit_size=24)
    for name, g, w in zip(("residuals", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert not got[2].any()
    np.testing.assert_array_equal(got[0].numpy(), x)
    np.testing.assert_array_equal(got[1].numpy(), bits)


def test_bound_prices_the_rice_instances_at_the_rice_work():
    """chip_smoke.work prices the cursor and the raw decode at the Rice
    decode alone (the raw decode unfolding and writing its residuals
    besides, which the cursor never does), below the full decode of the
    same lanes, and counts stacked lanes as lanes, not word rows."""
    import chip_smoke
    from alacjax_torch.kernels import decode as k_decode
    from alacjax_torch.ops import fused_decode, tutils
    from torch_decode_cases import RICE, decode_lanes
    L, rows, n = 24, 8, 40
    words, lane = decode_lanes(np.random.default_rng(9), L, n, rows, taps=8)
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    head = (torch.from_numpy(words.view(np.int32)), t["start"], n, t["cb"],
            RICE[0], t["pb"], RICE[1], RICE[2])
    calls = [
        ("decode_cursor", k_decode.cursor_scan, fused_decode.cursor_scan,
         head, dict(chanbits_max=33, num=t["num"])),
        ("decode_raw", k_decode.decode_channel, fused_decode.decode_channel,
         head + (None,) * 4, dict(num=t["num"], chanbits_max=33, raw=True)),
        ("decode", k_decode.decode_channel, fused_decode.decode_channel,
         head + (t["coefs"], t["mode"], t["order"], t["den"]),
         dict(num=t["num"], chanbits_max=33))]
    priced, coded = [], []
    for call in calls:
        tutils.WORK = {}
        try:
            got = call[2](*call[3], **call[4])
            counts = tutils.WORK
        finally:
            tutils.WORK = None
        priced.append(chip_smoke.work(call, got, counts))
        coded.append(tutils.work_total(counts, "coded"))
    (b_cur, o_cur, ls_cur), (b_raw, o_raw, _), (_, o_dec, ls_dec) = priced
    assert ls_cur == ls_dec == L * n
    assert coded[0] == coded[1] > 0
    assert o_raw - o_cur == chip_smoke.UNFOLD * coded[0]
    assert o_cur < o_raw < o_dec
    assert b_raw - b_cur == L * n * 4            # the residuals written
