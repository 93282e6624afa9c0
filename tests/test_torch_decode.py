"""The port's fused channel decode (alacjax_torch.ops.fused_decode, the
decode kernel's plain version) == alacjax.ops.fused_decode.decode_channel
with taps=8, bit for bit: samples, end bits and the error flag.

Streams come from the scalar oracle encoder (predictor, optional
first-difference stage, adaptive Rice) for orders 0, 4, 8 and 31 (and
16, which the 8-tap walk flags), over sines, noise, silence and
zero-run-heavy lanes.  On such streams no refill underrun can occur, so
the port's error flag (zero-run overrun | order the walk does not
cover) equals the JAX one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.bitbuffer import BitBuffer
from alacjax.ops import bitpack as jbp
from alacjax.ops import fused_decode as jfd
from alacjax.oracle import ag as oag
from alacjax.oracle import dp as odp
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.ops import fused_decode as tfd
from alacjax_torch.oracle import ag as tag

WB = (1 << KB0) - 1
CB = 17


def streams(rng, orders, S, mode_nz):
    """Oracle-encoded channel streams, one lane per order -> ((B, W)
    uint32 word image, (B, 16) coefs0, (B, S) samples, stream bits)."""
    full = 1 << (CB - 2)
    packets, coefs0, xs = [], [], []
    for b, na in enumerate(orders):
        kind = b % 5
        if kind == 0:
            x = np.clip(np.sin(np.arange(S) * 0.07) * (full // 2),
                        -full, full - 1).astype(np.int64)
        elif kind == 1:
            x = rng.integers(-full, full, S)
        elif kind == 2:
            x = np.zeros(S, dtype=np.int64)
            x[::73] = rng.integers(-300, 300, len(x[::73]))
        elif kind == 3:
            x = rng.integers(-3, 4, S)
        else:
            x = np.zeros(S, dtype=np.int64)
            x[0] = 9                              # one run to the end
        c = odp.init_coefs(9)
        coefs0.append(np.asarray(c, dtype=np.int32).copy())
        s1 = odp.pc_block(x, c, na, CB, 9)
        if mode_nz:
            s1 = odp.pc_block(s1, odp.init_coefs(9), 31, CB, 9)
        bb = BitBuffer(byte_size=16 * S)
        oag.dyn_comp(tag.set_standard_ag_params(S, S), bb, s1, S, CB)
        packets.append(bb.to_bytes())
        xs.append(x)
    W = max(len(p) for p in packets) // 4 + 3
    return (jbp.bytes_to_words(packets, W), np.stack(coefs0), np.stack(xs),
            [8 * len(p) for p in packets])


@pytest.mark.parametrize("mode_nz", [False, True])
def test_decode_channel_matches_jax(rng, mode_nz):
    S = 240
    orders = [0, 4, 8, 31, 8, 16, 4, 0, 31, 8]
    B = len(orders)
    words, coefs0, xs, nbits = streams(rng, orders, S, mode_nz)
    lane = dict(
        start=np.zeros(B, np.int32), pb=np.full(B, PB0, np.int32),
        coefs0=coefs0, mode=np.full(B, 4 if mode_nz else 0, np.int32),
        order=np.array(orders, np.int32), den=np.full(B, 9, np.int32),
        num=np.full(B, S, np.int32))
    lane["num"][6] = S // 3                       # one partial lane
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    got = tfd.decode_channel(
        torch.from_numpy(words.view(np.int32)), t["start"], S, CB, MB0,
        t["pb"], KB0, WB, t["coefs0"], t["mode"], t["order"], t["den"],
        num=t["num"])
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    want = jfd.decode_channel(
        jnp.asarray(words), j["start"], S, CB, MB0, j["pb"], KB0, WB,
        j["coefs0"], j["mode"], j["order"], j["den"], taps=8, num=j["num"])
    for name, g, w in zip(("samples", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)

    # the lanes the 8-tap walk covers decode losslessly and end where
    # their stream ends; order 16 is flagged
    err = got[2].numpy()
    assert list(np.nonzero(err)[0]) == [orders.index(16)]
    for b in range(B):
        if err[b] or b == 6:
            continue
        np.testing.assert_array_equal(got[0][b].numpy(), xs[b])
        assert nbits[b] - 7 <= int(got[1][b]) <= nbits[b]
