"""The decode at per-lane chanbits 16..33: the port's plain
decode_channel (the decode kernel's plain version) == alacjax's
fused_decode.decode_channel on the same random words, bit for bit, at
8 taps and in the raw mode.  At chanbits 33 every sign extension gives
0 in both, the value csrc/common.cuh's sext_sh gives on the card.
Inputs: tests/torch_decode_cases.py (random words, every order, modes
0 and 15, partial lanes)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import fused_decode as jfd
from alacjax_torch.ops import fused_decode as tfd
from alacjax_torch.ops.tutils import sign_extend
from torch_decode_cases import RICE, decode_lanes

L, S = 48, 96


@pytest.fixture(scope="module")
def lanes():
    return decode_lanes(np.random.default_rng(33), L, S, taps=8)


@pytest.mark.parametrize("raw", [False, True])
def test_decode_channel_at_chanbits_16_to_33_matches_jax(lanes, raw):
    words, lane = lanes
    mb0, kb, wb = RICE
    assert 33 in lane["cb"]
    if raw:
        # the raw mode reads no predictor argument; alacjax's still flags
        # orders above its walk, so hand both order 0 (as rice_decode does)
        lane = dict(lane, order=np.zeros_like(lane["order"]))
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    got = tfd.decode_channel(
        torch.from_numpy(words.view(np.int32)), t["start"], S, t["cb"], mb0,
        t["pb"], kb, wb, t["coefs"], t["mode"], t["order"], t["den"],
        num=t["num"], taps=8, chanbits_max=33, raw=raw)
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    want = jfd.decode_channel(
        jnp.asarray(words), j["start"], S, j["cb"], mb0, j["pb"], kb, wb,
        j["coefs"], j["mode"], j["order"], j["den"], chanbits_max=33,
        taps=8, raw=raw, num=j["num"])
    for name, g, w in zip(("samples", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if not raw:
        # a 33-bit lane's samples past its first are 0 (mode 0 and
        # order 0 pass the residuals through)
        walked = (lane["cb"] == 33) & (lane["order"] != 0) & (lane["mode"] == 0)
        assert walked.any()
        assert not got[0][torch.from_numpy(walked), 1:].any()


def test_sign_extension_past_32_bits_is_zero():
    x = torch.tensor([5, -7, 1 << 31, -(1 << 31)], dtype=torch.int64)
    assert not sign_extend(x, 33).any()
    cb = torch.tensor([32, 33, 16, 33])
    assert sign_extend(x, cb).tolist() == [5, 0, 0, 0]
