"""The standalone-predictor route == alacjax's, bit for bit.

The plain pc_block (the predictor kernel's reference) equals
alacjax.ops.predict.pc_block at static orders 1, 4, 8 and 16, in modes
0 and 31, and with a per-lane chanbits; and equals the TPU kernel
predict_pallas.pc_block_pallas itself in interpret mode at its own tile
(1024 lanes x 512 samples, order 8).  Then whole encodes with
predict_legacy=True (the trial, the search and fast mode through the
predictor and a separate Rice cost pass, the counterpart of
ALACJAX_PALLAS_PREDICT_LEGACY=1) give the same word images as the
default route and as alacjax's default encode, without launching the
fused cost kernel.  The environment switch itself is never flipped in
this process: alacjax caches traces that read it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import predict as jpred
from alacjax.oracle import dp as odp
from alacjax_torch import get_codec
from alacjax_torch.kernels import cost as k_cost
from alacjax_torch.kernels import predict as k_predict
from alacjax_torch.ops import predict as tpred
from torch_encode_cases import (
    S, jax_encode, make_config, make_frames, torch_config, torch_encode,
)


def corpus(rng, B, S, chanbits=17):
    """(B, S) int32 lanes: a sine, noise, silence, impulses, sparse and
    small values."""
    full = 1 << (chanbits - 2)
    t = np.arange(S)
    rows = [np.clip(np.sin(t * 0.05) * (full // 2), -full, full - 1),
            rng.integers(-full, full, S), np.zeros(S),
            np.where(t % 41 == 0, full - 1, 0),
            np.where(t % 3 == 0, rng.integers(-300, 300, S), 0),
            rng.integers(-2, 3, S)]
    while len(rows) < B:
        rows.append(rng.integers(-50, 51, S))
    return np.stack(rows[:B]).astype(np.int32)


def _coefs(B, rng=None):
    c = np.tile(np.asarray(odp.init_coefs(9), dtype=np.int32), (B, 1))
    if rng is not None:                     # transmitted-looking tables
        c[:, 3:] = rng.integers(-64, 64, (B, 13))
    return c


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=name)


@pytest.mark.parametrize("order", [1, 4, 8, 16, 0, 31])
def test_pc_block_matches_jax(rng, order):
    x = corpus(rng, 8, 200)
    c0 = _coefs(8, rng)
    got = tpred.pc_block(torch.from_numpy(x), torch.from_numpy(c0), order,
                         17, 9)
    want = jpred.pc_block(jnp.asarray(x), jnp.asarray(c0), order, 17, 9)
    _eq(got[0], want[0], "residuals")
    _eq(got[1], want[1], "coefs")


@pytest.mark.parametrize("order", [4, 8])
def test_pc_block_lane_chanbits_matches_jax(rng, order):
    """A stack of SCE (16-bit) and CPE (17-bit) channels in one call."""
    x = corpus(rng, 8, 200, chanbits=16)
    cb = np.array([16, 17] * 4, np.int32)
    c0 = _coefs(8)
    got = tpred.pc_block(torch.from_numpy(x), torch.from_numpy(c0), order,
                         torch.from_numpy(cb), 9)
    want = jpred.pc_block(jnp.asarray(x), jnp.asarray(c0), order,
                          jnp.asarray(cb), 9)
    _eq(got[0], want[0], "residuals")
    _eq(got[1], want[1], "coefs")


def test_pc_block_matches_pallas_kernel(rng):
    """The plain predictor against predict_pallas._kernel in interpret
    mode, at its tile (LANE_TILE x S_CHUNK), order 8."""
    from alacjax.ops.pallas.predict_pallas import (
        LANE_TILE, S_CHUNK, pc_block_pallas,
    )
    x = corpus(rng, LANE_TILE, S_CHUNK)
    c0 = _coefs(LANE_TILE, rng)
    want = pc_block_pallas(jnp.asarray(x), jnp.asarray(c0), 8, 17, 9,
                           interpret=True)
    got = k_predict.pc_block(torch.from_numpy(x), torch.from_numpy(c0), 8,
                             17, 9)
    _eq(got[0], want[0], "residuals")
    _eq(got[1], want[1], "coefs")


def test_rice_cost_wrapper_with_lane_args_takes_the_plain_version(rng):
    x = corpus(rng, 8, 100)
    cb = torch.from_numpy(np.array([16, 17, 20, 21] * 2, np.int32))
    num = torch.from_numpy(np.array([100, 1, 50, 99] * 2, np.int32))
    from alacjax_torch.ops import rice
    got = k_predict.rice_cost(torch.from_numpy(x), cb, 2, 40, 14, 16383,
                              num=num)
    assert torch.equal(got, rice.rice_cost(torch.from_numpy(x), cb, 2, 40,
                                           14, 16383, num=num))


CASES = {
    "stereo-16bit": (16, 2, None, {}),
    "sce-cpe-20bit-partial": (20, 3, [S, 300, S, 1, S, S, 600, S], {}),
    "stereo-16bit-fast": (16, 2, None, dict(fast_mode=True)),
}


@pytest.fixture(scope="module", params=list(CASES))
def routes(request):
    """One batch through the standalone-predictor route (counting the
    wrapper calls), the default route and alacjax's default encode."""
    depth, nch, nums, kw = CASES[request.param]
    cfg = make_config(depth, nch, **kw)
    pcm = make_frames(cfg, 3 * depth + nch, nums=nums)
    calls = {"cost": 0, "predict": 0, "rice_cost": 0}
    mp = pytest.MonkeyPatch()
    for mod, name, key in ((k_cost, "pc_block_cost2", "cost"),
                           (k_predict, "pc_block", "predict"),
                           (k_predict, "rice_cost", "rice_cost")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        mp.setattr(mod, name, counted)
    try:
        legacy = torch_encode(cfg, pcm, nums, predict_legacy=True)
        legacy_calls = dict(calls)
        default = torch_encode(cfg, pcm, nums)
    finally:
        mp.undo()
    return dict(legacy=legacy, default=default, calls=legacy_calls,
                jax=jax_encode(cfg, pcm, nums))


def test_legacy_route_words_match_default_route(routes):
    packets, words, bits = routes["legacy"]
    want_packets, want_words, want_bits = routes["default"]
    np.testing.assert_array_equal(bits, want_bits)
    np.testing.assert_array_equal(words, want_words)
    assert packets == want_packets


def test_legacy_route_words_match_alacjax(routes):
    _, words, bits = routes["legacy"]
    np.testing.assert_array_equal(bits, routes["jax"][1])
    np.testing.assert_array_equal(words, routes["jax"][0])


def test_legacy_route_skips_the_cost_kernel(routes):
    calls = routes["calls"]
    assert calls["cost"] == 0
    assert calls["predict"] >= 1 and calls["rice_cost"] >= 1


def test_legacy_route_prices_each_pass_in_one_launch(routes):
    """One predictor call for every order of a pass (the stereo trial,
    the search) and one Rice cost call for its residuals and, stage 2,
    their first difference: at most two of each per encode."""
    calls = routes["calls"]
    assert 1 <= calls["predict"] == calls["rice_cost"] <= 2


def test_get_codec_keys_on_the_route():
    cfg = torch_config(make_config(16, 2))
    a = get_codec(cfg, chunk=4, device="cpu", predict_legacy=True)
    assert a.predict_legacy
    assert get_codec(cfg, chunk=4, device="cpu", predict_legacy=True) is a
    assert get_codec(cfg, chunk=4, device="cpu") is not a
    assert not get_codec(cfg, chunk=4, device="cpu").predict_legacy
