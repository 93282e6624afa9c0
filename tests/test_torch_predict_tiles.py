"""The standalone predictor's and the Rice cost pass's plain versions
(alacjax_torch.kernels.predict :: plain_pc_block and plain_rice_cost,
what the CPU wrappers run) == alacjax.ops.predict.pc_block and
alacjax.ops.rice.rice_cost, bit for bit, at the edges of csrc/predict.cu's
tiles: S on either side of the 32-sample tile and not a multiple of it,
lane counts one and three past a warp, per-lane chanbits 16..33 and
sample counts, every static order with its own block of starting
coefficients.  The multi-order and dual forms equal the per-call
compositions they stand for, exactly.  Inputs from the jax-free
tests/torch_predict_cases.py, which the card test of the kernels
(tests/test_torch_port.py) shares."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import jaxutils as ju
from alacjax.ops import predict as jpred
from alacjax.ops import rice as jrice
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.kernels import predict as k_predict
from alacjax_torch.ops import predict as tpred
from alacjax_torch.ops import tutils as tu
from torch_predict_cases import CASES, ORDER_PAIRS, predict_lanes, rice_lanes

WB = (1 << KB0) - 1
RICE = (MB0, PB0, KB0, WB)
# each case with two order pairs; every pair meets three cases
PAIRED = [(L, S, ORDER_PAIRS[(i + k) % len(ORDER_PAIRS)])
          for i, (L, S) in enumerate(CASES) for k in (0, 4)]


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=name)


@pytest.mark.parametrize("L,S,orders", PAIRED)
def test_pc_block_orders_at_tile_edges_match_jax(L, S, orders):
    x, cb, c0 = predict_lanes(np.random.default_rng(L * 1000 + S), L, S)
    tx, tcb, tc0 = map(torch.from_numpy, (x, cb, c0))
    res, coefs = k_predict.pc_block(tx, tc0, orders, tcb, 9)
    assert tuple(res.shape) == (2, L, S) and tuple(coefs.shape) == (2, L, 16)
    for i, od in enumerate(orders):
        want = jpred.pc_block(jnp.asarray(x), jnp.asarray(c0[i]), od,
                              jnp.asarray(cb), 9)
        _eq(res[i], want[0], f"residuals, order {od}")
        _eq(coefs[i], want[1], f"coefs, order {od}")
        one = k_predict.pc_block(tx, tc0[i], od, tcb, 9)
        assert torch.equal(one[0], res[i]) and torch.equal(one[1], coefs[i])
    shared = k_predict.pc_block(tx, tc0[0], orders, tcb, 9)
    for i, od in enumerate(orders):
        one = k_predict.pc_block(tx, tc0[0], od, tcb, 9)
        assert torch.equal(shared[0][i], one[0])
        assert torch.equal(shared[1][i], one[1])


@pytest.mark.parametrize("L,S", CASES)
def test_rice_cost_at_tile_edges_matches_jax(L, S):
    r, bs, num = rice_lanes(np.random.default_rng(L * 1000 + S), L, S)
    tr, tbs, tnum = map(torch.from_numpy, (r, bs, num))
    jr, jbs, jnum = map(jnp.asarray, (r, bs, num))
    for n, jn in ((None, None), (tnum, jnum)):
        single = k_predict.rice_cost(tr, tbs, *RICE, num=n)
        dual = k_predict.rice_cost(tr, tbs, *RICE, num=n, dual=True)
        assert tuple(dual.shape) == (2, L)
        _eq(single, jrice.rice_cost(jr, jbs, *RICE, num=jn), "residuals")
        _eq(dual[1], jrice.rice_cost(jpred.wrap_diff(jr, jbs), jbs, *RICE,
                                     num=jn), "first difference")
        assert torch.equal(dual[0], single)
        assert torch.equal(dual[1], k_predict.rice_cost(
            tpred.wrap_diff(tr, tbs), tbs, *RICE, num=n))


def test_sign_extend_past_32_bits_matches_jax():
    """At 33 bits the C idiom's shift is negative: alacjax gives 0 (XLA's
    out-of-range shifts), and so does the port (it kept the value)."""
    x = np.array([[0, 5, -5, 2**31 - 1, -2**31]] * 2, np.int32)
    bits = np.array([32, 33], np.int32)
    _eq(tu.sign_extend(torch.from_numpy(x), 33),
        ju.sign_extend(jnp.asarray(x), 33), "int width")
    _eq(tu.sign_extend(torch.from_numpy(x), torch.from_numpy(bits)),
        ju.sign_extend(jnp.asarray(x), jnp.asarray(bits)), "per-lane width")
