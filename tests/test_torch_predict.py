"""The port's encode-side scan (alacjax_torch.ops.predict, the cost
kernel's plain version) == alacjax.ops.predict, bit for bit.

Orders 4 and 8 with one cost machine (the mixres trial's route) and two
(the search's), on lanes that mix sines, noise, silence, impulses and
zero-run-heavy small values; then the same plain version against the
TPU cost kernel itself in interpret mode at its minimum sample count.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import predict as jpred
from alacjax.ops import rice as jrice
from alacjax.oracle import dp as odp
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.ops import predict as tpred
from alacjax_torch.ops import rice as trice

WB = (1 << KB0) - 1
RICE = (MB0, PB0, KB0, WB)


def corpus(rng, chanbits, B, S):
    """(B, S) int32 lanes: sine, noise, silence, impulses, sparse and
    small values (zero runs of every length), then small noise."""
    full = 1 << (chanbits - 2)
    t = np.arange(S)
    rows = [np.clip(np.sin(t * 0.05) * (full // 2), -full, full - 1),
            rng.integers(-full, full, S),
            np.zeros(S),
            np.where(t % 41 == 0, full - 1, 0),
            np.where(t % 3 == 0, rng.integers(-300, 300, S), 0),
            rng.integers(-2, 3, S)]
    while len(rows) < B:
        rows.append(rng.integers(-50, 51, S))
    return np.stack(rows[:B]).astype(np.int32)


def _coefs(B):
    return np.tile(np.asarray(odp.init_coefs(9), dtype=np.int32), (B, 1))


def _eq(got, want, name):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=name)


@pytest.mark.parametrize("chanbits", [16, 17])
@pytest.mark.parametrize("order", [4, 8])
def test_cost2_matches_jax(rng, order, chanbits):
    B, S = 8, 160
    x = corpus(rng, chanbits, B, S)
    c0 = _coefs(B)
    got = tpred.pc_block_cost2(torch.from_numpy(x), torch.from_numpy(c0),
                               order, chanbits, 9, *RICE)
    want = jpred.pc_block_cost2(jnp.asarray(x), jnp.asarray(c0), order,
                                chanbits, 9, *RICE)
    for name, g, w in zip(("res", "cost1", "cost2", "coefs"), got, want):
        _eq(g, w, name)
    # stage 2 prices the first difference of the residuals
    _eq(tpred.wrap_diff(got[0], chanbits),
        jpred.wrap_diff(jnp.asarray(want[0]), chanbits), "wrap_diff")
    _eq(trice.rice_cost(tpred.wrap_diff(got[0], chanbits), chanbits, *RICE),
        want[2], "rice_cost of the stage-2 residuals")


@pytest.mark.parametrize("order", [4, 8])
def test_cost_single_matches_jax(rng, order):
    """One cost machine: pc_block_cost_coefs and pc_block_cost."""
    B, S = 8, 160
    x = corpus(rng, 17, B, S)
    c0 = _coefs(B)
    got = tpred.pc_block_cost_coefs(torch.from_numpy(x), torch.from_numpy(c0),
                                    order, 17, 9, *RICE)
    want = jpred.pc_block_cost_coefs(jnp.asarray(x), jnp.asarray(c0), order,
                                     17, 9, *RICE)
    for name, g, w in zip(("res", "cost", "coefs"), got, want):
        _eq(g, w, name)
    res, cost = tpred.pc_block_cost(torch.from_numpy(x), torch.from_numpy(c0),
                                    order, 17, 9, *RICE)
    _eq(res, want[0], "pc_block_cost res")
    _eq(cost, want[1], "pc_block_cost cost")
    _eq(trice.rice_cost(res, 17, *RICE),
        jrice.rice_cost(jnp.asarray(want[0]), 17, *RICE), "rice_cost")


@pytest.mark.parametrize("order,dual", [(8, True), (8, False), (4, True)])
def test_cost_matches_pallas_kernel(rng, order, dual):
    """The plain scan (the CUDA kernel's reference) against the TPU cost
    kernel in interpret mode, at its minimum sample count (S_CHUNK)."""
    from alacjax.ops.pallas.cost_pallas import S_CHUNK, pc_block_cost2_pallas
    B, S = 8, S_CHUNK
    x = corpus(rng, 17, B, S)
    c0 = _coefs(B)
    want = pc_block_cost2_pallas(jnp.asarray(x), jnp.asarray(c0), order, 17,
                                 9, *RICE, na_max=order, dual=dual,
                                 interpret=True)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c0)
    if dual:
        got = tpred.pc_block_cost2(xt, ct, order, 17, 9, *RICE)
        names = ("res", "cost1", "cost2", "coefs")
    else:
        got = tpred.pc_block_cost_coefs(xt, ct, order, 17, 9, *RICE)
        want = (want[0], want[1], want[3])
        names = ("res", "cost1", "coefs")
    for name, g, w in zip(names, got, want):
        _eq(g, w, name)
