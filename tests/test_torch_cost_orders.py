"""The cost kernel's multi-order interface, on the CPU: one call of
alacjax_torch.kernels.cost.pc_block_cost2 with a tuple of orders (its
plain version for CPU tensors) equals one call of alacjax's
pc_block_cost2 (dual) or pc_block_cost_coefs (single machine) per order,
stacked in the order given, with per-lane chanbits and sample counts.
L = 33 lanes and S = 100 samples leave ragged edges against the
kernel's 32-lane x 32-sample tiles.  Tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import predict as jpred
from alacjax.oracle import dp as odp
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.kernels import cost as k_cost

RICE = (MB0, PB0, KB0, (1 << KB0) - 1)
L, S = 33, 100


def lanes(rng):
    """(L, S) samples of up to 16 bits taking every branch of the scan
    (silence, zero runs cut by num, impulses, noise), per-lane chanbits
    16/17/20/21 and sample counts (full, 1, S - 1, random)."""
    x = rng.integers(-30000, 30000, (L, S))
    x[0] = 0
    x[1, ::3] = 0
    x[2] = rng.integers(-2, 3, S)
    x[3, S // 2:] = 0
    x[4] = np.where(np.arange(S) % 17 == 0, 29000, 0)
    cb = rng.choice([16, 17, 20, 21], L).astype(np.int32)
    num = np.where(rng.random(L) < 0.5, S, rng.integers(1, S + 1, L))
    num[:4] = (S, 1, S - 1, S // 2 + 3)
    c0 = np.tile(np.asarray(odp.init_coefs(9), np.int32), (L, 1))
    return x.astype(np.int32), cb, num.astype(np.int32), c0


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
@pytest.mark.parametrize("orders", [(4, 8), (8,)], ids=["o4o8", "o8"])
def test_multi_order_cost_equals_one_alacjax_call_per_order(rng, orders,
                                                            dual):
    x, cb, num, c0 = lanes(rng)
    got = k_cost.pc_block_cost2(
        torch.from_numpy(x), torch.from_numpy(c0), orders,
        torch.from_numpy(cb), 9, *RICE, dual=dual, num=torch.from_numpy(num))
    n = len(orders)
    assert [tuple(g.shape) for g in got] == [(n, L, S), (n, L), (n, L),
                                             (n, L, 16)]
    args = (jnp.asarray(x), jnp.asarray(c0))
    for i, od in enumerate(orders):
        if dual:
            want = jpred.pc_block_cost2(*args, od, jnp.asarray(cb), 9, *RICE,
                                        num=jnp.asarray(num))
            pairs = zip(("res", "cost1", "cost2", "coefs"), got, want)
        else:
            want = jpred.pc_block_cost_coefs(*args, od, jnp.asarray(cb), 9,
                                             *RICE, num=jnp.asarray(num))
            pairs = zip(("res", "cost1", "coefs"),
                        (got[0], got[1], got[3]), want)
            assert not got[2][i].any()
        for name, g, w in pairs:
            np.testing.assert_array_equal(
                g[i].numpy().astype(np.int64) & 0xFFFFFFFF,
                np.asarray(w).astype(np.int64) & 0xFFFFFFFF,
                err_msg=f"order {od} {name}")
