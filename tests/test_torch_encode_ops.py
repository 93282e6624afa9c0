"""The port's plain Rice machines and fused search scan with per-lane
chanbits and sample counts == alacjax's, bit for bit.

rice_cost and rice_encode_words with a per-lane ``num`` (partial frames:
the machine flushes a pending run at num and emits nothing after) and a
per-lane bit size (SCE and CPE channels of 16 to 21 bits in one call);
pc_block_cost2 / pc_block_cost_coefs with both; then the plain scan and
emission against the TPU cost and emit kernels themselves in interpret
mode, with per-lane chanbits and num, at their minimum sample count.
These are the plain versions the CUDA cost, emit and rice_cost kernels
are held to on the card.
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
EMIT = ("words", "keys", "end_bits", "tail_val", "tail_key")


def lanes(rng, B, S):
    """(B, S) residual-like lanes taking every branch of the token
    machine (escapes at 21 bits, zero runs reaching a lane's end, small
    values), per-lane chanbits 16/17/20/21 and sample counts (full, 1,
    S-1, runs cut by num)."""
    x = rng.integers(-40000, 40000, (B, S))
    x[0] = 0
    x[1, ::3] = 0
    x[2] = rng.integers(-2, 3, S)
    x[3] = rng.integers(-(1 << 20), 1 << 20, S)
    x[4, :] = 0
    x[4, 0] = 5
    x[5, S // 2:] = 0
    cb = np.array([16, 17, 20, 21] * (B // 4), np.int32)
    num = np.full(B, S, np.int32)
    num[1::3] = rng.integers(1, S, len(num[1::3]))
    num[4], num[5], num[6] = 1, S // 2 + 7, S - 1
    return x.astype(np.int32), cb, num


def _eq(got, want, name):
    np.testing.assert_array_equal(
        np.asarray(got).astype(np.int64) & 0xFFFFFFFF,
        np.asarray(want).astype(np.int64) & 0xFFFFFFFF, err_msg=name)


@pytest.mark.parametrize("lane_bits", [False, True])
@pytest.mark.parametrize("with_num", [False, True])
def test_rice_cost_matches_jax(rng, lane_bits, with_num):
    x, cb, num = lanes(rng, 12, 160)
    bits = cb if lane_bits else 17
    got = trice.rice_cost(torch.from_numpy(x),
                          torch.from_numpy(cb) if lane_bits else 17, *RICE,
                          num=torch.from_numpy(num) if with_num else None)
    want = jrice.rice_cost(jnp.asarray(x),
                           jnp.asarray(bits) if lane_bits else 17, *RICE,
                           num=jnp.asarray(num) if with_num else None)
    _eq(got, want, "rice_cost")


@pytest.mark.parametrize("with_num", [False, True])
def test_rice_encode_words_lane_bits_matches_jax(rng, with_num):
    x, cb, num = lanes(rng, 12, 160)
    start = rng.integers(0, 3000, 12).astype(np.int32)
    got = trice.rice_encode_words(
        torch.from_numpy(x), torch.from_numpy(cb), *RICE,
        torch.from_numpy(start), bit_size_cap=21,
        num=torch.from_numpy(num) if with_num else None)
    want = jrice.rice_encode_words(
        jnp.asarray(x), jnp.asarray(cb), *RICE, jnp.asarray(start),
        bit_size_cap=21, emit_flush=False,
        num=jnp.asarray(num) if with_num else None)
    for name, g, w in zip(EMIT, got, want):
        _eq(g, w, name)


def _coefs(B):
    return np.tile(np.asarray(odp.init_coefs(9), dtype=np.int32), (B, 1))


@pytest.mark.parametrize("order", [4, 8])
def test_cost2_lane_chanbits_and_num_match_jax(rng, order):
    x, cb, num = lanes(rng, 12, 160)
    x = np.clip(x, -30000, 30000)            # samples of up to 16 bits
    c0 = _coefs(12)
    got = tpred.pc_block_cost2(torch.from_numpy(x), torch.from_numpy(c0),
                               order, torch.from_numpy(cb), 9, *RICE,
                               num=torch.from_numpy(num))
    want = jpred.pc_block_cost2(jnp.asarray(x), jnp.asarray(c0), order,
                                jnp.asarray(cb), 9, *RICE,
                                num=jnp.asarray(num))
    for name, g, w in zip(("res", "cost1", "cost2", "coefs"), got, want):
        _eq(g, w, name)
    got = tpred.pc_block_cost_coefs(torch.from_numpy(x), torch.from_numpy(c0),
                                    order, torch.from_numpy(cb), 9, *RICE,
                                    num=torch.from_numpy(num))
    want = jpred.pc_block_cost_coefs(jnp.asarray(x), jnp.asarray(c0), order,
                                     jnp.asarray(cb), 9, *RICE,
                                     num=jnp.asarray(num))
    for name, g, w in zip(("res", "cost", "coefs"), got, want):
        _eq(g, w, name)


def test_cost_matches_pallas_kernel_lane_num(rng):
    """The plain scan against the TPU cost kernel in interpret mode with
    its per-lane cb and num rows (cost_pallas.py:177-179)."""
    from alacjax.ops.pallas.cost_pallas import S_CHUNK, pc_block_cost2_pallas
    x, cb, num = lanes(rng, 8, S_CHUNK)
    x = np.clip(x, -30000, 30000)
    c0 = _coefs(8)
    want = pc_block_cost2_pallas(jnp.asarray(x), jnp.asarray(c0), 8,
                                 jnp.asarray(cb), 9, *RICE, na_max=8,
                                 num=jnp.asarray(num), dual=True,
                                 interpret=True)
    got = tpred.pc_block_cost2(torch.from_numpy(x), torch.from_numpy(c0), 8,
                               torch.from_numpy(cb), 9, *RICE,
                               num=torch.from_numpy(num))
    for name, g, w in zip(("res", "cost1", "cost2", "coefs"), got, want):
        _eq(g, w, name)


def test_emit_matches_pallas_kernel_lane_num(rng):
    """The plain emission against the TPU emit kernel in interpret mode
    with per-lane bit sizes up to 21 and num (emit_pallas.py:96-110)."""
    from alacjax.ops.pallas.cost_pallas import S_CHUNK
    from alacjax.ops.pallas.emit_pallas import rice_encode_words_pallas
    x, cb, num = lanes(rng, 8, S_CHUNK)
    start = rng.integers(0, 3000, 8).astype(np.int32)
    got = trice.rice_encode_words(
        torch.from_numpy(x), torch.from_numpy(cb), *RICE,
        torch.from_numpy(start), bit_size_cap=21, num=torch.from_numpy(num))
    want = rice_encode_words_pallas(
        jnp.asarray(x), jnp.asarray(cb), *RICE, jnp.asarray(start),
        bit_size_cap=21, num=jnp.asarray(num), interpret=True)
    for name, g, w in zip(EMIT, got, want):
        _eq(g, w, name)
