"""Three public ops of alacjax that no codec path calls and that have no
kernel there either (XLA glue kept by its tests), ported as torch ops and
held to alacjax's, bit for bit: predict.unpc_block (the inverse
predictor, static and per-lane orders), rice.rice_encode_tokens (the
token stream in bitstream order) and bitpack.combine_chunks (the
sort-based assembler, its duplicate budget's overflow poisoning
included)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.oracle import dp as odp
from alacjax.ops import bitpack as jbitpack
from alacjax.ops import predict as jpredict
from alacjax.ops import rice as jrice
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.ops import bitpack as tbitpack
from alacjax_torch.ops import predict as tpredict
from alacjax_torch.ops import rice as trice

WB = (1 << KB0) - 1
MASK = 0xFFFFFFFF


def _u32(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64) & MASK


@pytest.mark.parametrize("numactive", [0, 4, 8, 16, 31])
def test_unpc_block_static_order_matches_jax(rng, numactive):
    """The residuals of the oracle's pc_block come back to the samples,
    with alacjax's adapted coefficients."""
    B, S, chanbits = 3, 120, 17
    x = rng.integers(-(1 << 16), 1 << 16, (B, S))
    c0 = np.asarray(odp.init_coefs(9), np.int32)
    res = np.stack([odp.pc_block(x[b], c0.copy(), numactive, chanbits, 9)
                    for b in range(B)]).astype(np.int32)
    c0b = np.broadcast_to(c0, (B, 16)).copy()
    got = tpredict.unpc_block(torch.from_numpy(res), torch.from_numpy(c0b),
                              numactive, chanbits, 9)
    want = jpredict.unpc_block(jnp.asarray(res), jnp.asarray(c0b), numactive,
                               chanbits, 9)
    for name, g, w in zip(("samples", "coefs"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[0].numpy(), x)


def test_unpc_block_per_lane_orders_matches_jax(rng):
    """Per-lane orders 0, 4, 8, 16 and 31 in one call, per-lane
    denshift, random starting coefficients."""
    nas = np.array([0, 4, 8, 16, 31, 8], np.int32)
    B, S = len(nas), 90
    res = rng.integers(-3000, 3000, (B, S)).astype(np.int32)
    c0 = rng.integers(-500, 500, (B, 16)).astype(np.int32)
    den = np.array([9, 9, 5, 12, 9, 1], np.int32)
    got = tpredict.unpc_block(torch.from_numpy(res), torch.from_numpy(c0),
                              torch.from_numpy(nas), 17, torch.from_numpy(den))
    want = jpredict.unpc_block(jnp.asarray(res), jnp.asarray(c0),
                               jnp.asarray(nas), 17, jnp.asarray(den))
    for name, g, w in zip(("samples", "coefs"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("bit_size", [16, 17, 32])
def test_rice_encode_tokens_matches_jax(rng, bit_size):
    """Codewords, zero runs (one to the end of the frame), escapes."""
    B, S = 5, 150
    full = 1 << (bit_size - 1)
    x = rng.integers(-1500, 1500, (B, S))
    x[1] = 0
    x[2] = rng.integers(-3, 4, S)
    x[3, ::13] = full - 1
    x[4, 1:] = 0
    x = x.astype(np.int32)
    got = trice.rice_encode_tokens(torch.from_numpy(x), bit_size, MB0, PB0,
                                   KB0, WB)
    want = jrice.rice_encode_tokens(jnp.asarray(x), bit_size, MB0, PB0, KB0,
                                    WB)
    for name, g, w in zip(("vals", "lens"), got, want):
        np.testing.assert_array_equal(_u32(g), _u32(w), err_msg=name)


def _chunk_streams(rng, B, W, dups):
    """Per lane the words 0..W-1 as (key, value) slots in a random order,
    ``dups`` of them split in two (disjoint bits, the same key), and
    empty slots."""
    T = W + max(dups) + 5
    keys = np.full((B, T), MASK, np.uint32)
    vals = np.zeros((B, T), np.uint32)
    for b in range(B):
        k = list(range(W))
        v = list(rng.integers(0, 1 << 32, W, dtype=np.uint64))
        for j in rng.choice(W, dups[b], replace=False):
            hi = v[j] & np.uint64(0xFFFF0000)
            v[j] = v[j] & np.uint64(0xFFFF)
            k.append(j)
            v.append(hi)
        perm = rng.permutation(len(k))
        keys[b, :len(k)] = np.asarray(k, np.uint32)[perm]
        vals[b, :len(k)] = np.asarray(v, np.uint64)[perm].astype(np.uint32)
    return keys, vals


def test_combine_chunks_matches_jax(rng):
    """Lanes within the duplicate budget, at it, and past it (poisoned)."""
    B, W, max_dups = 5, 40, 4
    keys, vals = _chunk_streams(rng, B, W, [0, 2, 4, 5, 9])
    got = tbitpack.combine_chunks(torch.from_numpy(vals.view(np.int32)),
                                  torch.from_numpy(keys.view(np.int32)), W,
                                  max_dups=max_dups)
    want = jbitpack.combine_chunks(jnp.asarray(vals), jnp.asarray(keys), W,
                                   max_dups=max_dups)
    np.testing.assert_array_equal(_u32(got), _u32(want))
    order = np.argsort(keys, axis=1, kind="stable")
    for b in range(3):                        # within budget: every word
        dense = np.zeros(W, np.uint64)
        for k, v in zip(keys[b][order[b]], vals[b][order[b]]):
            if k != MASK:
                dense[k] += v
        np.testing.assert_array_equal(_u32(got)[b], dense.astype(np.int64))


def test_combine_chunks_overflow_poisons_lane():
    """tests/test_bitpack_fields.py's case: lane 1 exceeds the budget and
    comes back bit-inverted, lane 0 exactly."""
    W, max_dups = 6, 2
    k0 = [0, 1, 2, 2, 2, 3, 4, 5]
    v0 = [10, 11, 4, 4, 4, 13, 14, 15]
    k1 = [0, 0, 0, 0, 1, 2, 3, 4, 5]
    v1 = [1, 1, 1, 1, 21, 22, 23, 24, 25]
    keys = np.full((2, 9), MASK, np.uint32)
    vals = np.zeros((2, 9), np.uint32)
    keys[0, :8], vals[0, :8] = k0, v0
    keys[1], vals[1] = k1, v1
    got = _u32(tbitpack.combine_chunks(torch.from_numpy(vals.view(np.int32)),
                                       torch.from_numpy(keys.view(np.int32)),
                                       W, max_dups=max_dups))
    want = _u32(jbitpack.combine_chunks(jnp.asarray(vals), jnp.asarray(keys),
                                        W, max_dups=max_dups))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [10, 11, 12, 13, 14, 15])
    assert (got[1] >> 31).all()               # small words, inverted
    with pytest.raises(ValueError, match="slot count"):
        tbitpack.combine_chunks(torch.zeros((1, 3), dtype=torch.int32),
                                torch.zeros((1, 3), dtype=torch.int32), 4)
