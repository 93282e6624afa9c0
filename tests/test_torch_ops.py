"""alacjax_torch's small plain ops == alacjax's, bit for bit (tolerance 0).

tutils at the 32-bit edge values, matrix (mix/unmix/shift_off/shift_in),
bitpack (assemble, field pack/unpack, segment place/extract, the chunk
merge and the host serializers) and the coefficient-table helpers.  The
same numpy arrays go through the JAX function on the CPU and its torch
counterpart.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from alacjax.ops import bitpack as jbp
from alacjax.ops import jaxutils as ju
from alacjax.ops import matrix as jmx
from alacjax.oracle import dp as odp
from alacjax_torch import state
from alacjax_torch.ops import bitpack as tbp
from alacjax_torch.ops import matrix as tmx
from alacjax_torch.ops import tutils as tu

# 0, 1, 2^31-1, 2^31, 2^32-1 as int32 bit patterns, plus a few neighbours
EDGES = np.array([0, 1, 2, 3, 0x7FFFFFFF, -2**31, -1, -2, 0x7FFFFFFE,
                  -2**31 + 1, 65535, 65536, -65536], dtype=np.int32)


def _jit(fn, *static):
    """The JAX function compiled as one program (much faster on the CPU
    than op-by-op dispatch; the same arithmetic)."""
    return jax.jit(fn, static_argnums=static)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got.numpy() if
                                             isinstance(got, torch.Tensor)
                                             else got).astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=msg)


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def test_tutils_edge_values():
    x = EDGES
    _eq(tu.clz32(_t(x)), ju.clz32(jnp.asarray(x)), "clz32")
    _eq(tu.lg3a(_t(x)), ju.lg3a(jnp.asarray(x)), "lg3a")
    _eq(tu.sign_of_int(_t(x)), ju.sign_of_int(jnp.asarray(x)), "sign")
    for bits in (8, 16, 17, 24, 31, 32):
        _eq(tu.sign_extend(_t(x), bits), ju.sign_extend(jnp.asarray(x), bits),
            f"sign_extend {bits}")
    for n in (0, 1, 9, 31):
        _eq(tu.arith_shift_right(_t(x), n),
            ju.arith_shift_right(jnp.asarray(x), n), f">> {n}")
    _eq(tu.iota1(7), np.asarray(ju.iota1(7)), "iota1")
    # per-lane sign_extend widths broadcast on the leading axis
    xs = np.tile(x, (3, 1))
    bits = np.array([8, 17, 32], dtype=np.int32)
    _eq(tu.sign_extend(_t(xs), _t(bits)),
        ju.sign_extend(jnp.asarray(xs), jnp.asarray(bits)), "per-lane")
    # the int32 <-> unsigned round trip the port keeps at module borders
    _eq(tu.as_i32_bits(tu.u32(_t(x))), x, "u32 round trip")
    _eq(tu.u32(_t(x)), _u32(x), "u32")


@pytest.mark.parametrize("mixres", [0, 1, 2, 3, 4, "perlane"])
def test_matrix_matches_jax(rng, mixres):
    B, S = 6, 40
    left = rng.integers(-2**16, 2**16, (B, S)).astype(np.int32)
    right = rng.integers(-2**16, 2**16, (B, S)).astype(np.int32)
    left[0, :len(EDGES)] = EDGES
    right[1, :len(EDGES)] = EDGES
    mr = (rng.integers(0, 5, (B, 1)).astype(np.int32) if mixres == "perlane"
          else mixres)
    mr_t = _t(mr) if mixres == "perlane" else mr
    mr_j = jnp.asarray(mr) if mixres == "perlane" else mr
    tu_, tv_ = tmx.mix(_t(left), _t(right), 2, mr_t)
    ju_, jv_ = jmx.mix(jnp.asarray(left), jnp.asarray(right), 2, mr_j)
    _eq(tu_, ju_, "mix u")
    _eq(tv_, jv_, "mix v")
    tl, tr = tmx.unmix(tu_, tv_, 2, mr_t)
    jl, jr = jmx.unmix(ju_, jv_, 2, mr_j)
    _eq(tl, jl, "unmix l")
    _eq(tr, jr, "unmix r")
    for bs in (0, 1, 2):
        th, tlo = tmx.shift_off(_t(left), bs)
        jh, jlo = jmx.shift_off(jnp.asarray(left), bs)
        _eq(th, jh, f"shift_off hi {bs}")
        _eq(tlo, jlo, f"shift_off lo {bs}")
        _eq(tmx.shift_in(th, tlo, bs), jmx.shift_in(jh, jlo, bs),
            f"shift_in {bs}")


def test_assemble_matches_jax(rng):
    B, T, W = 5, 60, 64
    lens = rng.integers(0, 33, (B, T)).astype(np.int32)
    lens[0] = 0
    lens[1] = 32
    vals = rng.integers(0, 2**32, (B, T)).astype(np.uint32)
    tw, tb = tbp.assemble(_t(vals.view(np.int32)), _t(lens), W)
    jw, jb = _jit(jbp.assemble, 2)(jnp.asarray(vals), jnp.asarray(lens), W)
    _eq(tu.u32(tw), _u32(np.asarray(jw)), "words")
    _eq(tb, jb, "total bits")


@pytest.mark.parametrize("d", [8, 16, 17, 20, 24, 32])
def test_fields_and_segments_match_jax(rng, d):
    B, F = 4, 37
    fields = rng.integers(0, 2**d, (B, F)).astype(np.uint64)
    fields = fields.astype(np.uint32).view(np.int32)
    tw = tbp.pack_fields(_t(fields), d)
    jw = _jit(jbp.pack_fields, 1)(jnp.asarray(fields), d)
    _eq(tu.u32(tw), _u32(np.asarray(jw)), "pack_fields")
    _eq(tbp.unpack_fields(tw, d, F),
        _u32(np.asarray(_jit(jbp.unpack_fields, 1, 2)(jw, d, F))),
        "unpack_fields")
    phase = rng.integers(0, 32, B).astype(np.int32)
    phase[0] = 0
    tp = tbp.place_segment(tw, _t(phase))
    jp = _jit(jbp.place_segment)(jw, jnp.asarray(phase))
    _eq(tu.u32(tp), _u32(np.asarray(jp)), "place_segment")
    n_out = (F * d + 31) // 32
    _eq(tu.u32(tbp.extract_segment(tp, _t(phase), n_out)),
        _u32(np.asarray(_jit(jbp.extract_segment, 2)(
            jp, jnp.asarray(phase), n_out))),
        "extract_segment")


def _merge_inputs(rng, B, T, W, n_t):
    """Chunk streams that satisfy the merge invariant: per lane, the
    non-empty keys are 0, 1, 2, ... in slot order; tails may repeat."""
    hit = rng.random((B, T)) < 0.4
    hit &= (np.cumsum(hit, axis=1) - 1) < W
    keys = np.where(hit, np.cumsum(hit, axis=1) - 1,
                    0xFFFFFFFF).astype(np.uint32)
    vals = np.where(hit, rng.integers(0, 2**32, (B, T)), 0).astype(np.uint32)
    tk = rng.integers(0, W, (B, n_t)).astype(np.uint32)
    tk[:, -1] = 0xFFFFFFFF
    tv = rng.integers(0, 2**32, (B, n_t)).astype(np.uint32)
    return vals, keys, tv, tk


@pytest.mark.parametrize("B,T,W", [(8, 300, 120), (5, 90, 100)])
def test_merge_sorted_chunks_matches_jax(rng, B, T, W):
    vals, keys, tv, tk = _merge_inputs(rng, B, T, W, 4)
    got = tbp.merge_sorted_chunks(*(_t(a.view(np.int32))
                                    for a in (vals, keys, tv, tk)), W)
    want = _jit(jbp.merge_sorted_chunks, 4)(
        *(jnp.asarray(a) for a in (vals, keys, tv, tk)), W)
    _eq(tu.u32(got), _u32(np.asarray(want)))


def test_merge_matches_pallas_kernel(rng):
    """The plain merge (the CUDA kernel's reference) against the TPU
    kernel itself, in interpret mode at its minimum shape (B=8)."""
    from alacjax.ops.pallas.merge import merge_compact_pallas
    B, T, W = 8, 300, 120
    vals, keys, tv, tk = _merge_inputs(rng, B, T, W, 1)
    tk[:] = 0xFFFFFFFF                   # the Pallas call does no tail OR
    got = tbp.merge_sorted_chunks(*(_t(a.view(np.int32))
                                    for a in (vals, keys, tv, tk)), W)
    want = merge_compact_pallas(jnp.asarray(vals), jnp.asarray(keys), W,
                                interpret=True)
    _eq(tu.u32(got), _u32(np.asarray(want)))


def test_host_serializers_match_jax(rng):
    B, W = 6, 20
    words = rng.integers(0, 2**32, (B, W)).astype(np.uint32)
    bits = rng.integers(0, 32 * W + 1, B)
    bits[0] = 0
    got = tbp.words_to_bytes(words.view(np.int32), bits)
    assert got == jbp.words_to_bytes(words, bits)
    np.testing.assert_array_equal(tbp.bytes_to_words(got, W + 2),
                                  jbp.bytes_to_words(got, W + 2))


def test_state_tables():
    B = 3
    row = np.asarray(odp.init_coefs(9), dtype=np.int32)
    c0 = state.init_coefs_batched(B, "cpu")
    assert c0.dtype == torch.int32 and tuple(c0.shape) == (B, 16)
    _eq(c0, np.tile(row, (B, 1)))
    banks = {0: {4: np.tile(row, (B, 1)), 8: np.zeros((B, 16), np.int64)}}
    tb = state.banks_from_numpy(banks, "cpu")
    _eq(tb[0][4], banks[0][4])
    assert tb[0][8].dtype == torch.int32
    with pytest.raises(ValueError):
        state.coefs_from_numpy(np.zeros((B, 8), np.int32), "cpu")


def test_state_tables_need_a_device():
    """The carried state has no default device: a call without one raises
    rather than put the tables on the CPU."""
    row = np.zeros((2, 16), np.int32)
    with pytest.raises(TypeError):
        state.init_coefs_batched(2)
    with pytest.raises(TypeError):
        state.coefs_from_numpy(row)
    with pytest.raises(TypeError):
        state.banks_from_numpy({0: {4: row}})
