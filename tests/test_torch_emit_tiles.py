"""The port's Rice emission (alacjax_torch.ops.rice.rice_encode_words,
the emit kernel's plain version) == alacjax.ops.rice.rice_encode_words
(emit_flush=False), bit for bit, at the edges of the emit kernel's tiles:
S + 1 steps on either side of the 32-step tile and one lane past a warp,
with per-lane bit sizes, sample counts and start phases."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import rice as jrice
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.ops import rice as trice
from torch_emit_cases import CAP, TILE_EDGE_S, emit_lanes

WB = (1 << KB0) - 1
RICE = (MB0, PB0, KB0, WB)
NAMES = ("words", "keys", "end_bits", "tail_val", "tail_key")
L = 33                                    # one lane past a warp


@pytest.mark.parametrize("S", TILE_EDGE_S)
def test_emission_at_tile_edges_matches_jax(S):
    x, bs, num, start = emit_lanes(np.random.default_rng(1000 + S), L, S)
    got = trice.rice_encode_words(
        torch.from_numpy(x), torch.from_numpy(bs), *RICE,
        torch.from_numpy(start), bit_size_cap=CAP, num=torch.from_numpy(num))
    want = jrice.rice_encode_words(
        jnp.asarray(x), jnp.asarray(bs), *RICE, jnp.asarray(start),
        bit_size_cap=CAP, emit_flush=False, num=jnp.asarray(num))
    assert tuple(got[0].shape) == tuple(got[1].shape) == (L, 2 * (S + 1))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(
            g.numpy().astype(np.int64) & 0xFFFFFFFF,
            np.asarray(w).astype(np.int64) & 0xFFFFFFFF, err_msg=name)
