"""The port's Rice emission (alacjax_torch.ops.rice.rice_encode_words,
the emit kernel's plain version) == alacjax.ops.rice, bit for bit: the
per-step word/key slots, end bits and the final partial-word tail, in
the codec's emit_flush=False mode; then against the TPU emit kernel in
interpret mode at its minimum sample count."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.ops import rice as jrice
from alacjax.types import KB0, MB0, PB0
from alacjax_torch.ops import rice as trice

WB = (1 << KB0) - 1
RICE = (MB0, PB0, KB0, WB)
NAMES = ("words", "keys", "end_bits", "tail_val", "tail_key")


def residuals(rng, B, S, bit_size):
    """Lanes that take every branch of the token machine: escapes (large
    values), zero runs of every length (one reaching the end of the
    frame), run-length escapes, and ordinary codewords."""
    full = 1 << (bit_size - 1)
    x = rng.integers(-40000, 40000, (B, S))
    x[0] = 0                                   # one run to the end
    x[1, ::3] = 0
    x[2] = rng.integers(-2, 3, S)              # zero-run heavy
    x[3] = rng.integers(-full, full, S)        # escape heavy
    x[4, :] = 0
    x[4, 0] = 5                                # long run after one value
    x[5, S // 2:] = 0
    return x.astype(np.int32)


def _compare(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(
            g.numpy().astype(np.int64) & 0xFFFFFFFF,
            np.asarray(w).astype(np.int64) & 0xFFFFFFFF, err_msg=name)


@pytest.mark.parametrize("bit_size", [16, 17])
def test_rice_encode_words_matches_jax(rng, bit_size):
    B, S = 8, 200
    x = residuals(rng, B, S, bit_size)
    start = rng.integers(0, 2000, B).astype(np.int32)
    start[0] = 0
    got = trice.rice_encode_words(torch.from_numpy(x), bit_size, *RICE,
                                  torch.from_numpy(start))
    want = jrice.rice_encode_words(jnp.asarray(x), bit_size, *RICE,
                                   jnp.asarray(start), emit_flush=False)
    _compare(got, want)


def test_rice_encode_words_matches_pallas_kernel(rng):
    """The plain machine (the CUDA kernel's reference) against the TPU
    emit kernel in interpret mode, at its minimum sample count."""
    from alacjax.ops.pallas.emit_pallas import rice_encode_words_pallas
    from alacjax.ops.pallas.cost_pallas import S_CHUNK
    B, S = 8, S_CHUNK
    x = residuals(rng, B, S, 17)
    start = rng.integers(0, 2000, B).astype(np.int32)
    got = trice.rice_encode_words(torch.from_numpy(x), 17, *RICE,
                                  torch.from_numpy(start))
    want = rice_encode_words_pallas(jnp.asarray(x), 17, *RICE,
                                    jnp.asarray(start), interpret=True)
    _compare(got, want)
