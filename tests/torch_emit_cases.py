"""Inputs of the Rice emission at the edges of the emit kernel's tiles
(csrc/emit.cu stages 32 samples of 32 lanes at a time and runs S + 1
steps, the last the virtual end step), shared by the CPU test against
alacjax (tests/test_torch_emit_tiles.py) and the card test of the kernel
(tests/test_torch_port.py).  No jax here: the card's machine lacks it."""

import numpy as np

CAP = 21                                  # bit_size_cap: a 20-bit CPE
# S + 1 steps straddling the 32-step tile: 2, 32, 33, 34, 66 steps
TILE_EDGE_S = (1, 31, 32, 33, 65)
EDGE_NUMS = (1, 31, 32, 33)


def emit_lanes(rng, L: int, S: int):
    """(res (L, S) int32, bit_size (L,), num (L,), start_bits (L,)),
    numpy, with lanes that take every branch of the token machine:
    ordinary codewords, a lane of zeros, a zero run pending at the
    virtual end step, zero-run-heavy lanes, a lane of 21-bit escapes and
    a long run after one value; per-lane bit sizes 17 and 21, per-lane
    sample counts 1, 31, 32, 33 (clamped to S) and S, start phases 0..31.
    Every value fits its lane's bit size."""
    bit_size = np.where(np.arange(L) % 2 == 0, 17, CAP).astype(np.int32)
    x = rng.integers(-30000, 30000, (L, S))
    x[:, ::3] *= rng.integers(0, 2, (L, 1))          # zeros on some lanes
    for i, fill in enumerate((
            np.zeros(S),                              # all zero
            np.where(np.arange(S) < S // 2,           # a run pending at S
                     rng.integers(-9, 10, S), 0),
            rng.integers(-2, 3, S),                   # zero-run heavy
            rng.integers(-(1 << (CAP - 1)), 1 << (CAP - 1), S),  # escapes
            np.where(np.arange(S) == 0, 5, 0))):      # a long run
        if i < L:
            x[i] = fill                       # lane 3's bit size is CAP
    num = np.full(L, S)
    edge = np.minimum(np.array(EDGE_NUMS), S)
    for i in range(5, L):
        if i % 5 != 0:
            num[i] = edge[i % len(edge)]
        else:                                 # more runs pending at S
            x[i] = np.where(np.arange(S) < (S * i) // (2 * L),
                            rng.integers(-3, 4, S), 0)
    start = (rng.integers(0, 4000, L) * 32 + np.arange(L) % 32)
    return (x.astype(np.int32), bit_size, num.astype(np.int32),
            start.astype(np.int32))
