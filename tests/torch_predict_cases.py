"""Inputs of the standalone predictor and its Rice cost pass at the edges
of their kernels' tiles (csrc/predict.cu stages 32 samples of 32 lanes
at a time; the Rice machines run S + 1 steps, the last the virtual end
step), shared by the CPU test against alacjax
(tests/test_torch_predict_tiles.py), the card test of the kernels
(tests/test_torch_port.py) and chip_smoke.py's phase 3.  No jax here:
the card's machine lacks it."""

import numpy as np

TILE_EDGE_S = (1, 31, 32, 33, 65, 100)       # 100: not a multiple of 32
LANE_COUNTS = (33, 67)                       # the last block partial
CASES = tuple((L, S) for L in LANE_COUNTS for S in TILE_EDGE_S)
CHANBITS = (16, 17, 20, 21, 24, 25, 32, 33)
EDGE_NUMS = (1, 31, 32, 33)
# every static order, two to a launch (the kernel's widest call)
ORDER_PAIRS = tuple((k, 17 - k) for k in range(1, 9))
INIT = (160, -190, 170)                      # dp.init_coefs(9)[:3]


def _lane_width(cb: int) -> int:
    return min(cb, 32)


def predict_lanes(rng, L: int, S: int, n_orders: int = 2):
    """(x (L, S), chanbits (L,), coefs0 (n_orders, L, 16)), int32 numpy.
    Lane i has chanbits CHANBITS[i % 8] and samples inside that width (a
    33-bit lane spans int32): sines, noise, silence, impulses at full
    scale, sparse and small values.  Each order has its own block of
    starting coefficients: the reference's first three and values in
    [-64, 64), with some lanes at the 16-bit edges so that a step wraps."""
    cb = np.array([CHANBITS[i % len(CHANBITS)] for i in range(L)], np.int32)
    t = np.arange(S)
    x = np.zeros((L, S), np.int64)
    for i in range(L):
        full = 1 << (_lane_width(int(cb[i])) - 1)
        kind = (i // len(CHANBITS)) % 6
        if kind == 0:
            x[i] = np.sin(t * rng.uniform(0.01, 0.2)) * (full // 2)
        elif kind == 1:
            x[i] = rng.integers(-full, full, S)
        elif kind == 2:
            pass                                          # silence
        elif kind == 3:
            x[i] = np.where(t % 7 == 0, full - 1, -full)  # full-scale swings
        elif kind == 4:
            x[i] = np.where(t % 3 == 0, rng.integers(-300, 300, S), 0)
        else:
            x[i] = rng.integers(-2, 3, S)
    c0 = np.zeros((n_orders, L, 16), np.int64)
    c0[:, :, :3] = INIT
    c0[:, :, 3:] = rng.integers(-64, 64, (n_orders, L, 13))
    c0[:, 1::5, :] = 32767                                # + 1 wraps
    c0[:, 2::5, :] = -32768
    return (x.astype(np.int32), cb, c0.astype(np.int32))


def rice_lanes(rng, L: int, S: int):
    """(res (L, S), bit_size (L,), num (L,)), int32 numpy, with lanes that
    take every branch of the token machine: ordinary codewords, a lane of
    zeros, a zero run pending at the virtual end step, zero-run-heavy
    lanes, escapes (small values, then values at the lane's width) and a
    long run after one value; per-lane bit sizes CHANBITS and sample
    counts 1, 31, 32, 33 (clamped to S) and S."""
    bs = np.array([CHANBITS[i % len(CHANBITS)] for i in range(L)], np.int32)
    x = rng.integers(-30000, 30000, (L, S))
    x[:, ::3] *= rng.integers(0, 2, (L, 1))
    for i in range(L):
        full = 1 << (_lane_width(int(bs[i])) - 1)
        kind = i % 6
        if kind == 0:
            x[i] = 0
        elif kind == 1:                                   # a run pending at S
            x[i] = np.where(np.arange(S) < S // 2, rng.integers(-9, 10, S), 0)
        elif kind == 2:
            x[i] = rng.integers(-2, 3, S)                 # zero-run heavy
        elif kind == 3:                                   # escapes
            x[i] = np.where(np.arange(S) % 4 == 3,
                            rng.integers(-full, full, S),
                            rng.integers(-1, 2, S))
        elif kind == 4:
            x[i] = np.where(np.arange(S) == 0, 5, 0)      # a long run
    num = np.full(L, S)
    num[1::2] = np.resize(np.minimum(EDGE_NUMS, S), len(num[1::2]))
    return (x.astype(np.int32), bs, num.astype(np.int32))
