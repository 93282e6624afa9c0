"""Synthetic inputs of the decode kernel's instances (csrc/decode.cu: the
8/16/30-tap decode, the cursor and the raw decode), shared by the CPU
tests against alacjax (tests/test_torch_chanbits33.py,
tests/test_torch_raw_decode.py), the card tests of the kernels
(tests/test_torch_port.py) and chip_smoke.py's phase 3.  No jax here:
the card's machine lacks it.

The words are random bits, so the lanes take every branch of the Rice
decode (escapes at the lane's width, zero runs, overruns that flag
err); per-lane chanbits cover 16..33, 33 included (one past a 32-bit
channel, where every sign extension gives 0); orders cover 0, 1..30 and
31 with modes 0 and 15; some lanes are partial.  With ``rows`` the L
lanes stack on fewer word rows (lane l reads row l % rows)."""

import numpy as np

from alacjax_torch.types import KB0, MB0, PB0
from torch_predict_cases import CHANBITS

WB0 = (1 << KB0) - 1
RICE = (MB0, KB0, WB0)
ORDERS = (0, 1, 4, 8, 9, 16, 17, 30, 31)


def decode_lanes(rng, L: int, S: int, rows: int | None = None,
                 taps: int = 30):
    """(words (rows, W), lane dict of (L,) int32 arrays: start, cb, pb,
    mode, order, den, num, skip (bool), and coefs (L, taps)), numpy."""
    rows = L if rows is None else rows
    W = 2 * S + 8
    words = rng.integers(0, 1 << 32, (rows, W), dtype=np.uint64)
    words = words.astype(np.uint32)
    # zero-heavy words in every fourth row: long Rice prefixes become
    # short codewords and zero runs
    words[::4] &= rng.integers(0, 1 << 32, (len(words[::4]), W),
                               dtype=np.uint64).astype(np.uint32)
    i = np.arange(L)
    lane = dict(
        start=rng.integers(0, 96, L),
        cb=np.array([CHANBITS[k % len(CHANBITS)] for k in i]),
        pb=np.where(i % 3 == 0, PB0, (PB0 * rng.integers(0, 8, L)) // 4),
        mode=np.where(i % 5 == 1, 15, 0),
        order=np.array([ORDERS[(k // 3) % len(ORDERS)] for k in i]),
        den=np.where(i % 7 == 3, rng.integers(1, 16, L), 9),
        num=np.where(i % 4 == 2, rng.integers(1, S + 1, L), S),
        skip=(i % 6 == 5))
    lane = {k: v.astype(bool if k == "skip" else np.int32)
            for k, v in lane.items()}
    coefs = rng.integers(-300, 300, (L, taps))
    coefs[:, :3] = (160, -190, 170)
    lane["coefs"] = coefs.astype(np.int32)
    return words, lane
