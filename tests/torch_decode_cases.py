"""Synthetic inputs of the decode kernel's instances (csrc/decode.cu: the
8/16/30-tap decode, the cursor and the raw decode), shared by the CPU
tests against alacjax (tests/test_torch_chanbits33.py,
tests/test_torch_raw_decode.py, tests/test_torch_rice_window.py,
tests/test_torch_fir_walk.py), the card tests of the kernels
(tests/test_torch_port.py, tests/test_torch_rice_window.py,
tests/test_torch_fir_walk.py) and chip_smoke.py's phase 3.  No jax
here: the card's machine lacks it.

The words are random bits, so the lanes take every branch of the Rice
decode (escapes at the lane's width, zero runs, overruns that flag
err); per-lane chanbits cover 16..33, 33 included (one past a 32-bit
channel, where every sign extension gives 0); orders cover 0, 1..30 and
31 with modes 0 and 15; some lanes are partial.  With ``rows`` the L
lanes stack on fewer word rows (lane l reads row l % rows).

``window_lanes`` aims at the Rice decoder's staged window (a ring of
words per lane in shared memory, refilled 16 words at a time, one
96-bit window a step): start bits at every residue mod 32 over the
whole row, its last words and just before refill boundaries; streams
that run past the row's last word (clamped reads); escapes at chanbits
32 and 33 followed at once by a zero-run codeword, some of them escaped
too; rows of few and of many ones; any row width.  With
``MB0_JUMP`` as the mean's start a lane's first zero-run codeword is
millions of bits long, so its cursor leaves the staged words for the
row's end.

``slow_lanes`` mixes, in every warp, lanes that take each of the Rice
decoder's slow paths (zero runs, escapes past the words a phase holds
staged, a mean that starts a run at every sample) with lanes that take
none.

``fir_lanes`` aims at the FIR walk: small residuals coded by the Rice
coder, so the sign-sign adaptation stops at every tap, with warps of
one order and of mixed orders (see its docstring)."""

import numpy as np

from alacjax_torch.bitbuffer import BitBuffer
from alacjax_torch.oracle import ag
from alacjax_torch.types import KB0, MAX_RUN_DEFAULT, MB0, PB0
from torch_predict_cases import CHANBITS

WB0 = (1 << KB0) - 1
RICE = (MB0, KB0, WB0)
ORDERS = (0, 1, 4, 8, 9, 16, 17, 30, 31)
PART_BITS = 512          # bits of one refill of the staged window
# a starting mean whose update triggers a zero run (its low 30 bits are
# small) with a zero-run parameter of about 2**24 bits
MB0_JUMP = (1 << 30) + 5


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


def _set_bits(row, pos: int, bits: str) -> None:
    """Write the string of '0'/'1' ``bits`` into the big-endian u32 row
    from bit ``pos`` on (bits past the row are dropped)."""
    for i, b in enumerate(bits):
        w, sh = divmod(pos + i, 32)
        if w >= len(row):
            return
        mask = np.uint32(1 << (31 - sh))
        row[w] = (row[w] | mask) if b == "1" else (row[w] & ~mask)


def window_lanes(rng, L: int, S: int, rows: int | None = None,
                 tail: int = 1):
    """(words (rows, W), lane dict as decode_lanes' with coefs (L, 8)),
    numpy, for the staged window's edges.  W = 4 * max(4, S // 8) + tail,
    so most streams run past the row's last word.  Lane i: start bit
    residues in turn; i % 8 == 7 starts in the last three words, i % 8 == 6
    just before a refill boundary, i % 8 in (2, 3) begins, at a residue
    from 31 down, with an escape at chanbits 32 / 33 of payload 0, which
    (mean MB0) triggers a zero run whose codeword follows at once,
    escaped itself on every other such lane; the rest start anywhere in
    the row.  Rows 0 mod 4 are
    zero-heavy, 1 mod 4 one-heavy (escapes); skip and num as in
    decode_lanes."""
    rows = L if rows is None else rows
    W = 4 * max(4, S // 8) + tail
    words = rng.integers(0, 1 << 32, (rows, W), dtype=np.uint64)
    words = words.astype(np.uint32)
    other = rng.integers(0, 1 << 32, (rows, W), dtype=np.uint64)
    other = other.astype(np.uint32)
    words[::4] &= other[::4]
    words[1::4] |= other[1::4]
    i = np.arange(L)
    kind = i % 8
    # residues 0, 1, ..., 31, 0, ... in turn over the lanes of the other
    # kinds, so 51 or more lanes take every residue
    residue = (np.cumsum(~np.isin(kind, (2, 3, 6))) - 1) % 32
    start = rng.integers(0, W, L) * 32 + residue
    start = np.where(kind == 7, (W - 1 - (i // 8) % 3) * 32 + residue, start)
    parts = max(1, (W * 32) // PART_BITS)
    near = (1 + (i // 8) % parts) * PART_BITS - 1 - i % 48
    start = np.where(kind == 6, near, start)
    # the escape lanes sweep the high residues, where the zero-run
    # codeword after a 42-bit escape reaches the window's fourth word
    esc_start = rng.integers(0, W - 4, L) * 32 + 31 - (i // 16) % 16
    start = np.where((kind == 2) | (kind == 3), esc_start, start)
    cb = np.array([CHANBITS[k % len(CHANBITS)] for k in i])
    cb = np.where(kind == 2, 32, np.where(kind == 3, 33, cb))
    for lane in np.nonzero((kind == 2) | (kind == 3))[0]:
        row = words[lane % rows]
        pos = int(start[lane])
        pattern = "1" * 9 + "0" * int(cb[lane])
        if (lane // 8) % 2:
            pattern += "1" * 9           # the zero-run codeword escapes
        _set_bits(row, pos, pattern)
    lane = dict(
        start=start,
        cb=cb,
        pb=np.where(i % 3 == 0, PB0, (PB0 * rng.integers(0, 8, L)) // 4),
        mode=np.where(i % 5 == 1, 15, 0),
        order=np.array([ORDERS[(k // 3) % 5] for k in i]),
        den=np.where(i % 7 == 3, rng.integers(1, 16, L), 9),
        num=np.where(i % 4 == 1, rng.integers(1, S + 1, L), S),
        skip=(i % 6 == 5))
    lane = {k: v.astype(bool if k == "skip" else np.int32)
            for k, v in lane.items()}
    coefs = rng.integers(-300, 300, (L, 8))
    coefs[:, :3] = (160, -190, 170)
    lane["coefs"] = coefs.astype(np.int32)
    return words, lane


def _rice_row(res, num: int, pb: int, bit_size: int, start: int, W: int,
              rng):
    """One lane's row: ``start`` random bits, then ``res[:num]`` coded by
    the adaptive-Rice coder (the port's oracle, ag_enc.c :: dyn_comp) at
    the decoder's parameters (MB0, pb, KB0), then random words: (W,)
    uint32."""
    bits = BitBuffer(byte_size=4 * W)
    for n in (min(start, 32), min(max(start - 32, 0), 32), max(start - 64, 0)):
        if n:
            bits.write(int(rng.integers(0, 1 << n)), n)
    ag.dyn_comp(ag.set_ag_params(MB0, pb, KB0, 0, 0, MAX_RUN_DEFAULT), bits,
                res, num, bit_size)
    used = -(-bits.get_position() // 32)
    if used > W - 4:
        raise ValueError(f"a lane's stream needs {used} words of {W}")
    row = np.frombuffer(bytes(bits.buf), dtype=">u4").astype(np.uint32)
    row[used:] = rng.integers(0, 1 << 32, W - used, dtype=np.uint64)
    return row


def fir_lanes(rng, L: int, S: int, taps: int):
    """(words (L, W), lane dict as decode_lanes' with coefs (L, taps)),
    numpy, for the adaptive FIR walk of the ``taps``-wide decode.  The
    residuals are coded into each lane's row by the Rice coder, and are
    mostly small (|r| <= 3, with runs of zeros), so the sign-sign walk
    runs deep and stops at every tap; a lane of chanbits 32 starts with
    three residuals near +-2**31, so its samples and the prediction wrap.

    Warp 0 (lanes 0-31) walks at order ``taps`` alone, warp 1 at order 4
    alone; the other lanes mix orders 1..taps, 0 and 31 (the mode-0 and
    cumulative overlays), and above ``taps`` (flagged, walked at
    ``taps``).  Lane i: denshift 1 + i % 15; chanbits 16, 17, 20, 24, 32 or 33
    in turn, and mode 0, 15 or 31 for each six lanes in turn; coefficients in +-300, at
    the 16-bit limits (every fifth lane) or within 8 of them (every fifth
    lane but one); a count below order + 2 (the warm-up cut) on every
    ninth lane, any count on another ninth, else S."""
    i = np.arange(L)
    warp = i // 32
    # 13 orders: coprime with the periods of chanbits, mode and denshift
    mixed = [taps, taps - 1, taps // 2, 1, 2, 3, 0, 31, 4, taps - 2,
             (3 * taps) // 4, 5, taps + 1 if taps < 30 else 6]
    order = np.where(warp == 0, taps, np.where(
        warp == 1, 4, np.array([mixed[k % len(mixed)] for k in i])))
    order = np.clip(order, 0, 31)
    na_k = np.clip(np.clip(order, 1, 30), None, taps)
    den = 1 + i % 15
    mode = np.array((0, 15, 31))[(i // 6) % 3]
    cb = np.array((16, 17, 20, 24, 32, 33))[i % 6]
    num = np.full(L, S)
    num = np.where(i % 9 == 4, rng.integers(0, na_k + 2), num)
    num = np.where(i % 9 == 7, rng.integers(1, S + 1, L), num)
    num = np.minimum(num, S)
    coefs = rng.integers(-300, 301, (L, taps))
    limits = rng.choice(np.array([-32768, 32767]), (L, taps))
    coefs = np.where((i % 5 == 3)[:, None], limits, coefs)
    near = limits - np.sign(limits) * rng.integers(0, 8, (L, taps))
    coefs = np.where((i % 5 == 4)[:, None], near, coefs)
    pb = np.where(i % 4 == 0, PB0, (PB0 * rng.integers(1, 8, L)) // 4)
    res = rng.integers(-3, 4, (L, S))
    res[rng.random((L, S)) < 0.3] = 0
    zero_runs = rng.random((L, -(-S // 16))) < 0.1   # 16-sample runs
    res[np.repeat(zero_runs, 16, axis=1)[:, :S]] = 0
    big = cb == 32
    res[big, :3] = rng.integers(-(1 << 31) + 1, 1 << 31, (int(big.sum()), 3))
    start = rng.integers(0, 96, L)
    W = 8 + (S * 34 + 96) // 32
    words = np.stack([_rice_row(res[k], int(num[k]), int(pb[k]),
                                min(int(cb[k]), 32), int(start[k]), W, rng)
                      for k in range(L)])
    lane = dict(start=start, cb=cb, pb=pb, mode=mode, order=order, den=den,
                num=num, skip=np.zeros(L, bool), coefs=coefs)
    lane = {k: v.astype(bool if k == "skip" else np.int32)
            for k, v in lane.items()}
    return words, lane


def slow_lanes(rng, L: int, S: int):
    """(words (L, W), lane dict as decode_lanes' with coefs (L, 8)),
    numpy, for the Rice decoder's slow paths beside lanes that take
    none, in every warp: streams coded by the Rice coder (_rice_row), so
    the paths are those a real stream takes.  Lane i by i % 8:
      0, 5, 7: music-like residuals at chanbits 16, 24 and 32 (a normal
         spread of 40, 3,000 and 3,000): no slow path;
      1: near silence (zeros, a rare +-1, at chanbits 16): zero runs;
      2: silence broken by full-scale samples at chanbits 16: escapes of
         25 bits after zero runs;
      3: uniform 24-bit samples: every codeword escapes, 33 bits, more
         than the 30 a codeword that two phases of staged words hold;
      4: uniform 32-bit samples: 41 bits a codeword;
      6: pb 0, so the mean stays at MB0 and every coded sample starts a
         zero run.
    Lanes of kind 7 code at pb 41, the others at 40 (or 0): with
    MB0_JUMP as the mean's start, a lane at pb 40 or 0 whose first value
    is small (its random leading bits decide) triggers at once a run
    whose codeword is millions of bits long, and a lane at pb 41 cannot.
    num below S on every fourth lane (i % 4 == 1), else S; each lane's
    stream starts after 0..95 random bits; orders 4 and 8, mode 0."""
    i = np.arange(L)
    kind = i % 8
    cb = np.array((16, 16, 16, 24, 32, 24, 16, 32))[kind]
    num = np.where(i % 4 == 1, rng.integers(1, S + 1, L), S)
    pb = np.where(kind == 6, 0, np.where(kind == 7, PB0 + 1, PB0))
    res = np.zeros((L, S), dtype=np.int64)
    for k in range(L):
        if kind[k] in (0, 5, 7):
            res[k] = rng.normal(0, 40 if kind[k] == 0 else 3000, S)
        elif kind[k] == 1:
            res[k] = np.where(rng.random(S) < 0.02,
                              rng.choice((-1, 1), S), 0)
        elif kind[k] == 2:
            res[k] = np.where(rng.random(S) < 0.01,
                              rng.choice((-32767, 32767), S), 0)
        elif kind[k] == 3:
            res[k] = rng.integers(-(1 << 23), 1 << 23, S)
        elif kind[k] == 4:
            res[k] = rng.integers(-(1 << 31) + 1, 1 << 31, S)
        else:
            res[k] = rng.integers(-3, 4, S)
    start = rng.integers(0, 96, L)
    W = 8 + (S * 42 + 96) // 32
    words = np.stack([_rice_row(res[k], int(num[k]), int(pb[k]),
                                int(cb[k]), int(start[k]), W, rng)
                      for k in range(L)])
    coefs = rng.integers(-300, 300, (L, 8))
    coefs[:, :3] = (160, -190, 170)
    lane = dict(start=start, cb=cb, pb=pb, mode=np.zeros(L),
                order=np.where(i % 3 == 0, 8, 4), den=np.full(L, 9),
                num=num, skip=np.zeros(L, bool), coefs=coefs)
    lane = {k: v.astype(bool if k == "skip" else np.int32)
            for k, v in lane.items()}
    return words, lane


def tile_lanes(words, lane, n: int):
    """The lanes of a case repeated n times (words rows and per-lane
    arrays alike): a launch of n times the lanes on the same streams."""
    if n == 1:
        return words, lane
    return (np.tile(words, (n, 1)),
            {k: np.tile(v, (n,) + (1,) * (v.ndim - 1))
             for k, v in lane.items()})
