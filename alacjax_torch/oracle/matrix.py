"""Stereo decorrelation oracle (reference: codec/matrix_enc.c / matrix_dec.c).

The reference fuses byte-level PCM unpacking into its depth-specific
``mix16/20/24/32`` / ``unmix16/20/24/32`` functions.  This rebuild separates
concerns: container code (alacjax.containers.pcm) converts wire PCM to
*planar int32 arrays of right-aligned signed samples at bit_depth* (for
20-bit content: the 24-bit container value >> 4, matching matrix_enc.c ::
mix20's left-justified load).  The mix math below then operates on those
planar arrays for every depth; the bytes-shifted side-channel is factored
into shift_off/shift_in (matrix_enc.c :: mix24/mix32 inline the same steps).

All arithmetic is exact int32 C semantics: arithmetic right shift on
negatives (python ``>>`` on ints == floor == C arithmetic shift), two's
complement wraparound applied where the reference's int32 would wrap.
"""

from __future__ import annotations

import numpy as np

_I32_MASK = 0xFFFFFFFF


def _wrap_i32(x: np.ndarray) -> np.ndarray:
    x = np.bitwise_and(x, _I32_MASK)
    return np.where(x >= 0x80000000, x - 0x100000000, x)


def shift_off(x: np.ndarray, bytes_shifted: int) -> tuple[np.ndarray, np.ndarray]:
    """Split off the low ``bytes_shifted`` bytes of each sample.

    Returns ``(x >> shift, x & mask)``; the masked low bits travel as the
    uint16 shift side-channel (matrix_enc.c :: mix24/mix32 shift handling).
    """
    x = np.asarray(x, dtype=np.int64)
    if bytes_shifted == 0:
        return x.astype(np.int64), np.zeros_like(x, dtype=np.int64)
    shift = bytes_shifted * 8
    mask = (1 << shift) - 1
    return x >> shift, x & mask


def shift_in(x: np.ndarray, shift_vals: np.ndarray, bytes_shifted: int) -> np.ndarray:
    """Re-insert shifted-off low bytes (matrix_dec.c :: unmix24/unmix32).

    The result wraps to int32 like the reference's int32_t output store:
    reachable only on hostile streams (non-convex mix parameters can
    leave the high part wider than 32 - 8*bytes_shifted bits); identity
    on anything a real encoder emits.  Keeps the oracle in lockstep with
    the native/device decoders' i32 arithmetic (tests/test_grammar_fuzz
    depth-32 case)."""
    if bytes_shifted == 0:
        return np.asarray(x, dtype=np.int64)
    shift = bytes_shifted * 8
    return _wrap_i32((np.asarray(x, dtype=np.int64) << shift)
                     | np.asarray(shift_vals, dtype=np.int64))


def mix(left: np.ndarray, right: np.ndarray, mixbits: int, mixres: int):
    """Forward decorrelation matrix (matrix_enc.c :: mix16/20/24/32 core).

    mixres != 0:  U = (mixres*L + ((1<<mixbits) - mixres)*R) >> mixbits,
                  V = L - R
    mixres == 0:  pass-through U = L, V = R.
    """
    l = np.asarray(left, dtype=np.int64)
    r = np.asarray(right, dtype=np.int64)
    if mixres != 0:
        mod = 1 << mixbits
        m2 = mod - mixres
        # C: int32 products/sum (wrapping) then arithmetic >> mixbits
        u = np.asarray(_wrap_i32(mixres * l + m2 * r), dtype=np.int64) >> mixbits
        v = _wrap_i32(l - r)
    else:
        u = l.copy()
        v = r.copy()
    return np.asarray(u, dtype=np.int64), np.asarray(v, dtype=np.int64)


def unmix(u: np.ndarray, v: np.ndarray, mixbits: int, mixres: int):
    """Inverse matrix (matrix_dec.c :: unmix16/20/24/32 core).

    mixres != 0:  R = U - ((mixres*V) >> mixbits),  L = V + R
    mixres == 0:  L = U, R = V.
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if mixres != 0:
        r = _wrap_i32(u - (np.asarray(_wrap_i32(mixres * v), dtype=np.int64) >> mixbits))
        l = _wrap_i32(v + r)
    else:
        l = u.copy()
        r = v.copy()
    return np.asarray(l, dtype=np.int64), np.asarray(r, dtype=np.int64)
