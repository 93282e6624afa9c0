"""Adaptive FIR/LPC predictor oracle (reference: codec/dp_enc.c / dp_dec.c).

``pc_block`` produces residuals with a sign-sign adaptive filter whose
coefficients update per sample with an early-exit walk from the highest tap
down; ``unpc_block`` replays the identical recurrence so decoder state tracks
encoder state sample-for-sample (SURVEY.md §2 rows 6-7).

C semantics reproduced deliberately:
  * arithmetic right shift of negatives (python ``>>`` on ints),
  * int32 wraparound on the prediction accumulator,
  * int16 wraparound on coefficients,
  * residual clamp to ``chanbits`` via ``(x << (32-chanbits)) >> (32-chanbits)``.

The reference's unrolled numactive==4/8 fast paths are bit-identical to its
general loop, so only the general semantics are modeled.  Exact early-exit
arithmetic is marked ⚠ VERIFY in SURVEY.md §2 — this file *defines* the
dialect and round-trip is the gate.
"""

from __future__ import annotations

import numpy as np

from ..types import AINIT, BINIT, CINIT, kALACMaxCoefs, sign_extend

_U32 = 0xFFFFFFFF


def _sign_of_int(i: int) -> int:
    """dp_enc.c :: sign_of_int — +1 / 0 / -1."""
    return (i > 0) - (i < 0)


def _wrap_i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def init_coefs(denshift: int, num_pairs: int = kALACMaxCoefs) -> np.ndarray:
    """Seed a coefficient set (dp_enc.c :: init_coefs)."""
    den = 1 << denshift
    coefs = np.zeros(num_pairs, dtype=np.int64)
    coefs[0] = (AINIT * den) >> 4
    coefs[1] = (BINIT * den) >> 4
    coefs[2] = (CINIT * den) >> 4
    return coefs


def copy_coefs(src: np.ndarray) -> np.ndarray:
    """dp_enc.c :: copy_coefs."""
    return np.array(src, dtype=np.int64, copy=True)


def pc_block(inp: np.ndarray, coefs: np.ndarray, numactive: int,
             chanbits: int, denshift: int) -> np.ndarray:
    """Forward prediction: samples -> residuals; mutates ``coefs`` in place.

    Reference: dp_enc.c :: pc_block.  Special modes: numactive==0 is a
    pass-through; numactive==31 is a pure first-order difference.
    """
    num = len(inp)
    out = np.zeros(num, dtype=np.int64)
    x = [int(v) for v in inp]

    if num > 0:
        out[0] = x[0]
    if numactive == 0:
        out[:] = inp
        return out
    if numactive == 31:
        for j in range(1, num):
            out[j] = sign_extend(x[j] - x[j - 1], chanbits)
        return out

    denhalf = 1 << (denshift - 1)
    lim = numactive + 1
    c = [int(v) for v in coefs]

    # warm-up: first numactive deltas
    for j in range(1, min(lim, num)):
        out[j] = sign_extend(x[j] - x[j - 1], chanbits)

    for j in range(lim, num):
        top = x[j - lim]
        # prediction accumulator: int32 wraparound, then arithmetic shift
        sum1 = denhalf
        for k in range(numactive):
            diff = (x[j - 1 - k] - top) & _U32
            if diff >= 0x80000000:
                diff -= 0x100000000
            sum1 += c[k] * diff
        sum1 &= _U32
        if sum1 >= 0x80000000:
            sum1 -= 0x100000000
        pred_adj = sum1 >> denshift

        del_ = sign_extend(x[j] - top - pred_adj, chanbits)
        out[j] = del_

        # sign-sign adaptation with early exit (dp_enc.c hot loop)
        del0 = del_
        sg = _sign_of_int(del_)
        if sg > 0:
            for k in range(numactive - 1, -1, -1):
                dd = (top - x[j - 1 - k]) & _U32
                if dd >= 0x80000000:
                    dd -= 0x100000000
                sgn = _sign_of_int(dd)
                c[k] = _wrap_i16(c[k] - sgn)
                del0 -= (numactive - k) * ((sgn * dd) >> denshift)
                if del0 <= 0:
                    break
        elif sg < 0:
            for k in range(numactive - 1, -1, -1):
                dd = (top - x[j - 1 - k]) & _U32
                if dd >= 0x80000000:
                    dd -= 0x100000000
                sgn = _sign_of_int(dd)
                c[k] = _wrap_i16(c[k] + sgn)
                del0 -= (numactive - k) * ((-sgn * dd) >> denshift)
                if del0 >= 0:
                    break

    coefs[:numactive] = c[:numactive]
    return out


def unpc_block(residuals: np.ndarray, coefs: np.ndarray, numactive: int,
               chanbits: int, denshift: int) -> np.ndarray:
    """Inverse prediction: residuals -> samples; mutates ``coefs`` in place.

    Reference: dp_dec.c :: unpc_block — the exact mirror recurrence.
    """
    num = len(residuals)
    out = [0] * num
    r = [int(v) for v in residuals]

    if num > 0:
        out[0] = r[0]
    if numactive == 0:
        return np.array(r, dtype=np.int64)
    if numactive == 31:
        prev = out[0]
        for j in range(1, num):
            prev = sign_extend(prev + r[j], chanbits)
            out[j] = prev
        return np.array(out, dtype=np.int64)

    denhalf = 1 << (denshift - 1)
    lim = numactive + 1
    c = [int(v) for v in coefs]

    for j in range(1, min(lim, num)):
        out[j] = sign_extend(r[j] + out[j - 1], chanbits)

    for j in range(lim, num):
        top = out[j - lim]
        sum1 = denhalf
        for k in range(numactive):
            diff = (out[j - 1 - k] - top) & _U32
            if diff >= 0x80000000:
                diff -= 0x100000000
            sum1 += c[k] * diff
        sum1 &= _U32
        if sum1 >= 0x80000000:
            sum1 -= 0x100000000
        pred_adj = sum1 >> denshift

        del_ = r[j]
        sam = sign_extend(del_ + top + pred_adj, chanbits)
        out[j] = sam

        del0 = del_
        sg = _sign_of_int(del_)
        if sg > 0:
            for k in range(numactive - 1, -1, -1):
                dd = (top - out[j - 1 - k]) & _U32
                if dd >= 0x80000000:
                    dd -= 0x100000000
                sgn = _sign_of_int(dd)
                c[k] = _wrap_i16(c[k] - sgn)
                del0 -= (numactive - k) * ((sgn * dd) >> denshift)
                if del0 <= 0:
                    break
        elif sg < 0:
            for k in range(numactive - 1, -1, -1):
                dd = (top - out[j - 1 - k]) & _U32
                if dd >= 0x80000000:
                    dd -= 0x100000000
                sgn = _sign_of_int(dd)
                c[k] = _wrap_i16(c[k] + sgn)
                del0 -= (numactive - k) * ((-sgn * dd) >> denshift)
                if del0 >= 0:
                    break

    coefs[:numactive] = c[:numactive]
    return np.array(out, dtype=np.int64)
