"""Adaptive Golomb/Rice entropy coding oracle (reference: codec/ag_enc.c /
ag_dec.c / aglib.h; SURVEY.md §2 rows 8-9).

Per-sample Rice parameter k derives from a fixed-point EMA of coded
magnitudes (``mb``); a zero-run mode takes over when the mean estimate
collapses.  Residual codewords use the 32-bit escape path
(``dyn_code_32bit``/``dyn_get_32bit``: unary prefix capped at 9, non-escape
codewords capped at 25 bits, escape = 9 ones + raw ``bitSize``-bit value);
zero-run lengths use the 16-bit path (``dyn_code``/``dyn_get``: escape =
9 ones + raw 16-bit value).

All state arithmetic is uint32 wraparound, as in the reference.  Exact
EMA / zero-run entry arithmetic is ⚠ VERIFY per SURVEY.md §0 — this file
defines the dialect; stage round-trip is the gate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bitbuffer import BitBuffer
from ..types import (
    BITOFF, KB0, MAX_DATATYPE_BITS_16, MAX_PREFIX_16, MAX_PREFIX_32,
    MAX_RICE_NUMBITS, MAX_RUN_DEFAULT, MB0, MDENSHIFT, MMULSHIFT, MOFF,
    N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, PB0, PBSHIFT, QB, QBSHIFT,
    AlacParamError, lead, lg3a,
)

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class AGParams:
    """aglib.h :: AGParamRec."""
    mb: int
    mb0: int
    pb: int
    kb: int
    wb: int
    qb: int
    fw: int
    sw: int
    maxrun: int


def set_ag_params(m: int, p: int, k: int, f: int, s: int, maxrun: int) -> AGParams:
    """aglib.h :: set_ag_params."""
    return AGParams(mb=m, mb0=m, pb=p, kb=k, wb=(1 << k) - 1, qb=QB - p,
                    fw=f, sw=s, maxrun=maxrun)


def set_standard_ag_params(fullwidth: int, sectorwidth: int) -> AGParams:
    """aglib.h :: set_standard_ag_params."""
    return set_ag_params(MB0, PB0, KB0, fullwidth, sectorwidth, MAX_RUN_DEFAULT)


# ---------------------------------------------------------------------------
# codeword construction
# ---------------------------------------------------------------------------
def dyn_code(m: int, k: int, n: int) -> tuple[int, int]:
    """16-bit-escape Rice codeword (ag_enc.c :: dyn_code).

    Returns (value, num_bits).  Used for zero-run lengths (n <= 65535).
    """
    if m == 0:
        raise AlacParamError("rice modulus 0")
    div = n // m
    if div >= MAX_PREFIX_16:
        num_bits = MAX_PREFIX_16 + MAX_DATATYPE_BITS_16
        value = (((1 << MAX_PREFIX_16) - 1) << MAX_DATATYPE_BITS_16) + n
    else:
        mod = n % m
        de = 1 if mod == 0 else 0
        num_bits = div + k + 1 - de
        value = (((1 << div) - 1) << (num_bits - div)) + mod + 1 - de
    return value, num_bits


def dyn_code_32bit(maxbits: int, m: int, k: int, n: int):
    """32-bit-escape Rice codeword (ag_enc.c :: dyn_code_32bit).

    Returns (escaped, value, num_bits).  Non-escape codewords longer than
    MAX_RICE_NUMBITS (25) bits also fall back to escape.  On escape the
    caller writes 9 one-bits then the raw ``maxbits``-bit value ``n``.
    """
    if m == 0:
        raise AlacParamError("rice modulus 0")
    div = n // m
    if div < MAX_PREFIX_32:
        mod = n - m * div
        de = 1 if mod == 0 else 0
        num_bits = div + k + 1 - de
        value = (((1 << div) - 1) << (num_bits - div)) + mod + 1 - de
        if num_bits <= MAX_RICE_NUMBITS:
            return False, value, num_bits
    return True, (1 << MAX_PREFIX_32) - 1, MAX_PREFIX_32


# ---------------------------------------------------------------------------
# codeword parsing
# ---------------------------------------------------------------------------
def _leading_ones(stream: int) -> int:
    return lead(~stream & _U32)


def dyn_get(bits: BitBuffer, m: int, k: int) -> int:
    """ag_dec.c :: dyn_get — 16-bit-escape codeword parse."""
    stream = bits.peek_word()
    pre = _leading_ones(stream)
    if pre >= MAX_PREFIX_16:
        bits.advance(MAX_PREFIX_16)
        return bits.read(MAX_DATATYPE_BITS_16)
    result = pre * m
    bits.advance(pre + 1)
    if k != 1:
        v = ((stream << (pre + 1)) & _U32) >> (32 - k)
        if v >= 2:
            result += v - 1
            bits.advance(k)
        else:
            bits.advance(k - 1)
    return result


def dyn_get_32bit(bits: BitBuffer, m: int, k: int, maxbits: int) -> int:
    """ag_dec.c :: dyn_get_32bit — 32-bit-escape codeword parse."""
    stream = bits.peek_word()
    pre = _leading_ones(stream)
    if pre >= MAX_PREFIX_32:
        bits.advance(MAX_PREFIX_32)
        return bits.read(maxbits)
    result = pre * m
    bits.advance(pre + 1)
    if k != 1:
        v = ((stream << (pre + 1)) & _U32) >> (32 - k)
        if v >= 2:
            result += v - 1
            bits.advance(k)
        else:
            bits.advance(k - 1)
    return result


# ---------------------------------------------------------------------------
# main entropy coder
# ---------------------------------------------------------------------------
def _zero_run_k_m(mb: int, wb: int) -> tuple[int, int]:
    """Zero-run Rice parameter from the collapsed mean (ag_enc.c/ag_dec.c)."""
    kz = lead(mb) - BITOFF + ((mb + MOFF) >> MDENSHIFT)
    mz = ((1 << kz) - 1) & wb
    return kz, mz


def dyn_comp(params: AGParams, bits: BitBuffer, inp: np.ndarray,
             num_samples: int, bit_size: int) -> int:
    """Encode residuals into ``bits`` (ag_enc.c :: dyn_comp).

    Returns the number of bits written.
    """
    mb = params.mb0 & _U32
    pb, kb, wb = params.pb, params.kb, params.wb
    zmode = 0
    start = bits.get_position()
    x = [int(v) for v in inp[:num_samples]]

    c = 0
    while c < num_samples:
        m = mb >> QBSHIFT
        k = min(lg3a(m), kb)
        m = (1 << k) - 1

        del_ = x[c]
        n = ((abs(del_) << 1) - (1 if del_ < 0 else 0) - zmode) & _U32

        escaped, value, num_bits = dyn_code_32bit(bit_size, m, k, n)
        bits.write(value, num_bits)
        if escaped:
            bits.write(n, bit_size)

        c += 1
        mb = (pb * (n + zmode) + mb - ((pb * mb) >> PBSHIFT)) & _U32
        if n > N_MAX_MEAN_CLAMP:
            mb = N_MEAN_CLAMP_VAL
        zmode = 0

        if ((mb << MMULSHIFT) & _U32) < QB and c < num_samples:
            zmode = 1
            nz = 0
            while c < num_samples and x[c] == 0:
                nz += 1
                c += 1
                if nz >= 65535:
                    zmode = 0
                    break
            kz, mz = _zero_run_k_m(mb, wb)
            value, num_bits = dyn_code(mz, kz, nz)
            bits.write(value, num_bits)
            mb = 0

    return bits.get_position() - start


def dyn_decomp(params: AGParams, bits: BitBuffer, num_samples: int,
               max_size: int) -> np.ndarray:
    """Decode ``num_samples`` residuals from ``bits`` (ag_dec.c :: dyn_decomp)."""
    mb = params.mb0 & _U32
    pb, kb, wb = params.pb, params.kb, params.wb
    zmode = 0
    out = np.zeros(num_samples, dtype=np.int64)

    c = 0
    while c < num_samples:
        m = mb >> QBSHIFT
        k = min(lg3a(m), kb)
        m = (1 << k) - 1

        n = dyn_get_32bit(bits, m, k, max_size)

        # least significant bit of (n + zmode) is the sign bit
        ndecode = n + zmode
        multiplier = (-(ndecode & 1)) | 1
        out[c] = ((ndecode + 1) >> 1) * multiplier
        c += 1

        mb = (pb * (n + zmode) + mb - ((pb * mb) >> PBSHIFT)) & _U32
        if n > N_MAX_MEAN_CLAMP:
            mb = N_MEAN_CLAMP_VAL
        zmode = 0

        if ((mb << MMULSHIFT) & _U32) < QB and c < num_samples:
            zmode = 1
            kz, mz = _zero_run_k_m(mb, wb)
            nz = dyn_get(bits, mz, kz)
            if c + nz > num_samples:
                raise AlacParamError("zero run overruns frame")
            c += nz  # out already zero-initialized
            if nz >= 65535:
                zmode = 0
            mb = 0

    return out
