"""Small integer helpers shared by the port's plain (torch) ops.

Counterpart of alacjax/ops/jaxutils.py.  Integer semantics mirror the C
reference exactly: int32/uint32 wrap, arithmetic right shift on signed,
logical on unsigned.

Torch on the CPU has no ``>>``/``<<``/``+``/``<`` for ``uint32``, so the
plain versions compute in int64: a signed 32-bit value is an int64 in
[-2^31, 2^31) (``wrap_i32`` after every op that may overflow), an
unsigned one an int64 in [0, 2^32) (``u32`` / ``& MASK32``).  At module
boundaries every array is int32; unsigned words travel as their int32
bit patterns (``as_i32_bits``), which is also what the CUDA kernels
read and write.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF

# The plain versions' data-dependent work, for sizing a kernel's least
# time (chip_smoke.py): None, or a dict into which the plain loops count
# the samples a Rice machine coded or decoded ("coded"; the others sat in
# a zero run or past the lane's count), the zero runs a Rice decode
# started ("runs") and the steps the sign-sign walks took ("taps").
# Entries are keyed (key, mask shape) and hold running per-element
# counts, one in-place add per step; ``work_total`` sums them.
WORK = None


def count_work(key: str, mask) -> None:
    """Count the true entries of ``mask`` under ``key`` while WORK is set."""
    if WORK is not None:
        acc = WORK.get((key, mask.shape))
        if acc is None:
            WORK[(key, mask.shape)] = mask.to(I64, copy=True)
        else:
            acc += mask


def work_total(work: dict, key: str) -> int:
    """All of ``key``'s counts in a WORK dict."""
    return sum(int(v.sum().item()) for (k, _), v in work.items() if k == key)


def u32(x):
    """Unsigned 32-bit view of an int tensor, as int64 in [0, 2^32)."""
    return x.to(I64) & MASK32


def wrap_i32(x):
    """int64 -> the int32 value it wraps to, kept as int64."""
    return ((x.to(I64) + (1 << 31)) & MASK32) - (1 << 31)


def as_i32_bits(x):
    """int64 value (signed or unsigned 32-bit) -> int32 bit pattern."""
    return wrap_i32(x).to(I32)


def sign_extend(x, bits):
    """Sign-extend the low ``bits`` bits of ``x``.  ``bits`` is an int or
    a per-lane tensor with fewer dims than ``x`` (broadcast on the
    leading axes).  C idiom: ``(x << (32-bits)) >> (32-bits)``; past 32
    bits its shift is negative, and alacjax's shifts (XLA's) give 0
    there, as csrc/predict.cu's clamping PTX shifts do.  Returns int64."""
    x = x.to(I64)
    if not isinstance(bits, int):
        bits = torch.as_tensor(bits, dtype=I64, device=x.device)
        if bits.ndim and bits.ndim < x.ndim:
            bits = bits.reshape(bits.shape + (1,) * (x.ndim - bits.ndim))
    one = torch.ones((), dtype=I64, device=x.device)
    mask = (one << bits) - 1
    sign = one << (bits - 1)
    out = ((x & mask) ^ sign) - sign
    if isinstance(bits, int):
        return out if bits <= 32 else torch.zeros_like(out)
    return torch.where(bits <= 32, out, 0)


def sign_of_int(x):
    """dp_enc.c :: sign_of_int — +1 / 0 / -1."""
    return torch.sign(x)


def clz32(x):
    """Count leading zeros of the unsigned 32-bit value (clz(0) == 32):
    32 less the value's bit length, the exponent frexp gives (float64
    holds every 32-bit value exactly; frexp(0) gives 0)."""
    _, e = torch.frexp(u32(x).to(torch.float64))
    return 32 - e.to(I64)


def lg3a(x):
    """ag_enc.c :: lg3a — 31 - clz(x + 3) on uint32."""
    return 31 - clz32(u32(x) + 3)


def arith_shift_right(x, n):
    """C ``>>`` on int32 (arithmetic)."""
    return wrap_i32(x) >> n


def iota1(n: int, dtype=I64, device=None):
    """1-D iota (the counterpart of jaxutils.iota1)."""
    return torch.arange(n, dtype=dtype, device=device)
