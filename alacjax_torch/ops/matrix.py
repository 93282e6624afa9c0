"""Batched stereo decorrelation (counterpart of alacjax/ops/matrix.py;
oracle: alacjax.oracle.matrix; reference: codec/matrix_enc.c /
matrix_dec.c).

Plain elementwise torch.  ``mixres``/``mixbits``/``bytes_shifted`` may be
ints or per-frame (B, 1) tensors.  int32 wraparound semantics match the
oracle exactly; results are int32.
"""

from __future__ import annotations

import torch

from ..utils.metrics import span
from .tutils import I32, I64, wrap_i32


def _arg(v, like):
    if isinstance(v, torch.Tensor):
        return torch.as_tensor(v, dtype=I64, device=like.device)
    # a Python number reaches the card through a pageable copy, which
    # torch ends with a stream synchronize
    with span("matrix.scalar.sync"):
        return torch.as_tensor(v, dtype=I64, device=like.device)


def mix(left, right, mixbits, mixres):
    """U = (mixres*L + ((1<<mixbits)-mixres)*R) >> mixbits, V = L - R;
    pass-through where mixres == 0."""
    l = wrap_i32(left)
    r = wrap_i32(right)
    mixres = _arg(mixres, l)
    mixbits = _arg(mixbits, l)
    m2 = wrap_i32((1 << mixbits) - mixres)
    u_mixed = wrap_i32(mixres * l + m2 * r) >> mixbits
    mixed = mixres != 0
    u = torch.where(mixed, u_mixed, l)
    v = torch.where(mixed, wrap_i32(l - r), r)
    return u.to(I32), v.to(I32)


def unmix(u, v, mixbits, mixres):
    """R = U - ((mixres*V) >> mixbits), L = V + R; pass-through where
    mixres == 0."""
    u = wrap_i32(u)
    v = wrap_i32(v)
    mixres = _arg(mixres, u)
    mixbits = _arg(mixbits, u)
    r_mixed = wrap_i32(u - (wrap_i32(mixres * v) >> mixbits))
    mixed = mixres != 0
    l = torch.where(mixed, wrap_i32(v + r_mixed), u)
    r = torch.where(mixed, r_mixed, v)
    return l.to(I32), r.to(I32)


def shift_off(x, bytes_shifted):
    """Split off low bytes: returns (x >> 8*bs, x & mask)."""
    x = wrap_i32(x)
    shift = _arg(bytes_shifted, x) * 8
    mask = (1 << shift) - 1
    return (x >> shift).to(I32), (x & mask).to(I32)


def shift_in(x, shift_vals, bytes_shifted):
    """Re-insert shifted-off low bytes."""
    x = wrap_i32(x)
    shift = _arg(bytes_shifted, x) * 8
    return wrap_i32((x << shift) | wrap_i32(shift_vals)).to(I32)
