"""Wrapper of the Rice emission kernel (csrc/emit.cu), the port of
alacjax/ops/pallas/emit_pallas.py.  Plain version:
alacjax_torch.ops.rice.rice_encode_words."""

from __future__ import annotations

import torch

from alacjax.types import MAX_PREFIX_32

from ..ops import rice
from . import LAUNCHES, expect, on_cuda, stream_ptr
from ._build import check, lib

MAX_SLOTS = 3       # csrc/emit.cu's per-step slot registers

plain = rice.rice_encode_words          # the plain version, same signature


def rice_encode_words(res, bit_size: int, mb0: int, pb: int, kb: int,
                      wb: int, start_bits):
    """Residuals (L, S) int32 + per-lane start bit (L,) -> (chunk words,
    chunk keys (L, n_slots*(S+1)) int32 bit patterns with -1 for empty
    slots, end_bits (L,), tail_val (L,), tail_key (L,))."""
    if not on_cuda(res, start_bits):
        return plain(res, bit_size, mb0, pb, kb, wb, start_bits)
    L, S = res.shape
    expect(res, "res", (L, S))
    expect(start_bits, "start_bits", (L,))
    n_slots = (31 + 25 + MAX_PREFIX_32 + bit_size) // 32
    if not 1 <= n_slots <= MAX_SLOTS or bit_size + MAX_PREFIX_32 > 32:
        raise ValueError(f"emit kernel does not take bit_size={bit_size}")
    dev = res.device
    xt = res.t().contiguous()
    words = torch.empty((L, n_slots * (S + 1)), dtype=torch.int32, device=dev)
    keys = torch.empty_like(words)
    end, tv, tk = (torch.empty((L,), dtype=torch.int32, device=dev)
                   for _ in range(3))
    status = lib().alac_emit(
        xt.data_ptr(), start_bits.data_ptr(), words.data_ptr(),
        keys.data_ptr(), end.data_ptr(), tv.data_ptr(), tk.data_ptr(),
        L, S, bit_size, n_slots, mb0, pb, kb, wb, stream_ptr(res))
    check(status, "alac_emit")
    LAUNCHES["emit"] += 1
    return words, keys, end, tv, tk
