"""Wrapper of the Rice emission kernel (csrc/emit.cu), the port of
alacjax/ops/pallas/emit_pallas.py.  Plain version:
alacjax_torch.ops.rice.rice_encode_words."""

from __future__ import annotations

import torch

from ..types import MAX_PREFIX_32

from ..ops import rice
from ..utils.metrics import readback
from . import LAUNCHES, expect, lane_vector, launch, on_cuda

N_SLOTS = 2         # csrc/emit.cu's slots per step (emit_slots of any admitted cap)

plain = rice.rice_encode_words          # the plain version, same signature


def rice_encode_words(res, bit_size, mb0: int, pb: int, kb: int, wb: int,
                      start_bits, bit_size_cap: int | None = None, num=None):
    """Residuals (L, S) int32 + per-lane start bit (L,) -> (chunk words,
    chunk keys (L, n_slots*(S+1)) int32 bit patterns with -1 for empty
    slots, end_bits (L,), tail_val (L,), tail_key (L,)).  ``bit_size`` is
    an int or a per-lane (L,) int32 tensor of values at most
    ``bit_size_cap``; ``num`` (None or (L,) int32) encodes only each
    lane's first num samples."""
    lane = [t for t in (bit_size, num) if isinstance(t, torch.Tensor)]
    if not on_cuda(res, start_bits, *lane):
        return plain(res, bit_size, mb0, pb, kb, wb, start_bits,
                     bit_size_cap=bit_size_cap, num=num)
    L, S = res.shape
    dev = res.device
    expect(res, "res", (L, S))
    expect(start_bits, "start_bits", (L,))
    if isinstance(bit_size, int):
        bit_size_cap = bit_size
    elif bit_size_cap is None:
        raise ValueError("per-lane bit sizes need bit_size_cap")
    else:
        # the kernel's escape token is one append of the 9-bit prefix and
        # the payload: every lane's bit size must respect the cap
        if readback(bit_size.max(), "emit.cap") > bit_size_cap:
            raise ValueError(f"a bit size exceeds bit_size_cap="
                             f"{bit_size_cap}")
    bs = lane_vector(bit_size, L, dev, "bit_size")
    if num is not None:
        expect(num, "num", (L,))
    if (rice.emit_slots(bit_size_cap) != N_SLOTS or bit_size_cap < 1
            or bit_size_cap + MAX_PREFIX_32 > 32):
        raise ValueError(f"emit kernel does not take bit_size={bit_size_cap}")
    words = torch.empty((L, N_SLOTS * (S + 1)), dtype=torch.int32, device=dev)
    keys = torch.empty_like(words)
    end, tv, tk = (torch.empty((L,), dtype=torch.int32, device=dev)
                   for _ in range(3))
    launch("alac_emit", res,
           res.data_ptr(), start_bits.data_ptr(), bs.data_ptr(),
           None if num is None else num.data_ptr(), words.data_ptr(),
           keys.data_ptr(), end.data_ptr(), tv.data_ptr(), tk.data_ptr(),
           L, S, bit_size_cap, mb0, pb, kb, wb)
    LAUNCHES["emit"] += 1
    return words, keys, end, tv, tk
