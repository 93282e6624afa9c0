"""Wrapper of the fused decode kernel (csrc/decode.cu), the port of
alacjax/ops/pallas/decode_step.py (and of the whole-loop job of
decode_pallas.py).  Plain version:
alacjax_torch.ops.fused_decode.decode_channel."""

from __future__ import annotations

import torch

from alacjax.types import kALACMaxCoefs

from ..ops import fused_decode
from . import LAUNCHES, expect, on_cuda, stream_ptr
from ._build import check, lib

plain = fused_decode.decode_channel     # the plain version, same signature


def decode_channel(words, start_bits, num_samples: int, chanbits: int,
                   mb0: int, pb, kb: int, wb: int, coefs0, mode, numactive,
                   denshift, num=None):
    """(B, W) int32 word image -> (samples (B, S) int32, end_bits (B,)
    int32, err (B,) bool): one channel, the 8-tap FIR walk.  Per-lane
    args are (B,) int32; coefs0 is (B, 16) int32."""
    lane = (start_bits, pb, coefs0, mode, numactive, denshift, num)
    if not on_cuda(words, *lane):
        return plain(words, start_bits, num_samples, chanbits, mb0, pb, kb,
                     wb, coefs0, mode, numactive, denshift, num=num)
    B, W = words.shape
    S = num_samples
    expect(words, "words", (B, W))
    for name, t in (("start_bits", start_bits), ("pb", pb), ("mode", mode),
                    ("numactive", numactive), ("denshift", denshift)):
        expect(t, name, (B,))
    expect(coefs0, "coefs0", (B, kALACMaxCoefs))
    if num is not None:
        expect(num, "num", (B,))
    dev = words.device
    samples_t = torch.empty((S, B), dtype=torch.int32, device=dev)
    end = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    status = lib().alac_decode(
        words.data_ptr(), start_bits.data_ptr(), pb.data_ptr(),
        coefs0.data_ptr(), mode.data_ptr(), numactive.data_ptr(),
        denshift.data_ptr(), None if num is None else num.data_ptr(),
        samples_t.data_ptr(), end.data_ptr(), err.data_ptr(),
        B, W, S, chanbits, mb0, kb, wb, stream_ptr(words))
    check(status, "alac_decode")
    LAUNCHES["decode"] += 1
    return samples_t.t().contiguous(), end, err != 0
