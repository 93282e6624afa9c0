"""Wrapper of the fused decode kernel (csrc/decode.cu), one source with
an instance per tap count.  The 8-tap instance is the port of
alacjax/ops/pallas/decode_step.py and counts under ``LAUNCHES["decode"]``;
the 16- and 30-tap instances, which the codec's retry ladder runs, are
the port of alacjax/ops/pallas/decode_pallas.py and count under
``LAUNCHES["decode_hi"]``.  Plain version:
alacjax_torch.ops.fused_decode.decode_channel."""

from __future__ import annotations

import torch

from ..ops import fused_decode
from . import LAUNCHES, expect, launch, on_cuda

plain = fused_decode.decode_channel     # the plain version, same signature
KERNEL_TAPS = (fused_decode.TAPS,) + fused_decode.LADDER_TAPS


def counter(taps: int) -> str:
    """The LAUNCHES key of the instance with this tap count."""
    return "decode" if taps == fused_decode.TAPS else "decode_hi"


def decode_channel(words, start_bits, num_samples: int, chanbits,
                   mb0: int, pb, kb: int, wb: int, coefs0, mode, numactive,
                   denshift, num=None, taps: int = fused_decode.TAPS,
                   chanbits_max: int | None = None):
    """(B, W) int32 word image -> (samples (B, S) int32, end_bits (B,)
    int32, err (B,) bool): one channel through the ``taps``-wide walk
    (8, 16 or 30).  Per-lane args are (B,) int32; coefs0 is (B, n)
    int32.  ``chanbits`` is an int, or a (B,) int32 tensor whose values
    are at most ``chanbits_max``."""
    lane = (start_bits, pb, coefs0, mode, numactive, denshift, num)
    if isinstance(chanbits, torch.Tensor):
        lane = lane + (chanbits,)
    if not on_cuda(words, *lane):
        return plain(words, start_bits, num_samples, chanbits, mb0, pb, kb,
                     wb, coefs0, mode, numactive, denshift, num=num,
                     taps=taps, chanbits_max=chanbits_max)
    if taps not in KERNEL_TAPS:
        raise ValueError(f"no decode kernel instance for taps={taps}; "
                         f"built: {KERNEL_TAPS}")
    B, W = words.shape
    S = num_samples
    expect(words, "words", (B, W))
    for name, t in (("start_bits", start_bits), ("pb", pb), ("mode", mode),
                    ("numactive", numactive), ("denshift", denshift)):
        expect(t, name, (B,))
    expect(coefs0, "coefs0", (B, coefs0.shape[1]))
    if num is not None:
        expect(num, "num", (B,))
    dev = words.device
    if isinstance(chanbits, torch.Tensor):
        if chanbits_max is None:
            raise ValueError("per-lane chanbits need chanbits_max")
        expect(chanbits, "chanbits", (B,))
        cb_lane = chanbits
    else:
        chanbits_max = chanbits
        cb_lane = torch.full((B,), chanbits, dtype=torch.int32, device=dev)
    samples = torch.empty((B, S), dtype=torch.int32, device=dev)
    end = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    launch("alac_decode", words,
           words.data_ptr(), start_bits.data_ptr(), cb_lane.data_ptr(),
           pb.data_ptr(), coefs0.data_ptr(), coefs0.shape[1],
           mode.data_ptr(), numactive.data_ptr(), denshift.data_ptr(),
           None if num is None else num.data_ptr(), samples.data_ptr(),
           end.data_ptr(), err.data_ptr(), B, W, S, taps, chanbits_max, mb0,
           kb, wb)
    LAUNCHES[counter(taps)] += 1
    return samples, end, err != 0
