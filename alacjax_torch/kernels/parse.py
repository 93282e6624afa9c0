"""Wrapper of the decode's parse kernel (csrc/parse.cu): one element's
header, partial-frame field, mix token and every channel's param header
and coefficients, read at each lane's element start from the int32 word
image, written as the ``ops.parse.Parsed`` the decode's kernels read,
with the element's escape flags and its readout (flags and counts).  No
TPU kernel: it replaces the torch glue of the decode (alacjax/codec.py
:: decode_frames_device's per-element header parse, XLA there).  Counts
under ``LAUNCHES["parse"]``, one launch per element.  Plain version:
alacjax_torch.ops.parse.parse_element."""

from __future__ import annotations

import torch

from ..oracle.encoder import bytes_shifted_for_depth
from ..ops import parse
from ..ops.parse import Parsed, lane_rows
from . import LAUNCHES, expect, launch, on_cuda

plain = parse.parse_element             # the plain version, same signature
KERNEL_MAX_ORDS = (16, 30)              # max(kALACMaxCoefs, taps)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(words, bitpos, num, width, num_samples, max_ord):
    B = words.shape[0] if words.dim() == 2 else -1
    expect(words, "words", (B, words.shape[-1]))
    if words.shape[1] < 1:
        raise ValueError("words: the image needs at least one word")
    if width not in (1, 2):
        raise ValueError(f"width must be 1 or 2, got {width}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be positive, got {num_samples}")
    if not 1 <= max_ord <= 30:
        raise ValueError(f"max_ord must be in 1..30, got {max_ord}")
    for name, t in (("bitpos", bitpos), ("num", num)):
        if t is not None:
            expect(t, name, (B,))


def parse_element(words, bitpos, num, tag, width: int, config,
                  num_samples: int, max_ord: int) -> Parsed:
    """One element's parse (see ops.parse.Parsed): ``words`` the (B, W)
    int32 word image, ``bitpos`` the (B,) int32 per-lane element start or
    None for bit 0, ``num`` the (B,) int32 frame length of the packet's
    first element or None for the first; ``tag`` the element's
    ElementTag, ``width`` its channels, ``max_ord`` the largest order
    accepted besides 31 (16 or 30 on the card: max(kALACMaxCoefs, taps))."""
    _check(words, bitpos, num, width, num_samples, max_ord)
    if not on_cuda(words, bitpos, num):
        return plain(words, bitpos, num, tag, width, config, num_samples,
                     max_ord)
    if max_ord not in KERNEL_MAX_ORDS:
        raise ValueError(f"no parse kernel instance for max_ord={max_ord}; "
                         f"built: {KERNEL_MAX_ORDS}")
    B, W = words.shape
    K = lane_rows(width)
    # one buffer: the lane rows, the coefficients, then the readout
    buf = torch.empty((K * B + width * B * max_ord + 4,), dtype=torch.int32,
                      device=words.device)
    lanes = buf[:K * B].view(K, B)
    coefs = buf[K * B:-4].view(width, B, max_ord)
    readout = buf[-4:]
    bits = torch.empty((2, B), dtype=torch.bool, device=words.device)
    launch("alac_parse", words,
           words.data_ptr(), _ptr(bitpos), _ptr(num), lanes.data_ptr(),
           coefs.data_ptr(), readout.data_ptr(), bits.data_ptr(), B, W,
           num_samples, width, max_ord, int(tag),
           bytes_shifted_for_depth(config.bit_depth), config.pb)
    LAUNCHES["parse"] += 1
    return Parsed(readout, bits, lanes, coefs)
