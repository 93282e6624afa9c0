"""Wrapper of the decode's pcm kernel (csrc/pcm.cu): one element's unmix,
shift-byte re-insert, escape select and tail mask, written into its
channels of the call's (B, C, S) output.  No TPU kernel: it replaces the
torch glue of the decode (alacjax/codec.py :: decode_frames_device's
per-element unmix, shift bytes and escape select, then the final stack
and mask).  Counts under ``LAUNCHES["pcm"]``, one launch per element.
Plain version: alacjax_torch.ops.pcm.element_pcm."""

from __future__ import annotations

import torch

from ..ops import pcm
from . import LAUNCHES, expect, launch, on_cuda

plain = pcm.element_pcm                 # the plain version, same signature


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(words, S, width, bs, depth, num, pos_shift, pos_esc, esc, r0,
           r1, mixbits, mixres, out, c0):
    B = words.shape[0] if words.dim() == 2 else -1
    expect(words, "words", (B, words.shape[-1]))
    if width not in (1, 2):
        raise ValueError(f"width must be 1 or 2, got {width}")
    if bs not in (0, 1, 2):
        raise ValueError(f"bs must be 0, 1 or 2, got {bs}")
    if not 1 <= depth <= 32:
        raise ValueError(f"depth must be in 1..32, got {depth}")
    for name, t in (("num", num), ("pos_shift", pos_shift),
                    ("pos_esc", pos_esc)):
        expect(t, name, (B,))
    expect(esc, "esc", (B,), torch.bool)
    if width == 2:
        if mixbits is None or mixres is None:
            raise ValueError("a CPE needs mixbits and mixres")
        expect(mixbits, "mixbits", (B,))
        expect(mixres, "mixres", (B,))
    elif mixbits is not None or mixres is not None or r1 is not None:
        raise ValueError("an SCE takes no mixbits, mixres or r1")
    if r0 is not None:
        expect(r0, "r0", (B, S))
        if width == 2:
            expect(r1, "r1", (B, S))
    elif r1 is not None:
        raise ValueError("r1 without r0")
    if out is not None:
        C = out.shape[1] if out.dim() == 3 else -1
        expect(out, "out", (B, C, S))
        if not 0 <= c0 <= C - width:
            raise ValueError(f"channels {c0}..{c0 + width - 1} lie outside "
                             f"the output's {C}")


def element_pcm(words, num_samples: int, width: int, bs: int, depth: int,
                num, pos_shift, pos_esc, esc, r0=None, r1=None, mixbits=None,
                mixres=None, unescape: bool = True, out=None, c0: int = 0):
    """Channels ``c0 .. c0 + width - 1`` of ``out`` ((B, C, S) int32, or a
    new (B, width, S) tensor if None), which it returns: the element's
    reconstructed streams ``r0`` (and ``r1`` for a CPE; (B, S) int32, or
    None for an element whose every lane escaped) unmixed, their shift
    bytes (``bs`` of them, 0..2) re-inserted, an escape lane's
    ``depth``-bit verbatim samples selected (with ``unescape``) and the
    samples past each lane's ``num`` zeroed.  ``words`` is the (B, W)
    int32 word image; ``num``, ``pos_shift`` (the shift-byte block's bit),
    ``pos_esc`` (the escape samples' bit), ``mixbits`` and ``mixres``
    (a CPE's) are (B,) int32 and ``esc`` (B,) bool, as the parse kernel
    writes them."""
    _check(words, num_samples, width, bs, depth, num, pos_shift, pos_esc,
           esc, r0, r1, mixbits, mixres, out, c0)
    if not on_cuda(words, num, pos_shift, pos_esc, esc, r0, r1, mixbits,
                   mixres, out):
        return plain(words, num_samples, width, bs, depth, num, pos_shift,
                     pos_esc, esc, r0, r1, mixbits, mixres, unescape, out, c0)
    B, W = words.shape
    S = num_samples
    if out is None:
        out = torch.empty((B, width, S), dtype=torch.int32,
                          device=words.device)
    launch("alac_pcm", words,
           words.data_ptr(), _ptr(r0), _ptr(r1), _ptr(mixbits), _ptr(mixres),
           pos_shift.data_ptr(), pos_esc.data_ptr(), esc.data_ptr(),
           num.data_ptr(), out.data_ptr(), B, W, S, out.shape[1], c0, width,
           bs, depth, int(unescape))
    LAUNCHES["pcm"] += 1
    return out
