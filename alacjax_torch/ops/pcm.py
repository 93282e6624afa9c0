"""The decode's pcm stage in plain torch: the reference that csrc/pcm.cu
is held to, and the CPU path of ``kernels.pcm.element_pcm``.

One element's reconstructed channels -> unmix (CPE), shift-byte
re-insert, escape select and tail mask, written into the element's
channels of the call's (B, C, S) output (alacjax/codec.py ::
decode_frames_device, the per-element glue after the channel scans,
then the final stack and mask).
"""

from __future__ import annotations

import torch

from . import bitpack, matrix
from .tutils import I32, iota1, sign_extend, wrap_i32


def shift_bytes(words, pos_shift, width: int, S: int, bs: int):
    """The element's shift-byte block: ``width`` channel-interleaved
    8*bs-bit fields per sample at a per-lane offset -> per-channel (B, S)
    low bytes (int64)."""
    d = 8 * bs
    seg = bitpack.extract_segment(words, pos_shift, (width * S * d + 31) // 32)
    sf = bitpack.unpack_fields(seg, d, width * S).reshape(-1, S, width)
    return [sf[:, :, ci] for ci in range(width)]


def escape_samples(words, pos_esc, depth: int, width: int, S: int):
    """An escape lane's verbatim samples: ``width`` channel-interleaved
    ``depth``-bit fields per sample at a per-lane offset -> per-channel
    (B, S) sign-extended samples (int64)."""
    F = width * S
    seg = bitpack.extract_segment(words, pos_esc, (depth * F + 31) // 32)
    f = sign_extend(bitpack.unpack_fields(seg, depth, F), depth)
    return [f[:, ci::width] for ci in range(width)]


def element_pcm(words, num_samples: int, width: int, bs: int, depth: int,
                num, pos_shift, pos_esc, esc, r0=None, r1=None, mixbits=None,
                mixres=None, unescape: bool = True, out=None, c0: int = 0):
    """Channels ``c0 .. c0 + width - 1`` of ``out`` ((B, C, S) int32; a
    new (B, width, S) tensor if None), which it returns, from the
    element's reconstructed streams ``r0`` (and ``r1`` for a CPE), (B, S)
    int32, or None for an element whose every lane escaped (then zeros,
    with no unmix and no shift bytes).  ``words`` is the (B, W) int32
    word image; ``num``, ``pos_shift``, ``pos_esc``, ``mixbits`` and
    ``mixres`` are the parse's (B,) int32 per-lane values, ``esc`` its
    (B,) bool escape flags.  With ``unescape`` an escape lane takes its
    verbatim samples; without it (the "nounesc" cut) it keeps what the
    unmix and shift bytes made of its streams.  Samples at and past a
    lane's ``num`` are 0."""
    B = words.shape[0]
    S = num_samples
    if out is None:
        out = torch.empty((B, width, S), dtype=I32, device=words.device)
    if r0 is None:
        dec = [torch.zeros((B, S), dtype=I32, device=words.device)] * width
    else:
        dec = [r0, r1][:width]
        if width == 2:
            dec = list(matrix.unmix(r0, r1, mixbits[:, None],
                                    mixres[:, None]))
        if bs:
            shifts = shift_bytes(words, pos_shift, width, S, bs)
            dec = [wrap_i32((wrap_i32(x) << 8 * bs) | sh).to(I32)
                   for x, sh in zip(dec, shifts)]
    if unescape:
        raws = escape_samples(words, pos_esc, depth, width, S)
        dec = [torch.where(esc[:, None], raw.to(I32), x)
               for raw, x in zip(raws, dec)]
    keep = iota1(S, device=words.device)[None, :] < num[:, None]
    for ci, x in enumerate(dec):
        out[:, c0 + ci] = torch.where(keep, x, 0)
    return out
