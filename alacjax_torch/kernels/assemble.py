"""Wrapper of the encode's assembly kernel (csrc/assemble.cu): every
element's header tokens, shift-byte block and Rice rows, the per-lane
escape select, the tails and the END tag, written in one launch as the
chunk image the merge kernel takes.  No TPU kernel: it replaces the
glue of alacjax/codec.py:696 mixed_chunks (XLA there).  Counts under
``LAUNCHES["assemble"]``, one launch an encode.  Plain version:
alacjax_torch.ops.assemble.chunks."""

from __future__ import annotations

import ctypes

import torch

from ..oracle.encoder import (
    DEFAULT_MIX_BITS, PB_FACTOR, bytes_shifted_for_depth,
)
from ..ops import assemble
from ..types import DENSHIFT_DEFAULT, kALACMaxCoefs
from . import LAUNCHES, expect, launch, on_cuda

plain = assemble.chunks                 # the plain version, same signature
MAX_ELEMS = 8                           # csrc/assemble.cu :: MAX_ELEMS
DESC = 26                               # csrc/assemble.cu :: DESC


def _header_words(width: int, partial_bits: int, comp: bool) -> int:
    """Columns of an element's header image (emit_header's cap words)."""
    cap = 23 + partial_bits + (16 + width * (16 + 16 * kALACMaxCoefs)
                               if comp else 0)
    return (31 + cap + 31) // 32


def layout(elems, comp: bool, S: int, depth: int, nums_given: bool,
           R: int):
    """Per element, the plain version's columns: (header, shift block,
    escape header, raw block, the element's width in columns, its tails).
    ``comp``: the call has the compressed form (Rice rows of R slots)."""
    bs = bytes_shifted_for_depth(depth)
    pbits = 32 if nums_given else 0
    out = []
    for e in elems:
        w = e["width"]
        hw = _header_words(w, pbits, True)
        bw = (w * S * 8 * bs + 31) // 32 + 1 if bs else 0
        ehw = _header_words(w, pbits, False)
        rw = (w * S * depth + 31) // 32 + 1
        if comp:
            T = hw + bw + w * R
            if e["any_escape"]:
                T = max(T, ehw + rw)
            n_tails = 1 + (1 if bs else 0) + w
        else:
            T, n_tails = ehw + rw, 2
        out.append((hw, bw, ehw, rw, T, n_tails))
    return out


def _lane(t, name: str, B: int, dtype) -> None:
    expect(t, name, (B,), dtype)


def _check(elems, emitted, total_c, config, nums):
    """Raise unless the call's tensors have the kernel's dtypes, shapes
    and layouts, and the elements' channels follow one another (the
    element e's Rice rows are emitted's rows after its predecessors')."""
    if not 1 <= len(elems) <= MAX_ELEMS:
        raise ValueError(f"1 to {MAX_ELEMS} elements, got {len(elems)}")
    S, depth = config.frame_length, config.bit_depth
    bs = bytes_shifted_for_depth(depth)
    B = total_c.shape[0] if total_c.dim() == 1 else -1
    _lane(total_c, "total_c", B, torch.int64)
    if nums is not None:
        _lane(nums, "nums", B, torch.int64)
    comp = emitted is not None
    ch = 0
    for i, e in enumerate(elems):
        w = e["width"]
        if w not in (1, 2) or e["is_cpe"] != (w == 2):
            raise ValueError(f"elems[{i}]: width {w}, is_cpe {e['is_cpe']}")
        if e["ch0"] != ch:
            raise ValueError(f"elems[{i}]: channels from {e['ch0']} overlap "
                             f"or leave a gap after channel {ch - 1}")
        ch += w
        _lane(e["start"], f"elems[{i}].start", B, torch.int64)
        if comp and e["any_escape"] or not comp:
            for c in range(w):
                x = e["chans"][c]
                if (x.dtype != torch.int32 or tuple(x.shape) != (B, S)
                        or x.stride(1) != 1 or x.stride(0) < S):
                    raise ValueError(f"elems[{i}].chans[{c}]: a ({B}, {S}) "
                                     f"int32 row view, got {x.dtype} "
                                     f"{tuple(x.shape)} {x.stride()}")
        if not comp:
            continue
        if e["any_escape"]:
            _lane(e["use_escape"], f"elems[{i}].use_escape", B, torch.bool)
        if w == 2:
            _lane(e["mixres"], f"elems[{i}].mixres", B, torch.int64)
        for c in range(w):
            _lane(e["orders"][c], f"elems[{i}].orders[{c}]", B, torch.int64)
            _lane(e["modes"][c], f"elems[{i}].modes[{c}]", B, torch.int64)
            expect(e["coefs0_win"][c], f"elems[{i}].coefs0_win[{c}]",
                   (B, kALACMaxCoefs))
            if bs:
                expect(e["los"][c], f"elems[{i}].los[{c}]", (B, S))
    if comp:
        cw, ck, _, ctv, ctk = emitted
        L = ch * B
        R = cw.shape[1] if cw.dim() == 2 else -1
        expect(cw, "emitted words", (L, R))
        expect(ck, "emitted keys", (L, R))
        expect(ctv, "emitted tail words", (L,))
        expect(ctk, "emitted tail keys", (L,))


def _tensors(elems, emitted, total_c, nums):
    """Every tensor the call reads, for the device check."""
    ts = [total_c, nums]
    for e in elems:
        ts += [e["start"], *e["chans"]]
        if emitted is not None:
            ts += [e["use_escape"], e["mixres"], *e["orders"], *e["modes"],
                   *e["coefs0_win"], *e["los"]]
    if emitted is not None:
        ts += [emitted[0], emitted[1], emitted[3], emitted[4]]
    return ts


def chunks(elems, emitted, total_c, config, nums):
    """The chunk image the merge takes, in one launch: ``elems`` the
    codec's element dicts (sized: start, use_escape, any_escape; with
    ``emitted``, the search's mixres, orders, modes, coefs0_win and the
    shift-off rows ``los``), ``emitted`` rice_encode_words's outputs
    over every channel in element order, or None where every lane of
    every element escaped; ``total_c`` (B,) int64 the bits before the
    END tag; ``nums`` (B,) int64 or None.  Returns ((B, T) chunk words,
    keys, (B, n_t) tail words, tail keys, int32 bit patterns; (B,) int32
    total bits), equal to ``plain``'s."""
    _check(elems, emitted, total_c, config, nums)
    if not on_cuda(*_tensors(elems, emitted, total_c, nums)):
        return plain(elems, emitted, total_c, config, nums)
    S, depth = config.frame_length, config.bit_depth
    bs = bytes_shifted_for_depth(depth)
    B = total_c.shape[0]
    comp = emitted is not None
    R = emitted[0].shape[1] if comp else 0
    lay = layout(elems, comp, S, depth, nums is not None, R)
    T = sum(x[4] for x in lay)
    n_t = sum(x[5] for x in lay) + 2
    desc = (ctypes.c_longlong * (DESC * len(elems)))()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def two(ts, on: bool):
        """The pointers of a channel list, null past its width or where
        the element does not read it."""
        ts = list(ts) if on else []
        return [ptr(t) for t in (ts + [None, None])[:2]]
    col = tail = row = 0
    for i, (e, (hw, bw, ehw, rw, Te, nt)) in enumerate(zip(elems, lay)):
        w = e["width"]
        slot = [ptr(e["start"]),
                ptr(e["use_escape"]) if comp and e["any_escape"] else 0,
                ptr(e["mixres"]) if comp and w == 2 else 0,
                *two(e["orders"], comp), *two(e["modes"], comp),
                *two(e["coefs0_win"], comp), *two(e["los"], comp and bs > 0),
                *two(e["chans"], not comp or e["any_escape"]),
                e["chans"][0].stride(0), w,
                assemble.header23(e["tag"], e["instance"], bs, False),
                assemble.header23(e["tag"], e["instance"], 0, True),
                col, Te, hw, bw, ehw, rw, tail, int(comp), row]
        desc[i * DESC:(i + 1) * DESC] = slot
        col += Te
        tail += nt
        row += w * B
    dev = total_c.device
    vals = torch.empty((B, T), dtype=torch.int32, device=dev)
    keys = torch.empty_like(vals)
    tv = torch.empty((B, n_t), dtype=torch.int32, device=dev)
    tk = torch.empty_like(tv)
    bits = torch.empty((B,), dtype=torch.int32, device=dev)
    cw, ck, _, ctv, ctk = emitted if comp else (None,) * 5
    launch("alac_assemble", total_c, desc, ptr(cw), ptr(ck), ptr(ctv),
           ptr(ctk), ptr(nums), total_c.data_ptr(), vals.data_ptr(),
           keys.data_ptr(), tv.data_ptr(), tk.data_ptr(), bits.data_ptr(),
           len(elems), B, T, n_t, S, depth, bs, R, DEFAULT_MIX_BITS << 8,
           (DENSHIFT_DEFAULT << 8) | (PB_FACTOR << 5))
    LAUNCHES["assemble"] += 1
    return vals, keys, tv, tk, bits
