"""The encode's chunk assembly in plain torch: the reference that
csrc/assemble.cu is held to, and the CPU path of ``kernels.assemble``.

Per element, the header tokens at the element's start, the shift-byte
block and each channel's Rice rows, with the per-lane escape select
(the element's escape stream, header and raw samples at full depth,
where ``use_escape`` is set), written as word chunks with absolute word
keys (-1 where empty) and the boundary words as tails, then the END
tag's two tails (alacjax/codec.py :: mixed_chunks and the END tag of
_encode_packet_chunks, XLA there).  ``chunks`` is the kernel's plain
version; ``mixed_chunks`` with ``pad_to_escape`` is the "assemble"
profiling cut.  Arithmetic is int64, the images int32 bit patterns at
the module's boundary.
"""

from __future__ import annotations

import torch

from ..oracle.encoder import (
    DEFAULT_MIX_BITS, PB_FACTOR, bytes_shifted_for_depth,
)
from ..types import DENSHIFT_DEFAULT, kALACMaxCoefs
from . import bitpack
from .tutils import I32, I64, MASK32, as_i32_bits, iota1, u32


# ---------------------------------------------------------------------------
# token-building helpers
# ---------------------------------------------------------------------------
def header23(tag, instance: int, bytes_shifted: int, escape: bool):
    """The 23-bit element header of a full frame (a partial frame ORs in
    bit 3)."""
    return ((int(tag) << 20) | (instance << 16) | (bytes_shifted << 1)
            | int(escape))


def chparam_token(order, mode):
    """(mode,denshift)<<8 | (pbFactor<<5|order) — per-lane order/mode."""
    return ((((mode.to(I64) << 4) | DENSHIFT_DEFAULT) << 8)
            | (PB_FACTOR << 5) | order.to(I64))


def coef_tokens(coefs, order):
    """(B,16) coef values + per-lane order -> 16 token slots."""
    vals = coefs.to(I64) & 0xFFFF
    ks = iota1(kALACMaxCoefs, device=coefs.device)[None, :]
    lens = torch.where(ks < order[:, None], 16, 0)
    return vals, lens


def interleave2(a, b):
    """(B,S),(B,S) -> (B,2S) interleaved a0,b0,a1,b1,..."""
    B, S = a.shape
    return torch.stack([a, b], dim=-1).reshape(B, 2 * S)


# ---------------------------------------------------------------------------
# scatter-free segment emission (word chunks with absolute keys)
# ---------------------------------------------------------------------------
def segment_keys(base_word, n: int):
    return base_word[:, None] + iota1(n, device=base_word.device)[None, :]


def emit_header(vals_list, lens_list, start_bits, cap_bits: int):
    """Assemble small header token streams at a per-lane absolute offset.
    Only COMPLETE words keep real keys (the merge invariant); the final
    partial word is returned as a tail.
    Returns (words, keys, end_bits, tail_val, tail_key), int64."""
    B = start_bits.shape[0]
    dev = start_bits.device
    phase = start_bits & 31
    vals = torch.cat([torch.zeros((B, 1), dtype=I64, device=dev)]
                     + vals_list, dim=1)
    lens = torch.cat([phase[:, None]] + lens_list, dim=1)
    cap_words = (31 + cap_bits + 31) // 32
    words, img_bits = bitpack.assemble(vals, lens, cap_words)
    words = u32(words)
    img_bits = img_bits.to(I64)
    keys = segment_keys(start_bits >> 5, cap_words)
    n_complete = img_bits >> 5
    keys = torch.where(iota1(cap_words, device=dev)[None, :]
                       < n_complete[:, None], keys, MASK32)
    has_tail = (img_bits & 31) > 0
    tail_val = torch.gather(words, 1, torch.clamp(n_complete, max=cap_words - 1)
                            [:, None])[:, 0]
    tail_val = torch.where(has_tail & (n_complete < cap_words), tail_val, 0)
    tail_key = (start_bits >> 5) + n_complete
    return words, keys, start_bits + img_bits - phase, tail_val, tail_key


def emit_block(fields, d: int, start_bits, nf_lane=None):
    """Pack fixed-width fields and place them at per-lane bit offsets:
    phase-0 pack + per-lane funnel shift + word keys, complete words
    only.  ``nf_lane`` (per-lane field count, partial frames) keeps each
    lane's first nf_lane fields; fields past it must be zero already.
    The boundary word is the tail (a gather at the per-lane complete-
    word count, which at a full count is _emit_block's or
    _emit_block_n's select alike).
    Returns (words, keys, end_bits, tail_val, tail_key), int64."""
    placed = u32(bitpack.place_segment(bitpack.pack_fields(fields, d),
                                       start_bits & 31))
    Wp = placed.shape[1]
    keys = segment_keys(start_bits >> 5, Wp)
    nbits = fields.shape[1] * d if nf_lane is None else nf_lane * d
    n_complete = ((start_bits & 31) + nbits) >> 5
    keys = torch.where(iota1(Wp, device=keys.device)[None, :]
                       < n_complete[:, None], keys, MASK32)
    end = start_bits + nbits
    tail_val = torch.gather(placed, 1, torch.clamp(n_complete, max=Wp - 1)
                            [:, None])[:, 0]
    tail_val = torch.where((end & 31) > 0, tail_val, 0)
    tail_key = (start_bits >> 5) + n_complete
    return placed, keys, end, tail_val, tail_key


def pad_cols(a, T: int, value: int):
    return torch.nn.functional.pad(a, (0, T - a.shape[1]), value=value)


def masked_block(e, name: str, nums):
    """An element's per-sample block (raw samples or shift bytes),
    channel-interleaved for a CPE, with the fields past each partial
    lane's count zeroed: (fields (B, width*S), per-lane field count or
    None)."""
    chans = e[name]
    f = interleave2(chans[0], chans[1]) if e["is_cpe"] else chans[0]
    if nums is None:
        return f, None
    nf = e["width"] * nums
    return torch.where(iota1(f.shape[1], device=f.device)[None, :]
                       < nf[:, None], f, 0), nf


def partial_tokens(hv, hl, nums, S: int):
    """A partial lane's header: bit 3 of the 23-bit header and a 32-bit
    numSamples token (zero-length on full lanes).  Returns the header
    cap's extra bits."""
    if nums is None:
        return 0
    partial = nums < S
    hv[0] = hv[0] | (partial.to(I64) << 3)[:, None]
    hv.append(nums[:, None])
    hl.append(torch.where(partial, 32, 0)[:, None])
    return 32


def esc_stream(e, depth: int, nums, S: int):
    """Escape stream chunks of one element: 23-bit header (+ numSamples
    on partial lanes) + raw samples at full depth, at the element's
    start.  Returns (vals, keys (int32 bits), (tails v), (tails k))."""
    B = e["start"].shape[0]
    dev = e["start"].device
    hv = [torch.full((B, 1), header23(e["tag"], e["instance"], 0, True),
                     dtype=I64, device=dev)]
    hl = [torch.full((B, 1), 23, dtype=I64, device=dev)]
    cap = 23 + partial_tokens(hv, hl, nums, S)
    ew, ek, epos, etv, etk = emit_header(hv, hl, e["start"], cap)
    raw, nf = masked_block(e, "chans", nums)
    rw, rk, _, rtv, rtk = emit_block(raw, depth, epos, nf)
    return (as_i32_bits(torch.cat([ew, rw], dim=1)),
            as_i32_bits(torch.cat([ek, rk], dim=1)), (etv, rtv), (etk, rtk))


def header_stream(e, bs: int, nums, S: int):
    """The compressed element's header tokens at its start: 23-bit
    header (+ numSamples), mixBits/mixRes (0, 0 for an SCE/LFE), and per
    channel the parameter word and its order's coefficients.  Returns
    emit_header's result."""
    B = e["start"].shape[0]
    dev = e["start"].device

    def full(v, n=1):
        return torch.full((B, n), v, dtype=I64, device=dev)

    hv = [full(header23(e["tag"], e["instance"], bs, False))]
    hl = [full(23)]
    cap = 23 + partial_tokens(hv, hl, nums, S) + 16
    hv.append(((DEFAULT_MIX_BITS << 8) | (e["mixres"].to(I64) & 0xFF))[:, None]
              if e["is_cpe"] else full(0))
    hl.append(full(16))
    for ci in range(e["width"]):
        hv.append(chparam_token(e["orders"][ci], e["modes"][ci])[:, None])
        hl.append(full(16))
        # the coefficients the winning order started from: fresh, or its
        # bank in a stream
        cv, cl = coef_tokens(e["coefs0_win"][ci], e["orders"][ci])
        hv.append(cv)
        hl.append(cl)
        cap += 16 + 16 * kALACMaxCoefs
    return emit_header(hv, hl, e["start"], cap)


def esc_width(e, depth: int, nums, S: int) -> int:
    """Word columns of esc_stream's chunks: the header image and the
    placed raw block."""
    cap = 23 + (0 if nums is None else 32)
    return (31 + cap + 31) // 32 + (e["width"] * S * depth + 31) // 32 + 1


def mixed_chunks(elems, emitted, config, nums, pad_to_escape: bool = False):
    """alacjax's mixed_chunks: per element, the header tokens, the
    shift-byte block and the Rice chunks of its channels, with the
    per-element escape select.  Returns (vals, keys) int32 bit patterns
    and the lists of tail values and keys.  ``pad_to_escape`` widens
    every element's chunks to its escape stream's width, as alacjax
    does (the "assemble" cut); the merge does not need it."""
    S = config.frame_length
    depth = config.bit_depth
    bs = bytes_shifted_for_depth(depth)
    cw_all, ck_all, _, ctv_all, ctk_all = emitted
    B = elems[0]["start"].shape[0]
    all_vals, all_keys, tail_v, tail_k = [], [], [], []
    rci = 0
    for e in elems:
        hw, hk, pos, htv, htk = header_stream(e, bs, nums, S)
        seg_v, seg_k = [as_i32_bits(hw)], [as_i32_bits(hk)]
        tv_c, tk_c = [htv], [htk]
        if bs:
            sh, nf = masked_block(e, "los", nums)
            bw, bk, pos, btv, btk = emit_block(sh, 8 * bs, pos, nf)
            seg_v.append(as_i32_bits(bw))
            seg_k.append(as_i32_bits(bk))
            tv_c.append(btv)
            tk_c.append(btk)
        for _ in range(e["width"]):
            sl = slice(rci * B, (rci + 1) * B)
            seg_v.append(cw_all[sl])
            seg_k.append(ck_all[sl])
            tv_c.append(u32(ctv_all[sl]))
            tk_c.append(u32(ctk_all[sl]))
            rci += 1
        vals = torch.cat(seg_v, dim=1)
        keys = torch.cat(seg_k, dim=1)
        ue = e["use_escape"]
        if pad_to_escape and not e["any_escape"]:
            T = max(vals.shape[1], esc_width(e, depth, nums, S))
            vals, keys = pad_cols(vals, T, 0), pad_cols(keys, T, -1)
        if e["any_escape"]:
            vals_e, keys_e, tv_e, tk_e = esc_stream(e, depth, nums, S)
            T = max(vals.shape[1], vals_e.shape[1])
            vals = torch.where(ue[:, None], pad_cols(vals_e, T, 0),
                               pad_cols(vals, T, 0))
            keys = torch.where(ue[:, None], pad_cols(keys_e, T, -1),
                               pad_cols(keys, T, -1))
            n_pad = len(tv_c) - 2
            zero = torch.zeros_like(tv_c[0])
            tv_c = [torch.where(ue, b, a)
                    for a, b in zip(tv_c, list(tv_e) + [zero] * n_pad)]
            tk_c = [torch.where(ue, b, a)
                    for a, b in zip(tk_c, list(tk_e) + [zero + MASK32] * n_pad)]
        all_vals.append(vals)
        all_keys.append(keys)
        tail_v += tv_c
        tail_k += tk_c
    return (torch.cat(all_vals, dim=1), torch.cat(all_keys, dim=1), tail_v,
            tail_k)


def escape_chunks(elems, config, nums):
    """Every lane of every element escaped (partial lanes, per-lane
    offsets): each element's escape stream, its two tails.  Returns
    (vals, keys) int32 bit patterns and the lists of tail values and
    keys."""
    av, ak, tv, tk = [], [], [], []
    for e in elems:
        ev, ek, (etv, rtv), (etk, rtk) = esc_stream(
            e, config.bit_depth, nums, config.frame_length)
        av.append(ev)
        ak.append(ek)
        tv += [etv, rtv]
        tk += [etk, rtk]
    return torch.cat(av, dim=1), torch.cat(ak, dim=1), tv, tk


def end_tails(total_c):
    """The END tag (3 bits) at the packet's known end position ``total_c``
    (B,): pure tails, as lists of two tail values and two keys."""
    phase = total_c & 31
    end_hi = (7 << 29) >> phase
    end_lo = torch.where(phase > 29, (7 << ((61 - phase) % 32)) & MASK32, 0)
    end_tk = [total_c >> 5,
              torch.where(phase > 29, (total_c >> 5) + 1, MASK32)]
    return [end_hi, end_lo], end_tk


def chunks(elems, emitted, total_c, config, nums):
    """What the merge takes, for a call where some lane compressed
    (``emitted``, rice_encode_words's outputs over every channel) or,
    with ``emitted`` None, where every lane of every element escaped:
    ((B, T) chunk words, (B, T) keys, (B, n_t) tail words, (B, n_t) tail
    keys, all int32 bit patterns in the merge's order with the END tag's
    two tails last; (B,) int32 total bits, END included)."""
    if emitted is None:
        vals, keys, tv, tk = escape_chunks(elems, config, nums)
    else:
        vals, keys, tv, tk = mixed_chunks(elems, emitted, config, nums)
    end_tv, end_tk = end_tails(total_c)
    return (vals, keys, as_i32_bits(torch.stack(tv + end_tv, dim=1)),
            as_i32_bits(torch.stack(tk + end_tk, dim=1)),
            (total_c + 3).to(I32))
