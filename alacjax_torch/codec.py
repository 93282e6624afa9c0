"""Batched codec pipeline on torch — the port of alacjax/codec.py.
Encode: single-element 16-bit layouts (stereo CPE or mono SCE),
independent full frames, the standard search.  Decode: every layout
(mono, stereo, 3 to 8 channels as chained SCE/CPE/LFE elements), depths
16/20/24/32, partial frames and every legal predictor order, through
the 8 -> 16 -> 30-tap retry ladder.

Encode dataflow (alacjax.codec._encode_packet_chunks, standard branch):
dilated mixres trial (7 stacked candidate streams per CPE, cost kernel,
order 8, one cost machine) -> mix -> order {4, 8} x stage {1, 2} search
(cost kernel, two cost machines, one call per order) -> closed-form
segment offsets and per-element escape sizing -> headers as tiny token
images -> Rice emission kernel -> per-element escape select -> merge
kernel (scatter + tail OR) -> (B, W) word image.

Decode dataflow (alacjax.codec.decode_frames_device, chained branch),
per element: header parse (static offsets for a single-element packet,
else one window aligned to the element's per-lane start) -> chained
channel decodes (decode kernel at 8, 16 or 30 taps; channel c+1 starts
where channel c ends) -> unmix -> shift-byte re-insert -> escape select;
the next element starts where this one ends.

Each ``lax.cond`` of the reference is a Python ``if`` on a
``.any().item()``.  Tensors live on the codec's device; the kernel
wrappers launch CUDA kernels for CUDA tensors and run the plain torch
versions for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from alacjax.oracle import ALACDecoder as OracleDecoder
from alacjax.oracle.encoder import (
    DEFAULT_MIX_BITS, FAST_ORDER, MAX_RES, MIXRES_DILATE, PB_FACTOR,
    SEARCH_ORDERS, SEARCH_STAGES, bytes_shifted_for_depth,
)
from alacjax.types import (
    DENSHIFT_DEFAULT, AlacConfig, AlacParamError, kALACMaxCoefs,
)

from .kernels import cost as k_cost
from .kernels import decode as k_decode
from .kernels import emit as k_emit
from .kernels import merge as k_merge
from .ops import bitpack, fused_decode, matrix, predict
from .ops.tutils import I32, I64, MASK32, as_i32_bits, iota1, sign_extend, u32
from .state import init_coefs_batched

DEFAULT_CHUNK = 256


DECODE_DEPTHS = (16, 20, 24, 32)


def check_encode_config(config: AlacConfig) -> None:
    """Raise unless the port's encoder covers this configuration yet."""
    if (len(config.elements) != 1 or config.bit_depth != 16
            or config.fast_mode or config.search != "standard"):
        raise AlacParamError(
            "alacjax_torch encodes single-element 16-bit layouts with the "
            "standard search; use alacjax for other configurations")


def check_decode_config(config: AlacConfig) -> None:
    """Raise unless the port's decoder covers this configuration: any
    element layout, depths 16/20/24/32."""
    if config.bit_depth not in DECODE_DEPTHS:
        raise AlacParamError(
            f"alacjax_torch decodes depths {DECODE_DEPTHS}, "
            f"not {config.bit_depth}")


# ---------------------------------------------------------------------------
# token-building helpers (encode)
# ---------------------------------------------------------------------------
def _header23(tag, bytes_shifted, escape):
    """The 23-bit element header of instance 0, full frame."""
    return (int(tag) << 20) | (bytes_shifted << 1) | int(escape)


def _chparam_token(order, mode):
    """(mode,denshift)<<8 | (pbFactor<<5|order) — per-lane order/mode."""
    return ((((mode.to(I64) << 4) | DENSHIFT_DEFAULT) << 8)
            | (PB_FACTOR << 5) | order.to(I64))


def _coef_tokens(coefs, order):
    """(B,16) coef values + per-lane order -> 16 token slots."""
    vals = coefs.to(I64) & 0xFFFF
    ks = iota1(kALACMaxCoefs, device=coefs.device)[None, :]
    lens = torch.where(ks < order[:, None], 16, 0)
    return vals, lens


def _interleave2(a, b):
    """(B,S),(B,S) -> (B,2S) interleaved a0,b0,a1,b1,..."""
    B, S = a.shape
    return torch.stack([a, b], dim=-1).reshape(B, 2 * S)


def _rice_params_static(config: AlacConfig):
    pb = (config.pb * PB_FACTOR) // 4
    return config.mb, pb, config.kb, (1 << config.kb) - 1


def _mixres_select(l_hi, r_hi, chanbits: int, config):
    """Stereo mode of a CPE in one dilated trial: 7 candidate streams
    (L, R, U1..U4, the shared V), priced by the cost kernel at order 8
    with fresh coefs; argmin of the summed cost (first minimum wins)."""
    B = l_hi.shape[0]
    mb0, pb, kb, wb = _rice_params_static(config)
    ld = l_hi[:, ::MIXRES_DILATE]
    rd = r_hi[:, ::MIXRES_DILATE]
    cand = [ld, rd]                                      # mixres 0
    cand += [matrix.mix(ld, rd, DEFAULT_MIX_BITS, mr)[0]
             for mr in range(1, MAX_RES + 1)]
    cand.append(as_i32_bits(ld.to(I64) - rd.to(I64)))   # shared V
    st = torch.cat(cand, dim=0).contiguous()
    _, c, _, _ = k_cost.pc_block_cost2(
        st, init_coefs_batched(st.shape[0], st.device), FAST_ORDER,
        chanbits, DENSHIFT_DEFAULT, mb0, pb, kb, wb, dual=False)
    c = c.to(I64).reshape(len(cand), B)
    tot = torch.stack([c[0] + c[1]]
                      + [c[1 + mr] + c[-1] for mr in range(1, MAX_RES + 1)])
    return torch.argmin(tot, dim=0)


def _search_channels(streams, chanbits: int, config):
    """Per-channel (order x stage) candidate search over every channel:
    one dual-cost kernel call per order over the stacked channels.
    Candidates (4,1),(4,2),(8,1),(8,2); first minimum wins.  Returns
    per-channel lists (res, order, mode, rice_bits) and the channels'
    shared fresh coefs0."""
    B = streams[0].shape[0]
    dev = streams[0].device
    mb0, pb, kb, wb = _rice_params_static(config)
    orders, stages = list(SEARCH_ORDERS), list(SEARCH_STAGES)
    W = len(streams)
    xs = torch.cat(streams, dim=0).contiguous()
    c0s = init_coefs_batched(W * B, dev)
    by_order = {}
    for od in orders:
        by_order[od] = k_cost.pc_block_cost2(
            xs, c0s, od, chanbits, DENSHIFT_DEFAULT, mb0, pb, kb, wb,
            dual=True)
    res_l, order_l, mode_l, rice_l = [], [], [], []
    for ci in range(W):
        sl = slice(ci * B, (ci + 1) * B)
        cand_costs, cand_rice = [], []
        for od in orders:
            _, c1, c2, _ = by_order[od]
            for rc in (c1[sl], c2[sl]):
                cand_costs.append(16 + 16 * od + rc.to(I64))
                cand_rice.append(rc.to(I64))
        win = torch.argmin(torch.stack(cand_costs, dim=0), dim=0)
        rice_win = torch.gather(torch.stack(cand_rice, dim=0), 0,
                                win[None, :])[0]
        order_win = torch.full((B,), orders[0], dtype=I64, device=dev)
        mode_win = torch.zeros((B,), dtype=I64, device=dev)
        for ki in range(len(cand_costs)):
            od, stg = orders[ki // len(stages)], stages[ki % len(stages)]
            hit = win == ki
            order_win = torch.where(hit, od, order_win)
            # two-stage mode is written as 15 on the wire (the reference
            # encoder's value)
            mode_win = torch.where(hit, 0 if stg == 1 else 15, mode_win)
        res_win = by_order[orders[0]][0][sl]
        for od in orders[1:]:
            res_win = torch.where((order_win == od)[:, None],
                                  by_order[od][0][sl], res_win)
        res_win = torch.where((mode_win != 0)[:, None],
                              predict.wrap_diff(res_win, chanbits), res_win)
        res_l.append(res_win.contiguous())
        order_l.append(order_win)
        mode_l.append(mode_win)
        rice_l.append(rice_win)
    return res_l, order_l, mode_l, rice_l, c0s[:B]


# ---------------------------------------------------------------------------
# scatter-free segment emission (word chunks with absolute keys)
# ---------------------------------------------------------------------------
def _segment_keys(base_word, n: int):
    return base_word[:, None] + iota1(n, device=base_word.device)[None, :]


def _emit_header(vals_list, lens_list, start_bits, cap_bits: int):
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
    keys = _segment_keys(start_bits >> 5, cap_words)
    n_complete = img_bits >> 5
    keys = torch.where(iota1(cap_words, device=dev)[None, :]
                       < n_complete[:, None], keys, MASK32)
    has_tail = (img_bits & 31) > 0
    tail_val = torch.gather(words, 1, torch.clamp(n_complete, max=cap_words - 1)
                            [:, None])[:, 0]
    tail_val = torch.where(has_tail & (n_complete < cap_words), tail_val, 0)
    tail_key = (start_bits >> 5) + n_complete
    return words, keys, start_bits + img_bits - phase, tail_val, tail_key


def _emit_block(fields, d: int, start_bits):
    """Pack fixed-width fields and place them at per-lane bit offsets:
    phase-0 pack + per-lane funnel shift + word keys, complete words
    only.  Returns (words, keys, end_bits, tail_val, tail_key), int64."""
    placed = u32(bitpack.place_segment(bitpack.pack_fields(fields, d),
                                       start_bits & 31))
    Wp = placed.shape[1]
    keys = _segment_keys(start_bits >> 5, Wp)
    nbits = fields.shape[1] * d
    phase = start_bits & 31
    n_complete = (phase + nbits) >> 5
    keys = torch.where(iota1(Wp, device=keys.device)[None, :]
                       < n_complete[:, None], keys, MASK32)
    end = start_bits + nbits
    has_tail = (end & 31) > 0
    lo, hi = nbits >> 5, (31 + nbits) >> 5
    tail_hi = placed[:, hi] if hi < Wp else torch.zeros_like(placed[:, 0])
    tail_val = torch.where(n_complete == lo, placed[:, lo], tail_hi)
    tail_val = torch.where(has_tail, tail_val, 0)
    tail_key = (start_bits >> 5) + n_complete
    return placed, keys, end, tail_val, tail_key


def _pad_cols(a, T: int, value: int):
    return torch.nn.functional.pad(a, (0, T - a.shape[1]), value=value)


def _raw_samples(e):
    """The element's PCM as its escape block writes it: channel-
    interleaved for a CPE."""
    chans = e["chans"]
    return _interleave2(chans[0], chans[1]) if e["is_cpe"] else chans[0]


def _encode_packet_chunks(pcm, config: AlacConfig, num_words: int):
    """(B, C, S) int32 planar -> ((B, W) int32 word image, (B,) total
    bits): the standard branch of alacjax's _encode_packet_chunks with
    nums=None and banks=None, for the one element
    ``check_encode_config`` admits (it starts at bit 0)."""
    check_encode_config(config)
    B = pcm.shape[0]
    dev = pcm.device
    S = config.frame_length
    depth = config.bit_depth
    bs = bytes_shifted_for_depth(depth)
    mb0, pb, kb, wb = _rice_params_static(config)
    (tag, width), = config.elements
    is_cpe = width == 2
    chanbits = depth - 8 * bs + (1 if is_cpe else 0)
    chans = [pcm[:, ci, :].to(I32) for ci in range(width)]
    his = [matrix.shift_off(c, bs)[0] for c in chans]

    # ---- stereo mode (one dilated trial), then the channel search ----
    if is_cpe:
        mixres = _mixres_select(his[0], his[1], chanbits, config)
        streams = list(matrix.mix(his[0], his[1], DEFAULT_MIX_BITS,
                                  mixres[:, None]))
    else:
        mixres = None
        streams = his
    res, orders, modes, rice_bits, coefs0 = _search_channels(
        streams, chanbits, config)
    e = dict(tag=tag, width=width, is_cpe=is_cpe, chans=chans,
             mixres=mixres, orders=orders, modes=modes, coefs0=coefs0)

    # ---- header / escape sizing ----
    hdr_bits = 23 + 16 + width * 16 + 16 * sum(orders)
    shift_bits = width * S * 8 * bs
    esc_bits = 23 + width * S * depth
    comp_bits = hdr_bits + shift_bits + sum(rice_bits)
    e["use_escape"] = comp_bits >= esc_bits
    total_c = torch.where(e["use_escape"], esc_bits, comp_bits)

    # ---- one stacked Rice emission over every channel ----
    pos = hdr_bits + shift_bits
    rice_starts = []
    for ci in range(width):
        rice_starts.append(pos)
        pos = pos + rice_bits[ci]
    any_comp = not bool(e["use_escape"].all().item())
    if any_comp:
        emitted = k_emit.rice_encode_words(
            torch.cat(res, dim=0), chanbits, mb0, pb, kb, wb,
            torch.cat(rice_starts, dim=0).to(I32))

    # ---- END tag (3 bits) at the known end position: pure tails ----
    phase = total_c & 31
    end_hi = (7 << 29) >> phase
    end_lo = torch.where(phase > 29, (7 << ((61 - phase) % 32)) & MASK32, 0)
    end_tv = [end_hi, end_lo]
    end_tk = [total_c >> 5, torch.where(phase > 29, (total_c >> 5) + 1, MASK32)]
    total_bits = (total_c + 3).to(I32)

    if any_comp:
        words = _assemble_mixed(e, emitted, end_tv, end_tk, config, bs,
                                num_words)
    else:
        words = _assemble_all_escape(e, config, num_words)
    return words, total_bits


def _esc_stream(e, depth: int):
    """Escape stream chunks: 23-bit header + raw samples at full depth.
    Returns (vals, keys, (tails v), (tails k)), int64."""
    B = e["chans"][0].shape[0]
    dev = e["chans"][0].device
    eh23 = torch.full((B, 1), _header23(e["tag"], 0, True), dtype=I64,
                      device=dev)
    start = torch.zeros((B,), dtype=I64, device=dev)
    ew, ek, epos, etv, etk = _emit_header(
        [eh23], [torch.full((B, 1), 23, dtype=I64, device=dev)], start, 23)
    rw, rk, _, rtv, rtk = _emit_block(_raw_samples(e), depth, epos)
    return (torch.cat([ew, rw], dim=1), torch.cat([ek, rk], dim=1),
            (etv, rtv), (etk, rtk))


def _esc_stream_width(width: int, S: int, depth: int) -> int:
    """Static column count of _esc_stream: header words + placed block."""
    return (31 + 23 + 31) // 32 + (width * S * depth + 31) // 32 + 1


def _assemble_mixed(e, emitted, end_tv, end_tk, config, bs: int,
                    num_words: int):
    """Chunk assembly when some lane compressed: header tokens, the Rice
    chunks of every channel, the per-lane escape select, then the merge
    kernel."""
    S = config.frame_length
    depth = config.bit_depth
    cw_all, ck_all, _, ctv_all, ctk_all = emitted
    B = e["chans"][0].shape[0]
    dev = e["chans"][0].device
    width = e["width"]

    def full(v, n=1):
        return torch.full((B, n), v, dtype=I64, device=dev)

    hv = [full(_header23(e["tag"], bs, False))]
    hl = [full(23)]
    if e["is_cpe"]:
        hv.append(((DEFAULT_MIX_BITS << 8)
                   | (e["mixres"].to(I64) & 0xFF))[:, None])
    else:
        hv.append(full(0))
    hl.append(full(16))
    for ci in range(width):
        hv.append(_chparam_token(e["orders"][ci], e["modes"][ci])[:, None])
        hl.append(full(16))
        cv, cl = _coef_tokens(e["coefs0"], e["orders"][ci])
        hv.append(cv)
        hl.append(cl)
    cap = 23 + 16 + width * (16 + 16 * kALACMaxCoefs)
    start = torch.zeros((B,), dtype=I64, device=dev)
    hw, hk, _, htv, htk = _emit_header(hv, hl, start, cap)
    seg_v, seg_k = [hw], [hk]
    tail_v, tail_k = [htv], [htk]
    for ci in range(width):
        sl = slice(ci * B, (ci + 1) * B)
        seg_v.append(u32(cw_all[sl]))
        seg_k.append(u32(ck_all[sl]))
        tail_v.append(u32(ctv_all[sl]))
        tail_k.append(u32(ctk_all[sl]))
    vals = torch.cat(seg_v, dim=1)
    keys = torch.cat(seg_k, dim=1)
    T = max(vals.shape[1], _esc_stream_width(width, S, depth))
    vals = _pad_cols(vals, T, 0)
    keys = _pad_cols(keys, T, MASK32)
    ue = e["use_escape"]
    if bool(ue.any().item()):
        vals_e, keys_e, tv_e, tk_e = _esc_stream(e, depth)
        vals = torch.where(ue[:, None], _pad_cols(vals_e, T, 0), vals)
        keys = torch.where(ue[:, None], _pad_cols(keys_e, T, MASK32), keys)
        n_pad = len(tail_v) - 2
        zero = torch.zeros_like(tail_v[0])
        tail_v = [torch.where(ue, b, a)
                  for a, b in zip(tail_v, list(tv_e) + [zero] * n_pad)]
        tail_k = [torch.where(ue, b, a)
                  for a, b in zip(tail_k, list(tk_e) + [zero + MASK32] * n_pad)]
    return k_merge.merge_sorted_chunks(
        as_i32_bits(vals), as_i32_bits(keys),
        as_i32_bits(torch.stack(tail_v + end_tv, dim=1)),
        as_i32_bits(torch.stack(tail_k + end_tk, dim=1)), num_words)


def _assemble_all_escape(e, config, num_words: int):
    """Every lane escaped: the packed raw image at its static bit
    offset, no chunk merge."""
    S = config.frame_length
    depth = config.bit_depth
    row = np.zeros((num_words,), np.uint64)

    def or_static(val, nbits, pos):
        w, ph = pos >> 5, pos & 31
        v64 = (val & ((1 << nbits) - 1)) << (64 - ph - nbits)
        if w < num_words:
            row[w] |= v64 >> 32
        if ph + nbits > 32 and w + 1 < num_words:
            row[w + 1] |= v64 & 0xFFFFFFFF

    B = e["chans"][0].shape[0]
    dev = e["chans"][0].device
    or_static(_header23(e["tag"], 0, True), 23, 0)
    img = bitpack.pack_fields(_raw_samples(e), depth)
    placed = u32(bitpack.place_segment(
        img, torch.full((B,), 23, dtype=I64, device=dev)))
    Wp = min(placed.shape[1], num_words)
    out = torch.zeros((B, num_words), dtype=I64, device=dev)
    out[:, :Wp] = placed[:, :Wp]
    or_static(0b111, 3, 23 + e["width"] * depth * S)
    out = out | torch.from_numpy(row.astype(np.int64)).to(dev)[None, :]
    return as_i32_bits(out)


def encode_frames_device(pcm, config: AlacConfig, num_words: int):
    """(B, C, S) planar int32 tensor -> ((B, W) int32 word image,
    (B,) int32 total bits)."""
    return _encode_packet_chunks(pcm, config, num_words)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _sfield(words, off: int, n: int):
    """(B,) n-bit field at a STATIC bit offset of a u32 (int64) image."""
    i, ph = off >> 5, off & 31
    a = words[:, i]
    if ph + n > 32:
        a = ((a << ph) & MASK32) | (words[:, i + 1] >> (32 - ph))
        return a >> (32 - n)
    return (a >> (32 - ph - n)) & ((1 << n) - 1)


def _parse_ph(ph, max_ord: int = kALACMaxCoefs):
    """Split a 16-bit channel-param header into (mode, den, pbf, order)."""
    mode = (ph >> 12) & 0xF
    den = (ph >> 8) & 0xF
    pbf = (ph >> 5) & 0x7
    order = ph & 0x1F
    perr = ((order > max_ord) & (order != 31)) | (
        (den == 0) & (order != 0) & (order != 31))
    return (mode, den, pbf, order), perr


def _decode_params_static(words, is_cpe: bool, max_ord: int = kALACMaxCoefs):
    """Header/param parse on a bit-0-aligned element view at static
    offsets; channel 1's fields sit at an offset set by order0, read from
    a 16-bit-stride field table.  Returns (params, end bits relative to
    the element start sans the partial numSamples field, err)."""
    c_ph0 = 23 + 16
    deep = c_ph0 + 16 + 16 * ((31 + max_ord if is_cpe else max_ord) + 1)
    need = deep // 32 + 2
    if words.shape[1] < need:
        words = torch.nn.functional.pad(words, (0, need - words.shape[1]))
    ph0 = _sfield(words, c_ph0, 16)
    (mode0, den0, pbf0, order0), perr = _parse_ph(ph0, max_ord)
    coefs0 = sign_extend(torch.stack(
        [_sfield(words, c_ph0 + 16 + 16 * j, 16) for j in range(max_ord)],
        dim=1), 16)
    params = [(mode0, den0, pbf0, order0, coefs0)]
    end = c_ph0 + 16 + 16 * order0
    if is_cpe:
        H = torch.stack([_sfield(words, c_ph0 + 16 + 16 * m, 16)
                         for m in range(31 + 1 + max_ord + 1)], dim=1)
        # orders outside 0..max_ord and 31 read as order 0 (those lanes
        # are flagged by perr), as the reference's select does
        legal = (order0 <= max_ord) | (order0 == 31)
        o_sel = torch.where(legal, order0, 0)
        ph1 = torch.gather(H, 1, o_sel[:, None])[:, 0]
        (mode1, den1, pbf1, order1), perr1 = _parse_ph(ph1, max_ord)
        perr = perr | perr1
        idx = o_sel[:, None] + 1 + iota1(max_ord, device=H.device)[None, :]
        coefs1 = sign_extend(torch.gather(H, 1, idx), 16)
        params.append((mode1, den1, pbf1, order1, coefs1))
        end = end + 16 + 16 * order1
    return params, end, perr


def _unescape_fast(words, depth: int, nch: int, S: int, partial):
    """Escape samples of a single-element packet: the raw block sits at
    static bit 23 (55 on partial lanes), so a word-shifted view and a
    constant funnel shift bring it to phase 0 for unpack_fields."""
    F = nch * S
    need = (depth * F + 31) // 32 + 2
    W = words.shape[1]
    wp = words if W >= need else torch.nn.functional.pad(words, (0, need - W))
    w0 = torch.where(partial[:, None], wp[:, 1:need], wp[:, :need - 1])
    al = ((w0[:, :-1] << 23) & MASK32) | (w0[:, 1:] >> 9)
    f = sign_extend(bitpack.unpack_fields(al, depth, F), depth)
    return [f[:, ci::nch] for ci in range(nch)]


def _unescape_window(words, pos_esc, depth: int, nch: int, S: int):
    """Escape samples at a per-lane offset (a later element of a
    multi-element packet): one word window aligned to phase 0, then the
    same periodic unpack."""
    F = nch * S
    seg = bitpack.extract_segment(words, pos_esc, (depth * F + 31) // 32)
    f = sign_extend(bitpack.unpack_fields(seg, depth, F), depth)
    return [f[:, ci::nch] for ci in range(nch)]


def _parse_element(w, bitpos, num, tag, width: int, config: AlacConfig,
                   S: int, max_ord: int, fast_hdr: bool):
    """Header parse of one element (alacjax.codec.decode_frames_device's
    per-element loop): ``w`` is the (B, W) u32 image, ``bitpos`` the
    per-lane element start, ``num`` the frame length of the packet's
    first element (None for the first).  A single-element packet is read
    at static offsets; otherwise one window aligned to the element
    carries the same static parse.  Returns a dict with ``esc``,
    ``partial``, ``num``, ``err``, the per-channel ``params`` (mode, den,
    pbf, order, coefs), ``pos_esc`` (the raw block of an escape lane),
    ``pos_shift`` (the shift-byte block), ``rice`` (the first channel's
    Rice start) and, for a CPE, ``mixbits`` and ``mixres``."""
    depth = config.bit_depth
    is_cpe = width == 2
    if fast_hdr:
        hdr = _sfield(w, 0, 23)
        nsf = _sfield(w, 23, 32)
    else:
        hdr = fused_decode._read_bits(w, bitpos, 23)
        nsf = fused_decode._read_bits(w, bitpos + 23, 32)
    rtag = hdr >> 20
    unused = (hdr >> 4) & 0xFFF
    partial = ((hdr >> 3) & 1) == 1
    bs_f = (hdr >> 1) & 3
    esc = (hdr & 1) == 1
    bs = bytes_shifted_for_depth(depth)
    err = ((rtag != int(tag)) | (unused != 0)
           | (~esc & (bs_f != bs)) | (esc & (bs_f != 0)))

    # partial (tail) frames: 32-bit numSamples right after the header;
    # the elements of one packet must agree on it
    bad_num = partial & ((nsf == 0) | (nsf > S))
    num_el = torch.where(partial & ~bad_num, nsf, S)
    err = err | bad_num
    if num is None:
        num = num_el
    else:
        err = err | (num_el != num)
    pos_esc = bitpos + 23 + torch.where(partial, 32, 0)

    if fast_hdr:
        # partial lanes' fields sit exactly one word later
        ncol = 61
        wpad = (w if w.shape[1] >= ncol + 1
                else torch.nn.functional.pad(w, (0, ncol + 1 - w.shape[1])))
        w_hdr = torch.where(partial[:, None], wpad[:, 1:ncol + 1],
                            wpad[:, :ncol])
    else:
        # the element sans the partial field, aligned to bit 0
        deep = 39 + 16 + 16 * ((31 + max_ord if is_cpe else max_ord) + 1)
        w_hdr = u32(bitpack.extract_segment(w, pos_esc - 23, deep // 32 + 2))
    out = dict(esc=esc, partial=partial, num=num, pos_esc=pos_esc)
    if is_cpe:
        mixtok = _sfield(w_hdr, 23, 16)
        out["mixbits"] = torch.where(esc, 0, mixtok >> 8)
        out["mixres"] = torch.where(esc, 0, sign_extend(mixtok & 0xFF, 8))
    params, end_rel, perr = _decode_params_static(w_hdr, is_cpe, max_ord)
    out["params"] = params
    out["err"] = err | (~esc & perr)
    pos_shift = torch.where(esc, pos_esc, pos_esc - 23 + end_rel)
    out["pos_shift"] = pos_shift
    out["rice"] = pos_shift + torch.where(esc, 0, width * 8 * bs * num)
    return out


def _channel_args(p, ci: int, config: AlacConfig):
    """Per-lane decode-kernel arguments of channel ``ci`` from
    _parse_element's result, as int32 tensors: (pb, coefs0, mode, order,
    denshift).  Escape lanes carry garbage header fields; their order is
    normalized to 0 so they cannot flag the walk's tap bound."""
    mode, den, pbf, order, coefs = p["params"][ci]
    order = torch.where(p["esc"], 0, order)
    return tuple(a.to(I32).contiguous() for a in (
        (config.pb * pbf) // 4, coefs, mode, order, den))


def _shift_bytes(words, pos_shift, width: int, S: int, bs: int):
    """The element's shift-byte block: ``width`` channel-interleaved
    8*bs-bit fields per sample at a per-lane offset -> per-channel (B, S)
    low bytes."""
    d = 8 * bs
    seg = bitpack.extract_segment(words, pos_shift, (width * S * d + 31) // 32)
    sf = bitpack.unpack_fields(seg, d, width * S).reshape(-1, S, width)
    return [sf[:, :, ci] for ci in range(width)]


def decode_frames_device(words, config: AlacConfig, num_samples: int,
                         taps: int = fused_decode.TAPS):
    """(B, W) int32 word image -> ((B, C, S) int32 pcm, (B,) bool err,
    (B,) int32 num): the chained branch of
    alacjax.codec.decode_frames_device, every layout and depth.  ``taps``
    (8, 16 or 30) is the width of the channel scans' FIR walk; lanes
    with a higher order flag err."""
    B = words.shape[0]
    dev = words.device
    S = num_samples
    depth = config.bit_depth
    kb = config.kb
    bs = bytes_shifted_for_depth(depth)
    # the parse accepts orders up to the walk's width, never below 16
    max_ord = max(kALACMaxCoefs, taps)
    fast_hdr = len(config.elements) == 1
    words_i32 = words.to(I32).contiguous()
    w = u32(words_i32)
    bitpos = torch.zeros((B,), dtype=I64, device=dev)
    err = torch.zeros((B,), dtype=torch.bool, device=dev)
    num = None
    out_ch = []
    for tag, width in config.elements:
        is_cpe = width == 2
        p = _parse_element(w, bitpos, num, tag, width, config, S, max_ord,
                           fast_hdr)
        esc, num = p["esc"], p["num"]
        err = err | p["err"]
        chanbits = depth - 8 * bs + (1 if is_cpe else 0)
        bitpos = p["rice"]

        if bool(esc.all().item()):
            dec = [torch.zeros((B, S), dtype=I32, device=dev)] * width
        else:
            # chained channel scans: channel c+1 starts where channel c ends
            num_i32 = num.to(I32).contiguous()
            recon = []
            for ci in range(width):
                pb, coefs, mode, order, den = _channel_args(p, ci, config)
                samples, bitpos_n, rerr = k_decode.decode_channel(
                    words_i32, bitpos.to(I32).contiguous(), S, chanbits,
                    config.mb, pb, kb, (1 << kb) - 1, coefs, mode, order,
                    den, num=num_i32, taps=taps)
                bitpos = torch.where(esc, bitpos, bitpos_n.to(I64))
                err = err | (~esc & rerr)
                recon.append(samples)
            if is_cpe:
                recon = list(matrix.unmix(recon[0], recon[1],
                                          p["mixbits"][:, None],
                                          p["mixres"][:, None]))
            if bs:
                shifts = _shift_bytes(words_i32, p["pos_shift"], width, S, bs)
                recon = [matrix.shift_in(r, sh, bs)
                         for r, sh in zip(recon, shifts)]
            dec = recon

        if bool(esc.any().item()):
            raws = (_unescape_fast(w, depth, width, S, p["partial"])
                    if fast_hdr else
                    _unescape_window(words_i32, p["pos_esc"], depth, width, S))
            dec = [torch.where(esc[:, None], raws[ci].to(I32), dec[ci])
                   for ci in range(width)]
        out_ch.extend(dec)
        bitpos = torch.where(esc, p["pos_esc"] + width * depth * num, bitpos)

    pcm = torch.stack(out_ch, dim=1)
    if bool((num < S).any().item()):
        pcm = torch.where(iota1(S, device=dev)[None, None, :]
                          < num[:, None, None], pcm, 0)
    return pcm.to(I32), err, num.to(I32)


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------
class TorchCodec:
    """Batched codec for one AlacConfig on one torch device: encode and
    decode whole chunks of frames per call.  Every configuration the
    decoder covers constructs; ``encode_frames`` raises AlacParamError
    for one the encoder does not cover yet."""

    def __init__(self, config: AlacConfig, chunk: int = DEFAULT_CHUNK,
                 device="cpu"):
        check_decode_config(config)
        self.config = config
        self.chunk = chunk
        self.device = torch.device(device)
        S = config.frame_length
        self.num_words = (config.max_escape_packet_bytes(S) + 3) // 4 + 2
        self.fallback_frames = 0   # frames the device flagged -> oracle

    def _encode(self, pcm):
        """(B, C, S) int32 device tensor -> (words, total_bits) tensors."""
        return encode_frames_device(pcm, self.config, self.num_words)

    def _decode(self, words, taps: int = fused_decode.TAPS):
        """(B, W) int32 device tensor -> (pcm, err, num) tensors."""
        return decode_frames_device(words, self.config,
                                    self.config.frame_length, taps=taps)

    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """(nf, C, S) planar int -> list of nf packets."""
        nf = pcm.shape[0]
        packets = []
        for off in range(0, nf, self.chunk):
            block = np.asarray(pcm[off:off + self.chunk])
            n = block.shape[0]
            if n < self.chunk:
                block = np.concatenate(
                    [block, np.zeros((self.chunk - n,) + block.shape[1:],
                                     dtype=block.dtype)], axis=0)
            x = torch.from_numpy(block.astype(np.int32)).to(self.device)
            words, bits = self._encode(x)
            packets.extend(bitpack.words_to_bytes(
                words[:n].cpu().numpy(), bits[:n].cpu().numpy()))
        return packets

    def decode_frames_ex(self, packets: list[bytes]
                         ) -> tuple[np.ndarray, np.ndarray]:
        """list of packets -> ((nf, C, S) planar int64, (nf,) sample
        counts).  When many lanes of a chunk are flagged (the usual sign
        of a legal stream of order above 8), the chunk decodes again at
        16 and then 30 taps; lanes still flagged (frames outside the
        device grammar) decode on the scalar oracle."""
        cfg = self.config
        S = cfg.frame_length
        nf = len(packets)
        out = np.zeros((nf, cfg.num_channels, S), dtype=np.int64)
        nums = np.full((nf,), S, dtype=np.int64)
        for off in range(0, nf, self.chunk):
            blk = packets[off:off + self.chunk]
            n = len(blk)
            padded = list(blk) + [b""] * (self.chunk - n)
            wh = bitpack.bytes_to_words(padded, self.num_words)
            wdev = torch.from_numpy(wh.view(np.int32)).to(self.device)
            pcm, err, num = self._decode(wdev)
            out[off:off + n] = pcm[:n].cpu().numpy()
            nums[off:off + n] = num[:n].cpu().numpy()
            err = err[:n].cpu().numpy()
            # the retry rule and threshold of alacjax's JaxCodec: a few
            # flagged lanes (corruption) go straight to the oracle
            for retry_taps in fused_decode.LADDER_TAPS:
                if err.any() and err.sum() * 4 >= n and n >= 64:
                    pcm_r, err_r, num_r = self._decode(wdev, taps=retry_taps)
                    fixed = np.nonzero(err & ~err_r[:n].cpu().numpy())[0]
                    idx = torch.from_numpy(fixed).to(self.device)
                    out[off + fixed] = pcm_r[idx].cpu().numpy()
                    nums[off + fixed] = num_r[idx].cpu().numpy()
                    err[fixed] = False
            self.fallback_frames += int(err.sum())
            if err.any():
                dec = OracleDecoder(cfg)
                for j in np.nonzero(err)[0]:
                    y, got = dec.decode_packet(blk[j])
                    out[off + j, :, :got] = y[:, :got]
                    out[off + j, :, got:] = 0
                    nums[off + j] = got
        return out, nums

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """list of FULL-frame packets -> (nf, C, S) planar int64."""
        out, nums = self.decode_frames_ex(packets)
        if (nums != self.config.frame_length).any():
            raise AlacParamError("unexpected partial frame")
        return out


_CODEC_CACHE: dict[tuple, TorchCodec] = {}


def get_codec(config: AlacConfig, chunk: int = DEFAULT_CHUNK,
              device="cpu") -> TorchCodec:
    """Shared-cache codec lookup by (config, chunk, device)."""
    key = (config, chunk, str(torch.device(device)))
    if key not in _CODEC_CACHE:
        _CODEC_CACHE[key] = TorchCodec(config, chunk, device=device)
    return _CODEC_CACHE[key]
