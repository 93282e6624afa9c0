"""Batched codec pipeline on torch — the port of alacjax/codec.py.
Encode: every element layout (mono, stereo, 3 to 8 channels as SCE/CPE/
LFE elements), depths 16/20/24/32, partial frames batched with full
frames, the standard, fast and exhaustive searches, independent frames
or, through encode_stream_device / encode_streams, streams of packets
that carry persistent coefficient banks from one packet to the next
(the stateful encoder's mode).  Decode: every layout and depth, partial
frames and every legal predictor order, through the 8 -> 16 -> 30-tap
retry ladder.

Encode dataflow (alacjax.codec._encode_packet_chunks, general branch):
per-element shift-off -> stereo mode of every CPE (one dilated trial, 7
candidate streams per CPE, order 8, one cost machine; fast mode takes a
constant) -> mix, written into the search's stacked input -> one (order
x stage) search over every channel of every element (one cost launch
for every order, one pick launch for every lane's winner; exhaustive
mode searches all five mixes of each CPE and picks per element) ->
closed-form element starts
and per-element escape sizing -> one Rice emission over every channel
(per-lane chanbits and sample count) -> one assemble kernel launch
(csrc/assemble.cu, kernels/assemble.py: every element's header tokens,
shift-byte block and Rice rows, the per-lane escape select, the tails
and the END tag, as the merge's chunk image) -> merge kernel (scatter +
tail OR) -> (B, W) word image.  The
trial and the search price candidates with the fused cost kernel or,
with ``predict_legacy``, with the standalone predictor kernel followed
by the Rice cost kernel (alacjax's ALACJAX_PALLAS_PREDICT_LEGACY=1).
The search's stream glue, the mixes (one launch for the trial's
candidates of every CPE, one for the chosen streams) and the pick, is
csrc/search.cu (kernels/search.py).

Decode dataflow (alacjax.codec.decode_frames_device, chained branch),
per element: one parse kernel launch (header, partial-frame field, mix
token and every channel's params, read at each lane's element start
from the int32 image; the first element's at bit 0) -> chained
channel decodes (decode kernel at 8, 16 or 30 taps; channel c+1 starts
where channel c ends) -> one pcm kernel launch (unmix, shift-byte
re-insert, escape select, tail mask) writing the element's channels of
the call's (B, C, S) output; the next element starts where this one
ends.  This is the decode's one program: alacjax's cursor+stacked
two-pass (ALACJAX_DECODE_STACKED=1) has no counterpart here: it never
beat the chained decode, on the TPU or on the H100.
``stop_at`` cuts the encode and the decode at alacjax's profiling
points (encode "mix", "search", "rice", "assemble"; decode "params",
"scan", "nounesc").

Each ``lax.cond`` of the reference is a Python ``if`` on a flag read
back from the device, one readback for all of the flags known at the
same point: the encode's after the search (every lane escaped; per
element, any lane escaped), the decode's after each element's parse
(every lane and any lane escaped, with the counts of escaped lanes and
of lanes whose header carries a sample count), through
``utils.metrics.readback``; each stage of the encode, the decode and
the host API sits in a ``utils.metrics.span``, and the decode records
its lanes and those counts with ``utils.metrics.count`` (README,
"Tracing").  Tensors live on the
codec's device; the kernel wrappers launch CUDA kernels for CUDA
tensors and run the plain torch versions for CPU tensors.  The encoder's
word images travel as int32 bit patterns (empty keys -1).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .oracle import ALACDecoder as OracleDecoder
from .oracle.encoder import (
    DEFAULT_MIX_BITS, FAST_MIX_RES, FAST_ORDER, MAX_RES, MIXRES_DILATE,
    PB_FACTOR, SEARCH_ORDERS, SEARCH_STAGES, bytes_shifted_for_depth,
)
from .types import (
    DENSHIFT_DEFAULT, MAX_DATATYPE_BITS_16, MAX_PREFIX_16, MAX_PREFIX_32,
    AlacConfig, AlacParamError, kALACMaxCoefs,
)

from .kernels import assemble as k_assemble
from .kernels import cost as k_cost
from .kernels import decode as k_decode
from .kernels import emit as k_emit
from .kernels import merge as k_merge
from .kernels import parse as k_parse
from .kernels import pcm as k_pcm
from .kernels import predict as k_predict
from .kernels import search as k_search
from .ops import bitpack, fused_decode, matrix, rice
from .ops import assemble as plain_assemble
from .ops import parse as plain_parse
from .ops.tutils import I32, I64, as_i32_bits, u32
from .state import init_coefs_batched
from .utils.metrics import count, readback, span

DEFAULT_CHUNK = 256


DECODE_DEPTHS = (16, 20, 24, 32)


def check_encode_config(config: AlacConfig) -> None:
    """Raise unless the port's encoder covers this configuration: every
    layout, depth 16/20/24/32 and search mode (persistent coefficient
    banks take the standard and fast searches: ``_check_banks``)."""
    check_decode_config(config)


def _check_banks(banks, config: AlacConfig, B: int) -> None:
    """Raise unless ``banks`` holds a (B, 16) int32 bank of every searched
    order for every channel, and the search is not exhaustive."""
    if config.search == "exhaustive" and not config.fast_mode:
        raise AlacParamError(
            "exhaustive device search is independent-frames only "
            "(persistent-bank stream encode uses the standard search; "
            "the stateful host encoders cover exhaustive+banks)")
    orders = [FAST_ORDER] if config.fast_mode else list(SEARCH_ORDERS)
    for ch in range(config.num_channels):
        for od in orders:
            bank = banks.get(ch, {}).get(od)
            if not isinstance(bank, torch.Tensor) or bank.dtype != I32 \
                    or tuple(bank.shape) != (B, kALACMaxCoefs):
                raise AlacParamError(
                    f"banks[{ch}][{od}] must be a ({B}, {kALACMaxCoefs}) "
                    f"int32 tensor")


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
def _rice_params_static(config: AlacConfig):
    pb = (config.pb * PB_FACTOR) // 4
    return config.mb, pb, config.kb, (1 << config.kb) - 1


def _lane_chanbits(chanbits_list, B: int, device):
    """The chanbits of streams stacked B lanes each: one int when they
    all agree, else a per-lane int32 vector (SCE and CPE channels differ
    by one bit)."""
    if len(set(chanbits_list)) == 1:
        return chanbits_list[0]
    return torch.cat([torch.full((B,), cb, dtype=I32, device=device)
                      for cb in chanbits_list])


def _tile_lanes(nums, n: int):
    """Per-lane sample counts of n stacked copies of the batch (int32),
    or None for full frames."""
    return None if nums is None else nums.to(I32).repeat(n).contiguous()


def _price(xs, c0s, orders, chanbits, num, config, dual: bool,
           predict_legacy: bool):
    """Residuals, Rice costs and adapted coefficients of stacked streams
    at each static order of ``orders``: (res (n, L, S), cost1 (n, L),
    cost2 (n, L) or None, coefs (n, L, 16)), one row per order.  ``c0s``
    is (L, 16), every order's starting coefficients, or (n, L, 16), one
    block per order (persistent banks).  The default route is ONE launch
    of the fused cost kernel for every order.  ``predict_legacy`` is the
    standalone-predictor route (alacjax/ops/predict.py:328-332 and
    :375-381): one predictor launch for every order, then one Rice cost
    launch over every order's residuals stacked as (n L, S), which
    prices, for stage 2, their first difference too; the cost kernel is
    not launched."""
    mb0, pb, kb, wb = _rice_params_static(config)
    if predict_legacy:
        res, coefs = k_predict.pc_block(xs, c0s, tuple(orders), chanbits,
                                        DENSHIFT_DEFAULT)
        n, L, S = res.shape
        cb = (chanbits if isinstance(chanbits, int)
              else chanbits.repeat(n).contiguous())
        cost = k_predict.rice_cost(res.reshape(n * L, S), cb, mb0, pb, kb,
                                   wb, num=None if num is None
                                   else _tile_lanes(num, n), dual=dual)
        if dual:
            return res, cost[0].reshape(n, L), cost[1].reshape(n, L), coefs
        return res, cost.reshape(n, L), None, coefs
    res, c1, c2, coefs = k_cost.pc_block_cost2(
        xs, c0s, orders, chanbits, DENSHIFT_DEFAULT, mb0, pb, kb, wb,
        dual=dual, num=num)
    return res, c1, c2 if dual else None, coefs


def _mixres_select(cpe_pairs, chanbits: int, config, nums=None,
                   predict_legacy: bool = False):
    """Stereo mode of every CPE in one stacked dilated trial: 7 candidate
    streams per CPE (L, R, U1..U4, the shared V; one mix launch for every
    CPE), priced at order 8 with fresh coefs over ceil(num /
    MIXRES_DILATE) samples per lane; per element, argmin of the summed
    cost (first minimum wins).  Returns a list of (B,) mixres
    selections."""
    B = cpe_pairs[0][0].shape[0]
    dev = cpe_pairs[0][0].device
    n_cand = (MAX_RES + 1) + 2
    st = k_search.mix_trial([l for l, _ in cpe_pairs],
                            [r for _, r in cpe_pairs], DEFAULT_MIX_BITS,
                            MAX_RES, MIXRES_DILATE)
    nd = (None if nums is None
          else _tile_lanes((nums + MIXRES_DILATE - 1) // MIXRES_DILATE,
                           n_cand * len(cpe_pairs)))
    with span("encode.mixres_trial"):
        _, c, _, _ = _price(st, init_coefs_batched(st.shape[0], dev),
                            (FAST_ORDER,), chanbits, nd, config, False,
                            predict_legacy)
    ce = c[0].to(I64).reshape(len(cpe_pairs), n_cand, B)
    return [torch.argmin(torch.stack(
        [ce[e, 0] + ce[e, 1]]
        + [ce[e, 1 + mr] + ce[e, n_cand - 1] for mr in range(1, MAX_RES + 1)]),
        dim=0) for e in range(len(cpe_pairs))]


def _stack_streams(groups, B: int, S: int, dev):
    """The search's stacked (W B, S) int32 input: per group, an element
    and its mixres (an int or a per-lane (B,) tensor; None for an SCE),
    the CPE's mixed pair (U, V) or the SCE's channel, B rows a stream;
    every CPE's pair written by one mix launch.  Returns (the stack, the
    first stream of each group)."""
    W = sum(2 if e["is_cpe"] else 1 for e, _ in groups)
    xs = torch.empty((W * B, S), dtype=I32, device=dev)
    firsts, ls, rs, mrs, rows = [], [], [], [], []
    w = 0
    for e, mr in groups:
        firsts.append(w)
        if e["is_cpe"]:
            ls.append(e["his"][0])
            rs.append(e["his"][1])
            mrs.append(mr)
            rows.append(w * B)
            w += 2
        else:
            xs[w * B:(w + 1) * B].copy_(e["his"][0])
            w += 1
    if ls:
        k_search.mix_streams(ls, rs, mrs, DEFAULT_MIX_BITS, out=xs, rows=rows)
    return xs, firsts


def _search_channels(xs, chanbits_list, config, nums=None,
                     predict_legacy: bool = False, banks=None):
    """Per-channel (order x stage) candidate search over the stacked
    streams ``xs`` ((W B, S), one stream per entry of ``chanbits_list``):
    one pricing call for every order, per-lane chanbits when SCE and CPE
    channels mix, then one pick launch for every lane.  Candidates
    (4,1),(4,2),(8,1),(8,2), first minimum wins; fast mode prices order
    8, stage 1 only.  Every order starts from the fresh coefficients or,
    with ``banks`` (one {order: (B, 16)} dict per stream), from its own
    bank.  Returns per-stream lists (res, order, mode, rice_bits,
    coefs0_win — the winning order's starting coefficients — and
    {order: adapted coefs})."""
    W = len(chanbits_list)
    B = xs.shape[0] // W
    dev = xs.device
    fast = config.fast_mode
    orders = [FAST_ORDER] if fast else list(SEARCH_ORDERS)
    stages = [1] if fast else list(SEARCH_STAGES)
    if banks is None:
        c0s = init_coefs_batched(W * B, dev)
    else:
        # one block per order, every stream's bank in stream order
        with span("encode.banks"):
            c0s = torch.stack([banks[ci][od] for od in orders
                               for ci in range(W)]).view(len(orders), W * B,
                                                         kALACMaxCoefs)
    cb_all = _lane_chanbits(chanbits_list, B, dev)
    num_all = _tile_lanes(nums, W)
    with span("encode.predict_cost"):
        res_o, c1_o, c2_o, coefs_o = _price(
            xs, c0s, tuple(orders), cb_all, num_all, config,
            len(stages) > 1, predict_legacy)
    res, sel = k_search.pick(res_o, c1_o, c2_o, orders, cb_all)
    c0_all = c0s
    if banks is not None:
        # the winning order's starting coefficients, lane by lane
        with span("encode.banks"):
            c0_all = c0s[0]
            for i, od in enumerate(orders[1:], 1):
                c0_all = torch.where((sel[0] == od)[:, None], c0s[i], c0_all)
    res_l, order_l, mode_l, rice_l, c0_l, adapted_l = [], [], [], [], [], []
    for ci in range(W):
        sl = slice(ci * B, (ci + 1) * B)
        res_l.append(res[sl])
        order_l.append(sel[0, sl])
        mode_l.append(sel[1, sl])
        rice_l.append(sel[2, sl])
        c0_l.append(c0_all[sl])
        adapted_l.append({od: coefs_o[i][sl] for i, od in enumerate(orders)})
    return res_l, order_l, mode_l, rice_l, c0_l, adapted_l


def _select_standard(elems, config, nums, predict_legacy: bool,
                     banks=None, mix_only: bool = False) -> None:
    """Stereo mode of every CPE (the dilated trial, or fast mode's
    constant; both with fresh coefficients), the mixed streams of every
    element (``e["streams"]``, row views of the search's stacked input;
    ``mix_only`` stops there), then one search over every channel of
    every element, each channel's orders starting from its banks when
    ``banks`` is given."""
    B, S = elems[0]["chans"][0].shape
    dev = elems[0]["chans"][0].device
    cpes = [e for e in elems if e["is_cpe"]]
    if config.fast_mode:
        for e in cpes:
            e["mixres"] = torch.full((B,), FAST_MIX_RES, dtype=I64,
                                     device=dev)
    elif cpes:
        sels = _mixres_select([(e["his"][0], e["his"][1]) for e in cpes],
                              cpes[0]["chanbits"], config, nums,
                              predict_legacy)
        for e, sel in zip(cpes, sels):
            e["mixres"] = sel
    xs, firsts = _stack_streams(
        [(e, (FAST_MIX_RES if config.fast_mode else e["mixres"])
          if e["is_cpe"] else None) for e in elems], B, S, dev)
    cbs = []
    for e, w in zip(elems, firsts):
        if not e["is_cpe"]:
            e["mixres"] = torch.zeros((B,), dtype=I64, device=dev)
        e["streams"] = [xs[(w + i) * B:(w + i + 1) * B]
                        for i in range(e["width"])]
        cbs += [e["chanbits"]] * e["width"]
    if mix_only:
        return
    stream_banks = None if banks is None else [
        banks[e["ch0"] + i] for e in elems for i in range(e["width"])]
    res, orders, modes, rice_bits, c0_win, adapted = _search_channels(
        xs, cbs, config, nums, predict_legacy, stream_banks)
    ci = 0
    for e in elems:
        sl = slice(ci, ci + e["width"])
        ci += e["width"]
        e.update(res=res[sl], orders=orders[sl], modes=modes[sl],
                 rice_bits=rice_bits[sl], coefs0_win=c0_win[sl],
                 adapted=adapted[sl])


def _select_exhaustive(elems, config, nums, predict_legacy: bool) -> None:
    """Every (mixres x order x stage) candidate of every channel in one
    stacked search (10 streams per CPE, written by one mix launch at a
    constant mixres each; no dilated trial); per CPE, the mixres whose
    two channels cost least in total (first minimum wins)."""
    B, S = elems[0]["chans"][0].shape
    dev = elems[0]["chans"][0].device
    groups, cbs = [], []
    for e in elems:
        for mr in range(MAX_RES + 1 if e["is_cpe"] else 1):
            groups.append((e, mr if e["is_cpe"] else None))
            cbs += [e["chanbits"]] * e["width"]
    xs, firsts = _stack_streams(groups, B, S, dev)
    res, orders, modes, rice_bits, c0_win, _ = _search_channels(
        xs, cbs, config, nums, predict_legacy)
    for e in elems:
        slots = [s for (g, _), s in zip(groups, firsts) if g is e]
        w = e["width"]
        # fresh coefficients on every slot: any slot's rows will do
        e["coefs0_win"] = c0_win[slots[0]:slots[0] + w]
        if not e["is_cpe"]:
            s = slots[0]
            e.update(mixres=torch.zeros((B,), dtype=I64, device=dev),
                     res=[res[s]], orders=[orders[s]], modes=[modes[s]],
                     rice_bits=[rice_bits[s]])
            continue
        tot = torch.stack([sum(16 + 16 * orders[s + c] + rice_bits[s + c]
                               for c in range(w)) for s in slots], dim=0)
        mr_win = torch.argmin(tot, dim=0)

        def pick(by_mr, mr_win=mr_win):
            out = by_mr[0]
            for m in range(1, MAX_RES + 1):
                hit = mr_win == m
                out = torch.where(hit[:, None] if out.ndim == 2 else hit,
                                  by_mr[m], out)
            return out

        e["mixres"] = mr_win
        for key, vals in (("res", res), ("orders", orders), ("modes", modes),
                          ("rice_bits", rice_bits)):
            e[key] = [pick([vals[s + c] for s in slots]) for c in range(w)]


ENCODE_CUTS = ("mix", "search", "rice", "assemble")   # _encode_packet_chunks


def _encode_packet_chunks(pcm, config: AlacConfig, num_words: int,
                          nums=None, predict_legacy: bool = False,
                          banks=None, stop_at: str | None = None):
    """(B, C, S) int32 planar -> ((B, W) int32 word image, (B,) int32
    total bits, new banks): the general branch of alacjax's
    _encode_packet_chunks.

    ``banks`` (None: independent frames, fresh coefficients, new banks
    None): {channel: {order: (B, 16) int32}} persistent coefficient
    banks, each order's search starting from its own; the new banks
    follow the oracle's commit rule (the winning order's bank takes its
    adapted coefficients unless the element escaped; every other bank
    stays).  The standard and fast searches only.

    ``nums`` (per-lane (B,), 1 <= nums <= S; samples past it zero):
    lanes with nums < S encode as partial frames — the header's partial
    flag and a 32-bit numSamples field, per-lane sized shift and escape
    blocks, cost and emission machines stopped at nums.
    ``predict_legacy`` prices the trial and the search through the
    standalone predictor kernel and the Rice cost kernel instead of the
    fused cost kernel: the same packets.

    ``stop_at`` cuts the program for profiling, returning what alacjax's
    _encode_packet_chunks returns at the same cut: "mix" each element's
    mixed streams (a list per element; the exhaustive search has no
    such point and runs on, as in alacjax); "search" (each element's
    winning residual streams, the total bits before the END tag);
    "rice" (the stacked Rice emission's chunk words, keys, tail values
    and tail keys, the same total); "assemble" (every element's chunk
    words and keys, the tail values and keys with the END tag's, the
    total bits), all before the merge."""
    check_encode_config(config)
    if stop_at is not None and stop_at not in ENCODE_CUTS:
        raise ValueError(f"stop_at must be one of {ENCODE_CUTS}, got "
                         f"{stop_at!r}")
    B = pcm.shape[0]
    if banks is not None:
        _check_banks(banks, config, B)
    dev = pcm.device
    S = config.frame_length
    depth = config.bit_depth
    bs = bytes_shifted_for_depth(depth)
    mb0, pb, kb, wb = _rice_params_static(config)
    if nums is not None:
        nums = nums.to(I64)
        pbits = torch.where(nums < S, 32, 0)

    # ---- per-element prep: instance counters, shift-off low bytes ----
    elems = []
    ch = 0
    tag_counters = {}
    with span("encode.prep"):
        for tag, width in config.elements:
            instance = tag_counters.get(int(tag), 0)
            tag_counters[int(tag)] = instance + 1
            is_cpe = width == 2
            chans = [pcm[:, ch + i, :].to(I32) for i in range(width)]
            ch += width
            split = [matrix.shift_off(c, bs) for c in chans]
            elems.append(dict(
                tag=tag, instance=instance, width=width, is_cpe=is_cpe,
                chanbits=depth - 8 * bs + (1 if is_cpe else 0), chans=chans,
                his=[h for h, _ in split], los=[lo for _, lo in split],
                ch0=ch - width))

    # ---- stereo modes and the channel search ----
    with span("encode.search"):
        if config.search == "exhaustive" and not config.fast_mode:
            _select_exhaustive(elems, config, nums, predict_legacy)
        else:
            _select_standard(elems, config, nums, predict_legacy, banks,
                             mix_only=stop_at == "mix")
            if stop_at == "mix":
                return [e["streams"] for e in elems]

    # ---- per-element header / escape sizing; chained element starts ----
    with span("encode.sizing"):
        n_lane = S if nums is None else nums
        start = torch.zeros((B,), dtype=I64, device=dev)
        for e in elems:
            width = e["width"]
            # +16: mixBits/mixRes are present in every non-escape element
            # (mono writes 0, 0); a partial lane's 32-bit numSamples field
            # sits in both forms
            hdr_bits = 23 + 16 + width * 16 + 16 * sum(e["orders"])
            esc_bits = 23 + width * depth * n_lane
            if nums is not None:
                hdr_bits = hdr_bits + pbits
                esc_bits = esc_bits + pbits
            shift_bits = width * 8 * bs * n_lane
            comp_bits = hdr_bits + shift_bits + sum(e["rice_bits"])
            e["use_escape"] = comp_bits >= esc_bits
            e["start"] = start
            e["rice_start"] = start + hdr_bits + shift_bits
            start = start + torch.where(e["use_escape"], esc_bits, comp_bits)
        total_c = start

        new_banks = None
        if banks is not None:
            # the oracle's commit rule: the winning order's bank takes the
            # adapted coefficients unless the element escaped
            with span("encode.banks"):
                new_banks = dict(banks)
                for e in elems:
                    for ci in range(e["width"]):
                        chan = e["ch0"] + ci
                        # 0, an order no bank has, where the element escaped
                        won = torch.where(e["use_escape"], 0,
                                          e["orders"][ci])[:, None]
                        new_banks[chan] = {
                            od: torch.where(won == od, coefs, banks[chan][od])
                            for od, coefs in e["adapted"][ci].items()}
    if stop_at == "search":
        return [e["res"] for e in elems], total_c

    # one readback: every lane of every element escaped, then per element
    # whether any lane escaped
    ue = torch.stack([e["use_escape"] for e in elems])
    flags = readback(torch.cat([ue.all().reshape(1), ue.any(dim=1)]),
                     "encode.flags")
    any_comp = not flags[0]
    for e, f in zip(elems, flags[1:]):
        e["any_escape"] = f

    # ---- one stacked Rice emission over every channel ----
    emitted = None
    cbs = [e["chanbits"] for e in elems for _ in range(e["width"])]
    with span("encode.rice_words"):
        if any_comp:
            feed, starts = [], []
            for e in elems:
                pos = e["rice_start"]
                for ci in range(e["width"]):
                    feed.append(e["res"][ci])
                    starts.append(pos)
                    pos = pos + e["rice_bits"][ci]
            emitted = k_emit.rice_encode_words(
                torch.cat(feed, dim=0), _lane_chanbits(cbs, B, dev), mb0, pb,
                kb, wb, torch.cat(starts, dim=0).to(I32),
                bit_size_cap=max(cbs), num=_tile_lanes(nums, len(feed)))
        elif stop_at in ("rice", "assemble"):
            # alacjax's skip_rice: empty chunks where every lane escaped
            emitted = _skipped_emission(len(cbs) * B, S, max(cbs), dev)
    if stop_at == "rice":
        cw, ck, _, ctv, ctk = emitted
        return cw, ck, ctv, ctk, total_c

    with span("encode.assemble"):
        if stop_at == "assemble":
            # the profiling cut reads the plain version on any device
            vals, keys, tv, tk = plain_assemble.mixed_chunks(
                elems, emitted, config, nums, pad_to_escape=True)
            end_tv, end_tk = plain_assemble.end_tails(total_c)
            return (vals, keys, tv + end_tv, tk + end_tk,
                    (total_c + 3).to(I32))
        if any_comp or nums is not None:
            # one assemble launch (the escape chunks alone where every
            # lane escaped), then the merge
            vals, keys, tv, tk, total_bits = k_assemble.chunks(
                elems, emitted, total_c, config, nums)
            words = k_merge.merge_sorted_chunks(vals, keys, tv, tk,
                                                num_words)
        else:
            total_bits = (total_c + 3).to(I32)
            words = _assemble_all_escape(elems, config, num_words)
    return words, total_bits, new_banks


def _skipped_emission(L: int, S: int, cap: int, device):
    """rice_encode_words's outputs where no stream is emitted: zero
    words, empty (-1) keys and tails."""
    words = torch.zeros((L, rice.emit_slots(cap) * (S + 1)), dtype=I32,
                        device=device)
    lane = torch.zeros((L,), dtype=I32, device=device)
    return words, words - 1, lane, lane, lane - 1


def _assemble_all_escape(elems, config, num_words: int):
    """Every lane of every element escaped, full frames: each element's
    packed raw image at its static bit offset, no chunk merge (with
    partial lanes the escape chunks take the assemble kernel and the
    merge)."""
    S = config.frame_length
    depth = config.bit_depth
    B = elems[0]["start"].shape[0]
    dev = elems[0]["start"].device
    row = np.zeros((num_words,), np.uint64)

    def or_static(val, nbits, pos):
        w, ph = pos >> 5, pos & 31
        v64 = (val & ((1 << nbits) - 1)) << (64 - ph - nbits)
        if w < num_words:
            row[w] |= v64 >> 32
        if ph + nbits > 32 and w + 1 < num_words:
            row[w + 1] |= v64 & 0xFFFFFFFF

    out = torch.zeros((B, num_words), dtype=I64, device=dev)
    pos = 0
    for e in elems:
        or_static(plain_assemble.header23(e["tag"], e["instance"], 0, True),
                  23, pos)
        raw, _ = plain_assemble.masked_block(e, "chans", None)
        p0 = pos + 23
        placed = u32(bitpack.place_segment(
            bitpack.pack_fields(raw, depth),
            torch.full((B,), p0 & 31, dtype=I64, device=dev)))
        w0 = p0 >> 5
        Wp = min(placed.shape[1], num_words - w0)
        out[:, w0:w0 + Wp] |= placed[:, :Wp]
        pos = p0 + e["width"] * depth * S
    or_static(0b111, 3, pos)
    with span("encode.row.sync"):     # a pageable copy to the card
        row_dev = torch.from_numpy(row.astype(np.int64)).to(dev)
    out = out | row_dev[None, :]
    return as_i32_bits(out)


def encode_frames_device(pcm, config: AlacConfig, num_words: int, nums=None,
                         predict_legacy: bool = False):
    """(B, C, S) planar int32 tensor (+ optional (B,) per-lane sample
    counts) -> ((B, W) int32 word image, (B,) int32 total bits)."""
    with span("encode"):
        words, bits, _ = _encode_packet_chunks(
            pcm, config, num_words, nums=nums, predict_legacy=predict_legacy)
    return words, bits


def encode_stream_device(pcm, config: AlacConfig, num_words: int,
                         banks=None, fresh=None,
                         predict_legacy: bool = False):
    """Persistent-coefficient stream encode (alacjax.codec.
    encode_stream_device; reference: ALACEncoder.cpp's mCoefsU/V, kept
    across the Encode() calls of one file): (B, N, C, S) planar int32,
    N full frames of each of B lanes -> ((B, N, W) int32 word images,
    (B, N) int32 total bits, the banks after packet N-1).  A loop over
    the N packets carries the banks as device tensors, so the packets of
    a lane chain exactly as the stateful encoders' do while the lanes
    stay data-parallel.

    ``banks`` ({channel: {order: (B, 16) int32}}, as returned; None:
    fresh for every lane) resumes the lanes where an earlier call left
    them.  ``fresh`` ((B, N) bool on the device) starts a new track: where
    ``fresh[:, t]`` is set, that lane's banks of every channel and order
    are the fresh coefficients before packet t.  Neither the carry nor
    the reset waits for the card."""
    B, N = pcm.shape[:2]
    dev = pcm.device
    orders = [FAST_ORDER] if config.fast_mode else list(SEARCH_ORDERS)
    init0 = init_coefs_batched(1, dev)
    if banks is None:
        banks = {ch: {od: init0.expand(B, -1) for od in orders}
                 for ch in range(config.num_channels)}
    _check_banks(banks, config, B)
    if fresh is not None and (fresh.dtype != torch.bool
                              or tuple(fresh.shape) != (B, N)
                              or fresh.device != dev):
        raise AlacParamError(f"fresh must be a ({B}, {N}) bool tensor on "
                             f"{dev}")
    words, bits = [], []
    with span("encode.stream"):
        for t in range(N):
            if fresh is not None:
                with span("encode.banks"):
                    reset = fresh[:, t, None]
                    banks = {ch: {od: torch.where(reset, init0, bank)
                                  for od, bank in by.items()}
                             for ch, by in banks.items()}
            with span("encode"):
                w, b, banks = _encode_packet_chunks(
                    pcm[:, t].contiguous(), config, num_words,
                    predict_legacy=predict_legacy, banks=banks)
            words.append(w)
            bits.append(b)
        return torch.stack(words, dim=1), torch.stack(bits, dim=1), banks


def encode_streams(pcm: np.ndarray, config: AlacConfig,
                   device="cuda") -> list[list[bytes]]:
    """Host API: (B, N, C, S) planar streams -> per-stream packet lists,
    byte-identical to the stateful ALACEncoder(config) on each stream.
    Runs on the card unless ``device`` says otherwise; without a card
    the default raises."""
    check_encode_config(config)
    dev = _resolve_device(device, "encode_streams")
    pcm = np.asarray(pcm)
    want = (config.num_channels, config.frame_length)
    if pcm.ndim != 4 or pcm.shape[2:] != want:
        raise AlacParamError(f"encode_streams takes (B, N, {want[0]}, "
                             f"{want[1]}) PCM, not {pcm.shape}")
    x = torch.from_numpy(pcm.astype(np.int32)).to(dev)
    words, bits, _ = encode_stream_device(x, config, _num_words(config))
    words, bits = words.cpu().numpy(), bits.cpu().numpy()
    return [bitpack.words_to_bytes(words[b], bits[b])
            for b in range(words.shape[0])]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
DECODE_CUTS = ("params", "scan", "nounesc")   # decode_frames_device stop_at


def _element_pcm(pcm, c0: int, words_i32, p, recon, width: int,
                 config: AlacConfig, S: int, unescape: bool) -> None:
    """One element's channels ``c0 ..`` of the call's (B, C, S) ``pcm``
    from its reconstructed streams ``recon`` (None for an element whose
    every lane escaped) through the pcm kernel: unmix (CPE), shift-byte
    re-insert, the escape select (with ``unescape``) and the tail mask."""
    depth = config.bit_depth
    with span("decode.pcm"):
        k_pcm.element_pcm(
            words_i32, S, width, bytes_shifted_for_depth(depth), depth,
            p.num, p.pos_shift, p.pos_esc, p.esc, *(recon or ()),
            mixbits=p.mixbits, mixres=p.mixres, unescape=unescape, out=pcm,
            c0=c0)


def decode_frames_device(words, config: AlacConfig, num_samples: int,
                         taps: int = fused_decode.TAPS,
                         stop_at: str | None = None):
    """(B, W) int32 word image -> ((B, C, S) int32 pcm, (B,) bool err,
    (B,) int32 num): alacjax.codec.decode_frames_device, every layout and
    depth.  ``taps`` (8, 16 or 30) is the width of the channel scans'
    FIR walk; lanes with a higher order flag err.

    Per element: one parse launch, one ``decode.flags`` readback (its
    flags and the counts ``decode.escaped`` and ``decode.sized``; the
    call's ``decode.lanes`` besides: ``utils.metrics.count``), the
    chained channel decodes (channel c + 1 starts where channel c ends;
    none when every lane escaped), one pcm launch (unmix, shift bytes,
    escape select and tail mask), then the next element starts where
    this one ends.

    ``stop_at`` cuts the program for profiling (alacjax's cuts):
    "params" returns (the first element's per-channel (mode, den, pbf,
    order, coefs), (Rice start bits, err)) after its parse; "scan" (its
    channels' reconstructed streams, (end bits, err)) after its channel
    decodes; "nounesc" the whole decode without the escape samples."""
    with span("decode"):
        count("decode.lanes", words.shape[0])
        return _decode_frames(words, config, num_samples, taps, stop_at)


def _decode_frames(words, config: AlacConfig, num_samples: int, taps: int,
                   stop_at: str | None):
    """decode_frames_device's program, inside its ``decode`` span."""
    if stop_at is not None and stop_at not in DECODE_CUTS:
        raise ValueError(f"stop_at must be one of {DECODE_CUTS}, got "
                         f"{stop_at!r}")
    B = words.shape[0]
    dev = words.device
    S = num_samples
    depth = config.bit_depth
    kb = config.kb
    wb = (1 << kb) - 1
    bs = bytes_shifted_for_depth(depth)
    # the parse accepts orders up to the walk's width, never below 16
    max_ord = max(kALACMaxCoefs, taps)
    n_total = sum(width for _, width in config.elements)
    words_i32 = words.to(I32).contiguous()
    # per-lane int32 start bits (None: the first element's, bit 0), error
    # flags and frame lengths, each set from the first element's parse on
    bitpos = err = num = None
    pcm = torch.empty((B, n_total, S), dtype=I32, device=dev)
    unescape = stop_at != "nounesc"
    c0 = 0
    for tag, width in config.elements:
        if stop_at == "params":
            # alacjax's cut reads the fields the decode does not keep
            # (pbf, an escape lane's order): the plain parse's
            return plain_parse.params_cut(words_i32, tag, width, config, S,
                                          max_ord)
        with span("decode.parse"):
            p = k_parse.parse_element(words_i32, bitpos, num, tag, width,
                                      config, S, max_ord)
            esc, num = p.esc, p.num
            err = p.err if err is None else err | p.err
        chanbits = depth - 8 * bs + (1 if width == 2 else 0)
        bitpos = p.rice
        # one readback per element: a lane coded, a lane escaped, and the
        # lanes escaped and sized (a sample count in the header)
        coded, escaped, n_esc, n_sized = readback(p.readout, "decode.flags")
        count("decode.escaped", n_esc)
        count("decode.sized", n_sized)
        with span("decode.scan"):
            recon = None
            if coded:
                # chained channel scans: channel c+1 starts where channel
                # c ends
                recon = []
                for ci in range(width):
                    pb, coefs, mode, order, den = p.args(ci)
                    samples, bitpos_n, rerr = k_decode.decode_channel(
                        words_i32, bitpos, S, chanbits, config.mb, pb, kb,
                        wb, coefs, mode, order, den, num=num, taps=taps)
                    bitpos = torch.where(esc, bitpos, bitpos_n)
                    err = err | (~esc & rerr)
                    recon.append(samples)
        if stop_at == "scan":
            if recon is None:
                recon = [torch.zeros((B, S), dtype=I32, device=dev)] * width
            return recon, (bitpos, err)
        _element_pcm(pcm, c0, words_i32, p, recon, width, config, S,
                     unescape and bool(escaped))
        c0 += width
        bitpos = torch.where(esc, p.pos_esc + width * depth * num, bitpos)
    return pcm, err, num


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------
def _resolve_device(device, who: str) -> torch.device:
    """``device`` as a torch.device; raise for a CUDA device without a
    card: the codec never moves to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device {str(dev)!r} requested, but no CUDA device is "
            "available (torch.cuda.is_available() is false); pass "
            "device=\"cpu\" to run the plain torch versions")
    return dev


def _num_words(config: AlacConfig) -> int:
    """Words of a packet's device image: the largest (escape) packet,
    plus two words of slack."""
    return (config.max_escape_packet_bytes(config.frame_length) + 3) // 4 + 2


def _max_packet_bytes(config: AlacConfig) -> int:
    """The longest legal packet of ``config`` without DSE or FIL elements.
    Per element: its tag, instance, unused bits, flags, 32-bit sample
    count and mix fields; per channel: mode/denshift/pb/order and 31
    coefficients; per sample and channel at most 16 shifted-out bits, one
    value code (9 prefix bits and the larger of chanbits and kb) and one
    zero-run code (9 prefix bits and 16); then the END tag."""
    S, C = config.frame_length, config.num_channels
    value = MAX_PREFIX_32 + max(config.bit_depth + 1, config.kb)
    run = MAX_PREFIX_16 + MAX_DATATYPE_BITS_16
    bits = (len(config.elements) * (3 + 4 + 12 + 4 + 32 + 16)
            + C * (16 + 16 * 31 + S * (16 + value + run)) + 3)
    return (bits + 7) // 8


def packet_image_words(config: AlacConfig, packets: list[bytes]
                       ) -> tuple[int, np.ndarray]:
    """The word width of a chunk's device image, and the mask of packets
    longer than any legal one (``_max_packet_bytes``).  The width is the
    escape packet's (``_num_words``), widened to the chunk's longest legal
    packet: a legal packet may be longer than the escape packet (a weak
    predictor forced on noise).  Masked packets are left out of the
    image; the caller decodes them elsewhere or refuses them."""
    lens = np.fromiter(map(len, packets), dtype=np.int64, count=len(packets))
    over = lens > _max_packet_bytes(config)
    longest = int(lens[~over].max(initial=0))
    return max(_num_words(config), -(-longest // 4) + 2), over


class TorchCodec:
    """Batched codec for one AlacConfig on one torch device: encode and
    decode whole chunks of frames per call.  The work runs on the card
    (``device="cuda"``, the default) through the CUDA kernels; a caller
    that wants the plain torch versions on the host passes
    ``device="cpu"``.  Without a card the default raises: the codec never
    moves to the CPU by itself.  ``predict_legacy`` runs the encoder's
    trial and search through the standalone predictor kernel and the
    Rice cost kernel instead of the fused cost kernel (alacjax's
    ALACJAX_PALLAS_PREDICT_LEGACY=1): the same packets."""

    def __init__(self, config: AlacConfig, chunk: int = DEFAULT_CHUNK,
                 device="cuda", predict_legacy: bool = False):
        check_encode_config(config)
        self.device = _resolve_device(device, type(self).__name__)
        self.config = config
        self.chunk = chunk
        self.predict_legacy = predict_legacy
        self.num_words = _num_words(config)
        self.fallback_frames = 0   # frames the device flagged -> oracle

    def _encode(self, pcm, nums=None):
        """(B, C, S) int32 device tensor (+ (B,) int32 sample counts) ->
        (words, total_bits) tensors."""
        return encode_frames_device(pcm, self.config, self.num_words,
                                    nums=nums,
                                    predict_legacy=self.predict_legacy)

    def _decode(self, words, taps: int = fused_decode.TAPS):
        """(B, W) int32 device tensor -> (pcm, err, num) tensors."""
        return decode_frames_device(words, self.config,
                                    self.config.frame_length, taps=taps)

    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """(nf, C, S) planar int -> list of nf packets (full frames)."""
        return self._encode_host(pcm, None)

    def encode_frames_ex(self, pcm: np.ndarray,
                         nums: np.ndarray) -> list[bytes]:
        """(nf, C, S) planar int + (nf,) per-frame sample counts -> list
        of nf packets.  Frames with nums < S encode as partial (tail)
        frames, batched with full frames; their samples at index >= nums
        must be zero (callers pad)."""
        return self._encode_host(pcm, np.asarray(nums, dtype=np.int32))

    def _to_device(self, block, rows: int, fill: int = 0):
        """A host array -> an int32 tensor of ``rows`` leading rows on the
        codec's device, rows past the array's set to ``fill``.  On the
        card the rows are staged in pinned memory and copied with
        non_blocking=True, so the host goes on while the copy waits for
        the work queued before it."""
        n = block.shape[0]
        pinned = self.device.type == "cuda"
        with span("api.copy_in"):
            host = torch.empty((rows,) + block.shape[1:], dtype=torch.int32,
                               pin_memory=pinned)
            h = host.numpy()
            np.copyto(h[:n], block, casting="unsafe")
            h[n:] = fill
            return host.to(self.device, non_blocking=True) if pinned else host

    def _to_host(self, *tensors):
        """Queue copies of device tensors to the host: on the card into
        pinned buffers with non_blocking=True and an event recorded after
        them, so they run right after the work that made them; on the CPU
        the tensors themselves.  ``_ready`` waits for them."""
        if self.device.type != "cuda":
            return tensors, None
        with span("api.copy_out"):
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in tensors)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            return host, event

    @staticmethod
    def _ready(host, event) -> list[np.ndarray]:
        """The numpy views of ``_to_host``'s buffers, once copied."""
        if event is not None:
            with span("api.ready.sync"):
                event.synchronize()
        return [t.numpy() for t in host]

    def _encode_host(self, pcm, nums):
        """Chunks of ``chunk`` frames through the device encode, one chunk
        of look-ahead as in alacjax's JaxCodec: chunk k+1's copy in, its
        device work and its copy out are queued before chunk k's words
        are serialized, so words_to_bytes runs while the card works.  A
        short last chunk is padded with silent full frames."""
        S = self.config.frame_length
        nf = pcm.shape[0]
        packets = []

        def serialize(copies):
            host = self._ready(*copies)
            with span("api.serdes"):
                packets.extend(bitpack.words_to_bytes(*host))

        with span("api.encode"):
            pending = None      # (host words and bits, event) of chunk k
            for off in range(0, nf, self.chunk):
                block = np.asarray(pcm[off:off + self.chunk])
                n = block.shape[0]
                x = self._to_device(block, self.chunk)
                if nums is None:
                    words, bits = self._encode(x)
                else:
                    words, bits = self._encode(
                        x, self._to_device(nums[off:off + n], self.chunk, S))
                cur = self._to_host(words[:n], bits[:n])
                if pending is not None:
                    serialize(pending)
                pending = cur
            if pending is not None:
                serialize(pending)
        return packets

    def decode_frames_ex(self, packets: list[bytes]
                         ) -> tuple[np.ndarray, np.ndarray]:
        """list of packets -> ((nf, C, S) planar int64, (nf,) sample
        counts).  A chunk holding a packet longer than the escape packet
        (legal, though no encoder writes one) gets a word image wide
        enough for it; a packet longer than any legal one
        (``packet_image_words``) skips the card and goes to the oracle.
        When many lanes of a chunk are flagged (the usual sign
        of a legal stream of order above 8), the chunk decodes again at
        16 and then 30 taps; lanes still flagged (frames outside the
        device grammar) decode on the scalar oracle.  Pipelined as
        alacjax's JaxCodec: chunk k+1's word images, copy in, device work
        and copy out are queued before chunk k's results are read back
        and checked (one chunk of look-ahead)."""
        cfg = self.config
        S = cfg.frame_length
        nf = len(packets)
        out = np.zeros((nf, cfg.num_channels, S), dtype=np.int64)
        nums = np.full((nf,), S, dtype=np.int64)

        def dispatch(off):
            blk = packets[off:off + self.chunk]
            n = len(blk)
            with span("api.serdes"):
                width, over = packet_image_words(cfg, blk)
                wh = bitpack.bytes_to_words(
                    [b"" if o else p for p, o in zip(blk, over)], width)
            wdev = self._to_device(wh.view(np.int32), self.chunk)
            pcm, err, num = self._decode(wdev)
            return off, n, blk, over, wdev, self._to_host(
                pcm[:n], err[:n], num[:n])

        with span("api.decode"):
            offs = list(range(0, nf, self.chunk))
            pending = dispatch(offs[0]) if offs else None
            for i in range(len(offs)):
                off, n, blk, over, wdev, copies = pending
                pending = (dispatch(offs[i + 1]) if i + 1 < len(offs)
                           else None)
                pcm, err, num = self._ready(*copies)
                with span("api.unpack"):
                    out[off:off + n] = pcm
                    nums[off:off + n] = num
                    err = err & ~over
                # the retry rule and threshold of alacjax's JaxCodec: a few
                # flagged lanes (corruption) go straight to the oracle;
                # chunk k's words are still on the card for the retry
                if err.any() and err.sum() * 4 >= n and n >= 64:
                    with span("api.ladder"):
                        self._ladder(wdev, off, n, err, out, nums)
                err |= over
                self.fallback_frames += int(err.sum())
                if err.any():
                    with span("api.oracle"):
                        dec = OracleDecoder(cfg)
                        for j in np.nonzero(err)[0]:
                            y, got = dec.decode_packet(blk[j])
                            out[off + j, :, :got] = y[:, :got]
                            out[off + j, :, got:] = 0
                            nums[off + j] = got
        return out, nums

    def _ladder(self, wdev, off: int, n: int, err, out, nums) -> None:
        """The retry ladder of one chunk: while at least a quarter of its
        ``n`` lanes are flagged, decode its words ``wdev`` again at the
        next rung's taps and store the lanes that rung fixes into ``out``
        and ``nums`` from row ``off``, clearing their ``err``."""
        def host(t):
            with span("api.ladder.sync"):
                return t.cpu().numpy()

        for retry_taps in fused_decode.LADDER_TAPS:
            if err.any() and err.sum() * 4 >= n:
                pcm_r, err_r, num_r = self._decode(wdev, taps=retry_taps)
                fixed = np.nonzero(err & ~host(err_r[:n]))[0]
                with span("api.ladder.sync"):
                    idx = torch.from_numpy(fixed).to(self.device)
                out[off + fixed] = host(pcm_r[idx])
                nums[off + fixed] = host(num_r[idx])
                err[fixed] = False

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """list of FULL-frame packets -> (nf, C, S) planar int64."""
        out, nums = self.decode_frames_ex(packets)
        if (nums != self.config.frame_length).any():
            raise AlacParamError("unexpected partial frame")
        return out


_CODEC_CACHE: dict[tuple, TorchCodec] = {}


def _lookup_devices(device, devices) -> tuple[torch.device, ...]:
    """The devices of a codec lookup (alacjax.codec._default_mesh and
    get_codec): ``devices`` None is every visible card for a "cuda"
    device without an index, bounded by ALACJAX_DEVICES (read here, at
    lookup), and ``device`` alone otherwise; an int is that many devices
    of ``device``'s type (cards from cuda:0, as many as there are;
    repeated entries for the CPU); a sequence is taken as it is."""
    dev = torch.device(device)
    if devices is None:
        if dev.type != "cuda" or dev.index is not None \
                or not torch.cuda.is_available():
            return (dev,)
        n = torch.cuda.device_count()
        env = os.environ.get("ALACJAX_DEVICES")
        if env is not None:
            n = max(1, min(n, int(env)))
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, int):
        if dev.type != "cuda" or not torch.cuda.is_available():
            return (dev,) * max(1, devices)
        n = max(1, min(devices, torch.cuda.device_count()))
        return tuple(torch.device("cuda", i) for i in range(n))
    return tuple(torch.device(d) for d in devices)


def get_codec(config: AlacConfig, chunk: int = DEFAULT_CHUNK,
              device="cuda", predict_legacy: bool = False,
              devices=None) -> TorchCodec:
    """Shared-cache codec lookup by (config, chunk, devices,
    predict_legacy).  ``devices`` (see _lookup_devices;
    None: every visible card, bounded by ALACJAX_DEVICES) of more than
    one entry give a ShardedCodec over them, one device the plain
    TorchCodec."""
    devs = _lookup_devices(device, devices)
    key = (config, chunk, tuple(map(str, devs)), predict_legacy)
    if key not in _CODEC_CACHE:
        if len(devs) == 1:
            _CODEC_CACHE[key] = TorchCodec(config, chunk, device=devs[0],
                                           predict_legacy=predict_legacy)
        else:
            from .parallel import ShardedCodec
            _CODEC_CACHE[key] = ShardedCodec(config, devs, chunk,
                                             predict_legacy=predict_legacy)
    return _CODEC_CACHE[key]


def _codec_key_config(config: AlacConfig) -> AlacConfig:
    """Normalize cookie-only fields before keying the codec cache:
    sample_rate / maxFrameBytes / avgBitRate never enter the packet
    math, so files differing only in them share ONE codec."""
    import dataclasses
    return dataclasses.replace(config, sample_rate=44100,
                               max_frame_bytes=0, avg_bit_rate=0)


def _torch_encode_stream(config: AlacConfig, pcm: np.ndarray,
                         device="cuda", devices=None) -> list[bytes]:
    """convert.py backend: planar (C, N) -> packets, full frames AND the
    partial tail in one device batch (per-lane nums; reference:
    ALACEncoder.cpp Encode partial-frame path)."""
    config = _codec_key_config(config)
    S = config.frame_length
    C = pcm.shape[0]
    N = pcm.shape[1]
    nf = N // S
    rem = N % S
    n_pk = nf + (1 if rem else 0)
    if not n_pk:
        return []
    frames = np.zeros((n_pk, C, S), dtype=pcm.dtype)
    if nf:
        frames[:nf] = np.transpose(
            pcm[:, : nf * S].reshape(C, nf, S), (1, 0, 2))
    nums = np.full((n_pk,), S, dtype=np.int32)
    if rem:
        frames[nf, :, :rem] = pcm[:, nf * S:]
        nums[nf] = rem
    codec = get_codec(config, device=device, devices=devices)
    if rem:
        return codec.encode_frames_ex(frames, nums)
    return codec.encode_frames(frames)


def _torch_decode_stream(config: AlacConfig, packets, num_valid_frames: int,
                         device="cuda", devices=None) -> np.ndarray:
    config = _codec_key_config(config)
    S = config.frame_length
    n_full = num_valid_frames // S
    n_full = min(n_full, len(packets))
    rem = num_valid_frames - n_full * S
    if rem and len(packets) <= n_full:
        raise AlacParamError("missing packets for trailing samples")
    n_pk = n_full + (1 if rem else 0)
    out = np.zeros((config.num_channels, num_valid_frames), dtype=np.int64)
    if not n_pk:
        return out
    # full frames AND the partial tail decode in one device batch
    # (per-lane num mask; reference: ALACDecoder.cpp partialFrame)
    pcm, nums = get_codec(config, device=device,
                          devices=devices).decode_frames_ex(
        list(packets[:n_pk]))
    if (nums[:n_full] != S).any():
        raise AlacParamError("unexpected partial frame")
    if rem and nums[n_full] != rem:
        raise AlacParamError(
            f"tail packet has {int(nums[n_full])} samples, expected {rem}")
    flat = np.transpose(pcm[:n_full], (1, 0, 2)).reshape(
        config.num_channels, n_full * S)
    out[:, : n_full * S] = flat
    if rem:
        out[:, n_full * S:] = pcm[n_full, :, :rem]
    return out


from . import convert as _convert  # noqa: E402  (registration at import)

_convert.register_backend("torch", _torch_encode_stream, _torch_decode_stream)
