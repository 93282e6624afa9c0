"""The benchmark's high-order packet writer: the packets of FFmpeg's ALAC
encoder at ``-max_prediction_order 30`` (libavcodec/alacenc.c), as far
as a decode's work goes.  FFmpeg codes each channel at an order from 1
to 30 (ALAC_MAX_LPC_ORDER), stage 1 (mode 0), with coefficients from a
Levinson-Durbin fit; this writer codes each channel at the order it is
given, stage 1, with the reference's adaptive walk from dp_enc.c's
starting coefficients at DENSHIFT (32 of them, where codec.encode's
writer holds 8), which is the one denshift the reference decoder reads.
The walk's length, the FIR's width and the Rice stream's cost follow
the orders and the residuals, not the coefficients' values.

Everything else is codec.encode's writer: each CPE's stereo mode from
the dilated trial, partial frames, shift-byte blocks, escape elements.
Its packets decode through codec.decode."""

from __future__ import annotations

import torch

from . import alac
from . import codec as rc
from .alac import I64

TAPS = 32             # starting coefficients per channel
MAX_ORDER = 30        # alacenc.c :: ALAC_MAX_LPC_ORDER


def _full(v, n, dev):
    return torch.full((n,), v, dtype=I64, device=dev)


def _trial(hi, lay: rc.Layout, cpes, num):
    """Each CPE's mixres (codec.encode's dilated trial: order 8, fresh
    coefficients, the first minimum of mixres 0..4)."""
    F = hi.shape[0]
    dev = hi.device
    numd = (num + rc.DILATE - 1) // rc.DILATE
    streams = []
    for _, c0 in cpes:
        ld, rd = hi[:, c0, ::rc.DILATE], hi[:, c0 + 1, ::rc.DILATE]
        streams += [alac.mix(ld, rd, rc.MIX_BITS, _full(mr, F, dev))[0]
                    for mr in range(rc.MAX_RES + 1)]
        streams += [alac.wrap32(ld - rd), rd]
    X = torch.cat(streams)
    L = X.shape[0]
    nd = numd.repeat(L // F)
    cb = _full(lay.chanbits(2), L, dev)
    res, _, _ = alac.fir(X, _full(rc.TRIAL_ORDER, L, dev),
                         alac.init_coefs(L, rc.TRIAL_ORDER, dev), cb, nd,
                         decode=False)
    bits, _ = alac.rice_encode(res, nd, cb, lay.mb, lay.pb, lay.kb)
    bits = bits.view(len(cpes), 7, F)
    cost = torch.stack([bits[:, mr] + (bits[:, 6] if mr == 0 else bits[:, 5])
                        for mr in range(rc.MAX_RES + 1)], 1)
    return torch.argmin(cost, 1)


def encode(pcm, lay: rc.Layout, orders, num=None):
    """(F, C, N) planar samples (right-aligned at the depth, zero past each
    frame's count) and (F, C) orders in 1..30 -> ((F, W) word images, (F,)
    total bits, stats): codec.encode's writer at any order.  ``stats``
    holds per channel (C, F) the written order, mode (0), coded samples,
    walk steps, Rice bits and whether its element escaped."""
    F, C, N = pcm.shape
    dev = pcm.device
    orders = orders.to(I64)
    if bool(((orders < 1) | (orders > MAX_ORDER)).any()):
        raise ValueError(f"orders must lie in 1..{MAX_ORDER}")
    pcm = pcm.to(I64)
    num = _full(N, F, dev) if num is None else num.to(I64)
    sh = 8 * lay.bytes_shifted
    hi = pcm >> sh
    lo = pcm & ((1 << sh) - 1)
    starts, ch = [], 0
    for _, width in lay.elements:
        starts.append(ch)
        ch += width
    cpes = [(ei, c0) for ei, ((_, w), c0) in
            enumerate(zip(lay.elements, starts)) if w == 2]
    mixres = _trial(hi, lay, cpes, num) if cpes else None
    best = {ei: mixres[i] for i, (ei, _) in enumerate(cpes)}

    # every channel after the mix at its order, stage 1
    chans, cbs = [], []
    for ei, ((_, width), c0) in enumerate(zip(lay.elements, starts)):
        if width == 2:
            chans += list(alac.mix(hi[:, c0], hi[:, c0 + 1], rc.MIX_BITS,
                                   best[ei]))
        else:
            chans.append(hi[:, c0])
        cbs += [lay.chanbits(width)] * width
    X = torch.cat(chans)                                  # (C F, N)
    CF = C * F
    cb = torch.tensor(cbs, dtype=I64, device=dev).repeat_interleave(F)
    numc = num.repeat(C)
    order = orders.T.contiguous()                         # (C, F)
    R, _, steps = alac.fir(X, order.view(-1), alac.init_coefs(CF, TAPS, dev),
                           cb, numc, decode=False)
    Wc = (N * alac.CODE_BITS + 31) // 32 + 2
    scratch = torch.zeros((CF, Wc), dtype=I64, device=dev)
    bits, coded = alac.rice_encode(R, numc, cb, lay.mb, lay.pb, lay.kb,
                                   img=scratch)
    rice_bits = bits.view(C, F)
    stats = dict(order=order, mode=torch.zeros_like(order),
                 rice_bits=rice_bits, coded=coded.view(C, F),
                 steps=steps.view(C, F))

    # elements: header, coefficients, shift bytes, Rice streams or escape
    W = lay.image_words()
    img = torch.zeros((F, W), dtype=I64, device=dev)
    rows = torch.arange(F, device=dev)
    partial = (num < N).to(I64)
    pos = torch.zeros((F,), dtype=I64, device=dev)
    jj = torch.arange(N, device=dev)
    k = torch.arange(TAPS, device=dev)
    co = alac.init_coefs(F, TAPS, dev) & 0xFFFF
    rice_start = torch.zeros((C, F), dtype=I64, device=dev)
    escaped = torch.zeros((C, F), dtype=torch.bool, device=dev)
    instances = {}
    for ei, ((tag, width), c0) in enumerate(zip(lay.elements, starts)):
        tid = rc.TAGS[tag]
        inst = instances.get(tid, 0)
        instances[tid] = inst + 1
        hdr = 23 + 32 * partial
        rice = rice_bits[c0:c0 + width]
        body = 16 + (16 + 16 * order[c0:c0 + width] + rice).sum(0) \
            + width * num * sh
        esc = body >= num * lay.bit_depth * width
        escaped[c0:c0 + width] = esc[None]
        head = ((tid << 20) | (inst << 16) | (partial << 3)
                | torch.where(esc, 1, lay.bytes_shifted << 1))
        alac.put_bits(img, rows, pos, head, _full(23, F, dev))
        alac.put_bits(img, rows, pos + 23, num, 32 * partial)
        comp = ~esc
        mix = best[ei] if width == 2 else _full(0, F, dev)
        mixbits = rc.MIX_BITS if width == 2 else 0
        p = pos + hdr
        alac.put_bits(img, rows, p, (mixbits << 8) | mix, 16 * comp)
        p = p + 16
        for c in range(c0, c0 + width):
            chp = (alac.DENSHIFT << 8) | (rc.PB_FACTOR << 5) | order[c]
            alac.put_bits(img, rows, p, chp, 16 * comp)
            alac.put_bits(img, rows[:, None], p[:, None] + 16 + 16 * k, co,
                          16 * (comp[:, None] & (k < order[c][:, None])))
            p = p + 16 + 16 * order[c]
        if sh:
            live = (jj[None, :] < num[:, None]) & comp[:, None]
            for ci in range(width):
                alac.put_bits(img, rows[:, None],
                              p[:, None] + (jj * width + ci)[None, :] * sh,
                              lo[:, c0 + ci], sh * live)
            p = p + width * num * sh
        for c in range(c0, c0 + width):
            rice_start[c] = p
            p = p + rice_bits[c]
        if bool(esc.any().item()):
            e = torch.nonzero(esc)[:, 0]
            d = lay.bit_depth
            live = jj[None, :] < num[e, None]
            for ci in range(width):
                alac.put_bits(img, e[:, None],
                              (pos[e] + hdr[e])[:, None]
                              + (jj * width + ci)[None, :] * d,
                              pcm[e, c0 + ci] & ((1 << d) - 1), d * live)
        pos = torch.where(esc, pos + hdr + num * lay.bit_depth * width, p)
    stats["escaped"] = escaped
    keep = ~escaped.view(-1)
    alac.splice(img, rows.repeat(C)[keep], rice_start.view(-1)[keep],
                scratch[keep], rice_bits.view(-1)[keep])
    alac.put_bits(img, rows, pos, _full(alac.ID_END, F, dev),
                  _full(3, F, dev))
    return img, pos + 3, stats
