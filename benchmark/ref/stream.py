"""The benchmark's plain reference for whole-track encodes: the stateful
encoder's packets, in which every packet of a track starts its
predictors from the coefficients the track's previous packet left
(ALACEncoder.cpp keeps them as its mCoefsU / mCoefsV members and
pc_block adapts them in place).  Vectorised across lanes in plain torch,
the search one packet step at a time; it imports nothing of the package
under test.

It follows the repo's stateful scalar encoder (the oracle's
ALACEncoder(config) without independent frames, and the native C++
encoder, which the repo holds equal to it), and so keeps the repo's
dialect where it departs, or may depart, from ALACEncoder.cpp (SURVEY.md
row 10 marks EncodeStereo's search grid and dilation as unverified):

- every CPE's stereo mode comes from a trial on every 4th sample at
  order 8 whose coefficients are fresh in every packet, never a bank's;
- the search prices orders 4 and 8, stages 1 and 2, each order of each
  channel from a bank of its own (ALACEncoder.cpp keeps
  kALACMaxSearches coefficient sets per channel);
- a bank takes its adapted coefficients only when its order won the
  channel and the element did not escape; an escaped element leaves
  every bank of its channels as it was.

Full frames only: a track's last packet here is whole (the benchmark's
tracks are cut on packet boundaries).
"""

from __future__ import annotations

import torch

from . import alac
from .alac import I64
from .codec import (DILATE, MAX_RES, MIX_BITS, MODE_DIFF, ORDERS, PB_FACTOR,
                    TAGS, TRIAL_ORDER, Layout, _const)

COEFS = 16            # kALACMaxCoefs: a bank's width


def fresh_banks(F: int, C: int, device) -> dict:
    """{channel: {order: (F, 16) int64}}: every bank at init_coefs."""
    return {c: {od: alac.init_coefs(F, COEFS, device) for od in ORDERS}
            for c in range(C)}


def encode_stream(pcm, lay: Layout, banks=None, fresh=None):
    """(F, N, C, S) planar samples of F lanes, N packets each -> ((F, N, W)
    word images, (F, N) total bits, the banks after packet N-1, stats).
    ``banks`` as ``fresh_banks`` returns (None: fresh for every lane);
    ``fresh`` (F, N) bool: where ``fresh[:, t]`` is set the lane starts a
    track at packet t, every bank of it back at init_coefs.  ``stats``
    holds per lane and packet, (F, N), the trial's and the search's walk
    steps and coded samples (``trial_steps``, ``trial_coded``,
    ``search_steps``, ``search_coded``).  The trial takes no bank, so it
    runs once over every packet; the search runs packet by packet."""
    F, N, C, S = pcm.shape
    dev = pcm.device
    if banks is None:
        banks = fresh_banks(F, C, dev)
    init = alac.init_coefs(1, COEFS, dev)
    best, trial_stats = stereo_modes(pcm.reshape(F * N, C, S), lay)
    imgs, bits, stats = [], [], []
    for t in range(N):
        if fresh is not None:
            reset = fresh[:, t, None].to(dev)
            banks = {c: {od: torch.where(reset, init, b)
                         for od, b in by.items()} for c, by in banks.items()}
        img, nbits, banks, st = encode_packet(
            pcm[:, t], lay, banks, {ei: m.view(F, N)[:, t]
                                    for ei, m in best.items()})
        imgs.append(img)
        bits.append(nbits)
        stats.append(st)
    stats = {k: torch.stack([st[k] for st in stats], 1) for k in stats[0]}
    stats.update({k: v.view(F, N) for k, v in trial_stats.items()})
    return torch.stack(imgs, 1), torch.stack(bits, 1), banks, stats


def stereo_modes(pcm, lay: Layout):
    """rc.encode's dilated trial over (F, C, N) planar full frames: every
    CPE's mixres ({element index: (F,)}, first minimum) from 7 candidate
    streams at order 8 with fresh coefficients, and its walk steps and
    coded samples per frame."""
    F, C, N = pcm.shape
    dev = pcm.device
    hi = pcm.to(I64) >> (8 * lay.bytes_shifted)
    cpes, ch = [], 0
    for ei, (_, width) in enumerate(lay.elements):
        if width == 2:
            cpes.append((ei, ch))
        ch += width
    zero = torch.zeros((F,), dtype=I64, device=dev)
    stats = {"trial_steps": zero, "trial_coded": zero}
    best = {}
    if not cpes:
        return best, stats
    nd = _const((N + DILATE - 1) // DILATE, F, dev)
    streams = []
    for _, c0 in cpes:
        ld, rd = hi[:, c0, ::DILATE], hi[:, c0 + 1, ::DILATE]
        us = [alac.mix(ld, rd, MIX_BITS, _const(mr, F, dev))[0]
              for mr in range(MAX_RES + 1)]
        streams += us + [alac.wrap32(ld - rd), rd]
    X = torch.cat(streams)
    L = X.shape[0]
    nd = nd.repeat(L // F)
    cb = _const(lay.chanbits(2), L, dev)
    res, _, steps = alac.fir(X, _const(TRIAL_ORDER, L, dev),
                             alac.init_coefs(L, TRIAL_ORDER, dev), cb, nd,
                             decode=False)
    tbits, coded = alac.rice_encode(res, nd, cb, lay.mb, lay.pb, lay.kb)
    tbits = tbits.view(len(cpes), 7, F)
    cost = torch.stack([tbits[:, mr] + (tbits[:, 6] if mr == 0
                                        else tbits[:, 5])
                        for mr in range(MAX_RES + 1)], 1)
    arg = torch.argmin(cost, 1)           # first minimum
    for i, (ei, _) in enumerate(cpes):
        best[ei] = arg[i]
    stats["trial_steps"] = steps.view(-1, F).sum(0)
    stats["trial_coded"] = coded.view(-1, F).sum(0)
    return best, stats


def encode_packet(pcm, lay: Layout, banks, best):
    """One packet of every lane: (F, C, N) planar samples (full frames),
    the banks it starts from and every CPE's mixres (``stereo_modes``) ->
    ((F, W) word images, (F,) total bits, the banks after it, per-lane
    search stats).  rc.encode's standard search and writer, each order of
    each channel starting from its bank, the header carrying the winning
    order's starting coefficients."""
    F, C, N = pcm.shape
    dev = pcm.device
    pcm = pcm.to(I64)
    num = _const(N, F, dev)
    sh = 8 * lay.bytes_shifted
    hi = pcm >> sh
    lo = pcm & ((1 << sh) - 1)
    starts_ch, ch = [], 0
    for _, width in lay.elements:
        starts_ch.append(ch)
        ch += width
    stats = {}

    # ---- the channel streams after the mix ----
    chans, cbs = [], []
    for ei, ((_, width), c0) in enumerate(zip(lay.elements, starts_ch)):
        if width == 2:
            u, v = alac.mix(hi[:, c0], hi[:, c0 + 1], MIX_BITS, best[ei])
            chans += [u, v]
        else:
            chans.append(hi[:, c0])
        cbs += [lay.chanbits(width)] * width
    X = torch.cat(chans)                                  # (C F, N)
    cb = torch.tensor(cbs, dtype=I64, device=dev).repeat_interleave(F)
    numc = num.repeat(C)
    CF = C * F
    Wc = (N * alac.CODE_BITS + 31) // 32 + 2
    lane = torch.arange(CF, device=dev)

    # ---- the candidates: orders 4, 8 (each from its banks) x stages 1, 2 ----
    X2 = torch.cat([X, X])
    ods = torch.cat([_const(ORDERS[0], CF, dev), _const(ORDERS[1], CF, dev)])
    start = torch.cat([banks[c][od] for od in ORDERS for c in range(C)])
    res1, adapted, steps = alac.fir(X2, ods, start, cb.repeat(2),
                                    numc.repeat(2), decode=False)
    res2 = alac.first_difference(res1, cb.repeat(2), numc.repeat(2))
    R = torch.cat([res1, res2])       # [stage][order][channel][frame]
    scratch = torch.zeros((4 * CF, Wc), dtype=I64, device=dev)
    sbits, coded = alac.rice_encode(R, numc.repeat(4), cb.repeat(4),
                                    lay.mb, lay.pb, lay.kb, img=scratch)
    sbits = sbits.view(2, 2, C, F)
    order_t = torch.tensor(ORDERS, dtype=I64, device=dev)
    price = 16 + 16 * order_t[None, :, None, None] + sbits
    # candidates (4, 1), (4, 2), (8, 1), (8, 2)
    cand = torch.stack([price[0, 0], price[1, 0], price[0, 1], price[1, 1]])
    win = torch.argmin(cand, 0)                           # (C, F)
    oi, stage = win // 2, win % 2
    chan_cost = cand.gather(0, win[None])[0]
    order = order_t[oi]
    pick = ((stage * 2 + oi) * CF).view(-1) + lane
    stats["search_steps"] = steps.view(2, C, F).sum((0, 1))
    stats["search_coded"] = coded.view(4, C, F).sum((0, 1))
    mode = torch.where(stage == 1, MODE_DIFF, 0)
    rice_bits = chan_cost - 16 - 16 * order
    start = start.view(2, C, F, COEFS)
    coefs0 = torch.where((oi == 1)[..., None], start[1], start[0])

    # ---- element sizes, escapes, fields ----
    W = lay.image_words()
    img = torch.zeros((F, W), dtype=I64, device=dev)
    rows = torch.arange(F, device=dev)
    pos = torch.zeros((F,), dtype=I64, device=dev)
    jj = torch.arange(N, device=dev)
    rice_start = torch.zeros((C, F), dtype=I64, device=dev)
    escaped = torch.zeros((C, F), dtype=torch.bool, device=dev)
    instances = {}
    for ei, ((tag, width), c0) in enumerate(zip(lay.elements, starts_ch)):
        tid = TAGS[tag]
        inst = instances.get(tid, 0)
        instances[tid] = inst + 1
        hdr = 23
        cost = chan_cost[c0:c0 + width].sum(0)
        body = 16 + cost + width * num * sh
        esc = body >= num * lay.bit_depth * width
        escaped[c0:c0 + width] = esc[None]
        head = ((tid << 20) | (inst << 16)
                | torch.where(esc, 1, lay.bytes_shifted << 1))
        alac.put_bits(img, rows, pos, head, _const(23, F, dev))
        p = pos + hdr
        comp = ~esc
        mixres_e = best[ei] if width == 2 else _const(0, F, dev)
        mixbits = MIX_BITS if width == 2 else 0
        alac.put_bits(img, rows, p, (mixbits << 8) | mixres_e, 16 * comp)
        p = p + 16
        k = torch.arange(8, device=dev)
        for ci in range(width):
            c = c0 + ci
            chp = ((mode[c] << 12) | (alac.DENSHIFT << 8) | (PB_FACTOR << 5)
                   | order[c])
            alac.put_bits(img, rows, p, chp, 16 * comp)
            co = coefs0[c, :, :8] & 0xFFFF
            alac.put_bits(img, rows[:, None], p[:, None] + 16 + 16 * k,
                          co, 16 * (comp[:, None] & (k < order[c][:, None])))
            p = p + 16 + 16 * order[c]
        if sh:
            live = comp[:, None].expand(F, N)
            for ci in range(width):
                alac.put_bits(img, rows[:, None],
                              p[:, None] + (jj * width + ci)[None, :] * sh,
                              lo[:, c0 + ci], sh * live)
            p = p + width * num * sh
        for ci in range(width):
            rice_start[c0 + ci] = p
            p = p + rice_bits[c0 + ci]
        if bool(esc.any().item()):
            e = torch.nonzero(esc)[:, 0]
            d = lay.bit_depth
            for ci in range(width):
                alac.put_bits(img, e[:, None],
                              (pos[e] + hdr)[:, None]
                              + (jj * width + ci)[None, :] * d,
                              pcm[e, c0 + ci] & ((1 << d) - 1),
                              _const(d, 1, dev)[:, None])
        pos = torch.where(esc, pos + hdr + num * lay.bit_depth * width, p)
    keep = ~escaped.view(-1)
    alac.splice(img, rows.repeat(C)[keep], rice_start.view(-1)[keep],
                scratch[pick[keep]], rice_bits.view(-1)[keep])
    alac.put_bits(img, rows, pos, _const(alac.ID_END, F, dev),
                  _const(3, F, dev))

    # ---- the commit: the winner's bank takes its adapted coefficients ----
    adapted = adapted.view(2, C, F, -1)
    col = torch.arange(COEFS, device=dev)
    new = {}
    for c in range(C):
        new[c] = {}
        for i, od in enumerate(ORDERS):
            got = torch.zeros((F, COEFS), dtype=I64, device=dev)
            got[:, :adapted.shape[-1]] = adapted[i, c]
            got = torch.where(col[None, :] < od, got, banks[c][od])
            take = ((oi[c] == i) & ~escaped[c])[:, None]
            new[c][od] = torch.where(take, got, banks[c][od])
    return img, pos + 3, new, stats
