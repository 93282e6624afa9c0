"""The benchmark's plain ALAC reference: a packet encoder in the repo's
dialect (independent frames, standard search) and a packet decoder, both
vectorised across frames in plain torch.  It imports nothing of the
package under test and takes nothing it made.

Encoder (the dialect of the repo's scalar oracle encoder, which Apple's
ALACEncoder.cpp structures): every CPE's stereo mode from a trial on
every 4th sample (order 8, fresh coefficients, Rice bits of both
streams, first minimum of mixres 0..4); then per channel the candidates
order 4 / 8 x stage 1 / 2 (stage 2: the residuals' first difference,
mode 15), each priced 16 + 16 * order + Rice bits, first minimum in
that order; an element escapes (raw samples) when its compressed body
is no shorter.  The writer of the decode cells skips the search and
codes each channel at an order it is given, since the standard search
picks order 4 on nearly every channel of this music.

Decoder: the packet grammar (SCE/CPE/LFE elements, partial frames,
shift-byte blocks, escape elements, END), the Rice decode, the
predictor's inverse at any order up to 31, the two-stage cascade and
the stereo unmix.
"""

from __future__ import annotations

import dataclasses

import torch

from . import alac
from .alac import I64

MIX_BITS = 2          # ALACEncoder.cpp :: kDefaultMixBits
MAX_RES = 4           # kMaxRes
DILATE = 4            # the dialect's mixres trial takes every 4th sample
TRIAL_ORDER = 8
ORDERS = (4, 8)
PB_FACTOR = 4
MODE_DIFF = 15        # stage 2's wire mode
TAGS = {"SCE": alac.ID_SCE, "CPE": alac.ID_CPE, "LFE": alac.ID_LFE}


@dataclasses.dataclass(frozen=True)
class Layout:
    """What the packets of one configuration look like."""
    bit_depth: int
    frame_length: int
    elements: tuple          # ((tag name, width), ...) in stream order
    mb: int = 10
    pb: int = 40
    kb: int = 14

    @property
    def channels(self) -> int:
        return sum(w for _, w in self.elements)

    @property
    def bytes_shifted(self) -> int:
        return {32: 2, 24: 1}.get(self.bit_depth, 0)

    def image_words(self) -> int:
        """Words of one packet's device image: the escape packet's bound
        (ALACAudioTypes.h sizes: per sample and channel depth/8 rounded up
        plus one byte, 16 bytes per element, 8 of escape header), plus
        two words of slack."""
        n = self.frame_length
        nbytes = (n * self.channels * ((self.bit_depth + 7) // 8 + 1)
                  + len(self.elements) * 16 + 8)
        return (nbytes + 3) // 4 + 2

    def chanbits(self, width: int) -> int:
        return self.bit_depth - 8 * self.bytes_shifted + (1 if width == 2 else 0)


def _const(v, n, dev):
    return torch.full((n,), v, dtype=I64, device=dev)


def encode(pcm, lay: Layout, num=None, orders=None):
    """(F, C, N) planar samples (int, right-aligned at the depth, zero past
    each frame's count) -> ((F, W) word images, (F,) total bits, stats).
    ``num`` (F,) samples per frame (default N, full frames).  The
    standard search by default; ``orders`` (F, C) given: the packet
    writer, no search (stage 1 at those orders) after the stereo trial.
    ``stats`` holds per frame the work of the trial and the search, and
    per channel (C, F) the written order, mode, coded samples, walk steps
    and Rice bits."""
    F, C, N = pcm.shape
    dev = pcm.device
    pcm = pcm.to(I64)
    num = _const(N, F, dev) if num is None else num.to(I64)
    sh = 8 * lay.bytes_shifted
    hi = pcm >> sh
    lo = pcm & ((1 << sh) - 1)
    starts_ch, ch = [], 0
    for _, width in lay.elements:
        starts_ch.append(ch)
        ch += width
    cpes = [(ei, c0) for ei, ((_, w), c0) in
            enumerate(zip(lay.elements, starts_ch)) if w == 2]
    zero = torch.zeros((F,), dtype=I64, device=dev)
    stats = {"trial_steps": zero, "trial_coded": zero}

    # ---- each CPE's stereo mode: the dilated trial ----
    best = {}
    if cpes:
        numd = (num + DILATE - 1) // DILATE
        streams = []
        for _, c0 in cpes:
            ld, rd = hi[:, c0, ::DILATE], hi[:, c0 + 1, ::DILATE]
            us = [alac.mix(ld, rd, MIX_BITS, _const(mr, F, dev))[0]
                  for mr in range(MAX_RES + 1)]
            streams += us + [alac.wrap32(ld - rd), rd]
        X = torch.cat(streams)
        L = X.shape[0]
        nd = numd.repeat(L // F)
        cb = _const(lay.chanbits(2), L, dev)
        res, _, steps = alac.fir(X, _const(TRIAL_ORDER, L, dev),
                                 alac.init_coefs(L, TRIAL_ORDER, dev), cb,
                                 nd, decode=False)
        bits, coded = alac.rice_encode(res, nd, cb, lay.mb, lay.pb, lay.kb)
        bits = bits.view(len(cpes), 7, F)
        cost = torch.stack([bits[:, mr] + (bits[:, 6] if mr == 0
                                           else bits[:, 5])
                            for mr in range(MAX_RES + 1)], 1)
        arg = torch.argmin(cost, 1)           # first minimum
        for i, (ei, _) in enumerate(cpes):
            best[ei] = arg[i]
        stats["trial_steps"] = steps.view(-1, F).sum(0)
        stats["trial_coded"] = coded.view(-1, F).sum(0)

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

    # ---- the candidates: orders 4, 8 x stages 1, 2 (the writer: one) ----
    if orders is None:
        n_cand = 4
        X2 = torch.cat([X, X])
        ods = torch.cat([_const(ORDERS[0], CF, dev),
                         _const(ORDERS[1], CF, dev)])
        res1, _, steps = alac.fir(X2, ods, alac.init_coefs(2 * CF, 8, dev),
                                  cb.repeat(2), numc.repeat(2), decode=False)
        res2 = alac.first_difference(res1, cb.repeat(2), numc.repeat(2))
        R = torch.cat([res1, res2])       # [stage][order][channel][frame]
    else:
        n_cand = 1
        ods = orders.T.reshape(-1).to(I64)
        R, _, steps = alac.fir(X, ods, alac.init_coefs(CF, 8, dev), cb, numc,
                               decode=False)
    scratch = torch.zeros((n_cand * CF, Wc), dtype=I64, device=dev)
    bits, coded = alac.rice_encode(R, numc.repeat(n_cand), cb.repeat(n_cand),
                                   lay.mb, lay.pb, lay.kb, img=scratch)
    if orders is None:
        bits = bits.view(2, 2, C, F)
        order_t = torch.tensor(ORDERS, dtype=I64, device=dev)
        price = 16 + 16 * order_t[None, :, None, None] + bits
        # candidates (4, 1), (4, 2), (8, 1), (8, 2)
        cand = torch.stack([price[0, 0], price[1, 0], price[0, 1],
                            price[1, 1]])
        win = torch.argmin(cand, 0)                       # (C, F)
        oi, stage = win // 2, win % 2
        chan_cost = cand.gather(0, win[None])[0]
        order = order_t[oi]
        pick = ((stage * 2 + oi) * CF).view(-1) + lane
        stats["search_steps"] = steps.view(2, C, F).sum((0, 1))
        stats["search_coded"] = coded.view(4, C, F).sum((0, 1))
        stats["steps"] = steps.view(2, C, F).gather(0, oi[None])[0]
    else:
        stage = torch.zeros((C, F), dtype=I64, device=dev)
        order = ods.view(C, F)
        chan_cost = 16 + 16 * order + bits.view(C, F)
        pick = lane
        stats["steps"] = steps.view(C, F)
    mode = torch.where(stage == 1, MODE_DIFF, 0)
    rice_bits = chan_cost - 16 - 16 * order
    stats.update(order=order, mode=mode, rice_bits=rice_bits,
                 coded=coded[pick].view(C, F))

    # ---- element sizes, escapes, fields ----
    W = lay.image_words()
    img = torch.zeros((F, W), dtype=I64, device=dev)
    rows = torch.arange(F, device=dev)
    partial = (num < N).to(I64)
    pos = torch.zeros((F,), dtype=I64, device=dev)
    jj = torch.arange(N, device=dev)
    rice_start = torch.zeros((C, F), dtype=I64, device=dev)
    escaped = torch.zeros((C, F), dtype=torch.bool, device=dev)
    instances = {}
    for ei, ((tag, width), c0) in enumerate(zip(lay.elements, starts_ch)):
        tid = TAGS[tag]
        inst = instances.get(tid, 0)
        instances[tid] = inst + 1
        hdr = 23 + 32 * partial
        cost = chan_cost[c0:c0 + width].sum(0)
        body = 16 + cost + width * num * sh
        esc = body >= num * lay.bit_depth * width
        escaped[c0:c0 + width] = esc[None]
        head = ((tid << 20) | (inst << 16) | (partial << 3)
                | torch.where(esc, 1, lay.bytes_shifted << 1))
        alac.put_bits(img, rows, pos, head, _const(23, F, dev))
        alac.put_bits(img, rows, pos + 23, num, 32 * partial)
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
            co = alac.init_coefs(F, 8, dev) & 0xFFFF
            alac.put_bits(img, rows[:, None], p[:, None] + 16 + 16 * k,
                          co, 16 * (comp[:, None] & (k < order[c][:, None])))
            p = p + 16 + 16 * order[c]
        if sh:
            live = (jj[None, :] < num[:, None]) & comp[:, None]
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
            live = jj[None, :] < num[e, None]
            for ci in range(width):
                alac.put_bits(img, e[:, None],
                              (pos[e] + hdr[e])[:, None]
                              + (jj * width + ci)[None, :] * d,
                              pcm[e, c0 + ci] & ((1 << d) - 1), d * live)
        pos = torch.where(esc, pos + hdr + num * lay.bit_depth * width, p)
    keep = ~escaped.view(-1)
    alac.splice(img, rows.repeat(C)[keep], rice_start.view(-1)[keep],
                scratch[pick[keep]], rice_bits.view(-1)[keep])
    alac.put_bits(img, rows, pos, _const(alac.ID_END, F, dev),
                  _const(3, F, dev))
    return img, pos + 3, stats


def decode(img, lay: Layout):
    """(F, W) word images -> ((F, C, N) samples, (F,) sample counts, (F,)
    error flags): every element of the layout in order; a frame whose
    stream leaves the grammar this reference reads (another tag, an
    order of 0, a denshift other than 9, a zero run past the count, no
    END) is flagged."""
    F = img.shape[0]
    N = lay.frame_length
    C = lay.channels
    dev = img.device
    rows = torch.arange(F, device=dev)
    pos = torch.zeros((F,), dtype=I64, device=dev)
    err = torch.zeros((F,), dtype=torch.bool, device=dev)
    num = _const(N, F, dev)
    out = torch.zeros((F, C, N), dtype=I64, device=dev)
    jj = torch.arange(N, device=dev)
    c0 = 0
    for tag, width in lay.elements:
        h = alac.get_bits(img, rows, pos, 23)
        t = h >> 20
        if tag == "CPE":
            err |= t != alac.ID_CPE
        else:
            err |= (t != alac.ID_SCE) & (t != alac.ID_LFE)
        partial = (h >> 3) & 1
        bs = (h >> 1) & 3
        esc = (h & 1) == 1
        sh = 8 * bs
        err |= (bs != lay.bytes_shifted) & ~esc
        pos = pos + 23
        n = torch.where(partial == 1, alac.get_bits(img, rows, pos, 32), N)
        err |= n > N
        n = torch.clamp(n, max=N)
        num = n
        pos = pos + 32 * partial
        p = pos
        m = alac.get_bits(img, rows, p, 16)
        mixbits, mixres = m >> 8, alac.sext(m & 0xFF, 8)
        p = p + 16
        params = []
        for _ in range(width):
            hdr = alac.get_bits(img, rows, p, 16)
            mode, den = hdr >> 12, (hdr >> 8) & 15
            pbf, order = (hdr >> 5) & 7, hdr & 31
            k = torch.arange(31, device=dev)
            co = alac.get_bits(img, rows[:, None], p[:, None] + 16 + 16 * k,
                               torch.where(k[None, :] < order[:, None], 16, 0))
            co = alac.sext(co, 16)
            err |= ~esc & ((order == 0) | (den != alac.DENSHIFT))
            params.append((mode, pbf, torch.clamp(order, min=1), co))
            p = p + 16 + 16 * order
        pshift = p
        p = p + width * n * sh
        cb = lay.chanbits(width)
        cbt = _const(cb, F, dev)
        ns = torch.where(esc, 0, n)
        dec = []
        for mode, pbf, order, co in params:
            res, p, rerr = alac.rice_decode(img, rows, p, ns, cbt, N, lay.mb,
                                            (lay.pb * pbf) // 4, lay.kb)
            err |= rerr & ~esc
            r1 = torch.where((mode != 0)[:, None],
                             alac.running_sum(res, cbt, ns), res)
            y, _, _ = alac.fir(r1, order, co, cbt, ns, decode=True)
            dec.append(y)
        if width == 2:
            dec = list(alac.unmix(dec[0], dec[1], mixbits, mixres))
        if lay.bytes_shifted:
            live = jj[None, :] < n[:, None]
            for ci in range(width):
                low = alac.get_bits(img, rows[:, None],
                                    pshift[:, None]
                                    + (jj * width + ci)[None, :] * sh[:, None],
                                    torch.where(live, sh[:, None], 0))
                dec[ci] = alac.wrap32((dec[ci] << sh[:, None]) | low)
        d = lay.bit_depth
        live = jj[None, :] < n[:, None]
        for ci in range(width):
            raw = alac.get_bits(img, rows[:, None],
                                pos[:, None] + (jj * width + ci)[None, :] * d,
                                torch.where(live & esc[:, None], d, 0))
            y = torch.where(esc[:, None], alac.sext(raw, d), dec[ci])
            out[:, c0 + ci] = torch.where(live, y, 0)
        pos = torch.where(esc, pos + width * n * d, p)
        c0 += width
    err |= alac.get_bits(img, rows, pos, 3) != alac.ID_END
    return out, num, err
