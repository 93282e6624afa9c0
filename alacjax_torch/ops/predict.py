"""Batched adaptive FIR predictor, encode side, alone or fused with
adaptive-Rice cost machines (counterpart of alacjax/ops/predict.py;
oracle: alacjax.oracle.dp; reference: codec/dp_enc.c).

The recurrence is sequential in the sample axis, so the plain version
is a Python loop over S with every lane in a (B,) tensor.  It is the
version the cost kernel (alacjax_torch/kernels/cost.py) and the
predictor kernel (alacjax_torch/kernels/predict.py) are held to.  The
order is a static int (the encoder's search runs one call per order, as
the TPU path does) and so is denshift; chanbits is an int or a per-lane
(B,) tensor (stacked SCE and CPE channels differ by one bit), and the
cost machines take a per-lane sample count ``num`` (partial frames).
Arithmetic is int64 wrapped to int32 wherever the reference's int32
wraps can be observed (a sign, a compare or a shift).
"""

from __future__ import annotations

import torch

from ..types import kALACMaxCoefs

from . import rice
from .tutils import I32, I64, count_work, iota1, sign_extend, wrap_i32


def _scan_cost(x, coefs0, na: int, chanbits, denshift: int, rice_params,
               dual: bool, num=None):
    """predict._scan_general, encode branch, with no cost machine
    (``rice_params`` None: pc_block), one, or two (``dual``).  The cost
    machines stop at each lane's ``num``; the walk runs all S samples.
    Returns (res (B,S) i32, coefs (B,16) i32, cost1 (B,) i32 or None,
    cost2 (B,) i32 or None)."""
    B, S = x.shape
    dev = x.device
    x = wrap_i32(x)
    coefs0 = coefs0.to(I64)
    chanbits = rice.lane_arg(chanbits)
    den = max(int(denshift), 1)
    denhalf = 1 << (den - 1)
    zero = torch.zeros((B,), dtype=I64, device=dev)
    lags = torch.zeros((B, na + 1), dtype=I64, device=dev)
    coefs = sign_extend(coefs0[:, :na], 16)
    weight = na - iota1(na, device=dev)[None, :]   # (na - k) per tap
    if rice_params is not None:
        mb0, pb, kb, wb = rice_params
        kw = dict(S=S if num is None else rice.lane_arg(num),
                  bit_size=chanbits, pb=pb, kb=kb, wb=wb)
        st1 = rice.init_state(B, mb0, dev)
        st2 = rice.init_state(B, mb0, dev)
    tot1 = zero
    tot2 = zero
    prev_out = zero
    out_cols = []
    for t in range(S):
        x_t = x[:, t]
        top = lags[:, na]
        in_warm = t <= na
        diff = lags[:, :na] - top[:, None]
        pred_adj = wrap_i32(denhalf + (coefs * diff).sum(dim=1)) >> den
        if t == 0:
            out = x_t
        elif in_warm:
            out = sign_extend(x_t - lags[:, 0], chanbits)
        else:
            out = sign_extend(x_t - top - pred_adj, chanbits)
        out_cols.append(out)

        if not in_warm:
            # sign-sign adaptation, from the last tap down; a tap acts
            # only while the error keeps its side (dp_enc.c early exit)
            sg = torch.sign(out)
            pos = (sg > 0)[:, None]
            dd = wrap_i32(-diff)
            sgn = torch.sign(dd)
            mag = wrap_i32(sgn * dd)
            step = weight * torch.where(pos, mag >> den, wrap_i32(-mag) >> den)
            can = sg != 0
            del0 = out
            acts = [None] * na
            for k in range(na - 1, -1, -1):
                acts[k] = can & (torch.sign(del0) == sg)
                del0 = wrap_i32(del0 - torch.where(acts[k], step[:, k], 0))
            acts = torch.stack(acts, dim=1)
            count_work("taps", acts)
            upd = torch.where(acts, torch.where(pos, -sgn, sgn), 0)
            coefs = sign_extend(coefs + upd, 16)
        lags = torch.cat([x_t[:, None], lags[:, :na]], dim=1)
        if rice_params is None:
            continue

        st1, bits = rice.step_bits(out, t, st1, **kw)
        tot1 = tot1 + bits
        if dual:
            d = out if t == 0 else sign_extend(out - prev_out, chanbits)
            st2, bits = rice.step_bits(d, t, st2, **kw)
            tot2 = tot2 + bits
            prev_out = out

    res = torch.stack(out_cols, dim=1).to(I32)
    coefs = torch.cat([coefs, coefs0[:, na:]], dim=1).to(I32)
    if rice_params is None:
        return res, coefs, None, None
    # virtual end step (t == S): flush a pending zero-run token
    one = zero + 1
    _, bits = rice.step_bits(one, S, st1, **kw)
    cost1 = (tot1 + bits).to(I32)
    cost2 = None
    if dual:
        _, bits = rice.step_bits(one, S, st2, **kw)
        cost2 = (tot2 + bits).to(I32)
    return res, coefs, cost1, cost2


def pc_block(x, coefs0, numactive: int, chanbits, denshift: int = 9):
    """Batched forward prediction (predict._run, encode): (B, S) samples
    -> (residuals (B, S), adapted coefs (B, 16)), int32.  ``numactive``
    is a static order 1..16, or 0 (the samples themselves) or 31 (their
    first difference); ``coefs0`` None starts from zeros."""
    B, _ = x.shape
    if coefs0 is None:
        coefs0 = torch.zeros((B, kALACMaxCoefs), dtype=I32, device=x.device)
    if numactive == 0:
        return x.to(I32), coefs0.to(I32)
    if numactive == 31:
        return wrap_diff(x, chanbits), coefs0.to(I32)
    if not 1 <= numactive <= kALACMaxCoefs:
        raise ValueError(f"static order {numactive} is not 0, 1..16 or 31")
    res, coefs, _, _ = _scan_cost(x, coefs0, numactive, chanbits, denshift,
                                  None, dual=False)
    return res, coefs


def pc_block_cost_coefs(x, coefs0, numactive: int, chanbits, denshift: int,
                        mb0: int, pb: int, kb: int, wb: int, num=None):
    """Fused forward prediction + Rice cost of the residuals (one machine,
    the mixres trial's and fast mode's route): (B, S) samples ->
    (residuals (B, S), cost (B,), adapted coefs (B, 16))."""
    res, coefs, c1, _ = _scan_cost(x, coefs0, numactive, chanbits, denshift,
                                   (mb0, pb, kb, wb), dual=False, num=num)
    return res, c1, coefs


def pc_block_cost(x, coefs0, numactive: int, chanbits, denshift: int,
                  mb0: int, pb: int, kb: int, wb: int, num=None):
    """(B, S) samples -> (residuals (B, S), rice cost bits (B,))."""
    res, cost, _ = pc_block_cost_coefs(x, coefs0, numactive, chanbits,
                                       denshift, mb0, pb, kb, wb, num=num)
    return res, cost


def pc_block_cost2(x, coefs0, numactive: int, chanbits, denshift: int,
                   mb0: int, pb: int, kb: int, wb: int, num=None):
    """Fused forward prediction + Rice cost of BOTH stage candidates:
    (B, S) samples -> (residuals (B, S), cost1 (B,), cost2 (B,),
    coefs (B, 16)).  cost1 prices the FIR residuals (mode 0), cost2
    their first difference (mode != 0, the two-stage cascade)."""
    res, coefs, c1, c2 = _scan_cost(x, coefs0, numactive, chanbits,
                                    denshift, (mb0, pb, kb, wb), dual=True,
                                    num=num)
    return res, c1, c2, coefs


def wrap_diff(res, chanbits):
    """Stage-2 emission residual: pc_block(res, 31) == first difference
    with chanbits (an int or per-lane (B,)) wraparound (dp_enc.c ::
    pc_block numactive==31)."""
    res = wrap_i32(res)
    diffs = sign_extend(res[:, 1:] - res[:, :-1], chanbits)
    return torch.cat([res[:, :1], diffs], dim=1).to(I32)


def unpc_block(res, coefs0, numactive, chanbits, denshift=9):
    """Batched inverse prediction (alacjax.ops.predict.unpc_block,
    dp_dec.c :: unpc_block): (B, S) residuals -> (samples (B, S), adapted
    coefs (B, n)), int32.  ``numactive`` is a static order (0: the
    residuals themselves; 31: their running sum; 1..16: the adaptive
    FIR) or a per-lane (B,) tensor of 0, 1..16 and 31, walked at 16 taps
    (alacjax's per-lane branch: orders clamped into 1..16 for the walk,
    then the 0 and 31 lanes overlaid).  ``denshift`` is an int or
    per-lane; ``coefs0`` None starts from zeros.  XLA glue in alacjax
    with no kernel; no codec path calls it (the decode runs the fused
    kernel, decode_channel)."""
    B, S = res.shape
    dev = res.device
    x = wrap_i32(res)
    if coefs0 is None:
        coefs0 = torch.zeros((B, kALACMaxCoefs), dtype=I32, device=dev)
    coefs0 = coefs0.to(I64)
    if isinstance(numactive, int):
        if numactive == 0:
            return x.to(I32), coefs0.to(I32)
        if numactive == 31:
            return _running_sum(x, chanbits).to(I32), coefs0.to(I32)
        nk, na = numactive, torch.full((B,), numactive, dtype=I64,
                                       device=dev)
    else:
        nk, na = kALACMaxCoefs, torch.clamp(numactive.to(I64), 1,
                                            kALACMaxCoefs)
    den = torch.clamp(torch.as_tensor(denshift, dtype=I64, device=dev),
                      min=1).expand(B)
    zero = torch.zeros((B,), dtype=I64, device=dev)
    lags = [zero] * (nk + 1)
    coefs = [coefs0[:, k] for k in range(nk)]
    outs = []
    for t in range(S):
        x_t = x[:, t]
        top = zero
        for i in range(nk + 1):
            top = torch.where(na == i, lags[i], top)
        in_warm = t <= na
        sum1 = (1 << (den - 1)) + sum(
            torch.where(k < na, coefs[k] * (lags[k] - top), 0)
            for k in range(nk))
        pred_adj = wrap_i32(sum1) >> den
        out = torch.where(
            in_warm, sign_extend(x_t + lags[0], chanbits),
            sign_extend(x_t + top + pred_adj, chanbits))
        out = x_t if t == 0 else out
        # sign-sign adaptation, from the last tap down, acting while the
        # error keeps its side (dp_dec.c early exit)
        sg = torch.sign(x_t)
        del0 = x_t
        for k in range(nk - 1, -1, -1):
            going = torch.where(sg > 0, del0 > 0, del0 < 0)
            act = ~in_warm & (sg != 0) & going & (k < na)
            dd = wrap_i32(top - lags[k])
            sgn = torch.sign(dd)
            upd = torch.where(sg > 0, -sgn, sgn)
            coefs[k] = sign_extend(coefs[k] + torch.where(act, upd, 0), 16)
            mag = wrap_i32(sgn * dd)
            term = torch.where(sg > 0, mag >> den, wrap_i32(-mag) >> den)
            del0 = wrap_i32(del0 - torch.where(act, (na - k) * term, 0))
        lags = [out] + lags[:-1]
        outs.append(out)
    samples = torch.stack(outs, dim=1)
    coefs_out = torch.stack(coefs + [coefs0[:, k] for k in
                                     range(nk, coefs0.shape[1])], dim=1)
    if not isinstance(numactive, int):
        na_raw = numactive.to(I64)[:, None]
        samples = torch.where(na_raw == 0, x, torch.where(
            na_raw == 31, _running_sum(x, chanbits), samples))
    return samples.to(I32), coefs_out.to(I32)


def _running_sum(x, chanbits):
    """The decode side of mode 31: the int32 running sum, at chanbits
    (an int or per-lane (B,))."""
    return sign_extend(wrap_i32(torch.cumsum(x, dim=1)), chanbits)
