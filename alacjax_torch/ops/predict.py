"""Batched adaptive FIR predictor, encode side, fused with adaptive-Rice
cost machines (counterpart of alacjax/ops/predict.py; oracle:
alacjax.oracle.dp; reference: codec/dp_enc.c).

The recurrence is sequential in the sample axis, so the plain version
is a Python loop over S with every lane in a (B,) tensor.  It is the
version the cost kernel (alacjax_torch/kernels/cost.py) is held to.
The order is a static int (the encoder's search runs one call per
order, as the TPU path does); chanbits and denshift are static too.
Arithmetic is int64 wrapped to int32 wherever the reference's int32
wraps can be observed (a sign, a compare or a shift).
"""

from __future__ import annotations

import torch

from . import rice
from .tutils import I32, I64, iota1, sign_extend, wrap_i32


def _scan_cost(x, coefs0, na: int, chanbits: int, denshift: int, mb0: int,
               pb: int, kb: int, wb: int, dual: bool):
    """predict._scan_general, encode branch with one or two cost
    machines.  Returns (res (B,S) i32, coefs (B,16) i32, cost1 (B,) i32,
    cost2 (B,) i32 or None)."""
    B, S = x.shape
    dev = x.device
    x = wrap_i32(x)
    coefs0 = coefs0.to(I64)
    den = max(int(denshift), 1)
    denhalf = 1 << (den - 1)
    zero = torch.zeros((B,), dtype=I64, device=dev)
    lags = torch.zeros((B, na + 1), dtype=I64, device=dev)
    coefs = sign_extend(coefs0[:, :na], 16)
    weight = na - iota1(na, device=dev)[None, :]   # (na - k) per tap
    kw = dict(S=S, bit_size=chanbits, pb=pb, kb=kb, wb=wb)
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
            upd = torch.where(torch.stack(acts, dim=1),
                              torch.where(pos, -sgn, sgn), 0)
            coefs = sign_extend(coefs + upd, 16)
        lags = torch.cat([x_t[:, None], lags[:, :na]], dim=1)

        st1, bits = rice.step_bits(out, t, st1, **kw)
        tot1 = tot1 + bits
        if dual:
            d = out if t == 0 else sign_extend(out - prev_out, chanbits)
            st2, bits = rice.step_bits(d, t, st2, **kw)
            tot2 = tot2 + bits
            prev_out = out

    # virtual end step (t == S): flush a pending zero-run token
    one = zero + 1
    _, bits = rice.step_bits(one, S, st1, **kw)
    cost1 = (tot1 + bits).to(I32)
    cost2 = None
    if dual:
        _, bits = rice.step_bits(one, S, st2, **kw)
        cost2 = (tot2 + bits).to(I32)
    res = torch.stack(out_cols, dim=1).to(I32)
    coefs = torch.cat([coefs, coefs0[:, na:]], dim=1).to(I32)
    return res, coefs, cost1, cost2


def pc_block_cost_coefs(x, coefs0, numactive: int, chanbits: int,
                        denshift: int, mb0: int, pb: int, kb: int, wb: int):
    """Fused forward prediction + Rice cost of the residuals (one machine,
    the mixres trial's route): (B, S) samples -> (residuals (B, S),
    cost (B,), adapted coefs (B, 16))."""
    res, coefs, c1, _ = _scan_cost(x, coefs0, numactive, chanbits, denshift,
                                   mb0, pb, kb, wb, dual=False)
    return res, c1, coefs


def pc_block_cost(x, coefs0, numactive: int, chanbits: int, denshift: int,
                  mb0: int, pb: int, kb: int, wb: int):
    """(B, S) samples -> (residuals (B, S), rice cost bits (B,))."""
    res, cost, _ = pc_block_cost_coefs(x, coefs0, numactive, chanbits,
                                       denshift, mb0, pb, kb, wb)
    return res, cost


def pc_block_cost2(x, coefs0, numactive: int, chanbits: int, denshift: int,
                   mb0: int, pb: int, kb: int, wb: int):
    """Fused forward prediction + Rice cost of BOTH stage candidates:
    (B, S) samples -> (residuals (B, S), cost1 (B,), cost2 (B,),
    coefs (B, 16)).  cost1 prices the FIR residuals (mode 0), cost2
    their first difference (mode != 0, the two-stage cascade)."""
    res, coefs, c1, c2 = _scan_cost(x, coefs0, numactive, chanbits,
                                    denshift, mb0, pb, kb, wb, dual=True)
    return res, c1, c2, coefs


def wrap_diff(res, chanbits: int):
    """Stage-2 emission residual: pc_block(res, 31) == first difference
    with chanbits wraparound (dp_enc.c :: pc_block numactive==31)."""
    res = wrap_i32(res)
    diffs = sign_extend(res[:, 1:] - res[:, :-1], chanbits)
    return torch.cat([res[:, :1], diffs], dim=1).to(I32)
