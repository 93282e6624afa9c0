"""Wrapper of the fused predict + Rice-cost kernel (csrc/cost.cu), the
port of alacjax/ops/pallas/cost_pallas.py.  Plain version:
alacjax_torch.ops.predict."""

from __future__ import annotations

import torch

from alacjax.types import kALACMaxCoefs

from ..ops import predict
from . import LAUNCHES, expect, on_cuda, stream_ptr
from ._build import check, lib

ORDERS = (4, 8)     # the orders csrc/cost.cu instantiates


def plain(x, coefs0, order: int, chanbits: int, denshift: int, mb0: int,
          pb: int, kb: int, wb: int, dual: bool = True):
    """The plain torch version, with the wrapper's signature and results."""
    if dual:
        return predict.pc_block_cost2(x, coefs0, order, chanbits, denshift,
                                      mb0, pb, kb, wb)
    res, c1, coefs = predict.pc_block_cost_coefs(
        x, coefs0, order, chanbits, denshift, mb0, pb, kb, wb)
    return res, c1, torch.zeros_like(c1), coefs


def pc_block_cost2(x, coefs0, order: int, chanbits: int, denshift: int,
                   mb0: int, pb: int, kb: int, wb: int, dual: bool = True):
    """(L, S) int32 samples -> (residuals (L, S), cost1 (L,), cost2 (L,),
    adapted coefs (L, 16)), all int32.  ``dual=False`` runs only the
    first cost machine (the mixres trial) and returns cost2 as zeros."""
    if not on_cuda(x, coefs0):
        return plain(x, coefs0, order, chanbits, denshift, mb0, pb, kb, wb,
                     dual)
    L, S = x.shape
    expect(x, "x", (L, S))
    expect(coefs0, "coefs0", (L, kALACMaxCoefs))
    if order not in ORDERS:
        raise ValueError(f"cost kernel is built for orders {ORDERS}, "
                         f"not {order}")
    xt = x.t().contiguous()                 # (S, L): a warp's loads coalesce
    res_t = torch.empty((S, L), dtype=torch.int32, device=x.device)
    cost1 = torch.empty((L,), dtype=torch.int32, device=x.device)
    cost2 = torch.zeros((L,), dtype=torch.int32, device=x.device)
    coefs = torch.empty((L, kALACMaxCoefs), dtype=torch.int32, device=x.device)
    status = lib().alac_cost(
        xt.data_ptr(), coefs0.data_ptr(), res_t.data_ptr(), cost1.data_ptr(),
        cost2.data_ptr(), coefs.data_ptr(), L, S, order, int(dual),
        chanbits, denshift, mb0, pb, kb, wb, stream_ptr(x))
    check(status, "alac_cost")
    LAUNCHES["cost"] += 1
    return res_t.t().contiguous(), cost1, cost2, coefs
