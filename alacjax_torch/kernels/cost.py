"""Wrapper of the fused predict + Rice-cost kernel (csrc/cost.cu), the
port of alacjax/ops/pallas/cost_pallas.py.  Plain version:
alacjax_torch.ops.predict."""

from __future__ import annotations

import torch

from alacjax.types import kALACMaxCoefs

from ..ops import predict
from . import LAUNCHES, expect, lane_vector, on_cuda, stream_ptr
from ._build import check, lib

ORDERS = (4, 8)     # the orders csrc/cost.cu instantiates


def plain(x, coefs0, order: int, chanbits, denshift: int, mb0: int,
          pb: int, kb: int, wb: int, dual: bool = True, num=None):
    """The plain torch version, with the wrapper's signature and results."""
    if dual:
        return predict.pc_block_cost2(x, coefs0, order, chanbits, denshift,
                                      mb0, pb, kb, wb, num=num)
    res, c1, coefs = predict.pc_block_cost_coefs(
        x, coefs0, order, chanbits, denshift, mb0, pb, kb, wb, num=num)
    return res, c1, torch.zeros_like(c1), coefs


def pc_block_cost2(x, coefs0, order: int, chanbits, denshift: int,
                   mb0: int, pb: int, kb: int, wb: int, dual: bool = True,
                   num=None):
    """(L, S) int32 samples -> (residuals (L, S), cost1 (L,), cost2 (L,),
    adapted coefs (L, 16)), all int32.  ``chanbits`` is an int or a
    per-lane (L,) int32 tensor; ``num`` (None or (L,) int32, each <= S)
    stops the cost machines at each lane's sample count.  ``dual=False``
    runs only the first cost machine (the mixres trial, fast mode) and
    returns cost2 as zeros."""
    lane = [t for t in (chanbits, num) if isinstance(t, torch.Tensor)]
    if not on_cuda(x, coefs0, *lane):
        return plain(x, coefs0, order, chanbits, denshift, mb0, pb, kb, wb,
                     dual, num)
    L, S = x.shape
    dev = x.device
    expect(x, "x", (L, S))
    expect(coefs0, "coefs0", (L, kALACMaxCoefs))
    if order not in ORDERS:
        raise ValueError(f"cost kernel is built for orders {ORDERS}, "
                         f"not {order}")
    cb = lane_vector(chanbits, L, dev, "chanbits")
    if num is not None:
        expect(num, "num", (L,))
    xt = x.t().contiguous()                 # (S, L): a warp's loads coalesce
    res_t = torch.empty((S, L), dtype=torch.int32, device=dev)
    cost1 = torch.empty((L,), dtype=torch.int32, device=dev)
    cost2 = torch.zeros((L,), dtype=torch.int32, device=dev)
    coefs = torch.empty((L, kALACMaxCoefs), dtype=torch.int32, device=dev)
    status = lib().alac_cost(
        xt.data_ptr(), coefs0.data_ptr(), cb.data_ptr(),
        None if num is None else num.data_ptr(), res_t.data_ptr(),
        cost1.data_ptr(), cost2.data_ptr(), coefs.data_ptr(), L, S, order,
        int(dual), denshift, mb0, pb, kb, wb, stream_ptr(x))
    check(status, "alac_cost")
    LAUNCHES["cost"] += 1
    return res_t.t().contiguous(), cost1, cost2, coefs
