"""Wrapper of the fused predict + Rice-cost kernel (csrc/cost.cu), the
port of alacjax/ops/pallas/cost_pallas.py: one launch prices every order
of a search.  Plain version: ``plain``, alacjax_torch.ops.predict once
per order."""

from __future__ import annotations

import torch

from ..ops import predict
from ..types import kALACMaxCoefs
from . import LAUNCHES, expect, lane_vector, launch, on_cuda

ORDERS = (4, 8)     # the orders csrc/cost.cu instantiates
MAX_ORDERS = 2      # orders one launch takes


def plain(x, coefs0, orders, chanbits, denshift: int, mb0: int, pb: int,
          kb: int, wb: int, dual: bool = True, num=None):
    """The plain torch version, with the wrapper's signature and results:
    predict.pc_block_cost2 (``dual``) or pc_block_cost_coefs (cost2
    zeros) once per order, from that order's row of a 3-D ``coefs0``,
    stacked."""
    parts = []
    for i, od in enumerate(orders):
        c0 = coefs0[i] if coefs0.dim() == 3 else coefs0
        if dual:
            parts.append(predict.pc_block_cost2(
                x, c0, od, chanbits, denshift, mb0, pb, kb, wb, num=num))
        else:
            res, c1, coefs = predict.pc_block_cost_coefs(
                x, c0, od, chanbits, denshift, mb0, pb, kb, wb, num=num)
            parts.append((res, c1, torch.zeros_like(c1), coefs))
    return tuple(torch.stack(p) for p in zip(*parts))


def pc_block_cost2(x, coefs0, orders, chanbits, denshift: int, mb0: int,
                   pb: int, kb: int, wb: int, dual: bool = True, num=None):
    """(L, S) int32 samples and a tuple of 1 or 2 predictor orders ->
    (residuals (n, L, S), cost1 (n, L), cost2 (n, L), adapted coefs
    (n, L, 16)), all int32, one row per order.  ``coefs0`` is (L, 16),
    every order's starting coefficients, or (n, L, 16), one row block
    per order (persistent coefficient banks).  ``chanbits`` is an int
    or a per-lane (L,) int32 tensor; ``num`` (None or (L,) int32, each
    <= S) stops the cost machines at each lane's sample count.
    ``dual=False`` runs only the first cost machine (the mixres trial,
    fast mode) and returns cost2 as zeros."""
    orders = tuple(orders)
    lane = [t for t in (chanbits, num) if isinstance(t, torch.Tensor)]
    if not on_cuda(x, coefs0, *lane):
        return plain(x, coefs0, orders, chanbits, denshift, mb0, pb, kb, wb,
                     dual, num)
    L, S = x.shape
    dev = x.device
    expect(x, "x", (L, S))
    if not 1 <= len(orders) <= MAX_ORDERS or len(set(orders)) != len(orders) \
            or any(od not in ORDERS for od in orders):
        raise ValueError(f"cost kernel takes 1 to {MAX_ORDERS} distinct "
                         f"orders of {ORDERS}, not {orders}")
    n = len(orders)
    per_order = coefs0.dim() == 3
    expect(coefs0, "coefs0", ((n,) if per_order else ()) + (L, kALACMaxCoefs))
    cb = lane_vector(chanbits, L, dev, "chanbits")
    if num is not None:
        expect(num, "num", (L,))
    res = torch.empty((n, L, S), dtype=torch.int32, device=dev)
    cost1 = torch.empty((n, L), dtype=torch.int32, device=dev)
    cost2 = torch.zeros((n, L), dtype=torch.int32, device=dev)
    coefs = torch.empty((n, L, kALACMaxCoefs), dtype=torch.int32, device=dev)
    launch("alac_cost", x,
           x.data_ptr(), coefs0.data_ptr(), cb.data_ptr(),
           None if num is None else num.data_ptr(), res.data_ptr(),
           cost1.data_ptr(), cost2.data_ptr(), coefs.data_ptr(), L, S,
           orders[0], orders[-1], n, int(dual), denshift,
           L * kALACMaxCoefs if per_order else 0, mb0, pb, kb, wb)
    LAUNCHES["cost"] += 1
    return res, cost1, cost2, coefs
