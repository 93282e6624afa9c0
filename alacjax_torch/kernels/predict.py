"""Wrappers of the standalone predictor kernel and its cost-only Rice
pass (csrc/predict.cu): ``pc_block`` is the port of
alacjax/ops/pallas/predict_pallas.py, one launch for one order or for
every order of a search, and counts under ``LAUNCHES["predict"]``;
``rice_cost`` prices its residuals (the XLA scan rice.rice_cost in
alacjax) and, with ``dual``, their first difference in the same launch,
and counts under ``LAUNCHES["rice_cost"]``.  Both read and write (L, S)
as they are.  Plain versions: ``plain_pc_block`` and
``plain_rice_cost``, on alacjax_torch.ops.predict.pc_block and
alacjax_torch.ops.rice.rice_cost.
"""

from __future__ import annotations

import torch

from ..types import kALACMaxCoefs

from ..ops import predict, rice
from . import LAUNCHES, expect, lane_vector, launch, on_cuda

ORDERS = tuple(range(1, kALACMaxCoefs + 1))   # csrc/predict.cu's instances
MAX_ORDERS = 2                                # orders one launch takes


def plain_pc_block(x, coefs0, order, chanbits, denshift: int):
    """The plain version, with the wrapper's signature and results:
    predict.pc_block at ``order``, or once per order of a tuple, from
    that order's block of a 3-D ``coefs0``, stacked."""
    if isinstance(order, int):
        return predict.pc_block(x, coefs0, order, chanbits, denshift)
    parts = [predict.pc_block(x, coefs0[i] if coefs0.dim() == 3 else coefs0,
                              od, chanbits, denshift)
             for i, od in enumerate(order)]
    return tuple(torch.stack(p) for p in zip(*parts))


def pc_block(x, coefs0, order, chanbits, denshift: int, cycles=None):
    """(L, S) int32 samples -> (residuals (L, S), adapted coefs (L, 16)),
    int32: the adaptive FIR predictor at a static order 1..16 with no
    cost machine.  ``order`` a tuple of 1 or 2 distinct orders gives
    (residuals (n, L, S), coefs (n, L, 16)), one row per order, from one
    launch; ``coefs0`` is then (L, 16), every order's starting
    coefficients, or (n, L, 16), one block per order.  ``chanbits`` is an
    int or a per-lane (L,) int32 tensor.  ``cycles`` (CUDA only: an
    (n, ceil(L / 32)) int64 tensor) receives each walker warp's clock64
    cycles inside its walk."""
    lane = [chanbits] if isinstance(chanbits, torch.Tensor) else []
    if not on_cuda(x, coefs0, *lane):
        return plain_pc_block(x, coefs0, order, chanbits, denshift)
    orders = (order,) if isinstance(order, int) else tuple(order)
    if not 1 <= len(orders) <= MAX_ORDERS or len(set(orders)) != len(orders) \
            or any(od not in ORDERS for od in orders):
        raise ValueError(f"predict kernel takes 1 to {MAX_ORDERS} distinct "
                         f"orders of 1..16, not {order}")
    L, S = x.shape
    dev = x.device
    n = len(orders)
    expect(x, "x", (L, S))
    per_order = coefs0.dim() == 3
    if per_order and isinstance(order, int):
        raise ValueError("one order takes one (L, 16) block of coefs0")
    expect(coefs0, "coefs0", ((n,) if per_order else ()) + (L, kALACMaxCoefs))
    cb = lane_vector(chanbits, L, dev, "chanbits")
    if cycles is not None:
        expect(cycles, "cycles", (n, -(-L // 32)), torch.int64)
    res = torch.empty((n, L, S), dtype=torch.int32, device=dev)
    coefs = torch.empty((n, L, kALACMaxCoefs), dtype=torch.int32, device=dev)
    launch("alac_predict", x,
           x.data_ptr(), coefs0.data_ptr(), cb.data_ptr(), res.data_ptr(),
           coefs.data_ptr(), None if cycles is None else cycles.data_ptr(),
           L, S, orders[0], orders[-1], n, denshift,
           L * kALACMaxCoefs if per_order else 0)
    LAUNCHES["predict"] += 1
    if isinstance(order, int):
        return res[0], coefs[0]
    return res, coefs


def plain_rice_cost(res, bit_size, mb0: int, pb: int, kb: int, wb: int,
                    num=None, dual: bool = False):
    """The plain version, with the wrapper's signature and results:
    rice.rice_cost, and with ``dual`` also of predict.wrap_diff(res),
    stacked."""
    cost = rice.rice_cost(res, bit_size, mb0, pb, kb, wb, num=num)
    if not dual:
        return cost
    return torch.stack([cost, rice.rice_cost(predict.wrap_diff(res, bit_size),
                                             bit_size, mb0, pb, kb, wb,
                                             num=num)])


def rice_cost(res, bit_size, mb0: int, pb: int, kb: int, wb: int,
              num=None, dual: bool = False):
    """(L, S) int32 residuals -> (L,) int32 Rice bits per lane, or with
    ``dual`` (2, L): those of the residuals and of their first difference
    (the two-stage candidate), from one launch.  ``bit_size`` (also the
    difference's width) is an int or a per-lane (L,) int32 tensor;
    ``num`` (None or (L,) int32, each <= S) prices only each lane's first
    num samples."""
    lane = [t for t in (bit_size, num) if isinstance(t, torch.Tensor)]
    if not on_cuda(res, *lane):
        return plain_rice_cost(res, bit_size, mb0, pb, kb, wb, num=num,
                               dual=dual)
    L, S = res.shape
    dev = res.device
    expect(res, "res", (L, S))
    cb = lane_vector(bit_size, L, dev, "bit_size")
    if num is not None:
        expect(num, "num", (L,))
    cost = torch.empty((2, L) if dual else (L,), dtype=torch.int32,
                       device=dev)
    launch("alac_rice_cost", res,
           res.data_ptr(), cb.data_ptr(),
           None if num is None else num.data_ptr(), cost.data_ptr(), L, S,
           int(dual), mb0, pb, kb, wb)
    LAUNCHES["rice_cost"] += 1
    return cost
