"""Wrappers of the standalone predictor kernel and its cost-only Rice
pass (csrc/predict.cu): ``pc_block`` is the port of
alacjax/ops/pallas/predict_pallas.py and counts under
``LAUNCHES["predict"]``; ``rice_cost`` prices its residuals (the XLA
scan rice.rice_cost in alacjax) and counts under
``LAUNCHES["rice_cost"]``.  Plain versions:
alacjax_torch.ops.predict.pc_block and alacjax_torch.ops.rice.rice_cost.
"""

from __future__ import annotations

import torch

from ..types import kALACMaxCoefs

from ..ops import predict, rice
from . import LAUNCHES, expect, lane_vector, launch, on_cuda

ORDERS = tuple(range(1, kALACMaxCoefs + 1))   # csrc/predict.cu's instances


plain_pc_block = predict.pc_block       # the plain version, same signature


def pc_block(x, coefs0, order: int, chanbits, denshift: int):
    """(L, S) int32 samples -> (residuals (L, S), adapted coefs (L, 16)),
    int32: the adaptive FIR predictor at a static order 1..16 with no
    cost machine.  ``chanbits`` is an int or a per-lane (L,) int32
    tensor."""
    lane = [chanbits] if isinstance(chanbits, torch.Tensor) else []
    if not on_cuda(x, coefs0, *lane):
        return plain_pc_block(x, coefs0, order, chanbits, denshift)
    L, S = x.shape
    dev = x.device
    expect(x, "x", (L, S))
    expect(coefs0, "coefs0", (L, kALACMaxCoefs))
    if order not in ORDERS:
        raise ValueError(f"predict kernel is built for orders 1..16, "
                         f"not {order}")
    cb = lane_vector(chanbits, L, dev, "chanbits")
    xt = x.t().contiguous()                 # (S, L): a warp's loads coalesce
    res_t = torch.empty((S, L), dtype=torch.int32, device=dev)
    coefs = torch.empty((L, kALACMaxCoefs), dtype=torch.int32, device=dev)
    launch("alac_predict", x,
           xt.data_ptr(), coefs0.data_ptr(), cb.data_ptr(), res_t.data_ptr(),
           coefs.data_ptr(), L, S, order, denshift)
    LAUNCHES["predict"] += 1
    return res_t.t().contiguous(), coefs


plain_rice_cost = rice.rice_cost        # the plain version, same signature


def rice_cost(res, bit_size, mb0: int, pb: int, kb: int, wb: int,
              num=None):
    """(L, S) int32 residuals -> (L,) int32 Rice bits per lane.
    ``bit_size`` is an int or a per-lane (L,) int32 tensor; ``num`` (None
    or (L,) int32, each <= S) prices only each lane's first num
    samples."""
    lane = [t for t in (bit_size, num) if isinstance(t, torch.Tensor)]
    if not on_cuda(res, *lane):
        return plain_rice_cost(res, bit_size, mb0, pb, kb, wb, num=num)
    L, S = res.shape
    dev = res.device
    expect(res, "res", (L, S))
    cb = lane_vector(bit_size, L, dev, "bit_size")
    if num is not None:
        expect(num, "num", (L,))
    xt = res.t().contiguous()
    cost = torch.empty((L,), dtype=torch.int32, device=dev)
    launch("alac_rice_cost", res,
           xt.data_ptr(), cb.data_ptr(),
           None if num is None else num.data_ptr(), cost.data_ptr(), L, S,
           mb0, pb, kb, wb)
    LAUNCHES["rice_cost"] += 1
    return cost
