"""Wrappers of the encode search's stream kernels (csrc/search.cu):
``mix_trial`` and ``mix_streams`` launch ``mix_kernel`` (the mixres
trial's candidate streams of every CPE; the chosen mix of every CPE
written into the search's stacked input), counted under
``LAUNCHES["search_mix"]``; ``pick`` launches ``pick_kernel`` (every
searched lane's winning order and stage, Rice bits and residual row),
counted under ``LAUNCHES["search_pick"]``.  No TPU kernel: they replace
the torch glue of the encode's search (alacjax/codec.py ::
_mixres_select, the mix before the search and _search_channels, XLA
there).  Plain versions: alacjax_torch.ops.search."""

from __future__ import annotations

import ctypes

import torch

from ..ops import search
from . import LAUNCHES, expect, launch, on_cuda

plain_mix_trial = search.mix_trial      # the plain versions, same signatures
plain_mix_streams = search.mix_streams
plain_pick = search.pick
MAX_JOBS = 16                           # csrc/search.cu :: MAX_MIX_JOBS


def _pairs(ls, rs):
    """(B, S) of the (B, S) int32 channel pairs, checked."""
    if not 1 <= len(ls) <= MAX_JOBS or len(rs) != len(ls):
        raise ValueError(f"1 to {MAX_JOBS} channel pairs, got {len(ls)} left "
                         f"and {len(rs)} right")
    B, S = ls[0].shape if ls[0].dim() == 2 else (-1, -1)
    for i, (left, right) in enumerate(zip(ls, rs)):
        expect(left, f"ls[{i}]", (B, S))
        expect(right, f"rs[{i}]", (B, S))
    return B, S


def _mixbits(mixbits: int) -> None:
    if not 0 <= mixbits <= 31:
        raise ValueError(f"mixbits must be in 0..31, got {mixbits}")


def _ptrs(ts):
    """A host array of the tensors' data pointers (None: null)."""
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _rows(out, rows):
    """A host array of the pointers to rows ``rows`` of (R, S) ``out``."""
    base, step = out.data_ptr(), out.shape[1] * out.element_size()
    return (ctypes.c_void_p * len(rows))(*[base + r * step for r in rows])


def mix_trial(ls, rs, mixbits: int, max_res: int, dilate: int):
    """The mixres trial's candidate streams of every CPE (channels
    ``ls[j]``, ``rs[j]``, (B, S) int32) at every ``dilate``-th sample,
    in one launch: per CPE, blocks of B rows L, R, U at mixres
    1..max_res and the shared V, stacked as
    ((max_res + 3) n B, ceil(S / dilate)) int32."""
    ls, rs = tuple(ls), tuple(rs)
    B, S = _pairs(ls, rs)
    _mixbits(mixbits)
    if max_res < 1 or dilate < 1:
        raise ValueError(f"max_res and dilate must be positive, got "
                         f"{max_res}, {dilate}")
    if not on_cuda(*ls, *rs):
        return plain_mix_trial(ls, rs, mixbits, max_res, dilate)
    n = len(ls)
    So = -(-S // dilate)
    blk = (max_res + 3) * B
    out = torch.empty((blk * n, So), dtype=torch.int32, device=ls[0].device)
    launch("alac_search_mix", ls[0], _ptrs(ls), _ptrs(rs), _ptrs([None] * n),
           (ctypes.c_int * n)(), _rows(out, [j * blk for j in range(n)]),
           n, B, S, So, mixbits, max_res, dilate, 1)
    LAUNCHES["search_mix"] += 1
    return out


def mix_streams(ls, rs, mixres, mixbits: int, out=None, rows=None):
    """Each CPE's chosen streams in one launch: pair j (channels
    ``ls[j]``, ``rs[j]``, (B, S) int32) mixed at ``mixres[j]``, an int
    or a per-lane (B,) int64 tensor, U into B rows of ``out`` from row
    ``rows[j]`` and V into the B rows after; (L, R) where mixres is 0.
    ``out`` is (R, S) int32, or None for a new (2 n B, S) tensor with
    the pairs in order (``rows`` is then ignored).  Returns ``out``."""
    ls, rs, mixres = tuple(ls), tuple(rs), tuple(mixres)
    B, S = _pairs(ls, rs)
    _mixbits(mixbits)
    n = len(ls)
    if len(mixres) != n:
        raise ValueError(f"{n} pairs, {len(mixres)} mixres")
    for j, mr in enumerate(mixres):
        if isinstance(mr, int):
            if not -(1 << 31) <= mr < (1 << 31):
                raise ValueError(f"mixres[{j}] {mr} lies outside int32")
        else:
            expect(mr, f"mixres[{j}]", (B,), torch.int64)
    if out is None:
        out = torch.empty((2 * n * B, S), dtype=torch.int32,
                          device=ls[0].device)
        rows = [2 * j * B for j in range(n)]
    else:
        expect(out, "out", (out.shape[0] if out.dim() == 2 else -1, S))
        if rows is None or len(rows) != n:
            raise ValueError(f"out needs the first row of each of {n} pairs")
        at = sorted(rows)
        if at[0] < 0 or at[-1] + 2 * B > out.shape[0] or any(
                b - a < 2 * B for a, b in zip(at, at[1:])):
            raise ValueError(f"pairs of {2 * B} rows from {list(rows)} "
                             f"overlap or lie outside out's {out.shape[0]}")
    lanes = [mr for mr in mixres if not isinstance(mr, int)]
    if not on_cuda(*ls, *rs, *lanes, out):
        return plain_mix_streams(ls, rs, mixres, mixbits, out, rows)
    launch("alac_search_mix", ls[0], _ptrs(ls), _ptrs(rs),
           _ptrs([None if isinstance(mr, int) else mr for mr in mixres]),
           (ctypes.c_int * n)(*[mr if isinstance(mr, int) else 0
                                for mr in mixres]),
           _rows(out, rows), n, B, S, S, mixbits, 0, 1, 0)
    LAUNCHES["search_mix"] += 1
    return out


def pick(res, cost1, cost2, orders, chanbits):
    """Every searched lane's winner in one launch: ``res`` (n, L, S),
    ``cost1`` and ``cost2`` (n, L) int32 (cost2 None: stage 1 alone)
    from the cost kernel at each of the n (1 or 2) ``orders``; the first
    minimum of 16 + 16 order + Rice bits over (order, stage).  Returns
    (the winning residual rows (L, S) int32, their first difference at
    ``chanbits`` (an int or per-lane (L,) int32) where stage 2 won; (3,
    L) int64: order, mode (0, or 15 for stage 2) and Rice bits)."""
    orders = tuple(orders)
    n, L, S = res.shape if res.dim() == 3 else (-1, -1, -1)
    if not 1 <= len(orders) <= 2 or len(set(orders)) != len(orders):
        raise ValueError(f"1 or 2 distinct orders, got {orders}")
    expect(res, "res", (len(orders), L, S))
    expect(cost1, "cost1", (n, L))
    if cost2 is not None:
        expect(cost2, "cost2", (n, L))
    lane = isinstance(chanbits, torch.Tensor)
    if lane:
        expect(chanbits, "chanbits", (L,))
    elif not 1 <= chanbits <= 33:
        raise ValueError(f"chanbits must be in 1..33, got {chanbits}")
    if not on_cuda(res, cost1, cost2, chanbits if lane else None):
        return plain_pick(res, cost1, cost2, orders, chanbits)
    out = torch.empty((L, S), dtype=torch.int32, device=res.device)
    sel = torch.empty((3, L), dtype=torch.int64, device=res.device)
    launch("alac_search_pick", res, res.data_ptr(), cost1.data_ptr(),
           None if cost2 is None else cost2.data_ptr(),
           chanbits.data_ptr() if lane else None, out.data_ptr(),
           sel.data_ptr(), L, S, n, orders[0], orders[-1],
           0 if lane else chanbits)
    LAUNCHES["search_pick"] += 1
    return out, sel
