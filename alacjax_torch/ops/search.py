"""The encode search's stream glue in plain torch: the reference that
csrc/search.cu is held to, and the CPU path of ``kernels.search``.

The stereo mixes of every CPE (the mixres trial's dilated candidate
streams, and the chosen mix of each CPE written into the search's
stacked input), then each searched stream's winning (order, stage) and
its residual row (alacjax/codec.py :: _mixres_select, the mix before the
search and _search_channels).  The ints (mixbits, a constant mixres,
chanbits) stay Python ints, so nothing here copies a number to the
device.  Arithmetic is int64 wrapped to int32, as ops/matrix.py :: mix.
"""

from __future__ import annotations

import torch

from .predict import wrap_diff
from .tutils import I32, I64, wrap_i32


def _i32(v: int) -> int:
    """A Python int wrapped to the int32 value it stands for."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def mix_pair(left, right, mixbits: int, mixres):
    """matrix.mix with ``mixbits`` an int and ``mixres`` an int or a
    per-lane (B,) tensor: (U, V) int32, (L, R) where mixres == 0."""
    l = wrap_i32(left)
    r = wrap_i32(right)
    if isinstance(mixres, int):
        if mixres == 0:
            return l.to(I32), r.to(I32)
        m2 = _i32((1 << mixbits) - mixres)
        u = wrap_i32(_i32(mixres) * l + m2 * r) >> mixbits
        return u.to(I32), wrap_i32(l - r).to(I32)
    mr = mixres.to(I64)[:, None]
    m2 = wrap_i32((1 << mixbits) - mr)
    u_mixed = wrap_i32(wrap_i32(mr) * l + m2 * r) >> mixbits
    mixed = mr != 0
    return (torch.where(mixed, u_mixed, l).to(I32),
            torch.where(mixed, wrap_i32(l - r), r).to(I32))


def mix_trial(ls, rs, mixbits: int, max_res: int, dilate: int):
    """The mixres trial's candidate streams of every CPE (channels
    ``ls[j]``, ``rs[j]``, (B, S) int32), at every ``dilate``-th sample:
    per CPE, blocks of B rows L, R, U at mixres 1..max_res, then the
    shared V, stacked: ((max_res + 3) n B, ceil(S / dilate)) int32."""
    cand = []
    for left, right in zip(ls, rs):
        ld = left[:, ::dilate]
        rd = right[:, ::dilate]
        cand += [ld, rd]                                 # mixres 0
        cand += [mix_pair(ld, rd, mixbits, mr)[0]
                 for mr in range(1, max_res + 1)]
        cand.append(wrap_i32(ld.to(I64) - rd.to(I64)).to(I32))
    return torch.cat(cand, dim=0).contiguous()


def mix_streams(ls, rs, mixres, mixbits: int, out=None, rows=None):
    """Each CPE's chosen streams, U then V, B rows each of ``out``
    ((R, S) int32, or a new (2 n B, S) tensor if None), which it
    returns: pair j from row ``rows[j]`` (with a new ``out``, the pairs
    in order), at ``mixres[j]``, an int or a per-lane (B,) int64
    tensor."""
    B, S = ls[0].shape
    if out is None:
        out = torch.empty((2 * len(ls) * B, S), dtype=I32,
                          device=ls[0].device)
        rows = [2 * j * B for j in range(len(ls))]
    for left, right, mr, row in zip(ls, rs, mixres, rows):
        u, v = mix_pair(left, right, mixbits, mr)
        out[row:row + B] = u
        out[row + B:row + 2 * B] = v
    return out


def pick(res, cost1, cost2, orders, chanbits):
    """Every searched lane's winner: ``res`` (n, L, S), ``cost1`` and
    ``cost2`` (n, L) (cost2 None: stage 1 alone) from the cost machines
    at each of the n ``orders``; candidate cost 16 + 16 order + Rice bits
    over (order, stage) in that order, the first minimum winning.
    Returns (the winning residual rows (L, S) int32, their first
    difference at ``chanbits`` (an int or per-lane (L,)) where stage 2
    won; (3, L) int64: order, mode (0, or 15 for stage 2) and Rice
    bits)."""
    L = res.shape[1]
    cand = []
    for i, od in enumerate(orders):
        for mode, rc in ((0, cost1[i]),) + (() if cost2 is None
                                            else ((15, cost2[i]),)):
            cand.append((od, mode, rc.to(I64)))
    win = torch.argmin(torch.stack([16 + 16 * od + rc
                                    for od, _, rc in cand]), dim=0)
    rice = torch.gather(torch.stack([rc for *_, rc in cand]), 0,
                        win[None, :])[0]
    order = torch.full((L,), orders[0], dtype=I64, device=res.device)
    mode = torch.zeros((L,), dtype=I64, device=res.device)
    for ki, (od, md, _) in enumerate(cand):
        hit = win == ki
        order = torch.where(hit, od, order)
        mode = torch.where(hit, md, mode)
    res_win = res[0]
    for i, od in enumerate(orders[1:], start=1):
        res_win = torch.where((order == od)[:, None], res[i], res_win)
    if cost2 is not None:
        res_win = torch.where((mode != 0)[:, None],
                              wrap_diff(res_win, chanbits), res_win)
    return res_win.to(I32), torch.stack([order, mode, rice])
