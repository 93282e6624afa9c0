"""The work counts behind chip_smoke.py's kernel bounds: the plain
versions count the samples their Rice machines code and the steps their
sign-sign walks take (alacjax_torch.ops.tutils.WORK), and chip_smoke.work
prices each decode lane's walk at its own order, not at the instance's
width.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.ops import fused_decode, predict, rice, tutils
from alacjax_torch.types import KB0, MB0, PB0
from test_torch_port import channel0_lanes

S = 128
WB = (1 << KB0) - 1


def counted(fn, *args, **kwargs):
    """(fn's result, the WORK dict of what it counted)."""
    tutils.WORK = {}
    try:
        out = fn(*args, **kwargs)
        return out, tutils.WORK
    finally:
        tutils.WORK = None


def decode_args(lane, words):
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    return (torch.from_numpy(words.view(np.int32)), t["start"], S, t["cb"],
            MB0, t["pb"], KB0, WB, t["coefs"], t["mode"], t["order"],
            t["den"]), t["num"]


def test_rice_machines_count_every_coded_sample():
    """A machine codes every nonzero sample up to the lane's count and
    none past it; an all-zero lane sits in a zero run."""
    rng = np.random.default_rng(5)
    x = rng.integers(1, 400, (4, S)) * rng.choice([-1, 1], (4, S))
    x[3] = 0
    num = torch.tensor([S, 77, 1, S], dtype=torch.int32)
    _, counts = counted(rice.rice_cost, torch.from_numpy(x.astype(np.int32)),
                        16, MB0, PB0, KB0, WB, num=num)
    assert S + 77 + 1 < tutils.work_total(counts, "coded") < S + 77 + 1 + 8
    assert tutils.WORK is None


@pytest.mark.parametrize("order,mode", [(4, 0), (8, 15), (16, 0), (24, 15),
                                        (30, 0)])
def test_decode_walk_takes_the_encoders_steps(order, mode):
    """The decode's sign-sign walk mirrors the encoder's: decoding a
    forced-order packet at 30 taps counts as many walk steps as the
    encoder's walk over the decoded samples from the packet's
    coefficients."""
    words, lane, _ = channel0_lanes(chip_smoke.forced_order_packet,
                                    [(16, 1, order, mode, S)], S, order)
    args, num = decode_args(lane, words)
    (samples, _, err), dec = counted(fused_decode.decode_channel, *args,
                                     num=num, taps=30, chanbits_max=16)
    assert not err.any()
    coefs = torch.from_numpy(lane["coefs"])
    _, enc = counted(predict._scan_cost, samples, coefs, order, 16,
                     int(lane["den"][0]), None, dual=False)
    taps = tutils.work_total(dec, "taps")
    assert taps == tutils.work_total(enc, "taps") > 0
    assert tutils.work_total(dec, "coded") == S


def test_bound_prices_each_lane_at_its_own_order():
    """chip_smoke.work counts a decode lane's walk at the lane's order:
    the same lanes cost as much at 16 taps as at 30, and a higher order
    costs more."""
    spec = [(16, 1, order, 0, S) for order in (9, 12, 16)]
    words, lane, _ = channel0_lanes(chip_smoke.forced_order_packet, spec, S,
                                    3)
    args, num = decode_args(lane, words)
    ops = {}
    for taps in (16, 30):
        kw = dict(num=num, taps=taps, chanbits_max=16)
        got, counts = counted(fused_decode.decode_channel, *args, **kw)
        call = ("decode_hi", k_decode.decode_channel, None, args, kw)
        _, ops[taps], lane_samples = chip_smoke.work(call, got, counts)
        assert lane_samples == len(spec) * S
    assert ops[16] == ops[30]
    one = []
    for b in range(len(spec)):
        sub = tuple(a[b:b + 1] if isinstance(a, torch.Tensor) else a
                    for a in args)
        kw = dict(num=num[b:b + 1], taps=30, chanbits_max=16)
        got, counts = counted(fused_decode.decode_channel, *sub, **kw)
        call = ("decode_hi", k_decode.decode_channel, None, sub, kw)
        one.append(chip_smoke.work(call, got, counts)[1])
    assert sum(one) == ops[30]
    assert one[0] < one[2]
