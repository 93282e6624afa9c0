"""The adaptive FIR walk of the fused channel decode (csrc/decode.cu's FIR
warp: the 8-, 16- and 30-tap instances) on inputs made for it:
tests/torch_decode_cases.py :: fir_lanes.  Small residuals, coded into
each lane's row by the Rice coder, keep the sign-sign adaptation going
deep, so the walk stops at every tap; warps of one order and of mixed
orders; every denshift 1..15; coefficients at the 16-bit limits;
samples that wrap at chanbits 32 and vanish at 33; counts below the
order (the warm-up cut); modes 0, 15 and 31 and the order-0 and
order-31 overlays.

On the CPU the port's plain decode_channel (the kernel's reference)
equals alacjax's decode_channel on those lanes at each tap count, bit
for bit, and the plain version's own count of the taps that act in
each step (``tutils.WORK["stops"]``) shows every count 0..na_k reached
for every order of the case.

The tests marked ``cuda`` hold each instance to its plain version on the
card, on the same lanes and on 4096 lanes of 4096 samples (128 coded
lanes tiled), with and without ``num``, and with every warp's largest
order 1..taps (so every walk width and every length of the warm-up).  The card's machine has no jax,
so run them there without the test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_fir_walk.py
"""

import numpy as np
import pytest
import torch

from alacjax_torch import kernels
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.ops import fused_decode as tfd
from alacjax_torch.ops import tutils
from torch_decode_cases import RICE, fir_lanes, tile_lanes

TAPS = (8, 16, 30)
L, S = 256, 256


def _case(taps, L=L, S=S, device="cpu", tile=1):
    words, lane = fir_lanes(np.random.default_rng(taps), L, S, taps)
    words, lane = tile_lanes(words, lane, tile)
    t = {k: torch.from_numpy(v).to(device) for k, v in lane.items()}
    return words, lane, torch.from_numpy(words.view(np.int32)).to(device), t


def _args(w, t, S, taps, num=True):
    mb0, kb, wb = RICE
    return ((w, t["start"], S, t["cb"], mb0, t["pb"], kb, wb, t["coefs"],
             t["mode"], t["order"], t["den"]),
            dict(num=t["num"] if num else None, taps=taps, chanbits_max=33))


def _jax_rows(words, end_bits):
    """Each lane's row as alacjax reads it: extended by copies of its
    last word (the port clamps a read past the row, alacjax pads with
    zeros) to 8 words past the furthest end bit."""
    width = max(words.shape[1], int(end_bits.max()) // 32 + 8)
    ext = np.repeat(words[:, -1:], width - words.shape[1], axis=1)
    return np.concatenate([words, ext], axis=1)


@pytest.fixture(scope="module")
def jax_ref():
    import jax.numpy as jnp

    from alacjax.ops import fused_decode as jfd
    return jnp, jfd


@pytest.fixture(scope="module", params=TAPS, ids=[f"taps{n}" for n in TAPS])
def plain_run(request):
    """(taps, case, the plain decode's outputs, its stop counts (L,
    taps + 1): steps of each lane in which 0..taps taps acted)."""
    taps = request.param
    words, lane, w, t = _case(taps)
    args, kw = _args(w, t, S, taps)
    tutils.WORK = {}
    try:
        got = tfd.decode_channel(*args, **kw)
        stops = tutils.WORK[("stops", (L, taps + 1))].numpy()
    finally:
        tutils.WORK = None
    return taps, (words, lane), got, stops


def test_plain_fir_walk_matches_jax(jax_ref, plain_run):
    jnp, jfd = jax_ref
    taps, (words, lane), got, _ = plain_run
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    mb0, kb, wb = RICE
    want = jfd.decode_channel(
        jnp.asarray(_jax_rows(words, got[1].numpy())), j["start"], S,
        j["cb"], mb0, j["pb"], kb, wb, j["coefs"], j["mode"], j["order"],
        j["den"], chanbits_max=33, taps=taps, num=j["num"])
    for name, g, x in zip(("samples", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                      err_msg=name)


def test_every_stop_tap_is_reached(plain_run):
    """For every order of the case (clamped to the walk), the steps that
    may adapt see each count of acting taps 0..na_k: the walk stops at
    every tap, runs through all of them, or (a zero error) does not
    start."""
    taps, (_, lane), _, stops = plain_run
    order = lane["order"]
    na_k = np.minimum(np.clip(order, 1, 30), taps)
    walks = (order != 0) & (order != 31)
    orders = sorted(set(na_k[walks].tolist()))
    assert taps in orders and 4 in orders and len(orders) >= 8
    for o in orders:
        seen = stops[walks & (na_k == o)].sum(axis=0)
        missing = [n for n in range(o + 1) if seen[n] == 0]
        assert not missing, f"order {o}: no step with {missing} taps acting"
        assert not seen[o + 1:].any()


def test_fir_lanes_cover_the_walk(plain_run):
    """The lanes are what the docstring says: one-order warps and mixed
    warps, every denshift, the coefficient limits, wrapping samples at
    chanbits 32, counts inside the warm-up, every mode and overlay."""
    taps, (words, lane), (samples, _, err), _ = plain_run
    order = lane["order"]
    assert (order[:32] == taps).all() and (order[32:64] == 4).all()
    assert all(len(set(order[w:w + 32])) > 4 for w in range(64, L, 32))
    assert set(lane["den"]) == set(range(1, 16))
    assert {-32768, 32767} <= set(lane["coefs"].ravel().tolist())
    assert {0, 15, 31} == set(lane["mode"].tolist())
    assert {0, 31} <= set(order.tolist())
    na_k = np.minimum(np.clip(order, 1, 30), taps)
    assert (lane["num"] <= na_k).any() and (lane["num"] == 0).any()
    wide = (lane["cb"] == 32) & (lane["mode"] == 0) & (order != 0)
    assert (np.abs(samples.numpy()[wide].astype(np.int64)) >= 1 << 30).any()
    # at chanbits 33 every sign extension gives 0: only step 0 (and the
    # order-0 pass-through of mode 0) carry a residual
    vanish = (lane["cb"] == 33) & (order != 0)
    assert vanish.any() and (samples.numpy()[vanish][:, 1:] == 0).all()
    assert err.numpy()[(order > taps) & (order != 31)].all()


# ---------------------------------------------------------------------------
# on the card: each instance against its plain version, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


# (lanes coded, samples, tiles): 256 x 256, and 4096 x 4096 tiled
CARD_CASES = [(L, S, 1), (128, 4096, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("num", [True, False], ids=["num", "S"])
@pytest.mark.parametrize("taps", TAPS, ids=[f"taps{n}" for n in TAPS])
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=[f"L{n * k}-S{s}" for n, s, k in CARD_CASES])
def test_fir_walk_kernel_on_card(cuda, case, taps, num):
    n, s, tile = case
    _, _, w, t = _case(taps, n, s, device=cuda, tile=tile)
    args, kw = _args(w, t, s, taps, num)
    want = k_decode.plain(*args, **kw)
    kernels.reset_launches()
    got = k_decode.decode_channel(*args, **kw)
    assert kernels.LAUNCHES[k_decode.counter(taps)] == 1
    for name, g, x in zip(("samples", "end_bits", "err"), got, want):
        assert torch.equal(g.cpu(), x.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("taps", TAPS, ids=[f"taps{n}" for n in TAPS])
def test_fir_walk_every_warp_width_on_card(cuda, taps):
    """A warp walks at the narrowest width that covers its lanes' orders
    and starts its unrolled steps after the warm-up of its largest
    order: for every largest order 1..taps (lanes of orders 1..cap, one
    lane at cap in each warp), the kernel equals its plain version."""
    n, s = 64, 128
    _, _, w, t = _case(taps, n, s, device=cuda)
    for cap in range(1, taps + 1):
        order = np.random.default_rng(cap).integers(1, cap + 1, n)
        order[::32] = cap
        t["order"] = torch.from_numpy(order.astype(np.int32)).to(cuda)
        for num in (True, False):
            args, kw = _args(w, t, s, taps, num)
            got = k_decode.decode_channel(*args, **kw)
            want = k_decode.plain(*args, **kw)
            for name, g, x in zip(("samples", "end_bits", "err"), got, want):
                assert torch.equal(g, x), (cap, num, name)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", TAPS, ids=[f"taps{n}" for n in TAPS])
def test_fir_cycles_on_card(cuda, taps):
    """cycles= fills a positive count per Rice warp and per FIR warp of
    each instance, and leaves the samples unchanged."""
    _, _, w, t = _case(taps, 96, 64, device=cuda)
    args, kw = _args(w, t, 64, taps)
    cyc = torch.zeros((k_decode.cycle_rows(True), 3), dtype=torch.int64,
                      device=cuda)
    got = k_decode.decode_channel(*args, **kw, cycles=cyc)
    again = k_decode.decode_channel(*args, **kw)
    assert (cyc[:2] > 0).all()
    for g, x in zip(got, again):
        assert torch.equal(g, x)
