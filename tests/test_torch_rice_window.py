"""The Rice decoder at the edges of csrc/decode.cu's staged window: each
lane's words staged in a ring in shared memory (by the store warp
between phases, or 16 at a time by the cursor's lane itself), one
96-bit window read a step.  Inputs: tests/torch_decode_cases.py ::
window_lanes (start bits at every residue mod 32 and near the row's end
and the refill boundaries, streams that run past the row's last word,
escapes at chanbits 32 and 33 followed at once by a zero-run codeword,
row widths 1, 2 and 3 mod 4, lanes stacked on fewer rows than 32,
skipped and partial lanes).

On the CPU the port's plain versions (the kernels' references) equal
alacjax's cursor_scan, decode_channel (raw and 8 taps) and rice_decode
on those inputs, bit for bit.  alacjax reads one row per lane and pads
a row with zeros, where the port reads lane l's words from row l % rows
and a read past the row's last word gives that word; so alacjax gets
each lane's row, extended by copies of its last word past every bit a
lane reads.

A lane enters the kernel's zero-run block on a bound of the trigger
known before the step's window (``RUN_OFF``); a CPU test holds that
bound to the plain step's arithmetic, exhaustively over pb and over
means at every power of two.  ``slow_lanes`` mixes lanes taking each
slow path of the decoder with lanes taking none; a CPU test shows that
its lanes take their paths.

The tests marked ``cuda`` hold each kernel instance (the cursor, the
raw decode, the 8-, 16- and 30-tap decode) to its plain version on the
card, on the same cases, at B=4096 lanes of S=4096 samples, and with a
starting mean whose first zero run jumps millions of bits (the cursor
leaves its staged words); and on the slow-path cases, with the kernel's
counts of its guard, its runs and its windows outside the staged
words.  The card's machine has no jax, so run them
there without the test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_rice_window.py
"""

import os

import numpy as np
import pytest
import torch

from alacjax_torch import kernels
from alacjax_torch import types as at
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.ops import fused_decode as tfd
from alacjax_torch.ops import rice as trice
from alacjax_torch.ops import tutils
from torch_decode_cases import (MB0_JUMP, RICE, slow_lanes, tile_lanes,
                               window_lanes)

# (row width mod 4, lanes, samples, word rows or None for one per lane)
CASES = [(1, 64, 96, None), (2, 64, 96, 8), (3, 96, 77, 16),
         (0, 40, 64, None)]
CARD_CASES = CASES + [(1, 4096, 4096, None), (3, 4096, 4096, 1024)]
TAPS = (8, 16, 30)


def _ids(cases):
    return [f"w{t}-L{L}-S{S}-r{r or L}" for t, L, S, r in cases]


def _case(tail, L, S, rows, device="cpu"):
    words, lane = window_lanes(np.random.default_rng(1000 * tail + L + S),
                               L, S, rows, tail)
    t = {k: torch.from_numpy(v).to(device) for k, v in lane.items()}
    return words, lane, torch.from_numpy(words.view(np.int32)).to(device), t


def _jax_rows(words, L, end_bits):
    """Each lane's row as alacjax reads it: row l % rows, extended by
    copies of its last word to 8 words past the furthest end bit."""
    width = max(words.shape[1], int(end_bits.max()) // 32 + 8)
    ext = np.repeat(words[:, -1:], width - words.shape[1], axis=1)
    return np.concatenate([words, ext], axis=1)[np.arange(L) % len(words)]


@pytest.fixture(scope="module")
def jax_ref():
    import jax.numpy as jnp

    from alacjax.ops import fused_decode as jfd
    from alacjax.ops import rice as jrice
    return jnp, jfd, jrice


def _same(got, want):
    for name, g, w in zip(("out", "end_bits", "err"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_cursor_scan_matches_jax(jax_ref, case):
    jnp, jfd, _ = jax_ref
    words, lane, w, t = _case(*case)
    L, S = case[1], case[2]
    mb0, kb, wb = RICE
    got = tfd.cursor_scan(w, t["start"], S, t["cb"], mb0, t["pb"], kb, wb,
                          chanbits_max=33, skip=t["skip"], num=t["num"])
    far, _ = tfd.cursor_scan(w, t["start"], S, t["cb"], mb0, t["pb"], kb,
                             wb, chanbits_max=33)
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    want = jfd.cursor_scan(jnp.asarray(_jax_rows(words, L, far.numpy())),
                           j["start"], S, j["cb"], mb0, j["pb"], kb, wb,
                           chanbits_max=33, skip=j["skip"], num=j["num"])
    _same(got, want)


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "taps8"])
@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_decode_channel_matches_jax(jax_ref, case, raw):
    """The raw decode (order 0 handed to alacjax, which flags orders
    above its walk even in the raw mode) and the 8-tap decode."""
    jnp, jfd, _ = jax_ref
    words, lane, w, t = _case(*case)
    L, S = case[1], case[2]
    mb0, kb, wb = RICE
    if raw:
        lane = dict(lane, order=np.zeros_like(lane["order"]))
    pred = (None,) * 4 if raw else (t["coefs"], t["mode"], t["order"],
                                    t["den"])
    got = tfd.decode_channel(w, t["start"], S, t["cb"], mb0, t["pb"], kb, wb,
                             *pred, num=t["num"], chanbits_max=33, raw=raw)
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    want = jfd.decode_channel(
        jnp.asarray(_jax_rows(words, L, got[1].numpy())), j["start"], S,
        j["cb"], mb0, j["pb"], kb, wb, j["coefs"], j["mode"], j["order"],
        j["den"], chanbits_max=33, taps=8, raw=raw, num=j["num"])
    _same(got, want)


@pytest.mark.parametrize("case", CASES[:2], ids=_ids(CASES[:2]))
def test_rice_decode_matches_jax(jax_ref, case):
    """rice_decode (the raw instance behind it) at per-lane bit sizes up
    to 33, every lane decoding all S samples."""
    jnp, _, jrice = jax_ref
    words, lane, w, t = _case(*case)
    L, S = case[1], case[2]
    mb0, kb, wb = RICE
    got = trice.rice_decode(w, t["start"], S, t["cb"], mb0, t["pb"], kb, wb,
                            max_bit_size=33)
    want = jrice.rice_decode(
        jnp.asarray(_jax_rows(words, L, got[1].numpy())),
        jnp.asarray(lane["start"]), S, jnp.asarray(lane["cb"]), mb0,
        jnp.asarray(lane["pb"]), kb, wb, max_bit_size=33)
    _same(got, want)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_window_cases_reach_the_edges(case):
    """The inputs do what they are for: streams past the row's last
    word, lanes starting in its last words and at every residue mod 32,
    escapes at chanbits 32 and 33 whose payload 0 decodes to residual 0,
    flagged overruns."""
    words, lane, w, t = _case(*case)
    L, S = case[1], case[2]
    W = words.shape[1]
    assert W % 4 == case[0]
    mb0, kb, wb = RICE
    res, end, err = tfd.decode_channel(w, t["start"], S, t["cb"], mb0,
                                       t["pb"], kb, wb, None, None, None,
                                       None, num=t["num"], chanbits_max=33,
                                       raw=True)
    assert (end.numpy() > 32 * W).any()
    assert (lane["start"] // 32 >= W - 3).any()
    assert len(set(lane["start"] % 32)) == 32 or L < 51
    esc = np.isin(np.arange(L) % 8, (2, 3)) & (lane["num"] > 1)
    for cb in (32, 33):
        sel = esc & (lane["cb"] == cb)
        assert sel.any()
        assert (res[torch.from_numpy(sel), 0] == 0).any()
    assert err.any() and not err.all()


# ---------------------------------------------------------------------------
# the zero-run guard: csrc/decode.cu enters the run block on a bound of the
# trigger taken from the mean before the step
# ---------------------------------------------------------------------------
M32 = (1 << 32) - 1
RUN_OFF = 1 << 26                      # decode.cu's RUN_OFF
DECODE_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "alacjax_torch", "csrc", "decode.cu")


def _guard(mb, pb):
    """The kernel's guard, in its 32-bit arithmetic (uint64 arrays)."""
    g = (mb - (((pb * mb) & M32) >> at.PBSHIFT)) & M32
    lim = np.where(pb <= 255, RUN_OFF + at.QB - 1, M32)
    return (((g << at.MMULSHIFT) + RUN_OFF) & M32) <= lim, g


def _trigger(mb, pb, n, zmode):
    """The plain step's trigger (fused_decode._RiceCursor.step) for the
    value n of a decoded codeword."""
    nd = (n + zmode) & M32
    upd = (pb * nd + mb - (((pb * mb) & M32) >> at.PBSHIFT)) & M32
    upd = np.where(n > at.N_MAX_MEAN_CLAMP, at.N_MEAN_CLAMP_VAL, upd)
    return ((upd << at.MMULSHIFT) & M32) < at.QB


def _pow2_near(top: int, d: int = 2):
    """Every power of two up to 2**top, each +- d, as uint64."""
    v = {(1 << i) + e for i in range(top + 1) for e in range(-d, d + 1)}
    return np.array(sorted(x for x in v if 0 <= x <= M32), dtype=np.uint64)


def _wrapping_means(pb: int):
    """Means whose g lies just below 2**30 (mod 2**30), where a trigger
    takes the wrap of pb * nd + g: g ~ mb * (1 - pb / 512)."""
    out = []
    for t in (1, 100, 4096, 1 << 20, (1 << 24) - 1):
        for hi in (0, 1, 2, 3):
            target = (hi << 30) + (1 << 30) - t
            mb = target * 512 // max(512 - pb, 1)
            out += [mb + e for e in range(-3, 4)]
    return np.array([x for x in out if 0 <= x <= M32], dtype=np.uint64)


def test_zero_run_guard_bounds_the_trigger():
    """Wherever the plain step triggers a zero run, the kernel's guard
    fires: over pb 0..255, means at every power of two +- 2 up to 2**32
    with 0, the clamp value and means whose update wraps, codeword
    values at every power of two +- 2 up to the clamp, the clamp itself,
    escape values above it up to 2**32 - 1, and zmode 0 and 1.  The
    guard is the source's (the test reads decode.cu's lines), it needs
    its wrap term (triggers with (g << 2) >= QB occur), and it stays off
    in a music stream's means."""
    with open(DECODE_CU) as f:
        src = f.read()
    assert "constexpr unsigned RUN_OFF = 1u << 26;" in src
    assert "run_lim = pb <= 255u ? RUN_OFF + QB - 1u : ~0u;" in src
    assert "(g << MMULSHIFT) + RUN_OFF <= run_lim" in src
    assert "mb_upd = pb * ndecode + g;" in src
    clamp = at.N_MEAN_CLAMP_VAL
    base_mb = np.concatenate([_pow2_near(32), np.array(
        [0, clamp - 1, clamp, clamp + 1, M32], dtype=np.uint64)])
    n = np.unique(np.concatenate([
        np.arange(0, 300, dtype=np.uint64), _pow2_near(16),
        np.array([clamp, clamp + 1, clamp + 2, M32], dtype=np.uint64),
        _pow2_near(32)[_pow2_near(32) > clamp]]))
    wrapped = 0
    for pb in range(256):
        mb = np.concatenate([base_mb, _wrapping_means(pb)])[:, None]
        p = np.uint64(pb)
        guard, g = _guard(mb, p)
        for zmode in (0, 1):
            trig = _trigger(mb, p, n[None, :], np.uint64(zmode))
            assert not (trig & ~guard).any(), pb
            wrapped += int((trig & (((g << 2) & M32) >= at.QB)).sum())
    assert wrapped > 0
    music = np.arange(200, 1 << 24, 997, dtype=np.uint64)
    assert not _guard(music, np.uint64(at.PB0))[0].any()
    assert _guard(np.uint64(10), np.uint64(256))[0]     # pb past 8 bits


def test_slow_lanes_take_their_paths():
    """slow_lanes' kinds do what they are for, in every warp: escapes of
    33 and 41 bits a codeword (past the 30 that two phases' staged words
    hold), zero runs on the near-silent and pb-0 lanes, and music-like
    lanes below 30 bits a codeword that start no run."""
    L, S = 64, 300
    words, lane = slow_lanes(np.random.default_rng(5), L, S)
    w = torch.from_numpy(words.view(np.int32))
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    mb0, kb, wb = RICE
    tutils.WORK = {}
    try:
        _, end, err = tfd.decode_channel(w, t["start"], S, t["cb"], mb0,
                                         t["pb"], kb, wb, None, None, None,
                                         None, num=t["num"], chanbits_max=33,
                                         raw=True)
        runs = sum(v for (k, _), v in tutils.WORK.items() if k == "runs")
    finally:
        tutils.WORK = None
    assert not err.any()
    kind = np.arange(L) % 8
    per = (end.numpy() - lane["start"]) / lane["num"]
    assert (per[kind == 3] >= 33).all() and (per[kind == 4] >= 41).all()
    assert (per[np.isin(kind, (0, 5, 7))] < 30).all()
    runs = runs.numpy()
    assert (runs[np.isin(kind, (1, 2, 6))] > 0).all()
    assert (runs[kind == 6] >= lane["num"][kind == 6] // 4).all()
    assert (runs[np.isin(kind, (3, 4))] == 0).all()


# (lanes, samples) of the slow-path cases: S below a tile, S not a multiple
# of one, many phases
SLOW = [(64, 20), (96, 77), (128, 1030)]


def _slow(L, S, device="cpu"):
    words, lane = slow_lanes(np.random.default_rng(7000 + L + S), L, S)
    t = {k: torch.from_numpy(v).to(device) for k, v in lane.items()}
    return words, lane, torch.from_numpy(words.view(np.int32)).to(device), t


@pytest.mark.parametrize("instance", ["cursor", "raw", "taps8"])
def test_slow_lanes_match_jax(jax_ref, instance):
    """The plain versions equal alacjax's on the slow-path lanes."""
    jnp, jfd, _ = jax_ref
    L, S = SLOW[1]
    words, lane, w, t = _slow(L, S)
    mb0, kb, wb = RICE
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    if instance == "cursor":
        got = tfd.cursor_scan(w, t["start"], S, t["cb"], mb0, t["pb"], kb,
                              wb, chanbits_max=33, num=t["num"])
        want = jfd.cursor_scan(jnp.asarray(_jax_rows(words, L,
                                                     got[0].numpy())),
                               j["start"], S, j["cb"], mb0, j["pb"], kb, wb,
                               chanbits_max=33, num=j["num"])
        _same(got, want)
        return
    raw = instance == "raw"
    if raw:
        j["order"] = jnp.zeros_like(j["order"])
    pred = (None,) * 4 if raw else (t["coefs"], t["mode"], t["order"],
                                    t["den"])
    got = tfd.decode_channel(w, t["start"], S, t["cb"], mb0, t["pb"], kb, wb,
                             *pred, num=t["num"], chanbits_max=33, raw=raw)
    want = jfd.decode_channel(
        jnp.asarray(_jax_rows(words, L, got[1].numpy())), j["start"], S,
        j["cb"], mb0, j["pb"], kb, wb, j["coefs"], j["mode"], j["order"],
        j["den"], chanbits_max=33, taps=8, raw=raw, num=j["num"])
    _same(got, want)


def test_jump_case_leaves_the_staged_words():
    """With MB0_JUMP a lane's first zero-run codeword is millions of
    bits, past its row: the cursor restages its ring at the row's end."""
    tail, L, S, rows = CASES[0]
    words, lane, w, t = _case(tail, L, S, rows)
    mb0, kb, wb = RICE
    end, _ = tfd.cursor_scan(w, t["start"], S, t["cb"], MB0_JUMP, t["pb"],
                             kb, wb, chanbits_max=33)
    jumped = end.numpy() > (1 << 24)
    assert jumped.any()


# ---------------------------------------------------------------------------
# on the card: each instance against its plain version, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _card_call(instance, w, t, S, mb0):
    """(kernel wrapper, plain version, args, kwargs, LAUNCHES key)."""
    head = (w, t["start"], S, t["cb"], mb0, t["pb"], RICE[1], RICE[2])
    if instance == "cursor":
        return (k_decode.cursor_scan, k_decode.plain_cursor, head,
                dict(chanbits_max=33, skip=t["skip"], num=t["num"]),
                "decode_cursor")
    if instance == "raw":
        return (k_decode.decode_channel, k_decode.plain, head + (None,) * 4,
                dict(num=t["num"], chanbits_max=33, raw=True), "decode_raw")
    taps = int(instance[4:])
    return (k_decode.decode_channel, k_decode.plain,
            head + (t["coefs"][:, :8].contiguous(), t["mode"], t["order"],
                    t["den"]),
            dict(num=t["num"], taps=taps, chanbits_max=33),
            k_decode.counter(taps))


@pytest.mark.cuda
@pytest.mark.parametrize("mb0", [RICE[0], MB0_JUMP], ids=["mb0", "jump"])
@pytest.mark.parametrize("instance",
                         ["cursor", "raw"] + [f"taps{n}" for n in TAPS])
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids(CARD_CASES))
def test_rice_window_kernels_on_card(cuda, case, instance, mb0):
    _, _, w, t = _case(*case, device=cuda)
    wrapper, plain, args, kwargs, key = _card_call(instance, w, t, case[2],
                                                   mb0)
    want = plain(*args, **kwargs)
    kernels.reset_launches()
    got = wrapper(*args, **kwargs)
    assert kernels.LAUNCHES[key] == 1
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x.cpu())


@pytest.mark.cuda
def test_rice_cycles_on_card(cuda):
    """cycles= fills one count of cycles per Rice warp (and per FIR warp,
    for the full decode), each positive, then the Rice warps' counts
    (guard fired >= runs triggered >= 0, windows not staged >= 0), and
    leaves the results unchanged."""
    L, S = 100, 64
    _, _, w, t = _case(1, L, S, None, device=cuda)
    blocks = -(-L // 32)
    for instance in ("cursor", "raw", "taps8"):
        wrapper, _, args, kwargs, _ = _card_call(instance, w, t, S, RICE[0])
        full = instance == "taps8"
        cyc = torch.zeros((k_decode.cycle_rows(full), blocks),
                          dtype=torch.int64, device=cuda)
        got = wrapper(*args, **kwargs, cycles=cyc)
        again = wrapper(*args, **kwargs)
        timed = 2 if full else 1
        assert (cyc[:timed] > 0).all()
        assert (cyc[timed] >= cyc[timed + 1]).all()
        assert (cyc[timed + 1:] >= 0).all()
        for g, x in zip(got, again):
            assert torch.equal(g, x)
        with pytest.raises(ValueError, match="cycles"):
            wrapper(*args, **kwargs, cycles=cyc[..., :1].contiguous())


def _counts(cyc, full: bool):
    """{count name: the launch's total} from a ``cycles=`` tensor."""
    rows = cyc[2 if full else 1:].sum(dim=1).tolist()
    return dict(zip(k_decode.COUNTS, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("mb0", [RICE[0], MB0_JUMP], ids=["mb0", "jump"])
@pytest.mark.parametrize("instance",
                         ["cursor", "raw"] + [f"taps{n}" for n in TAPS])
@pytest.mark.parametrize("case", SLOW + [(4096, 1030)],
                         ids=[f"L{L}-S{S}" for L, S in SLOW + [(4096, 1030)]])
def test_slow_paths_on_card(cuda, case, instance, mb0):
    """Each instance equals its plain version on warps that mix lanes
    taking each slow path (zero runs, escapes at 16, 24 and 32 bits, a
    mean that starts a run at every sample, num < S; with MB0_JUMP, lanes
    whose first run jumps millions of bits beside lanes whose does not)
    with lanes taking none; 4096 lanes are the 128-lane case 32 times.
    The counts of cycles= show the paths taken, and cycles= changes no
    output."""
    L, S = case
    words, lane, _, _ = _slow(min(L, 128), S)
    words, lane = tile_lanes(words, lane, L // min(L, 128))
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in lane.items()}
    wrapper, plain, args, kwargs, key = _card_call(instance, w, t, S, mb0)
    want = plain(*args, **kwargs)
    kernels.reset_launches()
    got = wrapper(*args, **kwargs)
    assert kernels.LAUNCHES[key] == 1
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x.cpu())
    full = instance.startswith("taps")
    cyc = torch.zeros((k_decode.cycle_rows(full), -(-L // 32)),
                      dtype=torch.int64, device=cuda)
    again = wrapper(*args, **kwargs, cycles=cyc)
    for g, x in zip(again, want):
        assert torch.equal(g.cpu(), x.cpu())
    n = _counts(cyc, full)
    assert n["guard_fired"] >= n["run_triggered"] > 0
    if S > 1000 and instance != "cursor" and mb0 == RICE[0]:
        assert n["window_unstaged"] > 0      # the 24- and 32-bit escapes
