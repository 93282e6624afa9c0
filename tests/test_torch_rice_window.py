"""The Rice decoder at the edges of csrc/decode.cu's staged window: each
lane's words staged 16 at a time in a ring in shared memory, one 96-bit
window read a step.  Inputs: tests/torch_decode_cases.py ::
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

The tests marked ``cuda`` hold each kernel instance (the cursor, the
raw decode, the 8-, 16- and 30-tap decode) to its plain version on the
card, on the same cases, at B=4096 lanes of S=4096 samples, and with a
starting mean whose first zero run jumps millions of bits (the cursor
leaves its staged words).  The card's machine has no jax, so run them
there without the test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_rice_window.py
"""

import numpy as np
import pytest
import torch

from alacjax_torch import kernels
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.ops import fused_decode as tfd
from alacjax_torch.ops import rice as trice
from torch_decode_cases import MB0_JUMP, RICE, window_lanes

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
    """cycles= fills one count per Rice warp (and per FIR warp, for the
    full decode), each positive, and leaves the results unchanged."""
    L, S = 100, 64
    _, _, w, t = _case(1, L, S, None, device=cuda)
    blocks = -(-L // 32)
    for instance in ("cursor", "raw", "taps8"):
        wrapper, _, args, kwargs, _ = _card_call(instance, w, t, S, RICE[0])
        shape = (2, blocks) if instance == "taps8" else (blocks,)
        cyc = torch.zeros(shape, dtype=torch.int64, device=cuda)
        got = wrapper(*args, **kwargs, cycles=cyc)
        again = wrapper(*args, **kwargs)
        assert (cyc > 0).all()
        for g, x in zip(got, again):
            assert torch.equal(g, x)
        with pytest.raises(ValueError, match="cycles"):
            wrapper(*args, **kwargs, cycles=cyc[..., :1].contiguous())
