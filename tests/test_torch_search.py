"""The encode search's stream glue: ``kernels.search`` (csrc/search.cu),
the mixres trial's candidate streams and each CPE's chosen mix in one
``mix_kernel`` launch each, every searched lane's winner in one
``pick_kernel`` launch.

On the CPU the wrappers run their plain versions (alacjax_torch.ops.
search), which equal the torch glue the codec ran before them
(``matrix.mix`` at the trial's four mixres, the chosen mix, the argmin
over the (order, stage) candidates and ``predict.wrap_diff``, kept here
as ``old_*``) on int32 edges, every mixres 0..4, chanbits 16 to 33 and
per-lane mixed, odd sample counts and cost ties; the packets of the
encode through them equal alacjax's scalar oracle encoder on stereo and
5.1 at depths 16, 20, 24 and 32 (chanbits 33 included), in the
standard, fast and exhaustive searches, with partial frames, escape
lanes and persistent banks; each encode calls each wrapper the times
its search needs; the wrappers refuse what the kernels do not take.

The tests marked ``cuda`` hold each kernel to its plain version bit for
bit on the card: both forms of ``mix_kernel`` and ``pick_kernel`` at
S = 4096 and at odd S, B = 4096 on the benchmark's two shapes, inputs at
INT32_MIN / INT32_MAX and at the chanbits edges, per-lane mixed
chanbits; the encode on the card equals the CPU's on every case above;
a B = 4096 encode launches ``search_mix`` twice and ``search_pick``
once, each call equal to its plain version.  The card's machine has no
jax, so run them there without the test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_search.py
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import alacjax.types
from alacjax.oracle import ALACEncoder as AlacjaxOracle
from alacjax_torch import codec, encode_streams, kernels
from alacjax_torch.kernels import search as k_search
from alacjax_torch.ops import bitpack, matrix, predict, search
from alacjax_torch.ops.tutils import I32, I64, as_i32_bits
from alacjax_torch.types import AlacConfig

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

S = 64
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
KINDS = ("sine", "noise", "impulse", "silence", "sine", "sine")


# ---------------------------------------------------------------------------
# the torch glue codec.py ran before csrc/search.cu
# ---------------------------------------------------------------------------
def old_trial(pairs):
    cand = []
    for left, right in pairs:
        ld, rd = left[:, ::4], right[:, ::4]
        cand += [ld, rd]
        cand += [matrix.mix(ld, rd, 2, mr)[0] for mr in range(1, 5)]
        cand.append(as_i32_bits(ld.to(I64) - rd.to(I64)))
    return torch.cat(cand, dim=0).contiguous()


def old_mix(left, right, mixres):
    mr = mixres if isinstance(mixres, int) else mixres[:, None]
    return matrix.mix(left, right, 2, mr)


def old_winner(res_o, c1_o, c2_o, orders, chanbits_list):
    """_search_channels' per-stream loop: (res, order, mode, rice)."""
    stages = [1] if c2_o is None else [1, 2]
    B = res_o.shape[1] // len(chanbits_list)
    by_order = {od: (res_o[i], c1_o[i], None if c2_o is None else c2_o[i])
                for i, od in enumerate(orders)}
    out = []
    for ci, cb in enumerate(chanbits_list):
        sl = slice(ci * B, (ci + 1) * B)
        cand_costs, cand_rice = [], []
        for od in orders:
            _, c1, c2 = by_order[od]
            for rc in ([c1[sl]] if c2 is None else [c1[sl], c2[sl]]):
                cand_costs.append(16 + 16 * od + rc.to(I64))
                cand_rice.append(rc.to(I64))
        win = torch.argmin(torch.stack(cand_costs, dim=0), dim=0)
        rice_win = torch.gather(torch.stack(cand_rice, dim=0), 0,
                                win[None, :])[0]
        order_win = torch.full((B,), orders[0], dtype=I64)
        mode_win = torch.zeros((B,), dtype=I64)
        for ki in range(len(cand_costs)):
            od, stg = orders[ki // len(stages)], stages[ki % len(stages)]
            hit = win == ki
            order_win = torch.where(hit, od, order_win)
            mode_win = torch.where(hit, 0 if stg == 1 else 15, mode_win)
        res_win = by_order[orders[0]][0][sl]
        for od in orders[1:]:
            res_win = torch.where((order_win == od)[:, None],
                                  by_order[od][0][sl], res_win)
        if len(stages) > 1:
            res_win = torch.where((mode_win != 0)[:, None],
                                  predict.wrap_diff(res_win, cb), res_win)
        out.append((res_win.to(I32), order_win, mode_win, rice_win))
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def edge_rows(B: int, n: int, seed: int, device="cpu"):
    """(B, n) int32: full-range noise, with rows and samples at INT32_MIN,
    INT32_MAX, 0, -1 and runs that flip between the extremes."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(INT32_MIN, INT32_MAX, (B, n), generator=g,
                      dtype=torch.int64)
    x[0] = INT32_MIN
    x[1 % B] = INT32_MAX
    x[2 % B, ::2] = INT32_MIN
    x[2 % B, 1::2] = INT32_MAX
    x[3 % B] = 0
    x[:, n // 2] = -1
    x[4 % B::5, 3 % n] = INT32_MAX
    small = torch.randint(-40, 40, (B, n), generator=g, dtype=torch.int64)
    x[5 % B::7] = small[5 % B::7]
    return x.to(I32).to(device)


def cost_rows(n: int, L: int, seed: int, device="cpu"):
    """(n, L) int32 Rice bit counts, many equal across candidates (ties)."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 1 << 20, (n, L), generator=g, dtype=torch.int64)
    c[:, ::3] = torch.randint(0, 4, (n, L), generator=g)[:, ::3] * 16
    return c.to(I32).to(device)


def lane_mixres(B: int, seed: int, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 5, (B,), generator=g, dtype=I64).to(device)


CHANBITS = {"16": 16, "17": 17, "20": 20, "24": 24, "32": 32, "33": 33,
            "mixed": None}


def chanbits_arg(key: str, W: int, B: int, device="cpu"):
    """(chanbits for the wrapper, per-stream ints for old_winner)."""
    if CHANBITS[key] is not None:
        return CHANBITS[key], [CHANBITS[key]] * W
    per = [(16, 17, 33, 32, 24, 25)[i % 6] for i in range(W)]
    lane = torch.cat([torch.full((B,), cb, dtype=I32) for cb in per])
    return lane.to(device), per


# ---------------------------------------------------------------------------
# the plain versions equal the glue they replace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [S, 61, 57])
@pytest.mark.parametrize("cpes", [1, 2, 3])
def test_plain_trial_equals_old_glue(cpes, n):
    pairs = [(edge_rows(12, n, 10 * j), edge_rows(12, n, 10 * j + 1))
             for j in range(cpes)]
    got = search.mix_trial([p[0] for p in pairs], [p[1] for p in pairs],
                           2, 4, 4)
    assert got.dtype == I32 and got.shape == (7 * cpes * 12, -(-n // 4))
    assert torch.equal(got, old_trial(pairs))
    assert torch.equal(k_search.mix_trial([p[0] for p in pairs],
                                          [p[1] for p in pairs], 2, 4, 4),
                       got)


@pytest.mark.parametrize("n", [S, 61])
@pytest.mark.parametrize("mixres", ["lanes", 0, 1, 2, 3, 4])
def test_plain_mix_equals_old_glue(mixres, n):
    left, right = edge_rows(16, n, 3), edge_rows(16, n, 4)
    mr = lane_mixres(16, 5) if mixres == "lanes" else mixres
    u, v = old_mix(left, right, mr)
    got = search.mix_streams([left], [right], [mr], 2)
    assert got.dtype == I32
    assert torch.equal(got[:16], u) and torch.equal(got[16:], v)


def test_mix_streams_writes_only_its_rows():
    """The exhaustive layout: an SCE's row block, then five pairs of a CPE
    at constant mixres 0..4 and one at per-lane mixres, into one stack."""
    B = 8
    left, right = edge_rows(B, S, 6), edge_rows(B, S, 7)
    mrs = [0, 1, 2, 3, 4, lane_mixres(B, 8)]
    rows = [B + 2 * j * B for j in range(len(mrs))]
    out = torch.full(((1 + 2 * len(mrs)) * B, S), 12345, dtype=I32)
    got = k_search.mix_streams([left] * 6, [right] * 6, mrs, 2, out=out,
                               rows=rows)
    assert got is out
    assert (out[:B] == 12345).all()
    for mr, row in zip(mrs, rows):
        u, v = old_mix(left, right, mr)
        assert torch.equal(out[row:row + B], u)
        assert torch.equal(out[row + B:row + 2 * B], v)


@pytest.mark.parametrize("n", [S, 61])
@pytest.mark.parametrize("cb", list(CHANBITS))
@pytest.mark.parametrize("orders", [(4, 8), (8,)], ids=["standard", "fast"])
def test_plain_pick_equals_old_glue(orders, cb, n):
    W, B = 6, 10
    res = torch.stack([edge_rows(W * B, n, 20 + i) for i in range(len(orders))])
    c1 = cost_rows(len(orders), W * B, 30)
    c2 = None if orders == (8,) else cost_rows(len(orders), W * B, 31)
    chanbits, per = chanbits_arg(cb, W, B)
    got, sel = k_search.pick(res, c1, c2, orders, chanbits)
    assert got.dtype == I32 and sel.dtype == I64 and sel.shape == (3, W * B)
    for ci, (r, od, md, rc) in enumerate(old_winner(res, c1, c2, orders,
                                                    per)):
        sl = slice(ci * B, (ci + 1) * B)
        assert torch.equal(got[sl], r)
        assert torch.equal(sel[0, sl], od)
        assert torch.equal(sel[1, sl], md)
        assert torch.equal(sel[2, sl], rc)
    if c2 is not None:
        assert (sel[1] == 15).any() and (sel[1] == 0).any()
        assert (sel[0] == 4).any() and (sel[0] == 8).any()


def test_pick_takes_the_first_minimum():
    """Four equal candidates: order 4, stage 1 wins; equal orders 8:
    stage 1 before stage 2."""
    L, n = 4, 8
    res = torch.stack([edge_rows(L, n, 40), edge_rows(L, n, 41)])
    c1 = torch.tensor([[64, 0, 64, 64], [0, 0, 64, 0]], dtype=I32)
    c2 = torch.tensor([[64, 0, 0, 64], [0, 64, 64, 0]], dtype=I32)
    _, sel = k_search.pick(res, c1, c2, (4, 8), 16)
    # lane 0: (4,1)=144 (4,2)=144 (8,1)=144 (8,2)=144 -> order 4 stage 1
    # lane 1: (4,1)=80 (4,2)=80 -> order 4, stage 1
    # lane 2: (4,2)=80 beats (4,1)=144
    # lane 3: (4,1)=144, (8,1)=144 -> order 4, stage 1
    assert sel[0].tolist() == [4, 4, 4, 4]
    assert sel[1].tolist() == [0, 0, 15, 0]


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------
def _good():
    left, right = edge_rows(4, 8, 1), edge_rows(4, 8, 2)
    res = torch.stack([edge_rows(8, 8, 3), edge_rows(8, 8, 4)])
    return left, right, res, cost_rows(2, 8, 5), cost_rows(2, 8, 6)


@pytest.mark.parametrize("call,error,match", [
    (lambda l, r, *_: k_search.mix_trial([l], [r.to(I64)], 2, 4, 4),
     TypeError, "int32"),
    (lambda l, r, *_: k_search.mix_trial([l], [r[:, :4]], 2, 4, 4),
     ValueError, "shape"),
    (lambda l, r, *_: k_search.mix_trial([l], [r.t().contiguous().t()],
                                         2, 4, 4), ValueError, "contiguous"),
    (lambda l, r, *_: k_search.mix_trial([l] * 17, [r] * 17, 2, 4, 4),
     ValueError, "pairs"),
    (lambda l, r, *_: k_search.mix_trial([l], [r], 32, 4, 4),
     ValueError, "mixbits"),
    (lambda l, r, *_: k_search.mix_trial([l], [r], 2, 4, 0),
     ValueError, "positive"),
    (lambda l, r, *_: k_search.mix_streams([l], [r], [1 << 31], 2),
     ValueError, "int32"),
    (lambda l, r, *_: k_search.mix_streams(
        [l], [r], [torch.zeros(4, dtype=I32)], 2), TypeError, "int64"),
    (lambda l, r, *_: k_search.mix_streams([l], [r], [1, 2], 2),
     ValueError, "mixres"),
    (lambda l, r, *_: k_search.mix_streams(
        [l, l], [r, r], [1, 2], 2, out=torch.zeros((16, 8), dtype=I32),
        rows=[0, 4]), ValueError, "overlap"),
    (lambda l, r, *_: k_search.mix_streams(
        [l], [r], [1], 2, out=torch.zeros((16, 8), dtype=I32), rows=[12]),
     ValueError, "outside"),
    (lambda l, r, *_: k_search.mix_streams(
        [l], [r], [1], 2, out=torch.zeros((16, 8), dtype=I32)),
     ValueError, "first row"),
    (lambda *a: k_search.pick(a[2], a[3], a[4], (4, 8, 16), 16),
     ValueError, "orders"),
    (lambda *a: k_search.pick(a[2], a[3], a[4], (8,), 16),
     ValueError, "shape"),
    (lambda *a: k_search.pick(a[2], a[3][:, :4], a[4], (4, 8), 16),
     ValueError, "shape"),
    (lambda *a: k_search.pick(a[2], a[3], a[4], (4, 8), 34),
     ValueError, "chanbits"),
    (lambda *a: k_search.pick(a[2], a[3], a[4], (4, 8),
                              torch.full((8,), 16, dtype=I64)),
     TypeError, "int32"),
])
def test_wrappers_check_their_inputs(call, error, match):
    with pytest.raises(error, match=match):
        call(*_good())


# ---------------------------------------------------------------------------
# the encode through them
# ---------------------------------------------------------------------------
# id: (channels, depth, config keywords, partial lanes)
ENCODES = {
    "stereo16": (2, 16, {}, False),
    "stereo20": (2, 20, {}, True),
    "stereo24": (2, 24, {}, False),
    "stereo32": (2, 32, {}, True),           # CPE chanbits 33
    "mono24": (1, 24, {}, False),
    "5.1-24": (6, 24, {}, True),
    "5.1-32": (6, 32, {}, False),
    "stereo16-fast": (2, 16, dict(fast_mode=True), True),
    "5.1-16-fast": (6, 16, dict(fast_mode=True), False),
    "stereo16-exhaustive": (2, 16, dict(search="exhaustive"), False),
    "5.1-20-exhaustive": (6, 20, dict(search="exhaustive"), True),
}


def encode_inputs(case: str, n: int = S, seed: int = 0):
    """(config, pcm (B, C, n) int32 numpy, nums or None): KINDS' lanes, a
    lane of full-scale noise in every channel (every element escapes)
    and one of each channel's own content."""
    nch, depth, kw, partial = ENCODES[case]
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=n, **kw)
    rng = np.random.default_rng(seed + 100 * nch + depth)
    pcm = np.stack([soak.gen_pcm(rng, k, nch, n, depth) for k in KINDS]
                   + [np.stack([soak.gen_pcm(rng, k, 1, n, depth)[0]
                                for k in ("sine", "noise", "impulse",
                                          "sine", "silence", "noise")[:nch]])]
                   ).astype(np.int32)
    nums = None
    if partial:
        nums = np.full((len(pcm),), n, dtype=np.int32)
        nums[2], nums[4] = n // 2 + 1, 5
        for b, k in enumerate(nums):
            pcm[b, :, k:] = 0
    return cfg, pcm, nums


def device_encode(cfg, pcm, nums, device="cpu"):
    x = torch.from_numpy(pcm).to(device)
    nd = None if nums is None else torch.from_numpy(nums).to(device)
    words, bits = codec.encode_frames_device(x, cfg, codec._num_words(cfg),
                                             nums=nd)
    return words.cpu(), bits.cpu()


def packets(words, bits):
    return bitpack.words_to_bytes(words.numpy(), bits.numpy())


def alacjax_config(cfg):
    return alacjax.types.AlacConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("case", list(ENCODES))
def test_packets_equal_alacjax_oracle(case):
    cfg, pcm, nums = encode_inputs(case)
    got = packets(*device_encode(cfg, pcm, nums))
    enc = AlacjaxOracle(alacjax_config(cfg), independent_frames=True)
    for i, frame in enumerate(pcm):
        n = cfg.frame_length if nums is None else int(nums[i])
        assert got[i] == enc.encode_packet(frame[:, :n]), f"frame {i}"


@pytest.mark.parametrize("nch", [2, 6])
def test_streams_with_banks_equal_stateful_oracle(nch):
    """Persistent coefficient banks (encode_stream_device): the banks'
    c0_win select beside the pick."""
    cfg = AlacConfig(bit_depth=16 if nch == 2 else 24, num_channels=nch,
                     frame_length=S)
    rng = np.random.default_rng(nch)
    pcm = np.stack([np.stack([soak.gen_pcm(rng, k, nch, S, cfg.bit_depth)
                              for k in ("sine", "impulse", "sine")])
                    for _ in range(3)]).astype(np.int32)
    got = encode_streams(pcm, cfg, device="cpu")
    for b in range(len(pcm)):
        enc = AlacjaxOracle(alacjax_config(cfg))
        assert got[b] == [enc.encode_packet(f) for f in pcm[b]], f"stream {b}"


@pytest.fixture
def search_calls(monkeypatch):
    """Every call of the three wrappers, as (name, args, kwargs, result)."""
    calls = []
    for name in ("mix_trial", "mix_streams", "pick"):
        real = getattr(k_search, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            out = _real(*args, **kwargs)
            calls.append((_name, args, kwargs, out))
            return out
        monkeypatch.setattr(k_search, name, spy)
    return calls


# id: (case, calls of mix_trial, mix_streams, pick)
CALLS = {"stereo16": (1, 1, 1), "5.1-24": (1, 1, 1), "mono24": (0, 0, 1),
         "stereo16-fast": (0, 1, 1), "stereo16-exhaustive": (0, 1, 1),
         "5.1-20-exhaustive": (0, 1, 1)}


@pytest.mark.parametrize("case", list(CALLS))
def test_one_call_of_each_wrapper_per_search(search_calls, case):
    cfg, pcm, nums = encode_inputs(case)
    device_encode(cfg, pcm, nums)
    names = [c[0] for c in search_calls]
    want = dict(zip(("mix_trial", "mix_streams", "pick"), CALLS[case]))
    assert {k: names.count(k) for k in want} == want
    for name, args, kwargs, _ in search_calls:
        if name == "mix_streams":
            # every CPE of the call in the one launch
            n_cpe = sum(w == 2 for _, w in cfg.elements)
            exhaustive = cfg.search == "exhaustive"
            assert len(args[0]) == n_cpe * (5 if exhaustive else 1)


def test_mix_cut_returns_row_views_of_the_search_input():
    cfg, pcm, _ = encode_inputs("5.1-24")
    x = torch.from_numpy(pcm)
    streams = codec._encode_packet_chunks(x, cfg, codec._num_words(cfg),
                                          stop_at="mix")
    flat = [s for elem in streams for s in elem]
    assert len(flat) == 6
    base = flat[0].untyped_storage().data_ptr()
    B = len(pcm)
    for i, s in enumerate(flat):
        assert s.shape == (B, S) and s.is_contiguous()
        assert s.data_ptr() == base + i * B * S * 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card")
    return torch.device("cuda")


# (lanes, samples): the benchmark's shape, then odd sample counts (V = 1;
# 57: the trial's So = 15, not a multiple of 4)
SHAPES = [(4096, 4096), (256, 61), (256, 57)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("cpes", [1, 2], ids=["cd16", "surround24"])
def test_trial_kernel_equals_plain_on_card(cuda, cpes, shape):
    B, n = shape
    ls = [edge_rows(B, n, 50 + j) for j in range(cpes)]
    rs = [edge_rows(B, n, 60 + j) for j in range(cpes)]
    kernels.reset_launches()
    got = k_search.mix_trial([x.to(cuda) for x in ls],
                             [x.to(cuda) for x in rs], 2, 4, 4)
    assert kernels.LAUNCHES["search_mix"] == 1
    assert torch.equal(got.cpu(), search.mix_trial(ls, rs, 2, 4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", ["cd16", "surround24", "exhaustive"])
def test_mix_kernel_equals_plain_on_card(cuda, layout, shape):
    """Per-lane mixres (the trial's argmin), a constant (fast mode) and
    the exhaustive search's five constants, into a stack with SCE rows."""
    B, n = shape
    l0, r0 = edge_rows(B, n, 70), edge_rows(B, n, 71)
    l1, r1 = edge_rows(B, n, 72), edge_rows(B, n, 73)
    if layout == "cd16":
        ls, rs, mrs, rows = [l0], [r0], [lane_mixres(B, 74)], [0]
    elif layout == "surround24":
        ls, rs, mrs = [l0, l1], [r0, r1], [lane_mixres(B, 75), 2]
        rows = [B, 3 * B]
    else:
        ls, rs = [l0] * 5 + [l1] * 5, [r0] * 5 + [r1] * 5
        mrs = [0, 1, 2, 3, 4] * 2
        rows = [B + 2 * j * B for j in range(10)]
    R = max(rows) + 2 * B + (B if layout != "cd16" else 0)
    want = torch.full((R, n), 7, dtype=I32)
    search.mix_streams(ls, rs, mrs, 2, out=want, rows=rows)
    out = torch.full((R, n), 7, dtype=I32, device=cuda)
    kernels.reset_launches()
    k_search.mix_streams([x.to(cuda) for x in ls], [x.to(cuda) for x in rs],
                         [m if isinstance(m, int) else m.to(cuda)
                          for m in mrs], 2, out=out, rows=rows)
    assert kernels.LAUNCHES["search_mix"] == 1
    assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 61])
@pytest.mark.parametrize("cb", list(CHANBITS))
@pytest.mark.parametrize("orders", [(4, 8), (8,)], ids=["standard", "fast"])
@pytest.mark.parametrize("W", [2, 6], ids=["cd16", "surround24"])
def test_pick_kernel_equals_plain_on_card(cuda, W, orders, cb, n):
    """B = 4096 at S = 4096 with the benchmark's chanbits (17: cd16's
    CPE; mixed: surround24's), 256 lanes at the other chanbits."""
    B = 64 if n != 4096 else 4096 if cb in ("17", "mixed") else 256
    res = torch.stack([edge_rows(W * B, n, 80 + i)
                       for i in range(len(orders))])
    c1 = cost_rows(len(orders), W * B, 90)
    c2 = None if orders == (8,) else cost_rows(len(orders), W * B, 91)
    chanbits, _ = chanbits_arg(cb, W, B)
    want, want_sel = search.pick(res, c1, c2, orders, chanbits)
    kernels.reset_launches()
    got, sel = k_search.pick(
        res.to(cuda), c1.to(cuda), None if c2 is None else c2.to(cuda),
        orders, chanbits if isinstance(chanbits, int) else chanbits.to(cuda))
    assert kernels.LAUNCHES["search_pick"] == 1
    assert torch.equal(got.cpu(), want) and torch.equal(sel.cpu(), want_sel)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [S, 63])
@pytest.mark.parametrize("case", list(ENCODES))
def test_encode_on_card_equals_cpu(cuda, case, n):
    """Every search through the kernels (S = 63: their one-sample form):
    the word image and bits of the CPU's plain versions."""
    cfg, pcm, nums = encode_inputs(case, n)
    want = device_encode(cfg, pcm, nums)
    got = device_encode(cfg, pcm, nums, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_streams_with_banks_on_card_equal_cpu(cuda):
    cfg = AlacConfig(bit_depth=24, num_channels=6, frame_length=S)
    rng = np.random.default_rng(6)
    pcm = np.stack([np.stack([soak.gen_pcm(rng, k, 6, S, 24)
                              for k in ("sine", "noise", "sine")])
                    for _ in range(4)]).astype(np.int32)
    assert encode_streams(pcm, cfg, device="cuda") == encode_streams(
        pcm, cfg, device="cpu")


def card_music(cfg, B: int, device):
    """(B, C, S) int32 on the card: a chord per frame with its own phases
    and a noise floor at a quarter of full scale; frame 1 full-scale
    noise (every element escapes); every 64th frame partial."""
    depth, nch, n = cfg.bit_depth, cfg.num_channels, cfg.frame_length
    g = torch.Generator(device=device).manual_seed(depth * nch)
    t = torch.arange(n, device=device, dtype=torch.float32)
    f = torch.tensor([0.011, 0.017, 0.023], device=device)
    ph = torch.rand((B, nch, 3, 1), generator=g, device=device) * 6.28
    x = torch.sin(f[None, None, :, None] * t + ph).sum(2) / 3
    noise = torch.randn((B, nch, n), generator=g, device=device) * 8
    x = (x * (1 << (depth - 3)) + noise).round().to(torch.int32)
    x[1] = torch.randint(-(1 << (depth - 1)), 1 << (depth - 1), (nch, n),
                         generator=g, device=device, dtype=torch.int32)
    nums = torch.full((B,), n, dtype=torch.int32, device=device)
    nums[::64] = n // 2 + 1
    x = torch.where(torch.arange(n, device=device) < nums[:, None, None],
                    x, 0)
    return x, nums


def host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu()
    if isinstance(v, (list, tuple)):
        return type(v)(host(x) for x in v)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cd16", "surround24"])
def test_benchmark_shapes_on_card(cuda, search_calls, cell):
    """B = 4096 frames of 4096 samples: two search_mix launches (the
    trial, the chosen mix) and one search_pick a call, each equal to its
    plain version on the same inputs, and the packets decode losslessly."""
    nch, depth, rate = (2, 16, 44100) if cell == "cd16" else (6, 24, 48000)
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=4096,
                     sample_rate=rate)
    x, nums = card_music(cfg, 4096, cuda)
    n_words = codec._num_words(cfg)
    codec.encode_frames_device(x, cfg, n_words, nums=nums)   # builds, warms
    search_calls.clear()
    kernels.reset_launches()
    words, _ = codec.encode_frames_device(x, cfg, n_words, nums=nums)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["search_mix"] == 2
    assert kernels.LAUNCHES["search_pick"] == 1
    assert [c[0] for c in search_calls] == ["mix_trial", "mix_streams",
                                            "pick"]
    for name, args, kwargs, out in search_calls:
        if name == "mix_streams":
            # the CPE rows of the stack; its SCE rows are the codec's copy
            ls, rs, mrs, mixbits = host(args)
            want = search.mix_streams(ls, rs, mrs, mixbits)
            B = ls[0].shape[0]
            for j, row in enumerate(kwargs["rows"]):
                assert torch.equal(out[row:row + 2 * B].cpu(),
                                   want[2 * j * B:2 * (j + 1) * B])
        else:
            want = getattr(search, name)(*host(args), **host(kwargs))
            assert torch.equal(host(out)[0] if name == "pick" else host(out),
                               want[0] if name == "pick" else want)
            if name == "pick":
                assert torch.equal(out[1].cpu(), want[1])
    got, err, num = codec.decode_frames_device(words, cfg, 4096)
    assert torch.equal(got, x) and not err.any() and torch.equal(num, nums)
