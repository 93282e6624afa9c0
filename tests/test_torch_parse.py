"""The decode's element parse: ``kernels.parse.parse_element``
(csrc/parse.cu), one launch per element that reads the element's header,
its partial frame's numSamples, a CPE's mix token and every channel's
param header and coefficients at each lane's element start from the
int32 word image, and writes them as the ``ops.parse.Parsed`` the
decode's kernels read, with the element's escape flags.

On the CPU the wrapper runs its plain version (alacjax_torch.ops.parse),
and the port's decode through it equals alacjax's scalar decoder on the
port's packets (mono, stereo, 5.1 and 7.1; depths 16, 20, 24 and 32;
partial lanes, escape lanes, an element whose every lane escapes); a
single-element packet's static offsets give the same fields as a read
at bit 0, which is the one path the kernel takes; the wrapper refuses a
wrong dtype, shape, device or size.

The tests marked ``cuda`` hold the kernel to its plain version bit for
bit on every field: every parse of decodes at 8 and 30 taps (max_ord 16
and 30), and crafted headers at per-lane starts, legal and corrupt (a
wrong tag, unused bits, a bad bytes_shifted, den 0, an order above
max_ord, order 31,
numSamples 0 or above S, elements that disagree on the frame length, an
image shorter than the header window, random words); a decode
launches the kernel once per element; and the "params" cut, which reads
through the plain version, gives the same fields on the card as here.  The card's machine has no jax,
so run them there without the test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_parse.py
"""

import dataclasses
import inspect
import pathlib
import sys

import numpy as np
import pytest
import torch

from alacjax_torch import codec, kernels
from alacjax_torch.kernels import parse as k_parse
from alacjax_torch.ops import bitpack
from alacjax_torch.ops import parse as plain_parse
from alacjax_torch.types import AlacConfig, ElementTag

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

S = 64
LANES = ("sine", "noise", "impulse", "sine", "silence", "sine")
NUMS = (S, S, S, 43, S, 17)      # lanes 3 and 5 are partial
MIXED_LANE = 5                   # noise in the first element's channels
# id: (channels, depth, index of an element whose every lane escapes)
CASES = {
    "mono16": (1, 16, None),
    "mono24": (1, 24, None),
    "stereo16": (2, 16, None),
    "stereo20": (2, 20, None),
    "stereo32": (2, 32, None),
    "5.1-24-sce-escapes": (6, 24, 0),
    "7.1-16-cpe-escapes": (8, 16, 1),
    "7.1-32": (8, 32, None),
}
CPU_CASES = ("mono24", "stereo16", "5.1-24-sce-escapes", "7.1-32")


def config(nch: int, depth: int, frame_length: int = S) -> AlacConfig:
    return AlacConfig(bit_depth=depth, num_channels=nch,
                      frame_length=frame_length)


def frames(nch: int, depth: int, esc_element):
    """(config, pcm (B, C, S) int32, nums (B,) int32) of LANES; the first
    element is noise on MIXED_LANE, ``esc_element`` on every lane."""
    cfg = config(nch, depth)
    rng = np.random.default_rng(1000 * nch + depth)
    pcm = np.stack([soak.gen_pcm(rng, kind, nch, S, depth)
                    for kind in LANES])
    noise = np.stack([soak.gen_pcm(rng, "noise", nch, S, depth)
                      for _ in LANES])
    c0 = 0
    for k, (_, width) in enumerate(cfg.elements):
        chans = slice(c0, c0 + width)
        if k == 0:
            pcm[MIXED_LANE, chans] = noise[MIXED_LANE, chans]
        if k == esc_element:
            pcm[:, chans] = noise[:, chans]
        c0 += width
    nums = np.array(NUMS, np.int32)
    for b, k in enumerate(nums):
        pcm[b, :, k:] = 0
    return cfg, pcm.astype(np.int32), nums


def encode(cfg, pcm, nums, device="cpu"):
    """The port's word image (B, W) int32 and packet bits (B,)."""
    return codec.encode_frames_device(
        torch.from_numpy(pcm).to(device), cfg, codec._num_words(cfg),
        nums=torch.from_numpy(nums).to(device))


@pytest.fixture
def parse_calls(monkeypatch):
    """Each parse_element call of the decodes run while it is active, as
    its arguments by name, and what it returned."""
    calls = []
    real = k_parse.parse_element
    sig = inspect.signature(real)

    def spy(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        got = real(*args, **kwargs)
        calls.append((dict(bound.arguments), got))
        return got
    monkeypatch.setattr(k_parse, "parse_element", spy)
    return calls


def assert_same(got, want, what=""):
    """Two Parsed: every field the same bits (got may lie on the card)."""
    for name in plain_parse.Parsed._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        g = g.cpu()
        if not torch.equal(g, w):
            bad = (g != w).reshape(-1, g.shape[-1]).any(0).nonzero()[:8]
            raise AssertionError(f"{what} {name}: lanes {bad.tolist()} "
                                 f"differ")


def on_cpu(a: dict) -> dict:
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in a.items()}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def oracle():
    from alacjax.oracle import ALACDecoder
    from alacjax.types import AlacConfig as JaxConfig

    def decode(cfg, words, bits):
        dec = ALACDecoder(JaxConfig(**dataclasses.asdict(cfg)))
        packets = bitpack.words_to_bytes(words.numpy(), bits.numpy())
        out = np.zeros((len(packets), cfg.num_channels, S), np.int64)
        for b, pkt in enumerate(packets):
            x, n = dec.decode_packet(pkt)
            out[b, :, :n] = x
        return out
    return decode


@pytest.mark.parametrize("case", CPU_CASES)
def test_decode_through_plain_parse_equals_alacjax(oracle, parse_calls,
                                                   case):
    cfg, pcm, nums = frames(*CASES[case])
    words, bits = encode(cfg, pcm, nums)
    kernels.reset_launches()
    got, err, num = codec.decode_frames_device(words, cfg, S)
    assert kernels.LAUNCHES["parse"] == 0
    np.testing.assert_array_equal(got.numpy(), oracle(cfg, words, bits))
    np.testing.assert_array_equal(got.numpy(), pcm)
    assert not err.any()
    assert num.dtype == torch.int32
    np.testing.assert_array_equal(num.numpy(), nums)
    # one parse an element, in the decode kernels' layout; the case holds
    # what it claims: the noise lane escapes in every element,
    # MIXED_LANE in the first, esc_element on every lane
    esc_element = CASES[case][2]
    assert len(parse_calls) == len(cfg.elements)
    for k, (a, p) in enumerate(parse_calls):
        width = cfg.elements[k][1]
        assert (a["bitpos"] is None) == (k == 0)
        assert (a["num"] is None) == (k == 0)
        assert p.lanes.dtype == torch.int32 and p.coefs.dtype == torch.int32
        assert p.lanes.shape == (plain_parse.lane_rows(width), len(LANES))
        assert p.coefs.shape == (width, len(LANES), 16)
        want_esc = torch.zeros(len(LANES), dtype=torch.bool)
        want_esc[[1, MIXED_LANE] if k == 0 else [1]] = True
        if k == esc_element:
            want_esc[:] = True
        assert torch.equal(p.esc, want_esc), k
        assert p.flags.tolist() == [int(not want_esc.all()), 1]
        assert not p.err.any()
        assert (p.mixbits is None) == (width == 1)


def random_image(rng, B: int, W: int):
    return torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (B, W)).astype(np.int32))


@pytest.mark.parametrize("W", [2, 3, 5, 64])
@pytest.mark.parametrize("width", [1, 2])
def test_static_offsets_equal_a_read_at_bit_0(width, W):
    """The plain version reads a single-element packet at static offsets
    (alacjax's fast path); the kernel reads every element at its per-lane
    start.  At bit 0 the two agree on every field, on images of random
    words, short ones among them."""
    rng = np.random.default_rng(W * 10 + width)
    cfg = config(width, 24)
    words = random_image(rng, 64, W)
    # legal headers on half the lanes, so some parse clean
    tag = ElementTag.CPE if width == 2 else ElementTag.SCE
    hdr = (int(tag) << 20) | (1 << 1)           # bytes shifted 1
    words[::2, 0] = (words[::2, 0] & 0x1FF) | (hdr << 9)
    zeros = torch.zeros(64, dtype=torch.int32)
    for max_ord in (16, 30):
        fast = plain_parse.parse_element(words, None, None, tag, width, cfg,
                                         S, max_ord)
        window = plain_parse.parse_element(words, zeros, None, tag, width,
                                           cfg, S, max_ord)
        assert_same(fast, window, f"max_ord {max_ord}")
    assert not fast.err[::2].all() and fast.err[1::2].all()


def _args(B=4, W=9, width=2, device="cpu"):
    return dict(words=torch.zeros((B, W), dtype=torch.int32, device=device),
                bitpos=torch.zeros((B,), dtype=torch.int32, device=device),
                num=torch.full((B,), S, dtype=torch.int32, device=device),
                tag=ElementTag.CPE, width=width, config=config(2, 16),
                num_samples=S, max_ord=16)


@pytest.mark.parametrize("change,error,match", [
    (dict(words=torch.zeros((4, 9), dtype=torch.int64)), TypeError, "words"),
    (dict(words=torch.zeros((36,), dtype=torch.int32)), ValueError, "words"),
    (dict(words=torch.zeros((4, 9), dtype=torch.int32)[:, ::2]), ValueError,
     "contiguous"),
    (dict(words=torch.zeros((4, 0), dtype=torch.int32)), ValueError,
     "one word"),
    (dict(bitpos=torch.zeros((4,), dtype=torch.int64)), TypeError, "bitpos"),
    (dict(bitpos=torch.zeros((5,), dtype=torch.int32)), ValueError,
     "bitpos"),
    (dict(num=torch.zeros((4,), dtype=torch.int64)), TypeError, "num"),
    (dict(num=torch.zeros((4, 1), dtype=torch.int32)), ValueError, "num"),
    (dict(width=3), ValueError, "width"),
    (dict(num_samples=0), ValueError, "num_samples"),
    (dict(max_ord=31), ValueError, "max_ord"),
    (dict(num=torch.zeros((4,), dtype=torch.int32, device="meta")),
     ValueError, "mixed devices"),
], ids=["words-dtype", "words-rank", "words-strided", "words-empty",
        "bitpos-dtype", "bitpos-shape", "num-dtype", "num-shape", "width",
        "num_samples", "max_ord", "mixed-devices"])
def test_wrapper_checks_its_inputs(change, error, match):
    a = _args()
    a.update(change)
    kernels.reset_launches()
    with pytest.raises(error, match=match):
        k_parse.parse_element(**a)
    assert kernels.LAUNCHES["parse"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [8, 30], ids=["max_ord16", "max_ord30"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_in_decodes(cuda, parse_calls, case, taps):
    """Every parse of a card decode of the port's packets, against the
    plain version on the same arguments; the decode equal to the CPU's."""
    cfg, pcm, nums = frames(*CASES[case])
    words, _ = encode(cfg, pcm, nums, cuda)
    kernels.reset_launches()
    out, err, num = codec.decode_frames_device(words, cfg, S, taps=taps)
    assert kernels.LAUNCHES["parse"] == len(cfg.elements) == len(parse_calls)
    assert torch.equal(out.cpu(), torch.from_numpy(pcm)) and not err.any()
    assert torch.equal(num.cpu(), torch.from_numpy(nums))
    for k, (a, p) in enumerate(parse_calls):
        assert_same(p, plain_parse.parse_element(**on_cpu(a)), f"element {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_params_cut_on_card_equals_cpu(cuda, case):
    """The "params" cut reads the fields the decode does not keep (pbf,
    an escape lane's order) through the plain parse: on the card the
    same tuples as on the CPU, and no parse launch."""
    cfg, pcm, nums = frames(*CASES[case])
    words, _ = encode(cfg, pcm, nums)
    want = codec.decode_frames_device(words, cfg, S, stop_at="params")
    kernels.reset_launches()
    got = codec.decode_frames_device(words.to(cuda), cfg, S, stop_at="params")
    assert kernels.LAUNCHES["parse"] == 0
    got_flat = [t for ch in got[0] for t in ch] + list(got[1])
    want_flat = [t for ch in want[0] for t in ch] + list(want[1])
    assert len(got_flat) == len(want_flat)
    for g, w in zip(got_flat, want_flat):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


# crafted headers: a field's value on every lane, or a corruption
HEADER_CASES = ("legal", "wrong-tag", "unused-bits", "bad-shift", "den-0",
                "order-above-max", "order-31", "num-0", "num-above-S",
                "num-disagrees", "short-image", "random")


def craft(case: str, width: int, max_ord: int, depth: int, B: int = 256,
          seed: int = 0):
    """(words (B, W) int32, bitpos (B,) int32, num (B,) int32 or None):
    random words, and at each lane's start a header of ``case``."""
    rng = np.random.default_rng(seed)
    bs = {16: 0, 20: 0, 24: 1, 32: 2}[depth]
    W = 3 if case == "short-image" else 80
    bitpos = rng.integers(0, 32 * W - 1200 if W > 40 else 40, B)
    if case == "random":
        bitpos = rng.integers(-70, 32 * W + 100, B)
        return random_image(rng, B, W), torch.from_numpy(
            bitpos.astype(np.int32)), None
    bits = rng.integers(0, 2, (B, 32 * W + 64)).astype(np.uint8)

    def put(b, pos, value, n):
        for i in range(n):
            if 0 <= pos + i < bits.shape[1]:
                bits[b, pos + i] = (int(value) >> (n - 1 - i)) & 1

    for b in range(B):
        p = int(bitpos[b])
        esc = rng.random() < 0.25
        partial = rng.random() < 0.5
        tag = int(ElementTag.CPE if width == 2 else
                  (ElementTag.SCE, ElementTag.LFE)[b % 2])
        unused, bs_f = 0, 0 if esc else bs
        nsf = int(rng.integers(1, S + 1))
        orders = rng.integers(0, max_ord + 1, 2)
        dens = rng.integers(1, 16, 2)
        if b % 7 == 0:
            orders[b % 2] = 31
        if case == "wrong-tag":
            tag = int(rng.choice([t for t in range(8) if t != tag]))
        elif case == "unused-bits":
            unused = int(rng.integers(1, 1 << 12))
        elif case == "bad-shift":
            bs_f = int(rng.choice([v for v in range(4) if v != bs_f]))
        elif case == "den-0":
            dens[rng.integers(0, 2)] = 0
        elif case == "order-above-max":
            orders[rng.integers(0, 2)] = rng.integers(max_ord + 1, 32)
        elif case == "order-31":
            orders[:] = 31
        elif case == "num-0":
            partial, nsf = True, 0
        elif case == "num-above-S":
            partial, nsf = True, int(rng.integers(S + 1, 1 << 32))
        hdr = ((tag << 20) | (int(rng.integers(0, 16)) << 16) | (unused << 4)
               | (int(partial) << 3) | (bs_f << 1) | int(esc))
        put(b, p, hdr, 23)
        q = p + 23
        if partial:
            put(b, q, nsf, 32)
            q += 32
        q += 16                                 # mixbits, mixres: random
        for ci in range(width):
            ph = ((int(rng.integers(0, 16)) << 12) | (int(dens[ci]) << 8)
                  | (int(rng.integers(0, 8)) << 5) | int(orders[ci]))
            put(b, q, ph, 16)
            q += 16 + 16 * int(orders[ci])
    packed = np.packbits(bits[:, :32 * W], axis=1).view(">u4").astype(
        np.uint32)
    words = torch.from_numpy(packed.view(np.int32).copy())
    num = None
    if case == "num-disagrees":
        num = torch.from_numpy(rng.integers(1, S + 1, B).astype(np.int32))
    return words, torch.from_numpy(bitpos.astype(np.int32)), num


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [16, 24, 32])
@pytest.mark.parametrize("max_ord", [16, 30])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("case", HEADER_CASES)
def test_kernel_equals_plain_on_crafted_headers(cuda, case, width, max_ord,
                                                depth):
    """Per-lane starts, and bit 0 (a packet's first element) both for a
    single-element packet (the plain version's static offsets) and as
    5.1's first element; with and without the first element's num."""
    words, bitpos, num = craft(case, width, max_ord, depth,
                               seed=HEADER_CASES.index(case) * 100
                               + width * 10 + max_ord // 16)
    tag = ElementTag.CPE if width == 2 else ElementTag.SCE
    runs = [(config(width, depth), bitpos), (config(6, depth), bitpos),
            (config(width, depth), None), (config(6, depth), None)]
    for cfg, start in runs:
        for n in ((num,) if num is not None else (None, torch.full(
                (words.shape[0],), S, dtype=torch.int32))):
            a = dict(words=words, bitpos=start, num=n, tag=tag, width=width,
                     config=cfg, num_samples=S, max_ord=max_ord)
            want = plain_parse.parse_element(**a)
            got = k_parse.parse_element(**{
                k: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for k, v in a.items()})
            assert_same(got, want, f"{cfg.num_channels} channels, start "
                        f"{'lane' if start is not None else 0}, num "
                        f"{'given' if n is not None else 'own'}")
    if case not in ("legal", "random", "short-image"):
        assert want.err.any()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cd16", "surround24"])
def test_one_launch_per_element(cuda, cell):
    """B=4096 frames of 4096 samples on the benchmark's configurations:
    one parse launch per element (1 for stereo, 4 for 5.1), one
    decode.flags.sync per element, lossless."""
    from alacjax_torch.utils import metrics
    nch, depth, rate = (2, 16, 44100) if cell == "cd16" else (6, 24, 48000)
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=4096,
                     sample_rate=rate)
    g = torch.Generator(device=cuda).manual_seed(nch)
    t = torch.arange(4096, device=cuda, dtype=torch.float32)
    ph = torch.rand((4096, nch, 1), generator=g, device=cuda) * 6.28
    x = (torch.sin(0.013 * t + ph) * (1 << (depth - 3))).round().to(
        torch.int32)
    words, _ = codec.encode_frames_device(x, cfg, codec._num_words(cfg))
    codec.decode_frames_device(words, cfg, 4096)     # builds and warms
    torch.cuda.synchronize()
    kernels.reset_launches()
    metrics.drain()
    metrics.enable()
    try:
        out, err, _ = codec.decode_frames_device(words, cfg, 4096)
    finally:
        metrics.disable()
    torch.cuda.synchronize()
    spans = [s[2] for s in metrics.drain()]
    assert torch.equal(out, x) and not err.any()
    assert kernels.LAUNCHES["parse"] == len(cfg.elements)
    assert [s for s in spans if s.endswith(".sync")] == (
        ["decode.flags.sync"] * len(cfg.elements))
