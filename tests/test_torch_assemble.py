"""The encode's chunk assembly: ``kernels.assemble.chunks``
(csrc/assemble.cu), every element's header tokens, shift-byte block and
Rice rows, the per-lane escape select, the tails and the END tag in one
launch, in place of the int64 torch glue of ``ops.assemble``.

On the CPU the wrapper runs its plain version (alacjax_torch.ops.
assemble, the glue moved unchanged out of codec.py): the packets of the
encode through it equal alacjax's scalar oracle encoder on mono, stereo
and 5.1 at depths 16, 20, 24 and 32 (chanbits 33 included), full and
partial frames, the fast and exhaustive searches, escape lanes mixed per
lane, an element that escapes on every lane beside compressed ones,
every lane escaped (full frames: the host row; partial: the escape
chunks through the wrapper), and persistent banks; the wrapper's column
layout (what sizes the kernel's grid) equals the plain version's shapes;
each encode calls the wrapper once; the "assemble" cut reads the plain
version and merges into the encode's own packets; the wrapper refuses
bad dtypes, shapes, devices and overlapping elements.

The tests marked ``cuda`` hold the kernel to its plain version bit for
bit on the card on every call of the cases above (S = 64 and S = 61),
the encode on the card to the CPU's, and B = 4096 encodes on the
benchmark's two shapes (S = 4096 and an odd S) to one ``assemble``
launch whose outputs equal the plain version's.  The card's machine has
no jax, so run them there without the test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_assemble.py
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
from alacjax_torch.kernels import assemble as k_assemble
from alacjax_torch.kernels import merge as k_merge
from alacjax_torch.ops import bitpack
from alacjax_torch.types import AlacConfig

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

S = 64
# per lane: the content of every channel (None: each channel its own)
LANES = ("sine", "noise", "impulse", "silence", None, "sine")

# id: (channels, depth, config keywords, partial frames, content)
#   "lanes": LANES; "element": the first CPE full-scale noise on every
#   lane (that element escapes everywhere, the others compress);
#   "all": full-scale noise everywhere (every lane escapes)
CASES = {
    "mono16": (1, 16, {}, False, "lanes"),
    "stereo16": (2, 16, {}, True, "lanes"),
    "stereo16-full": (2, 16, {}, False, "lanes"),
    "stereo20": (2, 20, {}, True, "lanes"),
    "stereo32": (2, 32, {}, True, "lanes"),          # CPE chanbits 33
    "mono32": (1, 32, {}, False, "lanes"),
    "5.1-24": (6, 24, {}, True, "lanes"),
    "5.1-24-full": (6, 24, {}, False, "lanes"),
    "5.1-24-element": (6, 24, {}, True, "element"),
    "5.1-32-element": (6, 32, {}, False, "element"),
    "5.1-16-fast": (6, 16, dict(fast_mode=True), True, "lanes"),
    "stereo24-exhaustive": (2, 24, dict(search="exhaustive"), True,
                            "lanes"),
    "stereo16-all-partial": (2, 16, {}, True, "all"),
    "5.1-24-all-full": (6, 24, {}, False, "all"),
}


def make_case(case: str, n: int = S, seed: int = 0):
    """(config, pcm (B, C, n) int32 numpy, nums (B,) int32 or None)."""
    nch, depth, kw, partial, content = CASES[case]
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=n, **kw)
    rng = np.random.default_rng(seed + 100 * nch + depth)
    own = ("sine", "noise", "impulse", "sine", "silence", "noise")
    if content == "all":
        kinds = ["noise"] * len(LANES)
    else:
        kinds = LANES
    pcm = np.stack([
        soak.gen_pcm(rng, k, nch, n, depth) if k is not None
        else np.stack([soak.gen_pcm(rng, own[c], 1, n, depth)[0]
                       for c in range(nch)])
        for k in kinds]).astype(np.int32)
    if content == "element":
        pcm[:, 1:3] = soak.gen_pcm(rng, "noise", 2 * len(pcm), n,
                                   depth).reshape(len(pcm), 2, n)
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


@pytest.fixture
def assemble_calls(monkeypatch):
    """Every call of the wrapper, as (args, result)."""
    calls = []
    real = k_assemble.chunks

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(k_assemble, "chunks", spy)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_packets_equal_alacjax_oracle(case):
    cfg, pcm, nums = make_case(case)
    got = packets(*device_encode(cfg, pcm, nums))
    enc = AlacjaxOracle(alacjax_config(cfg), independent_frames=True)
    for i, frame in enumerate(pcm):
        n = cfg.frame_length if nums is None else int(nums[i])
        assert got[i] == enc.encode_packet(frame[:, :n]), f"frame {i}"


@pytest.mark.parametrize("nch", [2, 6])
def test_streams_with_banks_equal_stateful_oracle(nch):
    """Persistent banks: each header carries the coefficients its
    winning order started from, a bank's after the first packet."""
    cfg = AlacConfig(bit_depth=16 if nch == 2 else 24, num_channels=nch,
                     frame_length=S)
    rng = np.random.default_rng(24 + nch)
    pcm = np.stack([np.stack([soak.gen_pcm(rng, k, nch, S, cfg.bit_depth)
                              for k in ("sine", "impulse", "noise", "sine")])
                    for _ in range(3)]).astype(np.int32)
    got = encode_streams(pcm, cfg, device="cpu")
    for b in range(len(pcm)):
        enc = AlacjaxOracle(alacjax_config(cfg))
        assert got[b] == [enc.encode_packet(f) for f in pcm[b]], f"stream {b}"


# id: wrapper calls an encode of the case makes (full frames where every
# lane escaped take the host row, no call)
CALLS = {case: 0 if case == "5.1-24-all-full" else 1 for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_one_wrapper_call_per_encode(assemble_calls, case):
    cfg, pcm, nums = make_case(case)
    kernels.reset_launches()
    device_encode(cfg, pcm, nums)
    assert len(assemble_calls) == CALLS[case]
    assert kernels.LAUNCHES["assemble"] == 0       # CPU: the plain version
    for (elems, emitted, *_), _ in assemble_calls:
        assert len(elems) == len(cfg.elements)
        assert (emitted is None) == (CASES[case][4] == "all")


@pytest.mark.parametrize("case", [c for c in CASES if CALLS[c]])
def test_layout_is_the_plain_versions(assemble_calls, case):
    """The wrapper's columns, which size the kernel's grid and outputs,
    are the plain version's: element by element (each element's columns
    hold its own keys only) and in total, tails included."""
    cfg, pcm, nums = make_case(case)
    device_encode(cfg, pcm, nums)
    (args, (vals, keys, tv, tk, bits)), = assemble_calls
    elems, emitted, total_c = args[:3]
    R = 0 if emitted is None else emitted[0].shape[1]
    lay = k_assemble.layout(elems, emitted is not None, cfg.frame_length,
                            cfg.bit_depth, nums is not None, R)
    assert sum(x[4] for x in lay) == vals.shape[1] == keys.shape[1]
    assert sum(x[5] for x in lay) + 2 == tv.shape[1] == tk.shape[1]
    assert torch.equal(bits, (total_c + 3).to(torch.int32))
    col = 0
    for i, (e, x) in enumerate(zip(elems, lay)):
        Te = x[4]
        nxt = elems[i + 1]["start"] if i + 1 < len(elems) else total_c
        k = keys[:, col:col + Te].to(torch.int64)
        lo = (e["start"] >> 5)[:, None].expand_as(k)
        hi = (nxt >> 5)[:, None].expand_as(k)
        real = k >= 0
        assert bool((k[real] >= lo[real]).all())
        assert bool((k[real] <= hi[real]).all())
        col += Te


def test_assemble_cut_reads_the_plain_version(assemble_calls):
    """The "assemble" cut calls no wrapper, and its chunks (padded to the
    escape width) and tails merge into the encode's own packets."""
    cfg, pcm, nums = make_case("5.1-24")
    x, nd = torch.from_numpy(pcm), torch.from_numpy(nums)
    nw = codec._num_words(cfg)
    vals, keys, tv, tk, bits = codec._encode_packet_chunks(
        x, cfg, nw, nums=nd, stop_at="assemble")
    assert not assemble_calls
    words, want_bits, _ = codec._encode_packet_chunks(x, cfg, nw, nums=nd)
    assert len(assemble_calls) == 1
    assert torch.equal(bits, want_bits)
    merged = k_merge.merge_sorted_chunks(
        vals, keys, torch.stack(tv, 1).to(torch.int32),
        torch.stack(tk, 1).to(torch.int32), nw)
    assert torch.equal(merged, words)


def _one_call(case="5.1-24"):
    """A recorded wrapper call's arguments (copies of the dicts)."""
    calls = []
    real = k_assemble.chunks
    k_assemble.chunks = lambda *a: calls.append(a) or real(*a)
    try:
        device_encode(*make_case(case))
    finally:
        k_assemble.chunks = real
    elems, emitted, total_c, cfg, nums = calls[0]
    return [dict(e) for e in elems], emitted, total_c, cfg, nums


def _bad(what):
    elems, emitted, total_c, cfg, nums = _one_call()
    if what == "dtype":
        elems[0]["start"] = elems[0]["start"].to(torch.int32)
    elif what == "shape":
        elems[1]["los"] = [t[:, :-1] for t in elems[1]["los"]]
    elif what == "emitted rows":
        emitted = (emitted[0][1:],) + tuple(emitted[1:])
    elif what == "device":
        elems[2]["orders"] = [t.to("meta") for t in elems[2]["orders"]]
    elif what == "overlap":
        elems[2]["ch0"] -= 1
    elif what == "elements":
        elems = elems * 3
    elif what == "nums":
        nums = nums.to(torch.int32)
    return elems, emitted, total_c, cfg, nums


@pytest.mark.parametrize("what,error,match", [
    ("dtype", TypeError, "start"),
    ("shape", ValueError, "los"),
    ("emitted rows", ValueError, "emitted"),
    ("device", ValueError, "device"),
    ("overlap", ValueError, "overlap"),
    ("elements", ValueError, "elements"),
    ("nums", TypeError, "nums"),
])
def test_wrapper_checks_its_inputs(what, error, match):
    args = _bad(what)
    with pytest.raises(error, match=match):
        k_assemble.chunks(*args)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card")
    return torch.device("cuda")


def to(v, dev):
    """Tensors in nested dicts, lists and tuples on ``dev``."""
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: to(x, dev) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to(x, dev) for x in v)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("n", [S, 61])
@pytest.mark.parametrize("case", [c for c in CASES if CALLS[c]])
def test_kernel_equals_plain_on_card(cuda, assemble_calls, case, n):
    """Every call of the case's CPU encode through the kernel: vals,
    keys, tails and total bits of the plain version, bit for bit."""
    cfg, pcm, nums = make_case(case, n)
    device_encode(cfg, pcm, nums)
    assert assemble_calls
    for args, want in list(assemble_calls):
        kernels.reset_launches()
        got = k_assemble.chunks(*to(args, cuda))
        assert kernels.LAUNCHES["assemble"] == 1
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [S, 61])
@pytest.mark.parametrize("case", list(CASES))
def test_encode_on_card_equals_cpu(cuda, case, n):
    cfg, pcm, nums = make_case(case, n)
    want = device_encode(cfg, pcm, nums)
    got = device_encode(cfg, pcm, nums, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_streams_with_banks_on_card_equal_cpu(cuda):
    cfg = AlacConfig(bit_depth=24, num_channels=6, frame_length=S)
    rng = np.random.default_rng(7)
    pcm = np.stack([np.stack([soak.gen_pcm(rng, k, 6, S, 24)
                              for k in ("sine", "noise", "sine")])
                    for _ in range(4)]).astype(np.int32)
    assert encode_streams(pcm, cfg, device="cuda") == encode_streams(
        pcm, cfg, device="cpu")


def card_music(cfg, B: int, device):
    """(B, C, S) int32 on the card: a chord per frame with its own phases
    and a noise floor; frame 1 full-scale noise (every element escapes);
    every 64th frame partial."""
    depth, nch, n = cfg.bit_depth, cfg.num_channels, cfg.frame_length
    g = torch.Generator(device=device).manual_seed(depth * nch + n)
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 1001])
@pytest.mark.parametrize("cell", ["cd16", "surround24"])
def test_benchmark_shapes_on_card(cuda, assemble_calls, cell, n):
    """B = 4096 frames: one assemble launch an encode, equal to the plain
    version on the same inputs (run on the card), and the packets decode
    losslessly."""
    nch, depth, rate = (2, 16, 44100) if cell == "cd16" else (6, 24, 48000)
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=n,
                     sample_rate=rate)
    x, nums = card_music(cfg, 4096, cuda)
    n_words = codec._num_words(cfg)
    codec.encode_frames_device(x, cfg, n_words, nums=nums)   # builds, warms
    assemble_calls.clear()
    kernels.reset_launches()
    words, _ = codec.encode_frames_device(x, cfg, n_words, nums=nums)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["assemble"] == 1
    (args, got), = assemble_calls
    want = k_assemble.plain(*args)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    del want, got, args
    assemble_calls.clear()
    dec, err, num = codec.decode_frames_device(words, cfg, n)
    assert torch.equal(dec, x) and not err.any() and torch.equal(num, nums)
