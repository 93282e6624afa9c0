"""The decode's pcm stage: ``kernels.pcm.element_pcm`` (csrc/pcm.cu), one
launch per element that unmixes a CPE, re-inserts the shift bytes,
selects an escape lane's verbatim samples and zeroes the samples past a
lane's count, straight into the call's (B, C, S) output.

On the CPU the wrapper runs its plain version (alacjax_torch.ops.pcm),
and the port's decode through it equals alacjax's scalar decoder on
the port's packets: mono, stereo, 5.1 and 7.1 at depths 16, 20, 24 and
32 (bytes shifted 0, 1 and 2), with partial lanes, lanes where every
element escapes or one does, and elements whose every lane escapes,
with the channel scans' walk at 8 and at 30 taps; the "nounesc" cut
equals alacjax's.  The wrapper refuses a wrong dtype, shape or device.

The tests marked ``cuda`` hold the kernel to its plain version bit for
bit on the card: every element call of those decodes, and at B=4096
frames of 4096 samples on the benchmark's configurations (16-bit
stereo, 24-bit 5.1) with partial and escape lanes, where a decode also
launches the kernel once per element and waits on the card only for its
flags.  The card's machine has no jax, so run them there without the
test tier's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_pcm.py
"""

import dataclasses
import inspect
import pathlib
import sys

import numpy as np
import pytest
import torch

from alacjax_torch import codec, kernels
from alacjax_torch.kernels import pcm as k_pcm
from alacjax_torch.ops import bitpack
from alacjax_torch.ops import pcm as plain_pcm
from alacjax_torch.types import AlacConfig
from alacjax_torch.utils import metrics

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

S = 64
LANES = ("sine", "noise", "impulse", "sine", "silence", "sine")
NUMS = (S, S, S, 43, S, 17)      # lanes 3 and 5 are partial
MIXED_LANE = 5                   # noise in the first element's channels
# id: (channels, depth, index of an element whose every lane escapes)
CASES = {
    "mono24": (1, 24, None),
    "stereo16": (2, 16, None),
    "stereo32": (2, 32, None),
    "5.1-20": (6, 20, None),
    "5.1-24-sce-escapes": (6, 24, 0),
    "7.1-32": (8, 32, None),
    "7.1-16-cpe-escapes": (8, 16, 1),
}
NOUNESC = (3, 24, 0)


def config(nch: int, depth: int, frame_length: int = S) -> AlacConfig:
    return AlacConfig(bit_depth=depth, num_channels=nch,
                      frame_length=frame_length)


def element_channels(cfg, k: int) -> range:
    c0 = sum(width for _, width in cfg.elements[:k])
    return range(c0, c0 + cfg.elements[k][1])


def frames(nch: int, depth: int, esc_element, n: int = S):
    """(config, pcm (B, C, n) int32, nums (B,) int32) of LANES, frames of
    n samples; the first element is noise on MIXED_LANE, ``esc_element``
    on every lane."""
    cfg = config(nch, depth, n)
    rng = np.random.default_rng(1000 * nch + depth)
    pcm = np.stack([soak.gen_pcm(rng, kind, nch, n, depth)
                    for kind in LANES])
    noise = [soak.gen_pcm(rng, "noise", nch, n, depth) for _ in LANES]
    for ch in element_channels(cfg, 0):
        pcm[MIXED_LANE, ch] = noise[MIXED_LANE][ch]
    if esc_element is not None:
        for ch in element_channels(cfg, esc_element):
            pcm[:, ch] = np.stack(noise)[:, ch]
    nums = np.minimum(NUMS, n).astype(np.int32)
    for b, k in enumerate(nums):
        pcm[b, :, k:] = 0
    return cfg, pcm.astype(np.int32), nums


def encode(cfg, pcm, nums, device="cpu"):
    """The port's word image (B, W) int32 and packet bits (B,)."""
    return codec.encode_frames_device(
        torch.from_numpy(pcm).to(device), cfg, codec._num_words(cfg),
        nums=torch.from_numpy(nums).to(device))


@pytest.fixture
def pcm_calls(monkeypatch):
    """Each element_pcm call of the decodes run while it is active, as
    its arguments by name, but the output it writes into."""
    calls = []
    real = k_pcm.element_pcm
    sig = inspect.signature(real)

    def spy(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        calls.append({k: v for k, v in a.items() if k not in ("out", "c0")})
        return real(*args, **kwargs)
    monkeypatch.setattr(k_pcm, "element_pcm", spy)
    return calls, real


def hold_to_plain(calls, real):
    """Every recorded call through the kernel and through the plain
    version on the card: the same bits."""
    for a in calls:
        got = real(**a)
        want = plain_pcm.element_pcm(**a)
        assert torch.equal(got, want), {k: v for k, v in a.items()
                                        if not isinstance(v, torch.Tensor)}


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


@pytest.mark.parametrize("taps", [8, 30], ids=["chained", "taps30"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_through_plain_pcm_equals_alacjax(oracle, pcm_calls, case,
                                                 taps):
    """The 30-tap walk (``ffmpeg30.playback-hi``'s decode) gives these
    frames' PCM too: their orders decode the same at any width."""
    calls, _ = pcm_calls
    cfg, pcm, nums = frames(*CASES[case])
    words, bits = encode(cfg, pcm, nums)
    got, err, num = codec.decode_frames_device(words, cfg, S, taps=taps)
    want = oracle(cfg, words, bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pcm)
    assert not err.any()
    np.testing.assert_array_equal(num.numpy(), nums)
    # the case holds what it claims: the noise lane escapes in every
    # element, MIXED_LANE in the first, esc_element on every lane (and
    # then has no streams), the other lanes nowhere else
    esc_element = CASES[case][2]
    assert len(calls) == len(cfg.elements)
    for k, a in enumerate(calls):
        want_esc = torch.zeros(len(LANES), dtype=torch.bool)
        want_esc[[1, MIXED_LANE] if k == 0 else [1]] = True
        if k == esc_element:
            want_esc[:] = True
        assert torch.equal(a["esc"], want_esc), k
        assert (a["r0"] is None) == (k == esc_element)
        assert a["bs"] == {16: 0, 20: 0, 24: 1, 32: 2}[cfg.bit_depth]


def test_nounesc_cut_equals_alacjax():
    """The cut keeps what the unmix and shift bytes made of an escape
    lane's streams, and zeros for an element whose every lane escaped."""
    import jax
    import jax.numpy as jnp
    from alacjax import codec as jcodec
    from alacjax.types import AlacConfig as JaxConfig

    cfg, pcm, nums = frames(*NOUNESC)
    words, _ = encode(cfg, pcm, nums)
    got = codec.decode_frames_device(words, cfg, S, stop_at="nounesc")
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    want = jax.jit(lambda w: jcodec.decode_frames_device(
        w, jcfg, S, stop_at="nounesc"))(
            jnp.asarray(words.numpy().view(np.uint32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    # the SCE escaped on every lane: zeros, though its lanes carry samples
    assert not got[0][:, 0].any() and pcm[:, 0].any()


def _args(B=4, W=9, nch_out=3, width=2, device="cpu"):
    i32 = dict(dtype=torch.int32, device=device)
    a = dict(words=torch.zeros((B, W), dtype=torch.int32, device=device),
             num_samples=S, width=width, bs=1, depth=24,
             num=torch.full((B,), S, **i32),
             pos_shift=torch.zeros((B,), **i32),
             pos_esc=torch.zeros((B,), **i32),
             esc=torch.zeros((B,), dtype=torch.bool, device=device),
             r0=torch.zeros((B, S), dtype=torch.int32, device=device),
             r1=torch.zeros((B, S), dtype=torch.int32, device=device),
             mixbits=torch.zeros((B,), **i32),
             mixres=torch.zeros((B,), **i32),
             out=torch.zeros((B, nch_out, S), dtype=torch.int32,
                             device=device), c0=1)
    return a


@pytest.mark.parametrize("change,error,match", [
    (dict(words=torch.zeros((4, 9), dtype=torch.int64)), TypeError, "words"),
    (dict(r0=torch.zeros((4, S), dtype=torch.int64)), TypeError, "r0"),
    (dict(num=torch.zeros((4,), dtype=torch.int64)), TypeError, "num"),
    (dict(esc=torch.zeros((4,), dtype=torch.int64)), TypeError, "esc"),
    (dict(r1=torch.zeros((4, S + 1), dtype=torch.int32)), ValueError, "r1"),
    (dict(pos_shift=torch.zeros((5,), dtype=torch.int32)), ValueError,
     "pos_shift"),
    (dict(mixres=None), ValueError, "mixbits and mixres"),
    (dict(out=torch.zeros((4, 3, S), dtype=torch.int32)[:, :, ::1].transpose(
        0, 1).contiguous()), ValueError, "out"),
    (dict(c0=2), ValueError, "outside"),
    (dict(width=3), ValueError, "width"),
    (dict(bs=3), ValueError, "bs"),
    (dict(depth=33), ValueError, "depth"),
    (dict(width=1), ValueError, "SCE"),
    (dict(r0=None), ValueError, "r1 without r0"),
    (dict(mixbits=torch.zeros((4,), dtype=torch.int32, device="meta")),
     ValueError, "mixed devices"),
], ids=["words-dtype", "r0-dtype", "num-dtype", "esc-dtype", "r1-shape",
        "lane-shape", "mixres-missing", "out-shape", "c0-range", "width",
        "bs", "depth", "sce-with-cpe-args", "r1-alone", "mixed-devices"])
def test_wrapper_checks_its_inputs(change, error, match):
    a = _args()
    a.update(change)
    with pytest.raises(error, match=match):
        k_pcm.element_pcm(**a)
    assert kernels.LAUNCHES["pcm"] == 0


def test_wrapper_fills_only_its_channels():
    """Channels outside c0 .. c0 + width - 1 are left as they were; out=None
    gives a (B, width, S) tensor with the same values."""
    a = _args()
    a["r0"] = torch.arange(4 * S, dtype=torch.int32).reshape(4, S)
    a["r1"] = -a["r0"]
    a["out"].fill_(7)
    out = k_pcm.element_pcm(**a)
    assert out is a["out"]
    assert (out[:, 0] == 7).all()
    alone = k_pcm.element_pcm(**dict(a, out=None, c0=0))
    assert alone.shape == (4, 2, S)
    assert torch.equal(alone, out[:, 1:])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [S, S - 3], ids=["4-samples", "1-sample"])
@pytest.mark.parametrize("path", ["chained", "nounesc"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_on_card(cuda, pcm_calls, case, path, n):
    """Frames of S samples take the kernel's four-samples-a-thread form,
    of S - 3 (not a multiple of 4) its one-sample form."""
    calls, real = pcm_calls
    cfg, pcm, nums = frames(*CASES[case], n=n)
    words, _ = encode(cfg, pcm, nums)
    kw = dict(stop_at="nounesc") if path == "nounesc" else {}
    want = codec.decode_frames_device(words, cfg, n, **kw)
    calls.clear()
    kernels.reset_launches()
    got = codec.decode_frames_device(words.to(cuda), cfg, n, **kw)
    assert kernels.LAUNCHES["pcm"] == len(cfg.elements) == len(calls)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    hold_to_plain(calls, real)


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


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cd16", "surround24"])
def test_benchmark_shapes_on_card(cuda, pcm_calls, cell):
    """B=4096 frames of 4096 samples: lossless, one pcm launch per
    element, no matrix.scalar.sync, and one host sync per element (its
    flags), the kernel equal to its plain version on every call."""
    calls, real = pcm_calls
    nch, depth, rate = (2, 16, 44100) if cell == "cd16" else (6, 24, 48000)
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=4096,
                     sample_rate=rate)
    x, nums = card_music(cfg, 4096, cuda)
    words, _ = codec.encode_frames_device(x, cfg, codec._num_words(cfg),
                                          nums=nums)
    codec.decode_frames_device(words, cfg, 4096)     # builds and warms
    torch.cuda.synchronize()
    calls.clear()
    kernels.reset_launches()
    metrics.drain()
    metrics.enable()
    try:
        out, err, num = codec.decode_frames_device(words, cfg, 4096)
    finally:
        metrics.disable()
    torch.cuda.synchronize()
    spans = [s[2] for s in metrics.drain()]
    assert torch.equal(out, x) and not err.any() and torch.equal(num, nums)
    assert kernels.LAUNCHES["pcm"] == len(cfg.elements)
    assert "matrix.scalar.sync" not in spans
    assert [s for s in spans if s.endswith(".sync")] == (
        ["decode.flags.sync"] * len(cfg.elements))
    hold_to_plain(calls, real)
