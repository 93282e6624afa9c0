"""Properties of the alacjax_torch package itself: it never imports jax
or any module of alacjax, its codec runs on the card unless asked for
the CPU, its kernel wrappers run the plain version only for CPU tensors
and refuse anything else rather than fall back, and the GPU smoke script
fails without a card.  The tests marked ``cuda`` hold each CUDA kernel
against its plain version on a card and skip without one.  The machine
with the card need not have jax, so run them there without the test
tier's conftest (which pins jax to the CPU):

    python -m pytest --noconftest -m cuda tests/test_torch_port.py
"""

import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from alacjax_torch import TorchCodec, get_codec, kernels
from alacjax_torch.kernels import _build
from alacjax_torch.kernels import cost as k_cost
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.kernels import emit as k_emit
from alacjax_torch.kernels import merge as k_merge
from alacjax_torch.kernels import parse as k_parse
from alacjax_torch.kernels import predict as k_predict
from alacjax_torch.ops import bitpack, fused_decode, parse, predict, rice
from alacjax_torch.oracle.encoder import PB_FACTOR
from alacjax_torch.state import init_coefs_batched
from alacjax_torch.types import (
    DENSHIFT_DEFAULT, AlacConfig, ElementTag, KB0, MB0, PB0,
)
from torch_decode_cases import decode_lanes
from torch_emit_cases import CAP, TILE_EDGE_S, emit_lanes
from torch_predict_cases import CASES as PREDICT_CASES
from torch_predict_cases import ORDER_PAIRS, predict_lanes, rice_lanes

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "alacjax_torch"
WB = (1 << KB0) - 1
RICE = (MB0, PB0, KB0, WB)
FOREIGN = ("jax", "jaxlib", "alacjax")     # top-level packages refused


def test_import_leaves_jax_out():
    """Importing the port loads no module of jax or of alacjax."""
    code = ("import sys\n"
            "import alacjax_torch, alacjax_torch.codec, alacjax_torch.kernels\n"
            "import alacjax_torch.state, alacjax_torch.native\n"
            "from alacjax_torch.kernels import cost, decode, emit, merge\n"
            "from alacjax_torch.kernels import predict\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FOREIGN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    """No module of the package (nor chip_smoke.py) names jax or an
    alacjax module in an import statement."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FOREIGN, (path, name)


def _field(packet: bytes, bit: int, n: int) -> int:
    v = int.from_bytes(packet, "big")
    return (v >> (8 * len(packet) - bit - n)) & ((1 << n) - 1)


def channel0_lanes(build, spec, S: int, seed: int):
    """Decode-kernel inputs for channel 0 of packets with forced orders.

    ``build`` is a forced-order packet builder (cfg, pcm, orders, modes)
    -> bytes; ``spec`` lists (depth, channels, order, mode, num) per
    lane.  Returns ((B, W) uint32 words, dict of per-lane numpy arrays
    start/pb/coefs (B, 30)/mode/order/den/num/cb, packets), each field
    read off the packet."""
    rng = np.random.default_rng(seed)
    packets, rows = [], []
    for depth, nch, order, mode, num in spec:
        cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
        t = np.arange(S)
        full = 1 << (depth - 1)
        pcm = np.clip((np.sin(t * 0.01) * (full // 4)
                       + np.sin(t * 0.1) * 200).astype(np.int64)[None, :]
                      + rng.integers(-3, 4, (nch, S)), -full, full - 1)
        packets.append(build(cfg, pcm[:, :num], [order] + [4] * (nch - 1),
                             [mode] * nch))
        at = 23 + (32 if num < S else 0) + 16 + 16
        coefs = [_field(packets[-1], at + 16 * k, 16)
                 for k in range(order % 31)]
        rows.append(dict(start=at + 16 * (order % 31),
                         coefs=[c - (c >> 15 << 16) for c in coefs],
                         cb=depth + (nch == 2), num=num, order=order,
                         mode=mode, pb=(cfg.pb * PB_FACTOR) // 4))
    words = bitpack.bytes_to_words(packets, max(map(len, packets)) // 4 + 3)
    lane = {k: np.array([r[k] for r in rows], np.int32)
            for k in ("start", "pb", "mode", "order", "num", "cb")}
    lane["den"] = np.full(len(rows), DENSHIFT_DEFAULT, np.int32)
    lane["coefs"] = np.zeros((len(rows), 30), np.int32)
    for b, r in enumerate(rows):
        lane["coefs"][b, :len(r["coefs"])] = r["coefs"]
    return words, lane, packets


def _small_inputs(rng, L=4, S=64):
    x = rng.integers(-3000, 3000, (L, S)).astype(np.int32)
    x[0] = 0
    return torch.from_numpy(x), init_coefs_batched(L, "cpu")


def test_cpu_tensors_take_the_plain_version(rng):
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    x, c0 = _small_inputs(rng)
    kernels.reset_launches()
    got = k_cost.pc_block_cost2(x, c0, (8,), 17, 9, *RICE, dual=True)
    want = predict.pc_block_cost2(x, c0, 8, 17, 9, *RICE)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w)
    got = k_cost.pc_block_cost2(x, c0, (4,), 17, 9, *RICE, dual=False)
    want = predict.pc_block_cost_coefs(x, c0, 4, 17, 9, *RICE)
    for g, w in zip((got[0], got[1], got[3]), want):
        assert torch.equal(g[0], w)
    start = torch.tensor([0, 5, 31, 64], dtype=torch.int32)
    got = k_emit.rice_encode_words(x, 17, *RICE, start)
    want = rice.rice_encode_words(x, 17, *RICE, start)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    words = torch.zeros((4, 40), dtype=torch.int32)
    words[:, :30] = got[0][:, :60:2]
    keys = torch.full((4, 12), -1, dtype=torch.int32)
    keys[:, :5] = torch.arange(5, dtype=torch.int32)
    vals = torch.arange(48, dtype=torch.int32).reshape(4, 12)
    tails = (torch.ones((4, 1), dtype=torch.int32),
             torch.full((4, 1), 7, dtype=torch.int32))
    assert torch.equal(k_merge.merge_sorted_chunks(vals, keys, *tails, 9),
                       bitpack.merge_sorted_chunks(vals, keys, *tails, 9))
    lane = [torch.full((4,), v, dtype=torch.int32) for v in (0, PB0)]
    per = (c0, torch.zeros((4,), dtype=torch.int32),
           torch.full((4,), 8, dtype=torch.int32),
           torch.full((4,), 9, dtype=torch.int32))
    got = k_decode.decode_channel(words, lane[0], 16, 17, MB0, lane[1], KB0,
                                  WB, *per)
    want = fused_decode.decode_channel(words, lane[0], 16, 17, MB0, lane[1],
                                       KB0, WB, *per)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = k_predict.pc_block(x, c0, 8, 17, 9)
    want = predict.pc_block(x, c0, 8, 17, 9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(k_predict.rice_cost(x, 17, *RICE),
                       rice.rice_cost(x, 17, *RICE))
    skip = torch.tensor([False, True, False, False])
    got = k_decode.cursor_scan(words, lane[0], 16, 17, MB0, lane[1], KB0, WB,
                               skip=skip)
    want = fused_decode.cursor_scan(words, lane[0], 16, 17, MB0, lane[1],
                                    KB0, WB, skip=skip)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = k_decode.decode_channel(words, lane[0], 16, 17, MB0, lane[1], KB0,
                                  WB, None, None, None, None, raw=True)
    want = fused_decode.decode_channel(words, lane[0], 16, 17, MB0, lane[1],
                                       KB0, WB, None, None, None, None,
                                       raw=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cfg = AlacConfig(bit_depth=16, num_channels=2)
    got = k_parse.parse_element(words, lane[0], None, ElementTag.CPE, 2, cfg,
                                16, 16)
    want = parse.parse_element(words, lane[0], None, ElementTag.CPE, 2, cfg,
                               16, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == dict.fromkeys(
        ("cost", "emit", "merge", "decode", "decode_hi", "decode_cursor",
         "decode_raw", "predict", "rice_cost", "parse", "pcm", "search_mix",
         "search_pick", "assemble"), 0)


def test_other_devices_raise_instead_of_falling_back(rng):
    x, c0 = _small_inputs(rng)
    with pytest.raises(ValueError, match="unsupported device"):
        k_cost.pc_block_cost2(x.to("meta"), c0.to("meta"), (8,), 17, 9,
                              *RICE)
    with pytest.raises(ValueError, match="mixed devices"):
        k_emit.rice_encode_words(x.to("meta"), 17, *RICE,
                                 torch.zeros((4,), dtype=torch.int32))


def test_cuda_entry_raises_without_a_gpu(monkeypatch, tmp_path):
    """Without a card the CUDA path raises: the codec on device "cuda"
    does not quietly run on the CPU, and the kernel build needs nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=64)
    pcm = np.zeros((2, 2, 64), dtype=np.int32)
    with pytest.raises((RuntimeError, AssertionError)):
        TorchCodec(cfg, chunk=2, device="cuda").encode_frames(pcm)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", ())
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib()
    assert not (tmp_path / "build").exists()


def test_codec_defaults_to_the_card():
    """TorchCodec(cfg) and get_codec(cfg) put their work on "cuda"; on a
    box without a card they raise, naming the device, rather than run on
    the CPU."""
    for fn in (TorchCodec, get_codec):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=64)
    for fn in (TorchCodec, get_codec):
        with pytest.raises(RuntimeError, match="'cuda'.*no CUDA device"):
            fn(cfg)
    assert TorchCodec(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result line without a
    card, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cwd = REPO
    script = REPO / "chip_smoke.py"
    if alone:
        cwd = tmp_path
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("order,dual", [(4, True), (8, True), (8, False)])
def test_cost_kernel_on_card(cuda, order, dual):
    x, c0 = _small_inputs(np.random.default_rng(order), L=96, S=300)
    x, c0 = x.to(cuda), c0.to(cuda)
    got = k_cost.pc_block_cost2(x, c0, (order,), 17, 9, *RICE, dual=dual)
    got = [g[0] for g in got]
    if dual:
        _same(got, predict.pc_block_cost2(x, c0, order, 17, 9, *RICE))
    else:
        _same((got[0], got[1], got[3]),
              predict.pc_block_cost_coefs(x, c0, order, 17, 9, *RICE))


@pytest.mark.cuda
def test_emit_kernel_on_card(cuda):
    rng = np.random.default_rng(2)
    x, _ = _small_inputs(rng, L=96, S=300)
    x[1] = torch.from_numpy(rng.integers(-2, 3, 300).astype(np.int32))
    start = torch.from_numpy(rng.integers(0, 3000, 96).astype(np.int32))
    got = k_emit.rice_encode_words(x.to(cuda), 17, *RICE, start.to(cuda))
    _same(got, rice.rice_encode_words(x, 17, *RICE, start))


@pytest.mark.cuda
def test_merge_and_decode_kernels_on_card(cuda):
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=256)
    rng = np.random.default_rng(3)
    t = np.arange(256)
    pcm = np.stack([np.clip(np.sin(t * (0.01 + 0.003 * b)) * 9000
                            + rng.integers(-40, 40, (2, 256)), -32768, 32767)
                    for b in range(12)]).astype(np.int32)
    pcm[3] = rng.integers(-32768, 32768, (2, 256))    # escapes
    pcm[5] = 0
    codec = TorchCodec(cfg, chunk=12, device="cuda")
    kernels.reset_launches()
    out, nums = codec.decode_frames_ex(codec.encode_frames(pcm))
    assert all(kernels.LAUNCHES[k] > 0
               for k in ("cost", "emit", "merge", "decode")), kernels.LAUNCHES
    np.testing.assert_array_equal(out, pcm)
    assert codec.fallback_frames == 0
    cpu = TorchCodec(cfg, chunk=12, device="cpu")
    assert codec.encode_frames(pcm) == cpu.encode_frames(pcm)


# (depth, channels, channel 0's order, mode, num): chanbits 16/17/20/21
HI_LANES = [(16, 1, 12, 0, 256), (16, 2, 30, 15, 256), (20, 1, 17, 0, 77),
            (20, 2, 24, 0, 256), (16, 1, 9, 15, 200), (20, 1, 30, 0, 256),
            (16, 2, 16, 0, 256), (20, 2, 31, 0, 256), (16, 1, 0, 0, 256),
            (20, 1, 4, 15, 256), (16, 2, 21, 15, 64), (20, 2, 8, 0, 256)] * 8


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [16, 30])
def test_decode_hi_kernel_on_card(cuda, taps):
    """The 16- and 30-tap decode instances with per-lane chanbits equal
    the plain version, and count under decode_hi."""
    import chip_smoke
    words, lane, _ = channel0_lanes(chip_smoke.forced_order_packet,
                                    HI_LANES, 256, taps)
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    t["coefs"] = t["coefs"][:, :taps].contiguous()
    w = torch.from_numpy(words.view(np.int32))

    def run(dev):
        d = {k: v.to(dev) for k, v in t.items()}
        return k_decode.decode_channel(
            w.to(dev), d["start"], 256, d["cb"], MB0, d["pb"], KB0, WB,
            d["coefs"], d["mode"], d["order"], d["den"], num=d["num"],
            taps=taps, chanbits_max=21)

    kernels.reset_launches()
    got = run(cuda)
    assert kernels.LAUNCHES["decode_hi"] == 1
    assert kernels.LAUNCHES["decode"] == 0
    _same(got, run("cpu"))


@pytest.mark.cuda
def test_51_24bit_decode_on_card(cuda):
    """24-bit 5.1 (four chained elements, shift bytes, an escaped frame
    and a partial one) decodes losslessly on the card, equal to the
    codec on the CPU."""
    from alacjax_torch.oracle import ALACEncoder
    cfg = AlacConfig(bit_depth=24, num_channels=6, frame_length=256)
    rng = np.random.default_rng(51)
    t = np.arange(256)
    pcm = np.stack([(np.round(np.sin(t * (0.01 + 0.002 * b) + np.arange(6)
                                     [:, None]) * 3e6).astype(np.int64))
                    + rng.integers(-300, 300, (6, 256)) for b in range(12)])
    pcm[4] = rng.integers(-(1 << 23), 1 << 23, (6, 256))    # escapes
    pcm[7, :, 100:] = 0                                     # partial
    enc = ALACEncoder(cfg, independent_frames=True)
    packets = [enc.encode_packet(f[:, :100] if b == 7 else f)
               for b, f in enumerate(pcm)]
    codec = TorchCodec(cfg, chunk=12, device="cuda")
    kernels.reset_launches()
    out, nums = codec.decode_frames_ex(packets)
    assert kernels.LAUNCHES["decode"] > 0
    assert codec.fallback_frames == 0
    np.testing.assert_array_equal(out, pcm)
    assert nums[7] == 100
    cpu_out, _ = TorchCodec(cfg, chunk=12,
                            device="cpu").decode_frames_ex(packets)
    np.testing.assert_array_equal(out, cpu_out)


def _lane_args(rng, L, S):
    """Per-lane int32 chanbits (16, 17, 20, 21) and sample counts (some
    lanes full, some partial down to 1)."""
    cb = rng.choice([16, 17, 20, 21], L)
    num = np.where(rng.random(L) < 0.5, S, rng.integers(1, S + 1, L))
    num[:3] = (S, 1, S - 1)
    return (torch.from_numpy(cb.astype(np.int32)),
            torch.from_numpy(num.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", list(PREDICT_CASES) + [(4096, 1024)])
def test_predict_kernel_on_card(cuda, L, S):
    """The standalone predictor at the edges of its tiles and at a wide
    shape: every static order, two to a launch with one block of
    starting coefficients each and per-lane chanbits 16..33, and each
    order alone with an int chanbits, equals the plain version."""
    x, cb, c0 = (torch.from_numpy(v).to(cuda) for v in predict_lanes(
        np.random.default_rng(L * 1000 + S), L, S))
    for pair in ORDER_PAIRS:
        kernels.reset_launches()
        got = k_predict.pc_block(x, c0, pair, cb, 9)
        assert kernels.LAUNCHES["predict"] == 1
        _same(got, k_predict.plain_pc_block(x, c0, pair, cb, 9))
        _same(k_predict.pc_block(x, c0[0], pair, cb, 9),
              k_predict.plain_pc_block(x, c0[0], pair, cb, 9))
    for order in k_predict.ORDERS:
        _same(k_predict.pc_block(x, c0[0], order, 17, 9),
              predict.pc_block(x, c0[0], order, 17, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", list(PREDICT_CASES) + [(4096, 1024)])
def test_rice_cost_kernel_on_card(cuda, L, S):
    """The cost-only Rice pass, single and dual, with and without num, at
    an int and a per-lane bit size (16..33), equals the plain version at
    the edges of its tiles and at a wide shape."""
    r, bs, num = (torch.from_numpy(v).to(cuda) for v in rice_lanes(
        np.random.default_rng(L * 1000 + S), L, S))
    for bit_size in (17, bs):
        for n in (None, num):
            for dual in (False, True):
                kernels.reset_launches()
                got = k_predict.rice_cost(r, bit_size, *RICE, num=n,
                                          dual=dual)
                assert kernels.LAUNCHES["rice_cost"] == 1
                want = k_predict.plain_rice_cost(r, bit_size, *RICE, num=n,
                                                 dual=dual)
                assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("orders,dual", [((4,), True), ((4, 8), True),
                                         ((8,), False)])
def test_cost_kernel_per_lane_on_card(cuda, orders, dual):
    """The cost kernel with per-lane chanbits and num equals its plain
    version."""
    rng = np.random.default_rng(200 + orders[-1])
    x, c0 = _small_inputs(rng, L=96, S=300)
    x[2, 150:] = 0
    cb, num = _lane_args(rng, 96, 300)
    got = k_cost.pc_block_cost2(x.to(cuda), c0.to(cuda), orders, cb.to(cuda),
                                9, *RICE, dual=dual, num=num.to(cuda))
    _same(got, k_cost.plain(x, c0, orders, cb, 9, *RICE, dual=dual, num=num))


@pytest.mark.cuda
def test_emit_kernel_per_lane_on_card(cuda):
    """The emit kernel with per-lane bit sizes up to 21 (a 20-bit CPE)
    and num equals its plain version."""
    rng = np.random.default_rng(21)
    x, _ = _small_inputs(rng, L=96, S=300)
    x[3] = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, 300)
                            .astype(np.int32))          # escapes at 21 bits
    x[4, 10:] = 0
    cb, num = _lane_args(rng, 96, 300)
    start = torch.from_numpy(rng.integers(0, 3000, 96).astype(np.int32))
    got = k_emit.rice_encode_words(x.to(cuda), cb.to(cuda), *RICE,
                                   start.to(cuda), bit_size_cap=21,
                                   num=num.to(cuda))
    _same(got, rice.rice_encode_words(x, cb, *RICE, start, bit_size_cap=21,
                                      num=num))


@pytest.mark.cuda
@pytest.mark.parametrize("predict_legacy", [False, True])
def test_51_encode_on_card(cuda, predict_legacy):
    """24-bit 5.1 with partial frames encodes on the card to the oracle's
    packets, through the cost kernel or through the standalone predictor
    and the Rice cost kernel (then the cost kernel never launches)."""
    from alacjax_torch.oracle import ALACEncoder
    cfg = AlacConfig(bit_depth=24, num_channels=6, frame_length=256)
    rng = np.random.default_rng(52)
    t = np.arange(256)
    pcm = np.stack([(np.round(np.sin(t * (0.01 + 0.002 * b) + np.arange(6)
                                     [:, None]) * 3e6).astype(np.int64))
                    + rng.integers(-300, 300, (6, 256)) for b in range(12)])
    pcm[4] = rng.integers(-(1 << 23), 1 << 23, (6, 256))    # escapes
    nums = np.full(12, 256)
    nums[[2, 7]] = (1, 100)
    for b, n in enumerate(nums):
        pcm[b, :, n:] = 0
    codec = TorchCodec(cfg, chunk=12, device="cuda",
                       predict_legacy=predict_legacy)
    kernels.reset_launches()
    packets = codec.encode_frames_ex(pcm, nums)
    used = [k for k, v in kernels.LAUNCHES.items() if v]
    assert used == (["emit", "merge", "predict", "rice_cost"] if predict_legacy
                    else ["cost", "emit", "merge"]) + [
        "search_mix", "search_pick", "assemble"], kernels.LAUNCHES
    enc = ALACEncoder(cfg, independent_frames=True)
    assert packets == [enc.encode_packet(f[:, :n]) for f, n in zip(pcm, nums)]


@pytest.mark.cuda
@pytest.mark.parametrize("orders,dual", [((4, 8), True), ((8,), False)])
def test_cost_kernel_per_order_coefs_on_card(cuda, orders, dual):
    """With one (L, 16) block of starting coefficients per order (the
    persistent banks), each order walks from its own block: the kernel
    equals its plain version."""
    rng = np.random.default_rng(300 + len(orders))
    x, _ = _small_inputs(rng, L=96, S=300)
    c0 = torch.from_numpy(rng.integers(-400, 400, (len(orders), 96, 16))
                          .astype(np.int32))
    cb, num = _lane_args(rng, 96, 300)
    got = k_cost.pc_block_cost2(x.to(cuda), c0.to(cuda), orders, cb.to(cuda),
                                9, *RICE, dual=dual, num=num.to(cuda))
    _same(got, k_cost.plain(x, c0, orders, cb, 9, *RICE, dual=dual, num=num))


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_stream_encode_on_card(cuda, fast):
    """encode_streams on the card equals the stateful oracle on every
    packet, with an element that escapes mid-stream."""
    from alacjax_torch import encode_streams
    from alacjax_torch.oracle import ALACEncoder
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=256,
                     fast_mode=fast)
    rng = np.random.default_rng(77)
    pcm = np.stack([np.stack([_music(rng, 2, 256) for _ in range(4)])
                    for _ in range(5)])
    pcm[1, 2] = rng.integers(-32768, 32768, (2, 256))      # escapes
    got = encode_streams(pcm, cfg)
    for b, stream in enumerate(pcm):
        enc = ALACEncoder(cfg)
        assert got[b] == [enc.encode_packet(p) for p in stream], b


@pytest.mark.cuda
def test_sharded_codec_on_card(cuda):
    """The frames axis with the card listed twice: the same packets and
    samples as the one-device codec."""
    from alacjax_torch import ShardedCodec
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=256)
    pcm = np.stack([_music(np.random.default_rng(b), 2, 256)
                    for b in range(9)])
    plain = TorchCodec(cfg, chunk=4, device=cuda)
    sharded = ShardedCodec(cfg, [cuda, cuda], chunk=3)
    packets = plain.encode_frames(pcm)
    assert sharded.encode_frames(pcm) == packets
    out, nums = sharded.decode_frames_ex(packets)
    assert (nums == 256).all() and np.array_equal(out, pcm)
    _, _, _, total, mismatch, _ = sharded.roundtrip_step(pcm)
    assert int(total) == sum(map(len, packets)) and int(mismatch) == 0


# ---------------------------------------------------------------------------
# the cost and decode kernels at the main path's widths against their plain
# versions: ragged (33) and full (4096) lane counts, short and full frames
# ---------------------------------------------------------------------------
SHAPES = [(33, 100), (33, 1024), (33, 4096), (4096, 100), (4096, 1024),
          (4096, 4096)]
N_DISTINCT = 16          # distinct forced-order packets, tiled to B


def _music(rng, B, S, scale=9000):
    """(B, S) int32 of sines with a little noise, as 16-bit audio."""
    t = np.arange(S)
    f = rng.uniform(0.002, 0.05, (B, 1))
    x = (np.sin(t * f + rng.uniform(0, 6, (B, 1))) * scale
         + rng.integers(-60, 61, (B, S)))
    return np.clip(x, -32768, 32767).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", SHAPES)
def test_cost_kernel_shapes_on_card(cuda, L, S):
    """The cost kernel equals the multi-order plain version: the search
    (orders 4 and 8, two machines) and the trial (order 8, one machine),
    with per-lane chanbits and num."""
    rng = np.random.default_rng(L + S)
    x = torch.from_numpy(_music(rng, L, S)).to(cuda)
    x[0] = 0
    if L > 2:
        x[2, S // 2:] = 0
    c0 = init_coefs_batched(L, cuda)
    cb, num = (t.to(cuda) for t in _lane_args(rng, L, S))
    for orders, dual in (((4, 8), True), ((8,), False)):
        want = k_cost.plain(x, c0, orders, cb, 9, *RICE, dual=dual, num=num)
        _same(k_cost.pc_block_cost2(x, c0, orders, cb, 9, *RICE, dual=dual,
                                    num=num), want)


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", [(33, s) for s in TILE_EDGE_S] + SHAPES)
def test_emit_kernel_shapes_on_card(cuda, L, S):
    """The emit kernel equals its plain version at the edges of its
    32-step tiles and at the main path's widths, with per-lane bit sizes
    (cap 21), sample counts and start phases."""
    lanes = emit_lanes(np.random.default_rng(L + S), L, S)
    x, bs, num, start = (torch.from_numpy(v).to(cuda) for v in lanes)
    want = k_emit.plain(x, bs, *RICE, start, bit_size_cap=CAP, num=num)
    kernels.reset_launches()
    got = k_emit.rice_encode_words(x, bs, *RICE, start, bit_size_cap=CAP,
                                   num=num)
    assert kernels.LAUNCHES["emit"] == 1
    _same(got, want)


def _codec_lanes(cuda, rng, B, S):
    """B mono 16-bit packets the codec encodes on the card, and their
    decode-kernel lane fields read off the packets."""
    cfg = AlacConfig(bit_depth=16, num_channels=1, frame_length=S)
    pcm = _music(rng, B, S)[:, None, :]
    packets = TorchCodec(cfg, chunk=B, device=cuda).encode_frames(pcm)
    assert not any(_field(p, 22, 1) for p in packets)     # none escaped
    param = [_field(p, 39, 16) for p in packets]
    order = np.array([v & 31 for v in param], np.int32)
    lane = dict(
        order=order, mode=np.array([v >> 12 for v in param], np.int32),
        den=np.array([(v >> 8) & 15 for v in param], np.int32),
        pb=np.array([(cfg.pb * ((v >> 5) & 7)) // 4 for v in param],
                    np.int32),
        start=(55 + 16 * order).astype(np.int32))
    coefs = np.zeros((B, 8), np.int32)
    for b, p in enumerate(packets):
        for k in range(order[b]):
            c = _field(p, 55 + 16 * k, 16)
            coefs[b, k] = c - (c >> 15 << 16)
    lane["coefs"] = coefs
    return packets, lane


def _forced_lanes(rng, B, S, taps):
    """N_DISTINCT mono 16-bit forced-order packets (chip_smoke.py ::
    forced_order_packet) tiled to B, with orders above the next narrower
    walk (9..16 at 16 taps, 17..30 at 30) and modes 0 and 15."""
    import chip_smoke
    lo = 9 if taps == 16 else 17
    spec = [(16, 1, lo + i % (taps - lo + 1), 15 * (i // 2 % 2), S)
            for i in range(min(B, N_DISTINCT))]
    _, lane, packets = channel0_lanes(chip_smoke.forced_order_packet, spec,
                                      S, int(rng.integers(1 << 16)))
    reps = -(-B // len(spec))
    lane = {k: np.concatenate([v] * reps)[:B] for k, v in lane.items()
            if k not in ("num", "cb")}
    return (packets * reps)[:B], lane


def _stream_lanes(cuda, B, S, seed, taps):
    """Decode-kernel inputs of B mono 16-bit packets, then damaged: every
    third row has random bit flips past its start, every fifth lane
    decodes only part of its samples, and the image is cut to the median
    row length so the longer rows run off its end.  At 8 taps the packets
    are the codec's own; at 16 and 30 taps, forced-order ones."""
    rng = np.random.default_rng(seed)
    packets, lane = (_codec_lanes(cuda, rng, B, S) if taps == 8
                     else _forced_lanes(rng, B, S, taps))
    lane["num"] = np.where(np.arange(B) % 5 == 2, rng.integers(1, S + 1, B),
                           S).astype(np.int32)
    lens = [len(p) for p in packets]
    words = bitpack.bytes_to_words(packets, max(lens) // 4 + 3)
    for b in range(1, B, 3):
        n_bits = 8 * lens[b] - int(lane["start"][b])
        for bit in int(lane["start"][b]) + rng.integers(0, n_bits, 3):
            words[b, bit // 32] ^= np.uint32(1 << (31 - bit % 32))
    w = np.ascontiguousarray(words[:, :int(np.median(lens)) // 4])
    t = {k: torch.from_numpy(v).to(cuda) for k, v in lane.items()}
    return torch.from_numpy(w.view(np.int32)).to(cuda), t


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [8, 16, 30])
@pytest.mark.parametrize("B,S", SHAPES)
def test_decode_kernel_damaged_rows_on_card(cuda, B, S, taps):
    """Each decode instance (8, 16 and 30 taps) equals the plain version
    on samples, end bits and error flags, truncated and corrupt rows
    included."""
    words, t = _stream_lanes(cuda, B, S, B + S + taps, taps)
    args = (words, t["start"], S, 16, MB0, t["pb"], KB0, WB, t["coefs"],
            t["mode"], t["order"], t["den"])
    want = k_decode.plain(*args, num=t["num"], taps=taps)
    assert not want[2].all()
    _same(k_decode.decode_channel(*args, num=t["num"], taps=taps), want)


# ---------------------------------------------------------------------------
# the decode kernel's row-mapped launch, its cursor and raw
# instances, and per-lane chanbits 16..33, against their plain versions
# ---------------------------------------------------------------------------
# (L, S, rows): one row per lane, and lanes stacked 3 and 2 to a row
DECODE_CASES = [(33, 100, None), (96, 300, 32), (4096, 1024, 2048)]


def _decode_case(cuda, L, S, rows, taps=30):
    words, lane = decode_lanes(np.random.default_rng(L + S), L, S, rows,
                               taps)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in lane.items()}
    return torch.from_numpy(words.view(np.int32)).to(cuda), t


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [8, 16, 30])
@pytest.mark.parametrize("L,S,rows", DECODE_CASES)
def test_decode_kernel_rows_and_chanbits33_on_card(cuda, L, S, rows, taps):
    """Each decode instance with lanes stacked on fewer word rows and
    per-lane chanbits 16..33 equals the plain version."""
    words, t = _decode_case(cuda, L, S, rows, taps)
    args = (words, t["start"], S, t["cb"], MB0, t["pb"], KB0, WB, t["coefs"],
            t["mode"], t["order"], t["den"])
    want = k_decode.plain(*args, num=t["num"], taps=taps, chanbits_max=33)
    kernels.reset_launches()
    got = k_decode.decode_channel(*args, num=t["num"], taps=taps,
                                  chanbits_max=33)
    assert kernels.LAUNCHES[k_decode.counter(taps)] == 1
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("L,S,rows", DECODE_CASES)
def test_decode_cursor_kernel_on_card(cuda, L, S, rows):
    """The cursor instance equals its plain version (skipped lanes stay
    put) and ends where the full decode ends on every other lane."""
    words, t = _decode_case(cuda, L, S, rows)
    args = (words, t["start"], S, t["cb"], MB0, t["pb"], KB0, WB)
    kw = dict(chanbits_max=33, skip=t["skip"], num=t["num"])
    want = k_decode.plain_cursor(*args, **kw)
    kernels.reset_launches()
    got = k_decode.cursor_scan(*args, **kw)
    assert kernels.LAUNCHES["decode_cursor"] == 1
    _same(got, want)
    _, end, _ = k_decode.decode_channel(
        *args, t["coefs"], t["mode"], t["order"], t["den"], num=t["num"],
        taps=30, chanbits_max=33)
    keep = ~t["skip"]
    assert torch.equal(got[0][keep], end[keep])
    assert torch.equal(got[0][t["skip"]], t["start"][t["skip"]])


@pytest.mark.cuda
@pytest.mark.parametrize("L,S,rows", DECODE_CASES)
def test_decode_raw_kernel_on_card(cuda, L, S, rows):
    """The raw instance equals its plain version, per-lane bit sizes and
    one bit size for every lane."""
    words, t = _decode_case(cuda, L, S, rows)
    for cb, cb_max in ((t["cb"], 33), (17, None)):
        args = (words, t["start"], S, cb, MB0, t["pb"], KB0, WB, None, None,
                None, None)
        want = k_decode.plain(*args, num=t["num"], chanbits_max=cb_max,
                              raw=True)
        kernels.reset_launches()
        got = k_decode.decode_channel(*args, num=t["num"],
                                      chanbits_max=cb_max, raw=True)
        assert kernels.LAUNCHES["decode_raw"] == 1
        _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", [(67, 100), (4096, 1024)])
def test_cost_kernel_chanbits33_on_card(cuda, L, S):
    """The cost kernel at per-lane chanbits 16..33 equals the plain
    version: the search (orders 4 and 8, two machines) and the trial."""
    x, cb, c0 = (torch.from_numpy(v).to(cuda) for v in
                 predict_lanes(np.random.default_rng(L), L, S, n_orders=1))
    for orders, dual in (((4, 8), True), ((8,), False)):
        want = k_cost.plain(x, c0[0], orders, cb, 9, *RICE, dual=dual)
        _same(k_cost.pc_block_cost2(x, c0[0], orders, cb, 9, *RICE,
                                    dual=dual), want)


@pytest.mark.cuda
@pytest.mark.parametrize("nch,depth", [(2, 16), (6, 24)])
def test_multichannel_decode_on_card(cuda, nch, depth):
    """The oracle encoder's packets (an escaped frame and a partial one
    among them) decode on the card as on the CPU, with one 8-tap launch
    per channel and no cursor launch, and losslessly."""
    from alacjax_torch.oracle import ALACEncoder
    S = 256
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    rng = np.random.default_rng(nch + depth)
    t = np.arange(S)
    lim = 1 << (depth - 1)
    pcm = np.stack([np.round(np.sin(t * (0.01 + 0.002 * b)
                                    + np.arange(nch)[:, None]) * lim / 8)
                    .astype(np.int64) + rng.integers(-30, 30, (nch, S))
                    for b in range(12)])
    pcm[4] = rng.integers(-lim, lim, (nch, S))              # escapes
    pcm[7, :, 100:] = 0                                     # partial
    enc = ALACEncoder(cfg, independent_frames=True)
    packets = [enc.encode_packet(f[:, :100] if b == 7 else f)
               for b, f in enumerate(pcm)]
    codec = TorchCodec(cfg, chunk=12, device="cuda")
    words = torch.from_numpy(bitpack.bytes_to_words(
        packets, codec.num_words).view(np.int32))
    want = TorchCodec(cfg, chunk=12, device="cpu")._decode(words)
    kernels.reset_launches()
    got = codec._decode(words.to(cuda))
    assert kernels.LAUNCHES["decode_cursor"] == 0
    assert kernels.LAUNCHES["decode"] == nch
    _same(got, want)
    out, nums = codec.decode_frames_ex(packets)
    assert codec.fallback_frames == 0
    assert nums[7] == 100
    np.testing.assert_array_equal(out, pcm)
