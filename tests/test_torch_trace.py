"""The port's span recorder (alacjax_torch.utils.metrics) and the spans
of the device program and the host API.

Off, ``span`` hands out one shared no-op object and a whole encode and
decode records nothing.  On, the names and nesting of one call are
exactly the tree below, for a stereo and a 5.1 layout and for the
decode at 8 and at 30 taps, and for a stream call (``encode.stream``:
per packet step the banks' reset and an ``encode`` whose search and
sizing gather and commit the banks in ``encode.banks``); the host
API's spans nest under
``api.encode`` / ``api.decode``, and ``api.ladder`` / ``api.oracle``
open only for a chunk with flagged lanes (the retry ladder's streams of
tests/test_torch_ladder.py, written with the port's own oracle).

The ``cuda`` test holds the syncs that torch's sync debug mode reports
in one call of each benchmark cell's shape to that call's ``*.sync``
spans, and an encode's to its count (3 a stereo encode, 8 a 5.1 one:
``matrix.scalar.sync`` in ``encode.prep`` alone); on a machine with the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import pathlib
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from alacjax_torch import TorchCodec, codec
from alacjax_torch.oracle import ALACEncoder
from alacjax_torch.types import AlacConfig
from alacjax_torch.utils import metrics

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

S = 64
B = 8
STEREO16 = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
SURROUND24 = AlacConfig(bit_depth=24, num_channels=6, frame_length=S)


def leaf(name):
    return (name, [])


SCALAR = leaf("matrix.scalar.sync")


def encode_tree(channels: int, cpes: int, assemble=()):
    """The shift-off of every channel takes an int argument; the search's
    mixes take theirs as kernel arguments, so it waits on nothing; on the
    card a layout of SCEs and CPEs also reads its emission's cap back
    (``emit.cap.sync``)."""
    return ("encode", [
        ("encode.prep", [SCALAR] * channels),
        ("encode.search", [leaf("encode.mixres_trial")] * (cpes > 0)
         + [leaf("encode.predict_cost")]),
        leaf("encode.sizing"), leaf("encode.flags.sync"),
        leaf("encode.rice_words"), ("encode.assemble", list(assemble))])


ENCODE = encode_tree(2, 1)


def decode_tree(widths):
    """Per element (of ``widths`` channels each) its parse, flags
    readback, scan and pcm, whatever the walk's width.  The pcm kernel
    writes the call's output, so nothing follows; its shift bytes take
    no int argument, so no ``matrix.scalar.sync`` either."""
    per = [leaf("decode.parse"), leaf("decode.flags.sync"),
           leaf("decode.scan"), leaf("decode.pcm")]
    return ("decode", per * len(widths))


def tree(spans):
    """The recorded spans as nested (name, children), in opening order."""
    kids = {i: [] for i in range(len(spans))}
    roots = []
    for i, (_, _, _, parent, _, _) in enumerate(spans):
        (roots if parent is None else kids[parent]).append(i)

    def build(i):
        return (spans[i][2], [build(k) for k in kids[i]])
    return [build(i) for i in roots]


@pytest.fixture
def recorder():
    metrics.drain()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.disable()
        metrics.drain()


def frames(cfg, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([soak.gen_pcm(rng, "sine", cfg.num_channels, S,
                                  cfg.bit_depth) for _ in range(n)])


def encode_device(cfg, pcm):
    x = torch.from_numpy(pcm.astype(np.int32))
    return codec.encode_frames_device(x, cfg, codec._num_words(cfg))


def test_off_hands_out_one_object_and_records_nothing():
    metrics.drain()
    assert metrics.span("a") is metrics.span("b")
    with metrics.span("a") as got:
        assert got is None
    words, _ = encode_device(STEREO16, frames(STEREO16, B, 1))
    codec.decode_frames_device(words, STEREO16, S)
    assert metrics.readback(torch.arange(3), "x") == [0, 1, 2]
    assert metrics.drain() == []


def test_readback_is_tolist_inside_a_sync_span(recorder):
    t = torch.tensor([[1, -2], [3, 4]], dtype=torch.int64)
    assert metrics.readback(t, "site") == t.tolist()
    assert metrics.readback(t.sum(), "site") == 6
    assert [s[2] for s in recorder.drain()] == ["site.sync"] * 2


def test_span_records_times_parent_call_and_thread(recorder):
    def other():
        with metrics.span("other"):
            pass

    with metrics.span("outer"):
        with metrics.span("inner"):
            pass
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    spans = recorder.drain()
    got = {s[2]: s for s in spans}
    t0, t1, _, parent, call, tid = got["inner"]
    assert got["outer"][0] <= t0 <= t1 <= got["outer"][1]
    assert parent == spans.index(got["outer"]) and got["outer"][3] is None
    assert call == got["outer"][4] and tid == got["outer"][5]
    # another thread's span opens a call of its own
    assert got["other"][3] is None
    assert got["other"][4] != call and got["other"][5] != tid
    assert recorder.drain() == []


@pytest.mark.parametrize("cfg", [STEREO16, SURROUND24],
                         ids=["stereo16", "surround24"])
def test_encode_tree(recorder, cfg):
    encode_device(cfg, frames(cfg, B, 2))
    encode_device(cfg, frames(cfg, B, 3))
    spans = recorder.drain()
    want = encode_tree(cfg.num_channels,
                       sum(w == 2 for _, w in cfg.elements))
    assert tree(spans) == [want, want]
    roots = [s for s in spans if s[3] is None]
    assert len({s[4] for s in spans}) == 2
    for root in roots:
        inside = [s for s in spans if root[0] <= s[0] <= s[1] <= root[1]]
        assert {s[4] for s in inside} == {root[4]}


@pytest.mark.parametrize("taps", [8, 30], ids=["chained", "taps30"])
@pytest.mark.parametrize("cfg", [STEREO16, SURROUND24],
                         ids=["stereo16", "surround24"])
def test_decode_tree(recorder, cfg, taps):
    pcm = frames(cfg, B, 4)
    words, _ = encode_device(cfg, pcm)
    recorder.drain()
    out, err, _ = codec.decode_frames_device(words, cfg, S, taps=taps)
    assert (out.numpy() == pcm).all() and not err.any()
    spans = recorder.drain()
    widths = [w for _, w in cfg.elements]
    assert tree(spans) == [decode_tree(widths)]
    assert sum(s[2] == "decode.flags.sync" for s in spans) == len(widths)
    assert {s[4] for s in spans} == {spans[0][4]}


def stream_tree(steps: int, fresh: bool):
    """One encode_stream_device call: per packet step the banks' reset
    (with ``fresh``) and one encode whose search gathers each order's
    banks and the winner's, and whose sizing commits them."""
    banks = leaf("encode.banks")
    enc = ("encode", [
        ("encode.prep", [SCALAR] * 2),
        ("encode.search", [leaf("encode.mixres_trial"), banks,
                           leaf("encode.predict_cost"), banks]),
        ("encode.sizing", [banks]), leaf("encode.flags.sync"),
        leaf("encode.rice_words"), ("encode.assemble", [])])
    return ("encode.stream", ([banks] * fresh + [enc]) * steps)


@pytest.mark.parametrize("fresh", [False, True], ids=["resumed", "fresh"])
def test_stream_tree(recorder, fresh):
    cfg = STEREO16
    x = torch.from_numpy(frames(cfg, 2 * B, 8).astype(np.int32)).view(
        B, 2, 2, S)
    nw = codec._num_words(cfg)
    _, _, banks = codec.encode_stream_device(x, cfg, nw)
    recorder.drain()
    mask = torch.zeros((B, 2), dtype=torch.bool)
    mask[::3, 1] = True
    codec.encode_stream_device(x, cfg, nw, banks=banks,
                               fresh=mask if fresh else None)
    spans = recorder.drain()
    assert tree(spans) == [stream_tree(2, fresh)]
    assert {s[4] for s in spans} == {spans[0][4]}


def test_all_escape_encode_copies_its_row_inside_a_sync_span(recorder):
    rng = np.random.default_rng(7)
    pcm = rng.integers(-(1 << 15), 1 << 15, (B, 2, S))
    words, bits = encode_device(STEREO16, pcm)
    assert (bits.numpy() == 23 + 2 * 16 * S + 3).all()     # every lane
    assert tree(recorder.drain()) == [
        encode_tree(2, 1, assemble=[leaf("encode.row.sync")])]


def test_host_encode_spans_nest_under_api_encode(recorder):
    cfg = STEREO16
    pcm = frames(cfg, 10, 5)
    tc = TorchCodec(cfg, chunk=4, device="cpu")
    packets = tc.encode_frames(pcm)
    nums = np.full((10,), S, dtype=np.int32)
    nums[-1] = S - 5
    pcm[-1, :, S - 5:] = 0
    tc.encode_frames_ex(pcm, nums)
    t = tree(recorder.drain())
    assert [r[0] for r in t] == ["api.encode"] * 2
    for root, per_chunk_in in zip(t, (1, 2)):
        kids = [k[0] for k in root[1]]
        assert kids.count("encode") == kids.count("api.serdes") == 3
        assert kids.count("api.copy_in") == 3 * per_chunk_in
        assert set(kids) == {"encode", "api.serdes", "api.copy_in"}
        assert [k for k in root[1] if k[0] == "encode"] == [ENCODE] * 3
    enc = ALACEncoder(cfg, independent_frames=True)
    assert packets == [enc.encode_packet(x) for x in frames(cfg, 10, 5)]


def _ladder_stream(n_high: int):
    """64 stereo frames; ``n_high`` of them (every other one, from the
    first) at order 24 and the rest at order 12, or, with ``n_high`` 1,
    one frame at order 24 among the port's own packets."""
    rng = np.random.default_rng(1224)
    packets = []
    enc = ALACEncoder(STEREO16, independent_frames=True)
    for b in range(64):
        pcm = soak.gen_pcm(rng, "sine", 2, S, 16)
        if n_high == 1:
            packets.append(soak.build_packet(STEREO16, pcm, [24, 24], [0, 0])
                           if b == 17 else enc.encode_packet(pcm))
        else:
            order = 12 if b % 2 else 24
            packets.append(soak.build_packet(STEREO16, pcm, [order, order],
                                             [15 * (b % 3 == 0)] * 2))
    return packets


@pytest.mark.parametrize("flagged", ["none", "ladder", "oracle"])
def test_host_decode_spans_nest_under_api_decode(recorder, flagged):
    if flagged == "none":
        packets = ALACEncoder(STEREO16, independent_frames=True)
        packets = [packets.encode_packet(x) for x in frames(STEREO16, 64, 6)]
    else:
        packets = _ladder_stream(32 if flagged == "ladder" else 1)
    tc = TorchCodec(STEREO16, chunk=64, device="cpu")
    tc.decode_frames_ex(packets)
    assert tc.fallback_frames == (flagged == "oracle")
    (root,) = tree(recorder.drain())
    assert root[0] == "api.decode"
    kids = [k[0] for k in root[1]]
    head = ["api.serdes", "api.copy_in", "decode", "api.unpack"]
    assert kids[:4] == head
    assert root[1][2] == decode_tree([2])
    rest = {"none": [], "ladder": ["api.ladder"],
            "oracle": ["api.oracle"]}[flagged]
    assert kids[4:] == rest
    if flagged == "ladder":
        ladder = root[1][4][1]
        rung = [decode_tree([2])] + [leaf("api.ladder.sync")] * 4
        assert ladder == rung * 2


# ---------------------------------------------------------------------------
# the card: every blocking sync of a call sits in a *.sync span
# ---------------------------------------------------------------------------
CELLS = {
    # cd16.ingest, cd16.playback, surround24.playback; and the 5.1 encode,
    # whose per-lane bit sizes read the emission's cap back; the syncs an
    # encode waits on: a shift-off's per channel, the flags', the cap's
    "cd16.encode": (2, 16, 44100, "encode", 3),
    "cd16.decode": (2, 16, 44100, "decode", None),
    "surround24.decode": (6, 24, 48000, "decode", None),
    "surround24.encode": (6, 24, 48000, "encode", 8),
    # full-scale noise: every lane escapes (the all-escape assembly, which
    # copies its escape row to the card)
    "noise16.encode": (2, 16, 44100, "encode", 4),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sync count is the card's")
    return torch.device("cuda")


def music(n: int, nch: int, depth: int, device, noise: bool = False):
    """(n, nch, 4096) int32: per frame a chord with its own phases and a
    noise floor, at a quarter of full scale; or full-scale noise."""
    g = torch.Generator(device=device).manual_seed(17)
    if noise:
        return torch.randint(-(1 << (depth - 1)), 1 << (depth - 1),
                             (n, nch, 4096), generator=g, device=device,
                             dtype=torch.int32)
    t = torch.arange(4096, device=device, dtype=torch.float32)
    f = torch.tensor([0.011, 0.017, 0.023], device=device)
    ph = torch.rand((n, nch, 3, 1), generator=g, device=device) * 6.28
    x = torch.sin(f[None, None, :, None] * t + ph).sum(2) / 3
    noise = torch.randn((n, nch, 4096), generator=g, device=device) * 8
    return (x * (1 << (depth - 3)) + noise).round().to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_sync_warnings_equal_sync_spans_on_card(cuda, cell):
    nch, depth, rate, what, n_syncs = CELLS[cell]
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=4096,
                     sample_rate=rate)
    x = music(4096, nch, depth, cuda, noise=cell.startswith("noise"))
    words_n = codec._num_words(cfg)
    words, _ = codec.encode_frames_device(x, cfg, words_n)

    def call():
        if what == "encode":
            return codec.encode_frames_device(x, cfg, words_n)
        return codec.decode_frames_device(words, cfg, 4096)

    call()                       # builds and warms every kernel
    torch.cuda.synchronize()
    metrics.drain()
    metrics.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        metrics.disable()
    torch.cuda.synchronize()
    spans = metrics.drain()
    # (set_sync_debug_mode's own notice, once a process, is no sync)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    where = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in syncs]
    sync_spans = [s[2] for s in spans if s[2].endswith(".sync")]
    print(f"[trace] {cell}: {len(syncs)} sync warnings {where}; "
          f"{len(sync_spans)} sync spans {sync_spans}")
    assert len(syncs) == len(sync_spans), (where, sync_spans)
    if what == "encode":
        assert len(sync_spans) == n_syncs, sync_spans
        scalar = [s for s in spans if s[2] == "matrix.scalar.sync"]
        assert all(spans[s[3]][2] == "encode.prep" for s in scalar)
    if what == "decode":
        assert (out[0] == x).all() and not out[1].any()
