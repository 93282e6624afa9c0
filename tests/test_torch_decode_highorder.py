"""decode_frames_device on FFmpeg's high-order packets (orders up to 30,
``alacenc.c -max_prediction_order 30``): at ``taps=30`` the parse reads
30 coefficients and every channel walks 30 taps; at 8 or 16 the lanes of
a higher order flag and the others decode.

Packets come from the benchmark's plain reference (benchmark/ref/:
highorder.encode and its decoder), at a tiny size on the CPU: ``taps=30``
equals the reference decoder on orders 4..30 with a partial tail and an
escape lane; ``taps=16`` equals ``taps=30`` at
orders up to 16; each lane flags at a width below its order and no
other lane does; the 30-coefficient parse reads back no more than the
8-tap one (one ``decode.flags.sync`` per element).

The ``cuda`` tests decode the benchmark's shapes (B = S = 4096) on the
card: the ffmpeg30 cell's packets, orders uniform over 4..30, and 5.1
packets of orders 4, 12 and 24, at 30 taps, lossless, with the host
syncs that torch's sync debug mode reports equal to the ``*.sync``
spans.  On a machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_highorder.py
"""

import pathlib
import sys
import warnings

import pytest
import torch

from alacjax_torch import codec, kernels
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.utils import metrics

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmark.lib import common, inputs  # noqa: E402
from benchmark.ref import codec as rc  # noqa: E402
from benchmark.ref import highorder  # noqa: E402

S = 256
B = 8
STEREO16 = dict(bit_depth=16, num_channels=2, sample_rate=44100,
                elements=[["CPE", 2]])
SURROUND24 = dict(bit_depth=24, num_channels=6, sample_rate=48000,
                  elements=[["SCE", 1], ["CPE", 2], ["CPE", 2], ["LFE", 1]])


@pytest.fixture()
def taps_seen(monkeypatch):
    """The taps of every channel decode the codec asks for."""
    seen = []
    wrapped = k_decode.decode_channel

    def recorder(*args, taps=8, **kwargs):
        seen.append(taps)
        return wrapped(*args, taps=taps, **kwargs)

    monkeypatch.setattr(k_decode, "decode_channel", recorder)
    return seen


@pytest.fixture
def recorder():
    metrics.drain()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.disable()
        metrics.drain()


def packets(layout: dict, orders, seed: int, tail: bool = False,
            noise_lane: int | None = None):
    """(words (B, W) int32 as the port takes them, pcm (B, C, S), num
    (B,), the port's config, the escaped lanes (B,)): music at ``orders``
    ((B, C) or one order per channel), lane B-1 a partial frame with
    ``tail``, and lane ``noise_lane`` full-scale noise, which escapes."""
    cfg = dict(layout, frame_length=S, mb=10, pb=40, kb=14,
               search="standard")
    lay = common.layout(cfg)
    pcm = inputs.music(B, lay, cfg["sample_rate"], seed, 1, "cpu")
    num = torch.full((B,), S, dtype=torch.int64)
    if tail:
        num[-1] = S // 2 - 3
        pcm[-1, :, num[-1]:] = 0
    if noise_lane is not None:
        lim = 1 << (lay.bit_depth - 1)
        pcm[noise_lane] = torch.randint(
            -lim, lim, pcm.shape[1:], dtype=torch.int32,
            generator=torch.Generator().manual_seed(seed))
    orders = torch.as_tensor(orders).expand(B, lay.channels)
    img, _, st = highorder.encode(pcm, lay, orders, num=num)
    # the noise lane's elements escape, and no other
    esc = torch.zeros((B,), dtype=torch.bool)
    if noise_lane is not None:
        esc[noise_lane] = True
    assert torch.equal(st["escaped"], esc.expand(lay.channels, B))
    ref, ref_num, ref_err = rc.decode(img, lay)
    assert torch.equal(ref, pcm.to(torch.int64)) and not ref_err.any()
    assert torch.equal(ref_num, num)
    port_cfg = common.port_config(cfg)
    assert img.shape[1] == codec._num_words(port_cfg)
    return inputs.as_i32(img), pcm, num, port_cfg, esc


def decode(words, cfg, taps):
    return codec.decode_frames_device(words, cfg, S, taps=taps)


def assert_same(got, want):
    for name, g, w in zip(("pcm", "err", "num"), got, want):
        assert torch.equal(g, w), name


def high_orders(seed: int):
    """(B, 2) orders uniform over 4..30, lane 0 at 30 and 29."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randint(4, 31, (B, 2), generator=g)
    o[0] = torch.tensor([30, 29])
    return o


def test_30_taps_equal_the_reference_on_high_orders(taps_seen):
    words, pcm, num, cfg, _ = packets(STEREO16, high_orders(5), 5,
                                      tail=True, noise_lane=2)
    got = decode(words, cfg, 30)
    assert taps_seen == [30, 30]
    assert torch.equal(got[0], pcm)
    assert not got[1].any()
    assert torch.equal(got[2], num.to(torch.int32))


@pytest.mark.parametrize("taps", [8, 16])
def test_narrower_walks_flag_exactly_the_lanes_above_them(taps):
    """A lane flags at a width below its channels' largest order, unless
    it escaped (its samples are verbatim); every other lane decodes."""
    orders = high_orders(17)
    words, pcm, _, cfg, esc = packets(STEREO16, orders, 17, tail=True,
                                      noise_lane=3)
    want_err = (orders.amax(dim=1) > taps) & ~esc
    assert want_err.any() and not want_err.all()
    pcm_t, err, _ = decode(words, cfg, taps)
    assert torch.equal(err, want_err)
    assert torch.equal(pcm_t[~err], pcm[~err])


def test_orders_up_to_16_equal_at_16_and_30_taps(taps_seen):
    g = torch.Generator().manual_seed(16)
    orders = torch.randint(1, 17, (B, 2), generator=g)
    orders[3] = 16
    words, pcm, _, cfg, _ = packets(STEREO16, orders, 7, tail=True)
    got = decode(words, cfg, 16)
    assert taps_seen == [16, 16]
    assert torch.equal(got[0], pcm) and not got[1].any()
    assert_same(decode(words, cfg, 30), got)


def test_surround_at_30_taps(taps_seen):
    """5.1: SCE at order 4, the CPEs at 12 and 24, the LFE at 4; at 16
    taps every lane flags (the second CPE)."""
    words, pcm, _, cfg, _ = packets(SURROUND24, [4, 12, 12, 24, 24, 4], 9,
                                    tail=True)
    got = decode(words, cfg, 30)
    assert taps_seen == [30] * 6
    assert torch.equal(got[0], pcm) and not got[1].any()
    assert decode(words, cfg, 16)[1].all()


@pytest.mark.parametrize("layout,orders", [
    (STEREO16, [24, 9]),
    (SURROUND24, [4, 12, 12, 24, 24, 4]),
], ids=["stereo16", "surround24"])
def test_the_30_coefficient_parse_adds_no_sync(recorder, layout, orders):
    words, _, _, cfg, _ = packets(layout, orders, 13)
    syncs = []
    for taps in (8, 30):
        recorder.drain()
        decode(words, cfg, taps)
        syncs.append([s[2] for s in recorder.drain()
                      if s[2].endswith(".sync")])
    assert syncs[0] == syncs[1] == (["decode.flags.sync"]
                                    * len(layout["elements"]))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the decode kernel runs on the card")
    return torch.device("cuda")


def card_packets(layout: dict, orders, device, n: int = 4096,
                 distinct: int = 512):
    """``n`` packets of 4096 samples on the card, ``distinct`` of them
    written and tiled; ``orders`` one per channel, or None for orders
    drawn uniform over 4..30 per channel."""
    cfg = dict(layout, frame_length=4096, mb=10, pb=40, kb=14,
               search="standard")
    lay = common.layout(cfg)
    pcm = inputs.music(distinct, lay, cfg["sample_rate"], 2 ** 31 + 19, 1,
                       device)
    if orders is None:
        g = inputs.generator(2 ** 31 + 19, 3, device)
        orders = torch.randint(4, 31, (distinct, lay.channels), generator=g,
                               device=device)
    else:
        orders = torch.tensor(orders, device=device).expand(distinct, -1)
    img, _, _ = highorder.encode(pcm, lay, orders)
    lanes = inputs.tile(n, distinct, device)
    return (inputs.as_i32(img)[lanes].contiguous(), pcm[lanes],
            common.port_config(cfg))


def traced_call(fn):
    """(fn's result, the syncs torch's sync debug mode reported, the
    port's spans) of one call."""
    torch.cuda.synchronize()
    metrics.drain()
    metrics.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        metrics.disable()
    torch.cuda.synchronize()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return out, syncs, [s[2] for s in metrics.drain()]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ffmpeg30", "surround24"])
def test_benchmark_shapes_on_card(cuda, case):
    layout, orders = {
        "ffmpeg30": (STEREO16, None),
        "surround24": (SURROUND24, [4, 12, 12, 24, 24, 4]),
    }[case]
    words, pcm, cfg = card_packets(layout, orders, cuda)
    decode_4096 = lambda: codec.decode_frames_device(  # noqa: E731
        words, cfg, 4096, taps=30)
    decode_4096()                                        # builds and warms
    kernels.reset_launches()
    got, syncs, spans = traced_call(decode_4096)
    assert torch.equal(got[0], pcm) and not got[1].any()
    assert torch.equal(got[2], torch.full_like(got[2], 4096))
    n_elem = len(layout["elements"])
    assert len(syncs) == n_elem
    assert [s for s in spans if s.endswith(".sync")] == (
        ["decode.flags.sync"] * n_elem)
    assert kernels.LAUNCHES["decode"] == 0
    assert kernels.LAUNCHES["decode_hi"] == layout["num_channels"]
