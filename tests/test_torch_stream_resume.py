"""Whole-track encodes on the CPU, tolerance 0: encode_stream_device
resumed from the banks an earlier call returned, with lanes that start a
new track (``fresh``) at packets of their own.

A call with staggered track starts equals, packet for packet, the
stateful scalar oracle ALACEncoder(cfg) run track by track (a new
encoder at each track's first packet), the benchmark's plain reference
(benchmark/ref/stream.py, also its banks) and alacjax's encode_streams
on the same whole tracks; two calls that carry the banks equal one call
over the same packets, packets and returned banks alike; ``fresh`` set
everywhere is the independent-frames encode; the exhaustive search with
banks raises.  The tracks hold a noise packet, whose element escapes
and must leave its banks as they were.

The ``cuda`` test holds a packet step of the stream encode at B = 4096
to the syncs of one encode_frames_device call; on a machine with the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_stream_resume.py
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from alacjax_torch import encode_stream_device
from alacjax_torch.codec import _num_words, encode_frames_device
from alacjax_torch.oracle import ALACEncoder
from alacjax_torch.ops.bitpack import words_to_bytes
from alacjax_torch.types import AlacConfig, AlacParamError
from alacjax_torch.utils import metrics

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmark.lib import inputs  # noqa: E402
from benchmark.ref import codec as rc  # noqa: E402
from benchmark.ref import stream as rs  # noqa: E402

S, B, N = 256, 8, 6
LAYOUTS = {
    "stereo16": (dict(bit_depth=16, num_channels=2), (("CPE", 2),)),
    "surround24": (dict(bit_depth=24, num_channels=6),
                   (("SCE", 1), ("CPE", 2), ("CPE", 2), ("LFE", 1))),
}
# track starts, lane by lane, besides every lane's packet 0
STARTS = [[3], [3], [1, 4], [2], [5], [], [1, 2, 3, 4, 5], [2, 4]]


def layout_config(name):
    kw, elements = LAYOUTS[name]
    cfg = AlacConfig(frame_length=S, **kw)
    lay = rc.Layout(bit_depth=cfg.bit_depth, frame_length=S,
                    elements=elements)
    return cfg, lay


def tracks_pcm(cfg, seed: int) -> np.ndarray:
    """(B, N, C, S) int32: a chord per lane, its phase moving from packet
    to packet, over a noise floor; lane 2's packet 3 full-scale noise (an
    escape inside a track)."""
    rng = np.random.default_rng(seed)
    C = cfg.num_channels
    amp = 1 << (cfg.bit_depth - 3)
    t = np.arange(N * S)
    out = np.empty((B, N, C, S), np.int64)
    for b in range(B):
        f = rng.uniform(0.003, 0.03, (C, 1))
        x = amp * np.sin(f * t + rng.uniform(0, 6.28, (C, 1)))
        x += rng.normal(0, 40, x.shape)
        out[b] = x.round().astype(np.int64).reshape(C, N, S).transpose(
            1, 0, 2)
    full = 1 << (cfg.bit_depth - 1)
    out[2, 3] = rng.integers(-full, full, (C, S))
    return out.astype(np.int32)


def fresh_mask() -> np.ndarray:
    fresh = np.zeros((B, N), bool)
    for b, starts in enumerate(STARTS):
        fresh[b, starts] = True
    return fresh


def segments(fresh):
    """(lane, first packet, end) of every track a lane plays."""
    out = []
    for b in range(B):
        cuts = [0] + [t for t in range(1, N) if fresh[b, t]] + [N]
        out += [(b, s, e) for s, e in zip(cuts, cuts[1:])]
    return out


def packets(words, bits):
    w, b = words.numpy(), bits.numpy()
    return [words_to_bytes(w[i], b[i]) for i in range(w.shape[0])]


def encode(x, cfg, banks=None, fresh=None):
    return encode_stream_device(x, cfg, _num_words(cfg), banks=banks,
                                fresh=fresh)


def oracle_tracks(cfg, pcm, fresh):
    out = [[None] * N for _ in range(B)]
    banks = []
    for b, s, e in segments(fresh):
        enc = ALACEncoder(cfg)
        for t in range(s, e):
            out[b][t] = enc.encode_packet(pcm[b, t])
        if e == N:
            banks.append(enc._coef_banks)
    return out, banks


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_staggered_track_starts_equal_the_oracle_reference_and_alacjax(name):
    from alacjax.codec import encode_streams as jax_encode_streams
    from alacjax.types import AlacConfig as JaxConfig
    cfg, lay = layout_config(name)
    pcm = tracks_pcm(cfg, seed=len(name))
    fresh = fresh_mask()
    words, bits, banks = encode(torch.from_numpy(pcm), cfg,
                                fresh=torch.from_numpy(fresh))
    got = packets(words, bits)
    want, oracle_banks = oracle_tracks(cfg, pcm, fresh)
    assert got == want
    assert any(p[2] & 0x02 for p in got[2])          # the escape
    # the oracle's banks after each lane's last packet
    for b, by in enumerate(oracle_banks):
        for (ch, od), coefs in by.items():
            np.testing.assert_array_equal(banks[ch][od][b].numpy(), coefs)
    # the benchmark's reference, packets and banks
    r_img, r_bits, r_banks, _ = rs.encode_stream(
        torch.from_numpy(pcm), lay, fresh=torch.from_numpy(fresh))
    assert packets(inputs.as_i32(r_img), r_bits) == got
    for ch, by in banks.items():
        for od, bank in by.items():
            assert torch.equal(r_banks[ch][od], bank.to(torch.int64))
    # alacjax on the same tracks, each from its first packet (zero frames
    # after a track's end keep one shape for every track)
    segs = segments(fresh)
    x = np.zeros((len(segs),) + pcm.shape[1:], np.int32)
    for k, (b, s, _) in enumerate(segs):
        x[k, :N - s] = pcm[b, s:]
    ref = jax_encode_streams(x, JaxConfig(**dataclasses.asdict(cfg)))
    for k, (b, s, e) in enumerate(segs):
        assert ref[k][:e - s] == got[b][s:e], (b, s, e)


def test_two_resumed_calls_equal_one_call():
    cfg, _ = layout_config("stereo16")
    x = torch.from_numpy(tracks_pcm(cfg, seed=4))
    fresh = torch.from_numpy(fresh_mask())
    w, b, banks = encode(x, cfg, fresh=fresh)
    w1, b1, banks1 = encode(x[:, :2], cfg, fresh=fresh[:, :2])
    w2, b2, banks2 = encode(x[:, 2:], cfg, banks=banks1, fresh=fresh[:, 2:])
    assert torch.equal(torch.cat([b1, b2], 1), b)
    assert torch.equal(torch.cat([w1, w2], 1), w)
    assert banks2.keys() == banks.keys()
    for ch, by in banks.items():
        assert by.keys() == banks2[ch].keys() == {4, 8}
        for od, bank in by.items():
            assert torch.equal(banks2[ch][od], bank)
    # without the banks the second call starts every lane afresh
    w3, _, _ = encode(x[:, 2:], cfg, fresh=fresh[:, 2:])
    assert not torch.equal(w3, w2)
    # no reset at all: packet 0 alone starts a track
    w4, b4, _ = encode(x, cfg)
    out = packets(w4, b4)
    for lane in range(B):
        enc = ALACEncoder(cfg)
        assert out[lane] == [enc.encode_packet(p) for p in x[lane].numpy()]


def test_fresh_everywhere_is_independent_frames():
    cfg, _ = layout_config("stereo16")
    pcm = tracks_pcm(cfg, seed=5)
    x = torch.from_numpy(pcm)
    _, _, carried = encode(x[:, :3], cfg)
    words, bits, banks = encode(x, cfg, banks=carried,
                                fresh=torch.ones((B, N), dtype=torch.bool))
    iw, ib = encode_frames_device(x.reshape(B * N, 2, S), cfg,
                                  _num_words(cfg))
    assert torch.equal(bits.reshape(-1), ib)
    assert torch.equal(words.reshape(B * N, -1), iw)
    one = ALACEncoder(cfg, independent_frames=True)
    assert packets(words, bits) == [[one.encode_packet(p) for p in lane]
                                    for lane in pcm]
    assert any(not torch.equal(bank, carried[ch][od])
               for ch, by in banks.items() for od, bank in by.items())


def test_exhaustive_with_banks_still_raises():
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     search="exhaustive")
    x = torch.zeros((1, 2, 2, S), dtype=torch.int32)
    with pytest.raises(AlacParamError, match="independent-frames only"):
        encode(x, cfg)
    with pytest.raises(AlacParamError, match="independent-frames only"):
        encode(x, cfg, fresh=torch.ones((1, 2), dtype=torch.bool))


def test_malformed_banks_and_fresh_raise():
    cfg, _ = layout_config("stereo16")
    x = torch.zeros((2, 3, 2, S), dtype=torch.int32)
    _, _, banks = encode(x[:, :1], cfg)
    with pytest.raises(AlacParamError, match="fresh must be"):
        encode(x, cfg, fresh=torch.ones((2, 2), dtype=torch.bool))
    with pytest.raises(AlacParamError, match="fresh must be"):
        encode(x, cfg, fresh=torch.ones((2, 3), dtype=torch.int32))
    short = {ch: {4: by[4]} for ch, by in banks.items()}
    with pytest.raises(AlacParamError, match=r"banks\[0\]\[8\]"):
        encode(x, cfg, banks=short)
    narrow = {ch: {od: b[:1] for od, b in by.items()}
              for ch, by in banks.items()}
    with pytest.raises(AlacParamError, match="must be a"):
        encode(x, cfg, banks=narrow)


# ---------------------------------------------------------------------------
# the card: a packet step waits on what an independent-frames call waits on
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sync count is the card's")
    return torch.device("cuda")


def music(n: int, device):
    g = torch.Generator(device=device).manual_seed(23)
    t = torch.arange(4096, device=device, dtype=torch.float32)
    f = torch.tensor([0.011, 0.017, 0.023], device=device)
    ph = torch.rand((n, 2, 3, 1), generator=g, device=device) * 6.28
    x = torch.sin(f[None, None, :, None] * t + ph).sum(2) / 3
    noise = torch.randn((n, 2, 4096), generator=g, device=device) * 8
    return (x * (1 << 13) + noise).round().to(torch.int32)


def recorded(fn):
    torch.cuda.synchronize()
    metrics.drain()
    metrics.enable()
    try:
        out = fn()
    finally:
        metrics.disable()
    torch.cuda.synchronize()
    return out, metrics.drain()


@pytest.mark.cuda
def test_a_packet_step_syncs_as_an_independent_call_on_card(cuda):
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=4096)
    steps = 3
    x = music(4096 * steps, cuda).view(steps, 4096, 2, 4096).transpose(0, 1)
    fresh = torch.rand((4096, steps), device=cuda) < 1 / 32
    nw = _num_words(cfg)
    _, _, banks = encode_stream_device(x, cfg, nw, fresh=fresh)   # warm
    encode_frames_device(x[:, 0].contiguous(), cfg, nw)
    _, one = recorded(lambda: encode_frames_device(x[:, 0].contiguous(),
                                                   cfg, nw))
    (words, bits, _), spans = recorded(lambda: encode_stream_device(
        x, cfg, nw, banks=banks, fresh=fresh))
    want = sorted(s[2] for s in one if s[2].endswith(".sync"))
    assert len(want) == 3
    tops = [i for i, s in enumerate(spans) if s[2] == "encode"]
    assert len(tops) == steps
    assert sum(s[2] == "encode.stream" for s in spans) == 1
    for i in tops:
        mine = sorted(s[2] for s in spans if s[2].endswith(".sync")
                      and spans[i][0] <= s[0] <= s[1] <= spans[i][1])
        assert mine == want
    assert sum(s[2].endswith(".sync") for s in spans) == 3 * steps
    assert words.shape[:2] == (4096, steps) and bits.shape == (4096, steps)
