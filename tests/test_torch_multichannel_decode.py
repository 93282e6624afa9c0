"""The port's multichannel decode (one chained program: each element's
channels decode in turn, channel c + 1 starting where channel c ends)
== alacjax's chained decode, bit for bit (PCM, err and num), and
lossless.

Layouts as alacjax's tests/test_stacked_decode.py: 3 and 6 channels at
16 bits here, 6 at 24 and 8 at 32 bits in
tests/test_torch_multichannel_decode_wide.py; S=256, B=6 frames from
the scalar oracle encoder, one of them noise that escapes in every
element, one partial; the cursor (the Rice warp alone, on no codec
path) on each channel decode's stream ends where that decode ends.
Also here: the cursor's end bits against alacjax's cursor_scan and the
oracle's bit counts, and the lane-to-row map (a stacked call equals its
per-channel calls).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alacjax.bitbuffer import BitBuffer
from alacjax.codec import decode_frames_jit
from alacjax.oracle import ALACEncoder
from alacjax.oracle import ag as oag
from alacjax.ops import fused_decode as jfd
from alacjax.types import AlacConfig
from alacjax_torch.codec import decode_frames_device
from alacjax_torch.kernels import decode as k_decode
from alacjax_torch.ops import bitpack
from alacjax_torch.ops import fused_decode as tfd
from conftest import gen_pcm
from torch_decode_cases import RICE, decode_lanes
from torch_encode_cases import torch_config

S = 256
B = 6
PARTIAL = 100


def _packets(nch: int, depth: int):
    rng = np.random.default_rng(nch * 100 + depth)
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=S)
    lim = 1 << (depth - 1)
    pcm = np.stack([gen_pcm(rng, "sine", nch, S, depth) for _ in range(B)])
    pcm[B - 1] = rng.integers(-lim, lim, (nch, S))     # escapes everywhere
    pcm[2, :, PARTIAL:] = 0
    enc = ALACEncoder(cfg, independent_frames=True)
    packets = [enc.encode_packet(f[:, :PARTIAL] if b == 2 else f)
               for b, f in enumerate(pcm)]
    num_words = (cfg.max_escape_packet_bytes(S) + 3) // 4 + 2
    return cfg, pcm, bitpack.bytes_to_words(packets, num_words)


def decode_all(nch: int, depth: int):
    """(source pcm, the port's decode, alacjax's chained decode (pcm,
    err, num), numpy; the port's channel decode calls as (args, kwargs,
    outputs)) of one layout's packets."""
    cfg, pcm, words = _packets(nch, depth)
    w = torch.from_numpy(words.view(np.int32))
    calls = []
    real = k_decode.decode_channel

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    k_decode.decode_channel = spy
    try:
        got = [t.numpy() for t in
               decode_frames_device(w, torch_config(cfg), S)]
    finally:
        k_decode.decode_channel = real
    want = [np.asarray(t) for t in
            decode_frames_jit(jnp.asarray(words), cfg, S, 8)]
    return pcm, got, want, calls


def check_matches_jax(case):
    _, got, want, _ = case
    for name, g, w in zip(("pcm", "err", "num"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def check_lossless(case):
    pcm, (dec, err, num), _, _ = case
    assert not err.any()
    np.testing.assert_array_equal(num, [S, S, PARTIAL, S, S, S])
    np.testing.assert_array_equal(dec, pcm)


def check_cursor_ends_where_each_channel_ends(case):
    """The cursor on each channel decode's stream (its start bits, pb and
    per-lane sample counts) ends where that decode ends on every lane
    the decode does not flag, and flags none of them."""
    *_, calls = case
    assert calls
    for args, kwargs, (_, end, err) in calls:
        c_end, c_err = k_decode.cursor_scan(*args[:8], num=kwargs["num"])
        assert torch.equal(c_end[~err], end[~err])
        assert not (c_err & ~err).any()


# 3 and 6 channels at 16 bits here;
# tests/test_torch_multichannel_decode_wide.py holds 24-bit 5.1 and
# 32-bit 7.1 (one alacjax decode compile of 20-30 s each, so the two
# files run side by side)
@pytest.fixture(scope="module", params=[(3, 16), (6, 16)],
                ids=["3ch-16", "6ch-16"])
def case(request):
    return decode_all(*request.param)


def test_decode_matches_jax_chained(case):
    check_matches_jax(case)


def test_decode_is_lossless(case):
    check_lossless(case)


def test_cursor_ends_where_each_channel_ends(case):
    check_cursor_ends_where_each_channel_ends(case)


def test_cursor_scan_end_bits_match_jax_and_oracle(rng):
    """End bits equal alacjax's cursor_scan called directly and the
    oracle dyn_comp's bit counts; a skipped lane does not move; the raw
    decode ends at the same bits."""
    n, chanbits = 200, 16
    res = rng.integers(-120, 120, (4, n)).astype(np.int32)
    res[1, 50:150] = 0                                  # zero runs
    packed, bits = [], []
    for b in range(4):
        bb = BitBuffer(byte_size=4096)
        bits.append(oag.dyn_comp(oag.set_standard_ag_params(n, n), bb,
                                 res[b], n, chanbits))
        packed.append(bb.to_bytes())
    words = bitpack.bytes_to_words(packed, max(map(len, packed)) // 4 + 3)
    mb0, kb, wb = RICE
    pb = np.full(4, AlacConfig().pb, np.int32)
    starts = np.zeros(4, np.int32)
    tw, ts, tp = (torch.from_numpy(v) for v in (words.view(np.int32),
                                                  starts, pb))
    end, err = tfd.cursor_scan(tw, ts, n, chanbits, mb0, tp, kb, wb)
    assert not err.any()
    np.testing.assert_array_equal(end.numpy(), bits)
    j_end, j_err = jfd.cursor_scan(jnp.asarray(words), jnp.asarray(starts),
                                   n, chanbits, mb0, jnp.asarray(pb), kb, wb)
    np.testing.assert_array_equal(end.numpy(), np.asarray(j_end))
    np.testing.assert_array_equal(err.numpy(), np.asarray(j_err))
    skip = torch.tensor([False, True, False, False])
    end_s, _ = tfd.cursor_scan(tw, ts, n, chanbits, mb0, tp, kb, wb,
                               skip=skip)
    assert int(end_s[1]) == 0
    np.testing.assert_array_equal(end_s.numpy()[[0, 2, 3]],
                                  end.numpy()[[0, 2, 3]])
    got, raw_end, _ = tfd.decode_channel(tw, ts, n, chanbits, mb0, tp, kb,
                                         wb, None, None, None, None, raw=True)
    np.testing.assert_array_equal(got.numpy(), res)
    np.testing.assert_array_equal(raw_end.numpy(), end.numpy())


def test_cursor_scan_matches_jax_on_random_words():
    """On random words, per-lane chanbits, partial and skipped lanes."""
    L, n = 40, 64
    words, lane = decode_lanes(np.random.default_rng(7), L, n)
    lane["cb"] = np.minimum(lane["cb"], 32)
    mb0, kb, wb = RICE
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    got = tfd.cursor_scan(torch.from_numpy(words.view(np.int32)), t["start"],
                          n, t["cb"], mb0, t["pb"], kb, wb, chanbits_max=32,
                          skip=t["skip"], num=t["num"])
    j = {k: jnp.asarray(v) for k, v in lane.items()}
    want = jfd.cursor_scan(jnp.asarray(words), j["start"], n, j["cb"], mb0,
                           j["pb"], kb, wb, chanbits_max=32, skip=j["skip"],
                           num=j["num"])
    for name, g, w in zip(("end_bits", "err"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("raw", [False, True])
def test_stacked_lanes_equal_per_channel_calls(raw):
    """Lanes stacked 3 to a word row (lane l reads row l % rows) decode
    exactly as each channel's own call on the same rows."""
    rows, n_ch, n = 8, 3, 48
    words, lane = decode_lanes(np.random.default_rng(3), n_ch * rows, n,
                               rows=rows, taps=8)
    mb0, kb, wb = RICE
    t = {k: torch.from_numpy(v) for k, v in lane.items()}
    w = torch.from_numpy(words.view(np.int32))

    def run(sl):
        return tfd.decode_channel(
            w, t["start"][sl], n, t["cb"][sl], mb0, t["pb"][sl], kb, wb,
            t["coefs"][sl], t["mode"][sl], t["order"][sl], t["den"][sl],
            num=t["num"][sl], chanbits_max=33, raw=raw)

    stacked = run(slice(None))
    parts = [run(slice(c * rows, (c + 1) * rows)) for c in range(n_ch)]
    for i, name in enumerate(("samples", "end_bits", "err")):
        assert torch.equal(stacked[i], torch.cat([p[i] for p in parts])), name
    with pytest.raises(ValueError, match="lanes do not stack"):
        tfd.decode_channel(w[:5], t["start"], n, 17, mb0, t["pb"], kb, wb,
                           t["coefs"], t["mode"], t["order"], t["den"])
