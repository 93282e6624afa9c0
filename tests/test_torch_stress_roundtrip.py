"""The port's counterpart of tests/test_stress_roundtrip.py: multi-seed
stress round trips through alacjax_torch's codec, a net for
data-dependent decode and encode faults.

- Persistent-bank streams: the port's stateful oracle encoder writes
  four packets a stream over 24 seeds (sine, noise, impulse, silence),
  byte for byte alacjax's stateful oracle's, and the codec decodes them
  losslessly (no CPU test decoded the stateful encoder's packets).
- A mixed-content batch and the Rice corner patterns: the codec's
  independent-frames packets equal both oracles' and decode losslessly.

On the CPU (the plain versions) each case's 8 streams decode in one
call of 32 lanes.  The ``cuda`` variants tile the same patterns over
B = 4096 lanes on the card; run them there without the test tier's
conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_stress_roundtrip.py
"""

import numpy as np
import pytest
import torch

from alacjax import oracle as joracle
from alacjax.types import AlacConfig as JConfig
from alacjax_torch import get_codec
from alacjax_torch import oracle as toracle
from alacjax_torch.types import AlacConfig
from torch_stress_cases import (gen_pcm, mixed_frames, rice_corner_frames,
                                stream_frames)

S, NF = 256, 4
SEEDS_PER_BLOCK = 8
CARD_LANES = 4096
KW = dict(bit_depth=16, num_channels=2, frame_length=S)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"


def test_gen_pcm_copy_equals_conftest():
    from conftest import gen_pcm as original
    for kind in ("sine", "noise", "impulse", "silence"):
        for depth in (16, 24):
            a = gen_pcm(np.random.default_rng(3), kind, 2, S, depth)
            b = original(np.random.default_rng(3), kind, 2, S, depth)
            np.testing.assert_array_equal(a, b, err_msg=kind)


def _streams(seed_block):
    """[(seed, kind, (NF, 2, S) PCM, NF packets)] of the block's seeds,
    each stream written by the port's stateful oracle and held to
    alacjax's."""
    out = []
    for seed in range(seed_block * SEEDS_PER_BLOCK,
                      (seed_block + 1) * SEEDS_PER_BLOCK):
        kind, x = stream_frames(seed, S, NF)
        mine = toracle.ALACEncoder(AlacConfig(**KW))
        theirs = joracle.ALACEncoder(JConfig(**KW))
        pkts = [mine.encode_packet(f) for f in x]
        assert pkts == [theirs.encode_packet(f) for f in x], (
            f"seed={seed} {kind}: the port's stateful oracle differs "
            "from alacjax's")
        out.append((seed, kind, x, pkts))
    return out


def _decode_streams(seed_block, device, lanes):
    """Every stream of the block through one decode_frames call, the
    packets tiled to ``lanes``; one failure message per seed."""
    streams = _streams(seed_block)
    pkts = [p for *_, ps in streams for p in ps]
    reps = lanes // len(pkts)
    codec = get_codec(AlacConfig(**KW), chunk=lanes, device=device)
    flagged = codec.fallback_frames      # the codec is shared: count anew
    y = codec.decode_frames(pkts * reps)
    assert y.shape == (lanes, 2, S) and codec.fallback_frames == flagged
    for r in range(reps):
        for i, (seed, kind, x, _) in enumerate(streams):
            lo = r * len(pkts) + i * NF
            np.testing.assert_array_equal(y[lo:lo + NF], x,
                                          err_msg=f"seed={seed} {kind}")


def _roundtrip(x, device, lanes):
    """The codec's independent-frames packets of x tiled to ``lanes``
    equal both oracles' and decode losslessly."""
    n = len(x)
    mine = toracle.ALACEncoder(AlacConfig(**KW), independent_frames=True)
    theirs = joracle.ALACEncoder(JConfig(**KW), independent_frames=True)
    want = [mine.encode_packet(f) for f in x]
    assert want == [theirs.encode_packet(f) for f in x]
    xt = np.tile(x, (lanes // n, 1, 1))
    codec = get_codec(AlacConfig(**KW), chunk=lanes, device=device)
    flagged = codec.fallback_frames
    pkts = codec.encode_frames(xt)
    for i, p in enumerate(pkts):
        assert p == want[i % n], f"frame {i}"
    np.testing.assert_array_equal(codec.decode_frames(pkts), xt)
    assert codec.fallback_frames == flagged


@pytest.mark.parametrize("seed_block", [0, 1, 2])
def test_decode_of_persistent_streams_many_seeds(seed_block):
    _decode_streams(seed_block, "cpu", SEEDS_PER_BLOCK * NF)


@pytest.mark.parametrize("seed", [11, 13, 17])
def test_roundtrip_mixed_content(seed):
    _roundtrip(mixed_frames(seed, S), "cpu", 4)


def test_roundtrip_pathological_rice_patterns():
    _roundtrip(rice_corner_frames(S), "cpu", 4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed_block", [0, 1, 2])
def test_decode_of_persistent_streams_on_card(cuda, seed_block):
    _decode_streams(seed_block, cuda, CARD_LANES)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 13, 17])
def test_roundtrip_mixed_content_on_card(cuda, seed):
    _roundtrip(mixed_frames(seed, S), cuda, CARD_LANES)


@pytest.mark.cuda
def test_roundtrip_pathological_rice_patterns_on_card(cuda):
    _roundtrip(rice_corner_frames(S), cuda, CARD_LANES)
