"""Escape-flip pairs (tests/test_escape_boundary.py) through the port:
for each depth and channel count, the noise amplitude where one step
flips the escape decision, searched with the port's native encoder and confirmed by its oracle
(tools/torch_fuzz_soak.py :: find_flip), is alacjax's oracle's flip, and
the frames just below and at it encode through the port's plain torch
versions (TorchCodec(..., device="cpu"), S=256) to alacjax's
ALACEncoder packets on both sides, the escape bit clear below and set
at the flip, and decode losslessly.  Tolerance zero.
"""

import dataclasses
import pathlib
import sys

import pytest

from alacjax.oracle import ALACEncoder as JEncoder
from alacjax.types import AlacConfig as JConfig
from alacjax_torch.types import AlacConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

SIZES = dataclasses.replace(soak.CPU, B=4)


def _alacjax_flip(depth, nch):
    """tests/test_escape_boundary.py :: _find_flip on alacjax's oracle."""
    cfg = JConfig(bit_depth=depth, num_channels=nch, frame_length=SIZES.S)

    def escapes(amp):
        enc = JEncoder(cfg, independent_frames=True)
        return soak.escaped(enc.encode_packet(soak.flip_frame(
            soak.FLIP_SEED, nch, depth, amp, SIZES.S)))

    lo, hi = 1, (1 << (depth - 1)) - 1
    assert escapes(hi)
    while lo < hi:
        mid = (lo + hi) // 2
        if escapes(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.parametrize("depth", soak.FLIP_DEPTHS)
@pytest.mark.parametrize("nch", soak.FLIP_CHANNELS)
def test_escape_flip_pair_matches_alacjax(depth, nch):
    cfg = AlacConfig(bit_depth=depth, num_channels=nch, frame_length=SIZES.S)
    stats = soak.Stats()
    flip, x, pkts = soak.escape_flip_round(depth, nch, SIZES, "cpu", stats)
    assert flip == _alacjax_flip(depth, nch)
    enc = JEncoder(JConfig(bit_depth=depth, num_channels=nch,
                           frame_length=SIZES.S), independent_frames=True)
    want = [enc.encode_packet(f) for f in x]
    assert [soak.escaped(p) for p in want] == [False, True]
    for lane, p in enumerate(pkts):
        amp = flip - 1 + lane % 2
        assert p == want[lane % 2], f"lane {lane} (amplitude {amp})"
