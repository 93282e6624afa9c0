"""Pathological full frames (tests/test_pathological_4096.py's five
fixtures: zero runs of growing lengths between impulses, run/burst
alternation, half silence then full-scale noise, per-sample zmode churn
and a music-like control) for each of its five configs, interleaved lane
by lane, through the port's plain torch versions at S=1024
(tools/torch_fuzz_soak.py :: pathological_round): every packet equals
alacjax's ALACEncoder(independent_frames=True) and the native encoder's,
with the same escape bit, and the round trip is lossless.  Tolerance
zero.
"""

import dataclasses
import pathlib
import sys

import pytest

from alacjax.oracle import ALACEncoder as JEncoder
from alacjax.types import AlacConfig as JConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_fuzz_soak as soak  # noqa: E402

SIZES = dataclasses.replace(soak.CPU, S=1024, B=10)


@pytest.mark.parametrize("name,kw", soak.PATHOLOGICAL_CONFIGS,
                         ids=[n for n, _ in soak.PATHOLOGICAL_CONFIGS])
def test_pathological_fixtures_match_alacjax(name, kw):
    stats = soak.Stats()
    x, pkts = soak.pathological_round(kw, SIZES, "cpu", stats)
    assert x.shape[0] == 5 and stats.lanes == {"fixed": SIZES.B}
    enc = JEncoder(JConfig(frame_length=SIZES.S, **kw),
                   independent_frames=True)
    want = [enc.encode_packet(f) for f in x]
    for lane, p in enumerate(pkts):
        assert p == want[lane % 5], f"{name} lane {lane}"
        assert soak.escaped(p) == soak.escaped(want[lane % 5])
