"""The port's decode of 24-bit 5.1 (SCE, CPE, CPE, LFE: four chained
elements) and of 32-bit stereo (two shift bytes per sample) == alacjax's
decode_frames_jit, bit for bit, and lossless; both batches hold
escaped (noise) frames and partial frames.  The corpus and the
comparison are test_torch_layouts.py's, split off so that the two files
run on separate workers.
"""

import numpy as np
import pytest

from test_torch_layouts import NUMS, layout_case


@pytest.fixture(scope="module", params=[(24, 6), (32, 2)],
                ids=["24bit-5.1", "32bit-stereo"])
def case(request):
    return layout_case(*request.param)


def test_decode_matches_jax(case):
    _, got, want = case
    for name, g, w in zip(("pcm", "err", "num"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_decode_is_lossless(case):
    pcm, (dec, err, num), _ = case
    assert not err.any()
    np.testing.assert_array_equal(num, NUMS)
    np.testing.assert_array_equal(dec, pcm)
