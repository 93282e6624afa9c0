"""The port's fast mode and exhaustive search == alacjax's, bit for bit.

16-bit stereo in fast mode (the constant mixres, order 8, stage 1, one
cost machine), 16-bit stereo with the exhaustive search (all five mixes
of the CPE searched, 10 streams, the per-element mixres pick), and the
exhaustive search over a 24-bit SCE+CPE layout with partial frames (per-
lane chanbits and sample counts in the widened search): word images and
total bits equal alacjax.codec._encode_packet_chunks's, packets equal
the scalar oracle encoder's (independent frames).
"""

import numpy as np
import pytest

from torch_encode_cases import S, encode_case, make_config

CASES = {
    "stereo-16bit-fast": (16, 2, None, dict(fast_mode=True)),
    "stereo-16bit-exhaustive": (16, 2, None, dict(search="exhaustive")),
    "sce-cpe-24bit-exhaustive-partial": (
        24, 3, [S, 400, S, S, 9, S, S, S], dict(search="exhaustive")),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    depth, nch, nums, kw = CASES[request.param]
    return encode_case(make_config(depth, nch, **kw), 5 * depth + nch,
                       nums=nums)


def test_words_match_jax(case):
    np.testing.assert_array_equal(case["bits"], case["jbits"])
    np.testing.assert_array_equal(case["words"], case["jwords"])


def test_packets_match_oracle(case):
    for i, (got, want) in enumerate(zip(case["packets"], case["oracle"])):
        assert got == want, f"frame {i}"


def test_search_mode_changes_the_packets():
    """Fast mode and the exhaustive search are different encoders: on the
    same frames their packets differ from the standard search's
    somewhere (fast mode's are larger), so the modes are really
    taken."""
    from torch_encode_cases import make_frames, torch_encode
    std = make_config(16, 2)
    pcm = make_frames(std, 3, kinds=["sine", "impulse", "sine"])
    sizes = {}
    for name, kw in (("standard", {}), ("fast", dict(fast_mode=True)),
                     ("exhaustive", dict(search="exhaustive"))):
        sizes[name] = torch_encode(make_config(16, 2, **kw), pcm)[2]
    assert (sizes["fast"] >= sizes["standard"]).all()
    assert (sizes["fast"] > sizes["standard"]).any()
    assert (sizes["exhaustive"] <= sizes["standard"]).all()
