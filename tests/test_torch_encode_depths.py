"""The port's encode at depths 20 and 32, and of batches in which every
lane escapes, == alacjax's, bit for bit.

20-bit stereo (no shift bytes, chanbits 21: the widest Rice escape
payload) in full frames, and 32-bit stereo (two shift bytes, escape at
full depth) with partial frames: word images and total bits equal
alacjax.codec._encode_packet_chunks's, packets equal the scalar oracle
encoder's.  Then two 24-bit SCE+CPE batches of noise, in which every
element of every lane escapes: with partial lanes (the escape chunks
through the merge) and in full frames (each element's raw image at its
static offset, no merge).
"""

import numpy as np
import pytest

from torch_encode_cases import (
    S, assert_case_matches, encode_case, escape_bits, make_config,
)

CASES = {
    "stereo-20bit": (20, 2, None),
    "stereo-32bit-partial": (32, 2, [S, S, 500, S, 3, S, S, S]),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    depth, nch, nums = CASES[request.param]
    return encode_case(make_config(depth, nch), depth + nch, nums=nums)


def test_words_match_jax(case):
    np.testing.assert_array_equal(case["bits"], case["jbits"])
    np.testing.assert_array_equal(case["words"], case["jwords"])


def test_packets_match_oracle(case):
    for i, (got, want) in enumerate(zip(case["packets"], case["oracle"])):
        assert got == want, f"frame {i}"


def test_noise_escapes_at_full_depth(case):
    """The noise frame's packet is its raw samples, channel-interleaved,
    at the full depth (32 bits a sample at 32-bit: the d=32 field
    pack)."""
    cfg, nums = case["cfg"], case["nums"]
    n = S if nums is None else nums[1]
    assert case["bits"][1] == escape_bits(cfg, [n])[0]
    packet = case["packets"][1]
    v = int.from_bytes(packet, "big")
    end = 8 * len(packet)
    at = 23 + (32 if n < S else 0)
    d = cfg.bit_depth
    raw = case["pcm"][1][:, :n].T.reshape(-1)
    for k in (0, 1, 2, len(raw) - 1):
        field = (v >> (end - at - d * (k + 1))) & ((1 << d) - 1)
        assert field == int(raw[k]) & ((1 << d) - 1), f"sample {k}"


@pytest.mark.parametrize("nums", [None, [S, 200, 1, S]],
                         ids=["full", "partial"])
def test_all_escape_batch(nums):
    """Every element of every lane escapes: both all-escape arms."""
    cfg = make_config(24, 3)
    c = encode_case(cfg, 77, kinds=["noise"] * 4, nums=nums)
    np.testing.assert_array_equal(
        c["bits"], escape_bits(cfg, [S] * 4 if nums is None else nums))
    assert_case_matches(c)
