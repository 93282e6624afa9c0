"""The port's encode of every element layout == alacjax's, bit for bit.

Frames of 1024 samples (sine, noise that escapes, impulse, silence) of
24-bit 5.1 (SCE, CPE, CPE, LFE) with partial frames of 300, 77 and 1
samples batched with full ones, 16-bit mono, and a 20-bit three-channel
SCE+CPE layout (per-lane chanbits 20 and 21 in one search and one
emission) go through TorchCodec on the CPU and through
alacjax.codec._encode_packet_chunks: the word images and total bits are
equal (tolerance 0), and the packets equal the scalar oracle encoder's
(independent frames).
"""

import numpy as np
import pytest

from torch_encode_cases import S, encode_case, escape_bits, make_config

CASES = {
    "51-24bit-partial": (24, 6, [S, 300, S, 1, S, 77, S, S]),
    "mono-16bit": (16, 1, None),
    "sce-cpe-20bit": (20, 3, None),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    depth, nch, nums = CASES[request.param]
    return encode_case(make_config(depth, nch), 10 * depth + nch, nums=nums)


def test_words_match_jax(case):
    np.testing.assert_array_equal(case["bits"], case["jbits"])
    np.testing.assert_array_equal(case["words"], case["jwords"])


def test_packets_match_oracle(case):
    for i, (got, want) in enumerate(zip(case["packets"], case["oracle"])):
        assert got == want, f"frame {i}"


def test_batch_holds_escaped_compressed_and_partial_lanes(case):
    """The noise frame escapes, the others compress, and partial lanes
    carry their own sample count."""
    cfg, nums = case["cfg"], case["nums"]
    esc = escape_bits(cfg, [S] * len(case["pcm"]) if nums is None else nums)
    noise = 1
    assert case["bits"][noise] == esc[noise]
    assert (case["bits"] < esc).sum() >= 5
    if nums is not None:
        for b in np.nonzero(np.asarray(nums) < S)[0]:
            # the partial flag (bit 3 of the 23-bit header) is set
            assert (case["packets"][b][2] >> 4) & 1 == 1, f"frame {b}"
