"""The port's multichannel decode == alacjax's chained decode, and
lossless, on the wide layouts of alacjax's tests/test_stacked_decode.py:
24-bit 5.1 (shift bytes, four elements) and 32-bit 7.1 (five elements);
the cursor ends where each channel decode ends.  Cases and checks:
tests/test_torch_multichannel_decode.py."""

import pytest

from test_torch_multichannel_decode import (
    check_cursor_ends_where_each_channel_ends, check_lossless,
    check_matches_jax, decode_all,
)


@pytest.fixture(scope="module", params=[(6, 24), (8, 32)],
                ids=["6ch-24", "8ch-32"])
def case(request):
    return decode_all(*request.param)


def test_decode_matches_jax_chained(case):
    check_matches_jax(case)


def test_decode_is_lossless(case):
    check_lossless(case)


def test_cursor_ends_where_each_channel_ends(case):
    check_cursor_ends_where_each_channel_ends(case)
