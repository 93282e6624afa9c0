"""The port's cursor+stacked decode == alacjax's chained decode and the
port's own on the wide layouts of alacjax's tests/test_stacked_decode.py:
24-bit 5.1 (shift bytes, four elements) and 32-bit 7.1 (five elements).
Cases and checks: tests/test_torch_stacked.py."""

import pytest

from test_torch_stacked import (
    check_matches_chained_and_lossless, check_matches_jax, decode_all,
)


@pytest.fixture(scope="module", params=[(6, 24), (8, 32)],
                ids=["6ch-24", "8ch-32"])
def case(request):
    return decode_all(*request.param)


def test_stacked_decode_matches_jax_chained(case):
    check_matches_jax(case)


def test_stacked_decode_matches_chained_and_is_lossless(case):
    check_matches_chained_and_lossless(case)
