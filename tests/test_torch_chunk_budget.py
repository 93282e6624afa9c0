"""The port's counterpart of tests/test_chunk_budget.py: the invariant
the merge relies on, checked on the real streams of the widest layout.

alacjax_torch's merge (csrc/merge.cu and its plain version) is a direct
scatter, ``out[b, key] = val``: it needs, per lane, the keys other than
empty (0xFFFFFFFF) to be 0, 1, ..., n - 1 in slot order, and drops a key
at or past ``num_words`` without an error, so a broken invariant would
lose or misplace words silently.  These tests wrap
``alacjax_torch.kernels.merge.merge_sorted_chunks`` (the codec calls it
through that module), encode 16-bit 7.1 (five elements) with sine,
all-escape, alternating and tiny-residual lanes, assert the invariant
on every lane the merge sees and hold the packets to the port's
oracle and alacjax's.  The ``cuda`` variant tiles the rows over
B = 4096 lanes on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_chunk_budget.py
"""

import numpy as np
import pytest
import torch

from alacjax import oracle as joracle
from alacjax.types import AlacConfig as JConfig
from alacjax_torch import TorchCodec
from alacjax_torch import oracle as toracle
from alacjax_torch.kernels import merge as k_merge
from alacjax_torch.types import AlacConfig
from torch_stress_cases import merge_key_faults, widest_layout_pcm

S = 64
KW = dict(bit_depth=16, num_channels=8, frame_length=S)
CARD_LANES = 4096


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"


def _faults_of(rows, num_words):
    w = max(map(len, rows))
    keys = torch.tensor([r + [-1] * (w - len(r)) for r in rows],
                        dtype=torch.int32)
    return merge_key_faults(keys, num_words).tolist()


def test_the_invariant_check_is_not_vacuous():
    """A row with a gap, one with a duplicate and one with a key past
    the image each fail the check; rows that hold the invariant, empty
    slots between their keys or no key at all, pass it."""
    assert _faults_of([[0, 1, 3], [0, 1, 1, 2], [0, 1, 2, 3, 4]], 4) == [
        True, True, True]
    assert _faults_of([[1, 2], [0, 2, 1], [-2, 0]], 8) == [True, True, True]
    assert _faults_of([[0, -1, 1, -1, -1, 2, 3], [-1, -1], [0, 1, 2, 3]],
                      4) == [False, False, False]


def _encode_recording(x, device, monkeypatch):
    """Encode x through a TorchCodec on ``device`` with the merge
    wrapper recorded: (packets, per merge call the lanes that broke the
    invariant and the most keys a lane held, num_words)."""
    observed = []
    real = k_merge.merge_sorted_chunks

    def record(vals, keys, tail_vals, tail_keys, num_words):
        valid = keys != -1
        observed.append((merge_key_faults(keys, num_words).nonzero()
                         .flatten().tolist(),
                         int(valid.sum(dim=1).max().item()), num_words))
        return real(vals, keys, tail_vals, tail_keys, num_words)

    monkeypatch.setattr(k_merge, "merge_sorted_chunks", record)
    codec = TorchCodec(AlacConfig(**KW), chunk=len(x), device=device)
    return codec, codec.encode_frames(x), observed


def _check(x, device, monkeypatch):
    codec, pkts, observed = _encode_recording(x, device, monkeypatch)
    assert observed, "the recorded merge_sorted_chunks never ran"
    for bad, most, num_words in observed:
        assert not bad, (f"lanes {bad[:8]}: keys violate the gapless-unique "
                         "invariant")
        assert most <= num_words
    mine = toracle.ALACEncoder(AlacConfig(**KW), independent_frames=True)
    theirs = joracle.ALACEncoder(JConfig(**KW), independent_frames=True)
    want = [mine.encode_packet(f) for f in x[:4]]
    assert want == [theirs.encode_packet(f) for f in x[:4]]
    for i, p in enumerate(pkts):
        assert p == want[i % 4], f"frame {i}"
    np.testing.assert_array_equal(codec.decode_frames(pkts), x)


def test_merge_invariant_widest_layout(monkeypatch):
    _check(widest_layout_pcm(np.random.default_rng(25), 4, S), "cpu",
           monkeypatch)


@pytest.mark.cuda
def test_merge_invariant_widest_layout_on_card(cuda, monkeypatch):
    x = widest_layout_pcm(np.random.default_rng(25), 4, S)
    _check(np.tile(x, (CARD_LANES // 4, 1, 1)), cuda, monkeypatch)
