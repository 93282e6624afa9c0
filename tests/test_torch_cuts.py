"""The profiling cuts (``stop_at``) of the port's encode
(_encode_packet_chunks: "mix", "search", "rice", "assemble") and decode
(decode_frames_device: "params", "scan", "nounesc") return what alacjax's
return at the same cut, value for value and in the same order.

Two batches: 24-bit SCE+CPE frames (shift bytes, a partial frame, a
noise frame that escapes), and all-noise stereo frames, where the Rice
emission is skipped and the cuts see its empty chunks.  Values compare
as 32-bit patterns (alacjax's words are uint32, the port's int32 bits)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from alacjax import codec as jcodec
from alacjax.types import AlacConfig
from alacjax_torch import codec as tcodec
from conftest import gen_pcm
from torch_encode_cases import torch_config

S = 64


def _flat(x):
    """Nested lists and tuples of arrays -> a flat list of int64 arrays
    of their 32-bit patterns."""
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return [a.astype(np.int64) & 0xFFFFFFFF]


def _same(got, want):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


def _batch(kind: str):
    """(alacjax config, pcm (B, C, S) int32, nums (B,) int32)."""
    rng = np.random.default_rng(64)
    if kind == "mixed":
        cfg = AlacConfig(bit_depth=24, num_channels=3, frame_length=S)
        pcm = np.stack([gen_pcm(rng, k, 3, S, 24)
                        for k in ("sine", "noise", "sine", "impulse")])
        nums = np.array([S, S, 40, S], np.int32)
        pcm[2, :, 40:] = 0
    else:
        cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S)
        pcm = np.stack([gen_pcm(rng, "noise", 2, S, 16) for _ in range(2)])
        nums = np.full(2, S, np.int32)
    return cfg, pcm.astype(np.int32), nums


_BATCHES = {}


def batch(kind: str):
    """_batch(kind) and its word count, made once per module."""
    if kind not in _BATCHES:
        cfg, pcm, nums = _batch(kind)
        nw = (cfg.max_escape_packet_bytes(S) + 3) // 4 + 2
        _BATCHES[kind] = cfg, pcm, nums, nw
    return _BATCHES[kind]


# the all-escape batch differs from the mixed one only past the search
@pytest.mark.parametrize("kind,stop", [
    ("mixed", "mix"), ("mixed", "search"), ("mixed", "rice"),
    ("mixed", "assemble"), ("noise", "rice"), ("noise", "assemble")])
def test_encode_cut_matches_jax(kind, stop):
    cfg, pcm, nums, nw = batch(kind)
    got = tcodec._encode_packet_chunks(
        torch.from_numpy(pcm), torch_config(cfg), nw,
        nums=torch.from_numpy(nums), stop_at=stop)
    want = jax.jit(lambda p, n: jcodec._encode_packet_chunks(
        p, cfg, nw, nums=n, stop_at=stop))(jnp.asarray(pcm),
                                           jnp.asarray(nums))
    _same(got, want)


@pytest.mark.parametrize("kind", ["mixed", "noise"])
@pytest.mark.parametrize("stop", ["params", "scan", "nounesc"])
def test_decode_cut_matches_jax(kind, stop):
    cfg, pcm, nums, nw = batch(kind)
    words, _, _ = tcodec._encode_packet_chunks(
        torch.from_numpy(pcm), torch_config(cfg), nw,
        nums=torch.from_numpy(nums))
    got = tcodec.decode_frames_device(words, torch_config(cfg), S,
                                      stop_at=stop)
    want = jax.jit(lambda w: jcodec.decode_frames_device(
        w, cfg, S, stop_at=stop))(jnp.asarray(words.numpy().view(np.uint32)))
    _same(got, want)


def test_cuts_are_checked():
    cfg = torch_config(AlacConfig(bit_depth=16, num_channels=2,
                                  frame_length=S))
    pcm = torch.zeros((1, 2, S), dtype=torch.int32)
    with pytest.raises(ValueError, match="stop_at"):
        tcodec._encode_packet_chunks(pcm, cfg, 100, stop_at="merge")
    with pytest.raises(ValueError, match="stop_at"):
        tcodec.decode_frames_device(torch.zeros((1, 100), dtype=torch.int32),
                                    cfg, S, stop_at="unmix")
