"""Inputs of the port's stress round trips and merge-invariant checks
(tests/test_torch_stress_roundtrip.py, tests/test_torch_chunk_budget.py,
chip_smoke.py phase 14), without jax: the machine with the card runs
them with ``--noconftest``, and tests/conftest.py imports jax.

``gen_pcm`` is a copy of tests/conftest.py's (held equal to it in
test_torch_stress_roundtrip.py); the frame builders are those of
tests/test_stress_roundtrip.py and tests/test_chunk_budget.py, the
latter widened from four lanes to any number of lanes (lane i takes
row i % 4); ``merge_key_faults`` is test_chunk_budget.py's invariant
check as torch ops, so it runs where the keys lie.
"""

import numpy as np
import torch

STREAM_KINDS = ("sine", "noise", "impulse", "silence")


def gen_pcm(rng, kind: str, nch: int, n: int, depth: int) -> np.ndarray:
    """Deterministic fixture PCM: white noise (escape stress), sine
    mixtures (zero-run friendly), silence (pure zero-run), impulse
    trains."""
    full = 1 << (depth - 1)
    if kind == "noise":
        return rng.integers(-full, full, (nch, n))
    if kind == "sine":
        t = np.arange(n)
        base = (np.sin(t * 0.01)[None, :] * (full // 4)
                + np.sin(t * 0.1)[None, :] * 200).astype(np.int64)
        return np.clip(base + rng.integers(-3, 4, (nch, n)), -full, full - 1)
    if kind == "silence":
        return np.zeros((nch, n), dtype=np.int64)
    if kind == "impulse":
        x = np.zeros((nch, n), dtype=np.int64)
        x[:, ::211] = full - 1
        x[:, 7::401] = -full
        return x
    raise ValueError(kind)


def stream_frames(seed: int, S: int, nf: int = 4) -> tuple[str, np.ndarray]:
    """One persistent-bank stream of test_stress_roundtrip.py: nf
    stereo-16 frames of the kind the seed picks -> (kind, (nf, 2, S))."""
    rng = np.random.default_rng(seed)
    kind = STREAM_KINDS[seed % 4]
    return kind, np.stack([gen_pcm(rng, kind, 2, S, 16) for _ in range(nf)])


def mixed_frames(seed: int, S: int) -> np.ndarray:
    """An escape frame, a zero-run frame, a sine and an impulse train in
    one batch: divergent escape, mixres and order choices across lanes."""
    rng = np.random.default_rng(seed)
    return np.stack([gen_pcm(rng, k, 2, S, 16)
                     for k in ("noise", "silence", "sine", "impulse")])


def rice_corner_frames(S: int) -> np.ndarray:
    """Alternating extremes, a run to the last sample, a run from the
    second sample, periodic run breaks (stereo-16)."""
    full = 1 << 15
    x = np.zeros((4, 2, S), np.int64)
    x[0, :, ::2] = full - 1
    x[0, :, 1::2] = -full
    x[1, :, -1] = 1
    x[2, :, 0] = -full
    x[3, :, ::16] = np.arange(S // 16) * 1000 % full
    return x


def widest_layout_pcm(rng, n: int, S: int, dtype=np.int64) -> np.ndarray:
    """(n, 8, S) 16-bit 7.1 PCM, lane i of row i % 4: a sine on every
    channel, full-scale noise (every element escapes), noise and a small
    sine on alternate channels, tiny residuals.  At n = 4 these are
    test_chunk_budget.py's rows drawn from ``rng`` in its order."""
    x = np.zeros((n, 8, S), dtype=dtype)
    t = np.arange(S)
    x[0::4] = (np.sin(t * 0.05)[None, :] * 3000).astype(np.int64)
    x[1::4] = rng.integers(-32768, 32768, (len(x[1::4]), 8, S))
    x[2::4, ::2] = rng.integers(-32768, 32768, (len(x[2::4]), 4, S))
    x[2::4, 1::2] = (np.sin(t * 0.1)[None, :] * 500).astype(np.int64)
    x[3::4] = rng.integers(-40, 40, (len(x[3::4]), 8, S))
    return x


def merge_key_faults(keys: torch.Tensor, num_words: int) -> torch.Tensor:
    """(B,) True where a lane of merge's (B, T) int32 keys breaks the
    invariant the direct-scatter merge relies on: the keys other than
    empty (0xFFFFFFFF, int32 -1), in slot order, are 0, 1, ..., n - 1
    (strictly increasing and gapless from word 0), and n <= num_words
    (a key past the image is dropped without an error)."""
    valid = keys != -1
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    wrong = (valid & (keys.to(torch.int64) != rank)).any(dim=1)
    return wrong | (valid.sum(dim=1) > num_words)
