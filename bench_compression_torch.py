"""Compression-rate benchmark of alacjax_torch: the standard search
against the exhaustive bound, the counterpart of bench_compression.py
for the PyTorch/CUDA port.

The reference's encoder searches with subsampled (dilated) trials
(codec/ALACEncoder.cpp :: EncodeStereo), and so does the standard
dialect (exact dilated mixres trial + exact per-channel order x stage
trials).  This benchmark measures what that costs against an exhaustive
full-rate search over every (mixres, order, stage), the best rate the
bitstream grammar admits with this coder, on the five BASELINE.json
configs and three hard contents (transients, decorrelated stereo,
escape-crossing ramps).  Gate: the worst delta < 1%, else exit 1.

Runs on the port's native C++ codec (alacjax_torch.native, packets
byte-identical to the oracle's and the card's; the tests hold that),
so it is host-only: its rows equal bench_compression.py's exactly
(tests/test_torch_bench.py).  The configs, the content generators and
the seed (2026) are copies of bench_compression.py's.  Imports no jax
and nothing of alacjax.

Usage: python3 bench_compression_torch.py [--frames N] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from alacjax_torch.native import NativeEncoder
from alacjax_torch.types import AlacConfig

S = 4096

# (name, config kwargs, content class).  The first five are the
# BASELINE.json configs on smooth sine-mixture "music"; the last three
# are VERDICT r02 item 8's hard deterministic content — the search
# decisions (mixres, order, stage, escape) actually differ on
# transient/decorrelated/ramping material, so the dilated-vs-exhaustive
# delta is measured where it is largest, not where it is easiest.
CONFIGS = [
    ("stereo 16-bit 44.1k", dict(bit_depth=16, num_channels=2), "music"),
    ("mono 16-bit", dict(bit_depth=16, num_channels=1), "music"),
    ("stereo 24-bit 96k", dict(bit_depth=24, num_channels=2,
                               sample_rate=96000), "music"),
    ("5.1 16-bit", dict(bit_depth=16, num_channels=6), "music"),
    ("noise 32-bit", dict(bit_depth=32, num_channels=2), "noise"),
    ("transients 16-bit", dict(bit_depth=16, num_channels=2), "transients"),
    ("wide stereo 16-bit", dict(bit_depth=16, num_channels=2), "wide"),
    ("ramp-escape 24-bit", dict(bit_depth=24, num_channels=2), "ramps"),
]


def gen_music(rng: np.random.Generator, nch: int, n: int, depth: int,
              noise: bool = False) -> np.ndarray:
    """Synthetic music-like PCM: evolving sine mixture + noise floor,
    per channel; pure noise for the escape-stress config."""
    full = (1 << (depth - 1)) - 1
    out = np.zeros((nch, n), dtype=np.int64)
    t = np.arange(n)
    for c in range(nch):
        if noise:
            x = rng.integers(-(full + 1), full + 1, size=n, dtype=np.int64)
            out[c] = x
            continue
        f0 = 110.0 * (2.0 ** (c * 0.31 + rng.uniform(0, 2)))
        sig = (0.5 * np.sin(2 * np.pi * f0 * t / 44100)
               + 0.22 * np.sin(2 * np.pi * f0 * 2.01 * t / 44100)
               + 0.1 * np.sin(2 * np.pi * f0 * 2.99 * t / 44100)
               + 0.004 * rng.standard_normal(n))
        env = 0.3 + 0.7 * np.abs(np.sin(2 * np.pi * t / (n / 3.7)))
        out[c] = np.clip(sig * env * 0.8 * full, -full - 1, full)
    return out


def gen_transients(rng: np.random.Generator, nch: int, n: int,
                   depth: int) -> np.ndarray:
    """Drum-like material: near-silence broken by exponentially-decaying
    full-scale bursts at irregular offsets.  High crest factor; the
    predictor restarts cold at every attack, which is where order/stage
    choices diverge most between dilated and exhaustive search."""
    full = (1 << (depth - 1)) - 1
    out = np.zeros((nch, n))
    pos = 0
    while pos < n:
        pos += int(rng.integers(200, 3000))
        if pos >= n:
            break
        ln = min(int(rng.integers(64, 1024)), n - pos)
        t = np.arange(ln)
        for c in range(nch):
            f = rng.uniform(80, 8000)
            decay = np.exp(-t / (ln / rng.uniform(2.0, 8.0)))
            out[c, pos:pos + ln] += (
                np.sin(2 * np.pi * f * t / 44100 + rng.uniform(0, 6))
                * decay * rng.uniform(0.5, 1.0))
        pos += ln
    out += 0.002 * rng.standard_normal((nch, n))
    return np.clip(out * full, -full - 1, full).astype(np.int64)


def gen_wide_stereo(rng: np.random.Generator, nch: int, n: int,
                    depth: int) -> np.ndarray:
    """Widely-decorrelated stereo: the channels share no source (plus an
    anti-phase common component), so mid/side mixing is actively harmful
    and the mixres trial has to discover that frame by frame."""
    full = (1 << (depth - 1)) - 1
    t = np.arange(n)
    out = np.zeros((nch, n))
    for c in range(nch):
        sig = np.zeros(n)
        for k in range(4):
            f = rng.uniform(60, 4000)
            sig += rng.uniform(0.1, 0.5) * np.sin(
                2 * np.pi * f * t / 44100 + rng.uniform(0, 6))
        sig += 0.01 * rng.standard_normal(n)
        out[c] = sig
    if nch == 2:
        common = 0.3 * np.sin(2 * np.pi * 220.0 * t / 44100)
        out[0] += common
        out[1] -= common  # anti-phase: L+R cancels, L-R doubles
    peak = np.abs(out).max()
    return np.clip(out / peak * 0.9 * full, -full - 1, full).astype(np.int64)


def gen_ramps(rng: np.random.Generator, nch: int, n: int,
              depth: int) -> np.ndarray:
    """Noise under a triangle amplitude envelope sweeping 0 -> full scale
    and back: each sweep crosses the escape decision threshold, so frames
    land on both sides of (and near) the compressed-vs-escape boundary."""
    full = (1 << (depth - 1)) - 1
    t = np.arange(n)
    period = 5.5 * S  # incommensurate with the frame length
    env = np.abs(((t / period) % 1.0) * 2 - 1)  # triangle 0..1
    out = np.zeros((nch, n))
    for c in range(nch):
        out[c] = rng.standard_normal(n) * env
    return np.clip(out * full, -full - 1, full).astype(np.int64)


GENERATORS = {
    "music": lambda rng, nch, n, depth: gen_music(rng, nch, n, depth),
    "noise": lambda rng, nch, n, depth: gen_music(rng, nch, n, depth,
                                                  noise=True),
    "transients": gen_transients,
    "wide": gen_wide_stereo,
    "ramps": gen_ramps,
}


def measure(cfg: AlacConfig, pcm: np.ndarray, search: str) -> int:
    enc = NativeEncoder(cfg, search=search)
    total = 0
    n = pcm.shape[1]
    for off in range(0, n, S):
        total += len(enc.encode_packet(pcm[:, off:off + S]))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24,
                    help="4096-sample frames per config")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(2026)
    rows = []
    for name, kw, content in CONFIGS:
        cfg = AlacConfig(frame_length=S, **kw)
        pcm = GENERATORS[content](rng, cfg.num_channels, args.frames * S,
                                  cfg.bit_depth)
        raw = pcm.shape[1] * cfg.num_channels * cfg.bit_depth // 8
        std = measure(cfg, pcm, "standard")
        exh = measure(cfg, pcm, "exhaustive")
        delta = (std - exh) / exh * 100.0
        rows.append(dict(config=name, ratio_standard=round(std / raw, 4),
                         ratio_exhaustive=round(exh / raw, 4),
                         delta_pct=round(delta, 3)))
        if not args.json:
            print(f"{name:22s} std={std/raw:.4f} exh={exh/raw:.4f} "
                  f"delta={delta:+.3f}%", flush=True)
    worst = max(r["delta_pct"] for r in rows)
    if args.json:
        print(json.dumps(dict(rows=rows, worst_delta_pct=worst)))
    else:
        print(f"worst delta: {worst:+.3f}% (gate: < 1%)")
    return 0 if worst < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
