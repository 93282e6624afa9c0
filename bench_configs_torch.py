#!/usr/bin/env python3
"""Benchmark of alacjax_torch on the five BASELINE.json configs, the
counterpart of bench_configs.py for the PyTorch/CUDA port.

    python3 bench_configs_torch.py [B=512] [iters=5] [--device cuda|cpu]

Prints one JSON line per config, with bench_configs.py's keys: stereo
16-bit 44.1 kHz, mono 16-bit, stereo 24-bit 96 kHz, 5.1 16-bit and
32-bit white noise (every frame escapes), B frames of 4096 samples
each.  ``frames_per_sec`` is device-resident encode+decode, each encode
chained into its decode and one synchronize at the end, as
bench_configs.py times it; ``encode_fps`` and ``decode_fps`` split the
same loop (the decode of the warm-up's words) as a diagnostic.  Every
config is gated on exact losslessness: a round trip that does not give
its input back raises, and the script exits nonzero.

Runs on the card; without one it exits 1 unless ``--device cpu`` asks
for the plain torch versions on the host.  Imports no jax and nothing
of alacjax.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from bench_torch import check_lossless, make_music, synchronize

S = 4096

CONFIGS = [
    ("stereo 16-bit 44.1kHz (headline)", dict(bit_depth=16, num_channels=2,
                                              sample_rate=44100), "music"),
    ("mono 16-bit", dict(bit_depth=16, num_channels=1,
                         sample_rate=44100), "music"),
    ("stereo 24-bit 96kHz hi-res", dict(bit_depth=24, num_channels=2,
                                        sample_rate=96000), "music"),
    ("5.1 multichannel 16-bit", dict(bit_depth=16, num_channels=6,
                                     sample_rate=48000), "music"),
    ("escape stress (white noise) 32-bit", dict(bit_depth=32, num_channels=2,
                                                sample_rate=96000), "escape"),
]


def gen(config_name: str, B: int, S: int, nch: int, depth: int) -> np.ndarray:
    """A copy of bench_configs.py :: gen (seed 3): white noise for the
    escape config, else make_music's channels scaled to the depth with
    a little noise."""
    rng = np.random.default_rng(3)
    full = 1 << (depth - 1)
    if config_name == "escape":
        return rng.integers(-full, full, (B, nch, S)).astype(np.int64)
    base = make_music(B, S).astype(np.int64)  # (B, 2, S) 16-bit
    scale = full // (1 << 15)
    out = np.zeros((B, nch, S), dtype=np.int64)
    for c in range(nch):
        out[:, c] = np.clip(base[:, c % 2] * max(scale, 1)
                            + rng.integers(-3, 4, (B, S)), -full, full - 1)
    return out


def run_config(name: str, kw: dict, kind: str, B: int, iters: int,
               device: str = "cuda", S: int = S) -> dict:
    """One config's line: a timed first round trip (the kernels build
    at first use), the lossless gate, the chained steady state and the
    encode/decode split."""
    import torch
    from alacjax_torch import TorchCodec
    from alacjax_torch.types import AlacConfig

    cfg = AlacConfig(frame_length=S, **kw)
    codec = TorchCodec(cfg, chunk=B, device=device)
    pcm = gen("escape" if kind == "escape" else "music",
              B, S, cfg.num_channels, cfg.bit_depth)
    x = torch.from_numpy(pcm.astype(np.int32)).to(device)
    t0 = time.perf_counter()
    words, bits = codec._encode(x)
    decoded, err, _ = codec._decode(words)
    synchronize(device)
    compile_s = time.perf_counter() - t0
    check_lossless(decoded, err, x, name)

    t0 = time.perf_counter()
    for _ in range(iters):
        w, b = codec._encode(x)
        d, e, _n = codec._decode(w)
    synchronize(device)
    dt = time.perf_counter() - t0
    check_lossless(d, e, x, name)
    fps = B * iters / dt

    # enc/dec split (diagnostic): same chained methodology per phase
    t0 = time.perf_counter()
    for _ in range(iters):
        w, b = codec._encode(x)
    synchronize(device)
    enc_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        d, e, _n = codec._decode(words)
    synchronize(device)
    dec_dt = time.perf_counter() - t0
    ratio = float(((bits.to(torch.int64) + 7) // 8).sum().item()) / (
        pcm.size * cfg.bit_depth / 8)
    return {
        "config": name,
        "frames_per_sec": fps,
        "audio_x_realtime": fps * S / cfg.sample_rate,
        "compression_ratio": ratio,
        "lossless": True,
        "compile_s": compile_s,
        "encode_fps": B * iters / enc_dt,
        "decode_fps": B * iters / dec_dt,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=512)
    ap.add_argument("iters", nargs="?", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_configs_torch: no CUDA device (torch.cuda.is_available()"
              " is false); --device cpu runs the plain versions on the host",
              file=sys.stderr)
        return 1
    for name, kw, kind in CONFIGS:
        print(json.dumps(run_config(name, kw, kind, args.B, args.iters,
                                    args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
