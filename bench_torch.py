#!/usr/bin/env python3
"""Benchmark of alacjax_torch: batched encode+decode throughput on one
NVIDIA GPU, the counterpart of bench.py for the PyTorch/CUDA port.

    python3 bench_torch.py [B=4096] [iters=6] [--devices N]
        [--search standard|exhaustive] [--repeats R=5] [--device cuda|cpu]

Prints ONE JSON line with bench.py's metric and keys: ``value`` is
device-resident encode+decode frames/s on 16-bit 44.1 kHz stereo
4096-sample frames (bench.py :: make_music, seed 7), each encode
chained into its decode on the card and one synchronize at the end of a
repeat, as bench.py times it.  The steady state runs R repeats of
``iters`` pairs; ``value`` is their median, and ``detail`` gives every
repeat's frames/s and the spread ((max - min) / median).  bench.py's
single reading is R = 1.

Gate: the warm-up round trip and every repeat's last decode must equal
the input exactly, with no error flag, and the host-API round trip
likewise; otherwise the bench raises, exits nonzero and prints no
metric line.

Denominator: the port's own native C++ host codec
(alacjax_torch.native, byte-identical packets), single core, measured
live on this host, as bench.py measures alacjax's.  Also reported: host
serdes (words <-> bytes) measured before the first CUDA call, the
host-API end to end (encode_frames -> decode_frames), the host <-> card
link rates and the transfer-adjusted end to end.

Runs on the card; without one it exits 1 unless ``--device cpu`` asks
for the plain torch versions on the host (the tests' route).  The
environment knobs of bench.py (ALACJAX_BENCH_SEARCH, _PLATFORM,
_DEVICES) are the arguments above.  Imports no jax and nothing of
alacjax.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

S = 4096
BASELINE_FRAMES_PER_SEC_EST = 2000.0  # used only when g++ is missing


class NotLossless(RuntimeError):
    """The round trip did not give the input back: the number is void."""


def make_music(nf: int, S: int, seed: int = 7) -> np.ndarray:
    """Synthetic stereo 'music': chords + vibrato + noise floor, int16
    values in int32 (nf, 2, S).  A copy of bench.py :: make_music."""
    rng = np.random.default_rng(seed)
    n = nf * S
    t = np.arange(n) / 44100.0
    sig = (8000 * np.sin(2 * np.pi * 440 * t)
           + 4000 * np.sin(2 * np.pi * 554.4 * t + 0.3)
           + 2000 * np.sin(2 * np.pi * 220 * t * (1 + 0.001 * np.sin(2 * np.pi * 5 * t)))
           + 120 * rng.standard_normal(n))
    left = np.clip(sig, -32768, 32767).astype(np.int32)
    right = np.clip(np.roll(sig, 23) * 0.92, -32768, 32767).astype(np.int32)
    pcm = np.stack([left, right]).reshape(2, nf, S)
    return np.transpose(pcm, (1, 0, 2)).copy()  # (nf, 2, S)


def measure_native_baseline(pcm: np.ndarray, config) -> tuple[float, str]:
    """Single-core C++ enc+dec frames/s on a slice of the bench corpus:
    the best pass over a 3 s window, a fresh encoder per pass (its coef
    banks would otherwise warm across passes)."""
    from alacjax_torch import native
    if not native.available():
        return (BASELINE_FRAMES_PER_SEC_EST,
                f"estimate (native unavailable: {native.build_error()})")
    nf = min(32, pcm.shape[0])
    dec = native.NativeDecoder(config)
    native.NativeEncoder(config).encode_packet(pcm[0])  # warm
    best = None
    deadline = time.time() + 3.0
    while True:
        enc = native.NativeEncoder(config)
        t0 = time.time()
        pkts = [enc.encode_packet(pcm[i]) for i in range(nf)]
        for p in pkts:
            dec.decode_packet(p)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
        if time.time() >= deadline:
            break
    return nf / best, "measured: this repo's native C++ single-core codec"


def measure_host_serdes(B: int, num_words: int) -> float:
    """Host serdes rate (words -> bytes -> words) in frames/s, best of
    3, on a shape-accurate synthetic batch: the cost is bytes copied and
    per-frame slicing, not content."""
    from alacjax_torch.ops import bitpack
    rng = np.random.default_rng(0)
    wh = rng.integers(0, 2 ** 32, (B, num_words), dtype=np.uint32)
    bh = np.minimum((np.full(B, 0.67 * 32 * num_words)).astype(np.int64),
                    32 * num_words).astype(np.int32)
    best = None
    for _ in range(3):
        t0 = time.time()
        pk = bitpack.words_to_bytes(wh, bh)
        bitpack.bytes_to_words(pk, num_words)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return B / best


def card_line() -> str | None:
    """The first card's name and power limit as nvidia-smi gives them,
    or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def synchronize(device) -> None:
    """Wait for every visible card when ``device`` is a CUDA device."""
    import torch
    if torch.device(device).type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def check_lossless(decoded, err, x, what: str) -> None:
    """Raise NotLossless unless the decode flagged no lane and gave x
    back exactly."""
    import torch
    if bool(err.any().item()):
        raise NotLossless(f"{what}: decode error flags set")
    if not torch.equal(decoded, x):
        raise NotLossless(f"{what}: round trip not lossless")


def metric_name(config) -> str:
    """bench.py's metric string for ``config``; bench.py's own at its
    configuration (16-bit stereo 44.1 kHz, 4096-sample frames)."""
    layout = "stereo" if config.num_channels == 2 else \
        f"{config.num_channels}-channel"
    return (f"encode+decode frames/sec/chip ({config.bit_depth}-bit {layout} "
            f"{config.sample_rate / 1000:g}kHz, {config.frame_length}-sample "
            "frames)")


def _lookup(device: str, devices: int | None):
    """get_codec's ``devices`` for the bench: one device unless
    ``devices`` asks for N (the first N visible cards, each once)."""
    import torch
    if devices is None:
        return 1
    if torch.device(device).type == "cuda" \
            and devices > torch.cuda.device_count():
        raise SystemExit(f"--devices {devices}: only "
                         f"{torch.cuda.device_count()} visible")
    return devices


def measure(config, B: int = 4096, iters: int = 6, repeats: int = 5,
            device: str = "cuda", devices: int | None = None) -> dict:
    """bench.py's measurement on ``config`` (16-bit stereo) through the
    port: returns its JSON line as a dict.  Raises NotLossless when a
    round trip does not give its input back, RuntimeError on
    ``device="cuda"`` without a card."""
    import torch
    from alacjax_torch import get_codec

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass device='cpu' for the plain versions")
    S = config.frame_length
    n_dev = _lookup(device, devices)
    # serdes first, while the host is quiet: before the CUDA context and
    # the codec exist
    serdes_fps = measure_host_serdes(
        B, (config.max_escape_packet_bytes(S) + 3) // 4 + 2)
    codec = get_codec(config, chunk=B, device=device, devices=n_dev)
    pcm = make_music(B, S)
    x = torch.from_numpy(pcm).to(device)

    # first calls: the kernels build with nvcc at first use
    t0 = time.perf_counter()
    words, bits = codec._encode(x)
    synchronize(device)
    enc_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded, err, _ = codec._decode(words)
    synchronize(device)
    dec_compile = time.perf_counter() - t0
    check_lossless(decoded, err, x, "warm-up")
    del decoded, err

    per_repeat = []
    for r in range(repeats):
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            w, _b = codec._encode(x)
            d, e, _n = codec._decode(w)
        synchronize(device)
        per_repeat.append(time.perf_counter() - t0)
        check_lossless(d, e, x, f"repeat {r}")
        del w, _b, d, e, _n
    rates = [B * iters / dt for dt in per_repeat]
    fps = statistics.median(rates)
    dt = B * iters / fps

    # the host API: packets serialised and parsed on the host, copies
    # both ways; a sub-batch chunk gives the pipelined loop work to overlap
    e2e_codec = get_codec(config, chunk=min(B, 1024), device=device,
                          devices=n_dev)
    pkts = e2e_codec.encode_frames(pcm)
    out = e2e_codec.decode_frames(pkts)
    if not np.array_equal(out, pcm):
        raise NotLossless("end-to-end round trip not lossless")
    e2e_iters = 2
    t0 = time.perf_counter()
    for _ in range(e2e_iters):
        pkts = e2e_codec.encode_frames(pcm)
        out = e2e_codec.decode_frames(pkts)
    e2e_dt = time.perf_counter() - t0
    e2e_fps = B * e2e_iters / e2e_dt
    del pkts, out

    bh = bits.cpu().numpy()
    # link rates; the XOR makes a fresh buffer, so the copy is real
    fresh = words ^ 1
    synchronize(device)
    t0 = time.perf_counter()
    fresh.cpu()
    d2h_mbps = fresh.nbytes / 1e6 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    torch.from_numpy(pcm ^ 1).to(device)
    synchronize(device)
    h2d_mbps = pcm.nbytes / 1e6 / (time.perf_counter() - t0)
    del fresh

    # transfer-adjusted end to end: device compute plus the batch's
    # host <-> device traffic at the measured link rates
    packet_bytes = float(np.sum((bh + 7) // 8))
    down = pcm.nbytes + packet_bytes      # PCM in, packets back in
    up = packet_bytes + pcm.nbytes        # packets out, decoded PCM out
    xfer_s = down / (h2d_mbps * 1e6) + up / (d2h_mbps * 1e6)
    e2e_adj_fps = B / (dt / iters + xfer_s)

    baseline_fps, baseline_src = measure_native_baseline(pcm, config)
    comp_ratio = packet_bytes / pcm.nbytes * 2
    on_card = torch.device(device).type == "cuda"
    detail = {
        "batch_frames": B,
        "iters": iters,
        "seconds": dt,
        "repeats": repeats,
        "repeat_frames_per_sec": rates,
        "spread": (max(rates) - min(rates)) / fps,
        "audio_seconds_per_second": fps * S / config.sample_rate,
        "compression_ratio": comp_ratio,
        "encode_compile_s": enc_compile,
        "decode_compile_s": dec_compile,
        "compile_note": "first encode and decode calls; the first one "
                        "includes the nvcc build of the kernels at first "
                        "use" if on_card else "first calls (plain versions)",
        "end_to_end_frames_per_sec": e2e_fps,
        "end_to_end_fraction": e2e_fps / fps,
        "e2e_transfer_adjusted_frames_per_sec": e2e_adj_fps,
        "e2e_link": ("PCIe, host <-> card (pageable copies), measured here"
                     if on_card else "none: host memory (device cpu)"),
        "host_serdes_frames_per_sec": serdes_fps,
        "host_serdes_note": "measured before the first CUDA call, on the "
                            "host (shape-accurate synthetic batch)",
        "d2h_MBps": d2h_mbps,
        "h2d_MBps": h2d_mbps,
        "mesh_devices": devices,
        "device": torch.cuda.get_device_name() if on_card else "cpu",
        "baseline_frames_per_sec": baseline_fps,
        "baseline_note": baseline_src,
    }
    if on_card:
        detail["power_limit"] = card_line()
    return {
        "metric": metric_name(config),
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / baseline_fps,
        "detail": detail,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=4096)
    ap.add_argument("iters", nargs="?", type=int, default=6)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--search", choices=("standard", "exhaustive"),
                    default="standard")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    from alacjax_torch.types import AlacConfig
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "false); --device cpu runs the plain versions on the host",
              file=sys.stderr)
        return 1
    config = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                        sample_rate=44100, search=args.search)
    print(json.dumps(measure(config, args.B, args.iters, args.repeats,
                             device=args.device, devices=args.devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
