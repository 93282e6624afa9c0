#!/usr/bin/env python3
"""Smoke run of the alacjax_torch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits nonzero on failure:
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the four CUDA kernels from alacjax_torch/csrc (nvcc, sm_90a);
  3. one device-resident encode + decode of the bench corpus
     (bench.py :: make_music, B=4096 frames of 16-bit stereo, S=4096)
     records every kernel call of the main path; each call is then run
     again through its kernel and through its plain torch version on the
     card, on the same inputs: the results must be exactly equal;
  4. the main path: TorchCodec encode_frames -> decode_frames_ex on the
     same corpus: lossless, no frame flagged, the first 256 packets
     byte-identical to the native C++ encoder, every kernel launched;
     encode/decode seconds and frames/s, then the device-resident steady
     state (PCM and words stay on the card) with its peak memory.
The line before the last is a JSON object of per-kernel results ("ms"
and "plain_ms" sum a kernel's calls in one batch); the last line is the
JSON result line.  ``--profile DIR`` also writes a torch.profiler table
of one device-resident encode + decode to DIR/profile.txt.
"""

import json
import os
import subprocess
import sys
import time

B = 4096                 # frames per batch (bench.py's headline batch)
N_NATIVE = 256           # packets held against the native C++ encoder
REPLACES = {
    "cost": "alacjax/ops/pallas/cost_pallas.py:346",
    "emit": "alacjax/ops/pallas/emit_pallas.py:257",
    "merge": "alacjax/ops/pallas/merge.py:98",
    "decode": "alacjax/ops/pallas/decode_step.py:121",
}
WRAPPERS = {            # kernel -> (wrapper module, wrapper function)
    "cost": ("alacjax_torch.kernels.cost", "pc_block_cost2"),
    "emit": ("alacjax_torch.kernels.emit", "rice_encode_words"),
    "merge": ("alacjax_torch.kernels.merge", "merge_sorted_chunks"),
    "decode": ("alacjax_torch.kernels.decode", "decode_channel"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def timed(fn, reps: int):
    """(result of the last call, mean ms per call) on the card's clock,
    after one warm-up call."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def timed_once(fn):
    """(result, ms) of one call, host clock around a synchronised call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over all outputs; shapes must agree."""
    import torch
    worst = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            worst = max(worst, int(d.item()))
    return worst


def record_main_path_calls(codec, x):
    """Run one device-resident encode + decode with every kernel wrapper
    wrapped by a recorder; returns [(kernel, wrapper, args, kwargs)]."""
    import importlib
    calls, saved = [], []
    for name, (mod_name, fn_name) in WRAPPERS.items():
        mod = importlib.import_module(mod_name)
        wrapper = getattr(mod, fn_name)

        def recorder(*args, _name=name, _fn=wrapper, **kwargs):
            calls.append((_name, _fn, args, kwargs))
            return _fn(*args, **kwargs)

        saved.append((mod, fn_name, wrapper))
        setattr(mod, fn_name, recorder)
    try:
        words, _ = codec._encode(x)
        codec._decode(words)
    finally:
        for mod, fn_name, wrapper in saved:
            setattr(mod, fn_name, wrapper)
    return calls


def compare_kernels(codec, x):
    """Phase 3: every kernel call of the main path against its plain
    version on the same inputs, on the card."""
    import importlib
    calls = record_main_path_calls(codec, x)
    rows = {k: dict(calls=0, ms=0.0, plain_ms=0.0, max_abs_err=0)
            for k in REPLACES}
    for name, wrapper, args, kwargs in calls:
        plain = importlib.import_module(WRAPPERS[name][0]).plain
        got, ms = timed(lambda: wrapper(*args, **kwargs), reps=3)
        want, plain_ms = timed_once(lambda: plain(*args, **kwargs))
        err = max_abs_err(got, want)
        shape = "x".join(str(d) for d in args[0].shape)
        print(f"  {name:6s} call {rows[name]['calls']} on {shape:12s} "
              f"kernel {ms:10.4f} ms   plain {plain_ms:12.3f} ms   "
              f"max_abs_err {err}", flush=True)
        if err != 0:
            fail(f"{name} kernel disagrees with its plain version")
        row = rows[name]
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
    missing = [k for k, r in rows.items() if r["calls"] == 0]
    if missing:
        fail(f"kernels the main path never called: {missing}")
    return rows


def main_path(pcm, cfg, codec):
    """Phase 4: the round trip through the host API, then the
    device-resident steady state."""
    import numpy as np
    import torch
    from alacjax import native
    from alacjax_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    packets = codec.encode_frames(pcm)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, nums = codec.decode_frames_ex(packets)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"  launches in the main-path run: {launches}")
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    if codec.fallback_frames:
        fail(f"{codec.fallback_frames} frames flagged by the device decode")
    if not (nums == cfg.frame_length).all() or not np.array_equal(out, pcm):
        fail("round trip is not lossless")
    if not native.available():
        fail(f"native C++ codec unavailable: {native.build_error()}")
    enc = native.NativeEncoder(cfg, independent_frames=True)
    ref = [enc.encode_packet(frame) for frame in pcm[:N_NATIVE]]
    bad = [i for i in range(N_NATIVE) if packets[i] != ref[i]]
    if bad:
        fail(f"{len(bad)} of the first {N_NATIVE} packets differ from the "
             f"native C++ encoder (first: frame {bad[0]})")
    n_bytes = sum(len(p) for p in packets)
    print(f"  host API round trip: lossless, 0 frames flagged, "
          f"{N_NATIVE}/{N_NATIVE} packets byte-identical to the native C++ "
          f"encoder, compression ratio {n_bytes / (pcm.size * 2)}")
    print(f"  host API: encode {enc_s} s, decode {dec_s} s, "
          f"{len(pcm) / (enc_s + dec_s)} enc+dec frames/s")

    x = torch.from_numpy(pcm).to("cuda")
    iters = 3
    enc_t = dec_t = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words, _ = codec._encode(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec, err, _ = codec._decode(words)
        torch.cuda.synchronize()
        enc_t += t1 - t0
        dec_t += time.perf_counter() - t1
        if bool(err.any().item()) or not torch.equal(dec, x):
            fail("device-resident round trip is not lossless")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  device-resident: encode {enc_t / iters} s, decode "
          f"{dec_t / iters} s per batch of {len(pcm)}, "
          f"{len(pcm) * iters / (enc_t + dec_t)} enc+dec frames/s, "
          f"peak device memory {peak} GiB")
    return launches


def profile(codec, x, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        words, _ = codec._encode(x)
        codec._decode(words)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(table)
    print(f"  profile written to {out_dir}/profile.txt")


def main() -> int:
    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "alacjax_torch")):
        fail("alacjax_torch/ is not beside this script: run it from the "
             "root of a checkout of the repository")

    # phase 1: the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a GPU")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    sys.path.insert(0, repo)
    from alacjax_torch import AlacConfig, TorchCodec
    from alacjax_torch.kernels import LAUNCHES, _build
    from bench import make_music

    # phase 2: build
    _build.lib()
    print(f"phase 2: kernels built in {_build.build_seconds} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=4096,
                     sample_rate=44100)
    pcm = make_music(B, cfg.frame_length)
    codec = TorchCodec(cfg, chunk=B, device="cuda")
    x = torch.from_numpy(pcm).to("cuda")

    # phase 3: kernels vs plain versions on the main path's inputs
    print(f"phase 3: kernels vs plain torch on {kind} ({card})", flush=True)
    rows = compare_kernels(codec, x)

    # phase 4: main path
    print(f"phase 4: main path, B={B} stereo-16 frames of "
          f"{cfg.frame_length} on {kind} ({card})", flush=True)
    launches = main_path(pcm, cfg, codec)
    if "--profile" in sys.argv:
        profile(codec, x, sys.argv[sys.argv.index("--profile") + 1])

    if "jax" in sys.modules:
        fail("jax was imported")
    if set(LAUNCHES) != set(REPLACES):
        fail(f"kernel set changed: {sorted(LAUNCHES)}")
    kernels = [dict(name=name, route="cuda",
                    source=f"alacjax_torch/csrc/{name}.cu",
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"])
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
