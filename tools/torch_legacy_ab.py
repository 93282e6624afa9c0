#!/usr/bin/env python3
"""alacjax_torch's predict_legacy route beside its default route on one
NVIDIA GPU, for one or more checkouts of the repository in turns:

    python3 tools/torch_legacy_ab.py DIR [DIR ...]

Each DIR is a checkout's root ("." for this one) and runs in a process of
its own, in the order given, so "OLD . . OLD" compares two trees on one
card within one call.  On bench.py's make_music corpus (B=4096 stereo-16
frames of 4096 samples, the shape of chip_smoke.py's phases 4 and 8) a
checkout reports:
  - the default route's device-resident encode and decode seconds and
    enc+dec frames/s (phase 4's metric; 3 batches after a warm-up);
  - the predict_legacy route's device-resident encode seconds (phase 8's
    metric), its words equal to the default route's;
  - each predict and rice_cost call of one legacy encode: its shape and
    arguments, its launches, and its time on the card (CUDA events over
    5 calls after a warm-up), with the time times the SM clock over S,
    the cycles one step of the call takes; where the checkout's
    pc_block takes ``cycles``, the walker warps' own clock64 cycles per
    step inside the walk, and those times S over the clock;
  - ptxas's registers and spills for csrc/predict.cu, and its kernels'
    innermost loops in SASS (chip_smoke.py :: sass_loops: instructions
    and the shortest trip).
The card's name and power limit come first, then one JSON line per DIR.
Needs a card; exits nonzero without one.

    python3 tools/torch_legacy_ab.py --chanbits33 DIR [DIR ...]

asks instead whether a checkout's cost and decode kernels agree with its
plain torch versions at per-lane chanbits 33 (one past a 32-bit channel,
where the C idiom ``(x << (32 - bits)) >> (32 - bits)`` shifts by -1).
It runs the cost kernel (orders 4 and 8 with two machines, order 8 with
one) and the 8-, 16- and 30-tap decode on the inputs of this
repository's tests/torch_predict_cases.py and tests/torch_decode_cases.py
(per-lane chanbits 16..33; L=4096, S=1024), and prints, per kernel and
output, how many elements differ from the plain version on the 33-bit
lanes and on the others.  A checkout whose decode entry refuses a bound
of 33 runs with chanbits_max=32 (its C entry checks only the bound).
"""

import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096
S = 4096
ITERS = 3
REPS = 5


def smi(query: str, fmt: str = "csv,noheader,nounits") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        sys.exit(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def describe(args, kwargs) -> dict:
    import torch
    out = {}
    for i, v in enumerate(args):
        if isinstance(v, torch.Tensor):
            out[f"arg{i}"] = list(v.shape)
        elif isinstance(v, (int, tuple)):
            out[f"arg{i}"] = v
    for k, v in kwargs.items():
        out[k] = list(v.shape) if isinstance(v, torch.Tensor) else v
    return out


def child(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from alacjax_torch import AlacConfig, TorchCodec, kernels
    from alacjax_torch.kernels import _build
    from alacjax_torch.kernels import predict as kp
    from bench import make_music
    from chip_smoke import sass_loops

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.lib()
    clock = float(smi("clocks.max.sm")) * 1e6
    ptxas, cur = [], None
    for line in _build.build_log.splitlines():
        if line.startswith("=="):
            cur = line
        elif cur == "== predict.cu" and any(k in line for k in (
                "registers", "spill")):
            ptxas.append(line.strip())
    loops = {fn: [v for v in sizes if v[0] > 1]
             for fn, sizes in sass_loops(_build.lib_path()).items()
             if "predict" in fn or "rice" in fn}
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    x = torch.from_numpy(make_music(B, S)).to("cuda")
    codec = TorchCodec(cfg, chunk=B, device="cuda")
    legacy = TorchCodec(cfg, chunk=B, device="cuda", predict_legacy=True)

    words, _ = codec._encode(x)
    codec._decode(words)
    enc_t = dec_t = 0.0
    for _ in range(ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words, bits = codec._encode(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec, err, _ = codec._decode(words)
        torch.cuda.synchronize()
        enc_t += t1 - t0
        dec_t += time.perf_counter() - t1
        if bool(err.any().item()) or not torch.equal(dec, x):
            sys.exit("the default route's round trip is not lossless")

    legacy._encode(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        lw, lb = legacy._encode(x)
    torch.cuda.synchronize()
    leg_t = (time.perf_counter() - t0) / ITERS
    if not (torch.equal(lw, words) and torch.equal(lb, bits)):
        sys.exit("the predict_legacy route's words differ from the default's")

    calls = []
    saved = {name: getattr(kp, name) for name in ("pc_block", "rice_cost")}

    def recorder(name):
        def rec(*args, **kwargs):
            calls.append((name, args, kwargs))
            return saved[name](*args, **kwargs)
        return rec
    for name in saved:
        setattr(kp, name, recorder(name))
    kernels.reset_launches()
    try:
        legacy._encode(x)
    finally:
        for name, fn in saved.items():
            setattr(kp, name, fn)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("predict", "rice_cost",
                                                 "cost")}
    takes_cycles = "cycles" in inspect.signature(kp.pc_block).parameters
    rows = []
    for name, args, kwargs in calls:
        fn = saved[name]
        ms = events_ms(lambda: fn(*args, **kwargs))
        steps = args[0].shape[1]
        row = dict(kernel=name, args=describe(args, kwargs), ms=ms,
                   cycles_per_step_from_ms=ms * 1e-3 * clock / steps)
        if name == "pc_block" and takes_cycles:
            order = args[2]
            n = 1 if isinstance(order, int) else len(order)
            cyc = torch.zeros((n, -(-args[0].shape[0] // 32)),
                              dtype=torch.int64, device="cuda")
            fn(*args, **kwargs, cycles=cyc)
            per = (cyc.double() / steps)
            row["walker_cycles_per_step"] = dict(
                mean=per.mean(dim=1).tolist(), max=per.max(dim=1).values
                .tolist())
            row["walker_chain_ms"] = [v * steps / clock * 1e3
                                      for v in row["walker_cycles_per_step"]
                                      ["max"]]
        rows.append(row)
    return dict(dir=root, device=torch.cuda.get_device_name(0),
                sm_clock_mhz=clock / 1e6, ptxas_predict=ptxas,
                sass_loops=loops,
                default_encode_s=enc_t / ITERS, default_decode_s=dec_t / ITERS,
                default_enc_dec_frames_per_s=B * ITERS / (enc_t + dec_t),
                legacy_encode_s=leg_t, legacy_launches_per_encode=launches,
                legacy_calls=rows)


def chanbits33(root: str) -> dict:
    """Elements of each cost and decode output that differ from the plain
    version, on the lanes at chanbits 33 and on the others."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(HERE, "tests"))
    import numpy as np
    import torch
    from alacjax_torch.kernels import cost as kc, decode as kd
    from alacjax_torch.types import DENSHIFT_DEFAULT, KB0, MB0, PB0
    from torch_decode_cases import RICE, decode_lanes
    from torch_predict_cases import predict_lanes

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    L, S = 4096, 1024
    out = dict(dir=root)

    def diff(name, got, want, lane33):
        for i, (g, w) in enumerate(zip(got, want)):
            bad = g.to(torch.int64) != w.to(torch.int64)
            bad = (bad.reshape(bad.shape[0], -1).sum(1) if bad.dim() > 1
                   else bad.to(torch.int64))
            out[f"{name} output {i}"] = dict(
                lanes33=int(bad[lane33].sum()), others=int(bad[~lane33].sum()))

    x, cb, c0 = (torch.from_numpy(v).cuda() for v in predict_lanes(
        np.random.default_rng(L + 33), L, S, n_orders=1))
    for orders, dual in (((4, 8), True), ((8,), False)):
        args = (x, c0[0], orders, cb, DENSHIFT_DEFAULT, MB0, PB0, KB0,
                (1 << KB0) - 1)
        n = len(orders)
        pairs = [(g.reshape(n * L, -1), w.reshape(n * L, -1)) for g, w in zip(
            kc.pc_block_cost2(*args, dual=dual), kc.plain(*args, dual=dual))
            if g is not None]
        diff(f"cost orders {orders} dual {dual}", [p[0] for p in pairs],
             [p[1] for p in pairs], (cb == 33).repeat(n))
    words, lane = decode_lanes(np.random.default_rng(L + 33), L, S)
    w = torch.from_numpy(words.view(np.int32)).cuda()
    t = {k: torch.from_numpy(v).cuda() for k, v in lane.items()}
    mb0, kb, wb = RICE
    for taps in (8, 16, 30):
        args = (w, t["start"], S, t["cb"], mb0, t["pb"], kb, wb,
                t["coefs"][:, :taps].contiguous(), t["mode"], t["order"],
                t["den"])
        want = kd.plain(*args, num=t["num"], taps=taps, chanbits_max=33)
        try:
            got = kd.decode_channel(*args, num=t["num"], taps=taps,
                                    chanbits_max=33)
        except (RuntimeError, ValueError):
            got = kd.decode_channel(*args, num=t["num"], taps=taps,
                                    chanbits_max=32)
            out["decode bound"] = 32
        torch.cuda.synchronize()
        diff(f"decode taps {taps}", got, want, t["cb"] == 33)
    return out


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--child":
        fn = chanbits33 if sys.argv[2] == "--chanbits33" else child
        print("RESULT " + json.dumps(fn(sys.argv[3])), flush=True)
        return 0
    mode = "--default"
    if len(sys.argv) >= 2 and sys.argv[1] == "--chanbits33":
        mode = sys.argv.pop(1)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(smi("name,power.limit", "csv,noheader"), flush=True)
    for d in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", mode, d], capture_output=True,
                              text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            sys.exit(f"{d}: exited {proc.returncode}")
        print(lines[-1][len("RESULT "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
