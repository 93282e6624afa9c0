"""One run of one cell: set-up, the measured window, the trace's reading
when asked, the check against the reference, and the result line."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import common, manifest, trace

FORBIDDEN = {"jax", "jaxlib", "flax", "alacjax"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark may not load; ``alacjax_torch`` is not ``alacjax``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device: str, t0: float) -> dict:
    """Run ``cell`` (from manifest.cell) once.  On the card the result
    is the contract's line; on the CPU (the tests' rehearsal, never the
    default) it carries no device metric."""
    import torch
    on_card = torch.device(device).type == "cuda"
    config = cell["config"]
    ctx = common.Context(seed=seed, device=device, config=config,
                         params=cell["traffic"],
                         layout=common.layout(config),
                         port_config=common.port_config(config))
    kind = manifest.load_module(cell["kind"])
    tracer = trace.Tracer(traced)
    c = kind.setup(ctx)
    common.sync(device)
    if on_card:
        torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tracer.start()
    e2e = c.run(seconds, tracer)
    tracer.stop()
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card
                else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device)) if on_card else 0}
    print(f"[bench] {cell['workload']['name']} seed {seed}: set-up "
          f"{setup_s} s, {c.calls} calls in {c.seconds} s", file=sys.stderr)
    metrics, breakdown = {}, None
    if traced:
        sms = clock = 0
        if on_card:
            from . import roofline
            sms = torch.cuda.get_device_properties(device) \
                .multi_processor_count
            clock = roofline.max_sm_clock_hz()
        t = trace.Trace(tracer, c.calls,
                        c.bounds(sms, clock) if on_card else {},
                        getattr(c, "record", None))
        for m in cell["per_layer"]:
            v = manifest.load_module(m["reader"]).read(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        print(f"[bench] trace: {len(t.device)} device rows in the window, "
              f"{t.rows_outside} outside", file=sys.stderr)
        dev_info["busy_s"] = t.busy_s
        dev_info["window_s"] = t.window_s
        breakdown = t.breakdown()
    else:
        e2e["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            if m["name"] not in e2e:
                raise RuntimeError(f"the traffic kind gave no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checks, info, attempted, failed = c.check()
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if on_card:
        result["metrics"] = metrics
        result["device"] = dev_info
    else:
        result["rehearsal"] = {"values": {k: v["value"]
                                          for k, v in metrics.items()},
                               "setup_s": setup_s}
    if breakdown is not None and on_card:
        result["breakdown"] = breakdown
    result["info"] = info
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="One run of one benchmark cell "
                                 "of alacjax_torch on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "false); the benchmark runs only on the card", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["workload"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"[bench] card: {card_line()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0
