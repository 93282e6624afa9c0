#!/usr/bin/env python3
"""The control of each cell's check: the plain reference put in the
port's place, computed one bit below the configuration's depth (each
sample's lowest bit cleared), the nearest precision below the lossless
one the configuration states.  Its check has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--device cpu]

Builds the cell's inputs as a run does, replaces the port's entry of
the cell (encode_frames_device, decode_frames_device or
TorchCodec.decode_frames_ex) by the control, drives a window of one
call or request after the warm-up, and prints the check as one JSON
line.  The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.lib import harness, inputs, manifest  # noqa: E402
from benchmark.ref import codec as rc  # noqa: E402


def coarse(x):
    """One bit below the configuration's precision."""
    return x & ~1


def install(cell: dict, lay: rc.Layout) -> None:
    """Put the control in the port's place for ``cell``'s traffic kind;
    each distinct input is computed once."""
    import alacjax_torch.codec as port
    kind = cell["traffic"]["kind"]
    memo = {}

    def once(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    if kind == "bulk_encode":
        def encode(x, config, num_words):
            def go():
                img, bits, _ = rc.encode(coarse(x.to(torch.int64)), lay)
                return inputs.as_i32(img), bits.to(torch.int32)
            return once(x.data_ptr(), go)
        port.encode_frames_device = encode
    elif kind == "bulk_decode":
        def decode(words, config, num_samples):
            def go():
                pcm, num, err = rc.decode(inputs.as_u32(words), lay)
                return (coarse(pcm).to(torch.int32), err,
                        num.to(torch.int32))
            return once(words.data_ptr(), go)
        port.decode_frames_device = decode
    elif kind == "segments":
        from alacjax_torch.ops import bitpack

        def decode_ex(self, packets):
            def go():
                img = torch.from_numpy(bitpack.bytes_to_words(
                    packets, lay.image_words()).astype("int64"))
                pcm, num, _ = rc.decode(img.to(self.device), lay)
                return coarse(pcm).cpu().numpy(), num.cpu().numpy()
            return once(tuple(map(id, packets)), go)
        port.TorchCodec.decode_frames_ex = decode_ex
    else:
        raise ValueError(f"no control for traffic kind {kind!r}")


def run(cell: dict, seed: int, device: str) -> dict:
    from benchmark.lib import common
    install(cell, common.layout(cell["config"]))
    return harness.run_cell(cell, seed, 0.0, False, device,
                            time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    r = run(cell, args.seed, args.device)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": r["correct"], "checks": r["checks"],
                      "info": r["info"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
