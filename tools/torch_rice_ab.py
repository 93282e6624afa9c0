#!/usr/bin/env python3
"""The decode kernel's Rice and FIR warps (csrc/decode.cu: the cursor,
the raw decode and the 8/16/30-tap decode) on one NVIDIA GPU, for one or
more checkouts of the repository in turns:

    python3 tools/torch_rice_ab.py [--sass OUT] DIR [DIR ...]

Each DIR is a checkout's root ("." for this one) and runs in a process of
its own, in the order given, so "OLD . . OLD" compares two trees on one
card within one call.  On bench_torch.py's make_music corpus (B=4096
stereo-16 frames of S=4096, the words of the checkout's own device
encode) and on chip_smoke.py's 24-bit 5.1 signal (music_51, B=4096
frames, encoded the same way), a checkout reports, for each decode
kernel call of the stereo and 5.1 decodes (two and six 8-tap launches),
the cursor instance (the Rice warp alone, on no codec path) on each of
those calls' arguments, rice_decode of the stereo frames' first channel
(the raw instance), the first 8-tap call again at 16 and 30 taps, and
that call
with every lane's order forced to 8, 16 and 30 at 8, 16 and 30 taps
(the corpus's lanes are all of order 4, so only these walk at full
width):
  - its time on the card (CUDA events over 5 calls after a warm-up)
    and that time times the SM clock over S, the cycles one step takes;
  - where the checkout's wrappers take ``cycles``, the Rice warps'
    clock64 cycles per codeword (a step) inside their loops, mean and
    most over the warps; where its kernels also count (``kd.COUNTS``),
    the counts and their shares of the lane-steps: those on which the
    zero-run guard fired, on which a zero run began, and whose window
    was not staged;
    and the FIR warps' per step for a full decode,
    also split by the order mix of each warp's walking lanes (a key such
    as "4", "8" or "4+8": the distinct orders, clamped to the walk, of
    the warp's lanes other than those of order 0 and 31), with each
    mix's share of the warps;
  - a hash of its outputs: equal hashes across checkouts mean identical
    outputs;
then ptxas's registers, spills and shared memory
for csrc/decode.cu, and per decode kernel function its innermost SASS
loops (chip_smoke.py :: sass_loops: size and shortest path in
instructions; in a full decode's function, the FIR warp's step loops
besides the Rice warp's, one per walk width, each U steps long where the
walk is unrolled) and its count of shared loads, device loads and
cp.async copies.  The card's name and power limit come
first, then one JSON line per DIR, then which calls' outputs differ
between the checkouts.  With ``--sass OUT`` each checkout also writes
its decode kernels' SASS (`cuobjdump -sass`) to OUT/<n>.sass, n the
checkout's place in the list.  Needs a card; exits nonzero without one.
"""

import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import time

from torch_legacy_ab import events_ms, smi

B = 4096
S = 4096


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sass_text(lib_path: str) -> str:
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout


def sass_counts(out: str) -> dict:
    """{decode kernel function: {shared loads, device loads, cp.async}}
    from `cuobjdump -sass` of the built library."""
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if re.search(r"decode|cursor|raw", m.group(1)) \
                else None
            if fn:
                counts[fn] = dict(LDS=0, LDG=0, LDGSTS=0)
            continue
        if fn:
            for op in ("LDGSTS", "LDS", "LDG"):
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
                    break
    return counts


def order_mix(numactive, taps: int) -> list[str]:
    """Per warp of 32 lanes, the distinct orders (clamped to 1..taps) of
    its walking lanes (not order 0 or 31), joined by "+"; "none" where
    every lane is of order 0 or 31."""
    na = numactive.cpu().tolist()
    keys = []
    for w0 in range(0, len(na), 32):
        walk = sorted({min(max(o, 1), taps) for o in na[w0:w0 + 32]
                       if o not in (0, 31)})
        keys.append("+".join(map(str, walk)) or "none")
    return keys


def child(root: str, sass_out: str | None = None) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from alacjax_torch import AlacConfig, TorchCodec
    from alacjax_torch.kernels import _build
    from alacjax_torch.kernels import decode as kd
    from bench_torch import make_music
    from chip_smoke import music_51, raw_drive, recording, sass_loops

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.lib()
    clock = float(smi("clocks.max.sm")) * 1e6
    ptxas, cur = [], None
    for line in _build.build_log.splitlines():
        if line.startswith("=="):
            cur = line
        elif cur == "== decode.cu" and any(k in line for k in (
                "registers", "spill", "Compiling entry")):
            ptxas.append(line.strip())
    loops = {fn: [v for v in sizes if v[0] > 1]
             for fn, sizes in sass_loops(_build.lib_path()).items()
             if re.search(r"decode|cursor|raw", fn)}
    sass = sass_text(_build.lib_path())
    if sass_out:
        with open(sass_out, "w") as f:
            f.write(sass)
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    cfg51 = AlacConfig(bit_depth=24, num_channels=6, frame_length=S,
                       sample_rate=48000)
    chained = TorchCodec(cfg, chunk=B, device="cuda")
    chained51 = TorchCodec(cfg51, chunk=B, device="cuda")
    x = torch.from_numpy(make_music(B, S)).to("cuda")
    w4, _ = chained._encode(x)
    x51 = torch.from_numpy(music_51(B)).to("cuda")
    w51, _ = chained51._encode(x51)
    del x51
    pcm, err, _ = chained._decode(w4)
    if bool(err.any().item()) or not torch.equal(pcm, x):
        sys.exit("the stereo decode is not lossless")

    calls = []

    def record(label, fn):
        with recording([]) as rec:
            fn()
        for i, (name, wrapper, _, args, kwargs) in enumerate(rec):
            if name.startswith("decode"):       # not the parse or the pcm
                calls.append((f"{label} {name} {i}", name, wrapper, args,
                              kwargs))
    record("chained stereo", lambda: chained._decode(w4))
    record("chained 5.1", lambda: chained51._decode(w51))
    # the Rice warp alone on each 8-tap call's stream: the Rice chain's
    # time apart from the FIR walk
    for label, _, _, args, kwargs in [c for c in calls if c[1] == "decode"]:
        calls.append((label.replace(" decode ", " decode_cursor "),
                      "decode_cursor", kd.cursor_scan, args[:8],
                      dict(num=kwargs["num"])))
    record("rice_decode stereo", lambda: raw_drive(chained, w4))
    first = next(c for c in calls if c[1] == "decode")
    for taps in (16, 30):
        calls.append((f"chained stereo decode_hi taps {taps}", "decode_hi",
                      first[2], first[3], dict(first[4], taps=taps)))
    # the same words with every lane's order forced to the walk's width
    # (the corpus's search picks order 4 on every lane)
    for taps in (8, 16, 30):
        args = list(first[3])
        args[10] = torch.full_like(args[10], taps)
        calls.append((f"chained stereo order {taps} taps {taps}",
                      "decode" if taps == 8 else "decode_hi", first[2],
                      tuple(args), dict(first[4], taps=taps)))

    rows = []
    for label, name, wrapper, args, kwargs in calls:
        ms = events_ms(lambda: wrapper(*args, **kwargs))
        outs = wrapper(*args, **kwargs)
        L = args[1].shape[0]
        row = dict(call=label, lanes=L, ms=ms,
                   cycles_per_step_from_ms=ms * 1e-3 * clock / S,
                   hash=digest(outs if isinstance(outs, tuple) else (outs,)))
        if "cycles" in inspect.signature(wrapper).parameters:
            blocks = -(-L // 32)
            full = name in ("decode", "decode_hi")
            # a checkout whose kernels count (kd.COUNTS) takes their rows
            # after the cycles; an older one takes the cycles alone
            counted = hasattr(kd, "COUNTS")
            shape = ((kd.cycle_rows(full), blocks) if counted
                     else (2, blocks) if full else (blocks,))
            cyc = torch.zeros(shape, dtype=torch.int64, device="cuda")
            wrapper(*args, **kwargs, cycles=cyc)
            per = cyc.double().reshape(-1, blocks) / S
            if counted:
                tot = cyc[-len(kd.COUNTS):].sum(dim=1).tolist()
                row["rice_counts"] = dict(zip(kd.COUNTS, tot))
                row["rice_count_shares"] = {k: v / (L * S)
                                            for k, v in zip(kd.COUNTS, tot)}
            row["rice_cycles_per_codeword"] = dict(
                mean=per[0].mean().item(), most=per[0].max().item())
            row["rice_chain_ms"] = per[0].max().item() * S / clock * 1e3
            if full:
                row["fir_cycles_per_step"] = dict(
                    mean=per[1].mean().item(), most=per[1].max().item())
                mix = {}
                for key, c in zip(order_mix(args[10],
                                            kwargs.get("taps", 8)),
                                  per[1].tolist()):
                    mix.setdefault(key, []).append(c)
                row["fir_cycles_by_order_mix"] = {
                    k: dict(warps=len(v), share=len(v) / blocks,
                            mean=sum(v) / len(v), most=max(v))
                    for k, v in sorted(mix.items())}
        rows.append(row)
    return dict(dir=root, device=torch.cuda.get_device_name(0),
                sm_clock_mhz=clock / 1e6, calls=rows,
                ptxas_decode=ptxas, sass_loops=loops,
                sass_counts=sass_counts(sass))


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print("RESULT " + json.dumps(child(*sys.argv[2:4])), flush=True)
        return 0
    sass_dir = None
    if len(sys.argv) >= 3 and sys.argv[1] == "--sass":
        sass_dir = sys.argv[2]
        del sys.argv[1:3]
        os.makedirs(sass_dir, exist_ok=True)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(smi("name,power.limit", "csv,noheader"), flush=True)
    results, failed = [], []
    for n, d in enumerate(sys.argv[1:]):
        t0 = time.perf_counter()
        extra = [os.path.join(os.path.abspath(sass_dir), f"{n}.sass")] \
            if sass_dir else []
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", d] + extra, capture_output=True,
                              text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:] + proc.stderr[-6000:], file=sys.stderr)
            print(f"{d}: exited {proc.returncode}", flush=True)
            failed.append(d)
            continue
        res = json.loads(lines[-1][len("RESULT "):])
        res["seconds"] = time.perf_counter() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    by_call = {}
    for res in results:
        for row in res["calls"]:
            by_call.setdefault(row["call"], set()).add(row["hash"])
    differ = sorted(c for c, h in by_call.items() if len(h) > 1)
    print(json.dumps(dict(checkouts=len(results), failed=failed,
                          calls_whose_outputs_differ=differ)), flush=True)
    return 1 if failed or differ else 0


if __name__ == "__main__":
    sys.exit(main())
