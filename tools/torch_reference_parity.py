#!/usr/bin/env python
"""Reference-parity harness for the alacjax_torch port
(tools/tools_reference_parity.py, without jax): the port's converter
against Apple's reference ``alacconvert`` once its sources are present.

Given a populated reference directory (``--reference DIR``) it

  1. copies the reference sources into its temporary work directory and
     builds ``alacconvert`` there (make where a makefile exists, else one
     g++ over every C/C++ source found), so nothing is written into DIR,
  2. writes the corpus: five configs (stereo16, mono16, hires24,
     surround51, escape32) by four content classes, each a WAV file of
     three frames and a partial tail,
  3. holds (a) the port's packets byte for byte against the reference's
     for each file, (b) the port's decoder on the reference's stream and
     the reference's decoder on the port's stream, both lossless,
  4. prints one JSON line: the bit-exact parity rate (target 1.0) and,
     for each divergence, the first differing packet and byte.

"Ours" is the port's converter (``alacjax_torch.convert.convert_file``)
on the torch backend, on the card unless ``--device cpu``.  The torch
backend encodes independent frames (each packet from fresh predictor
state, as the device encoder does), so the harness writes its
reference's streams in that mode too; against a reference binary that
carries its coefficients from packet to packet, the packets after a
file's first differ by design, and the cross-decodes are the check.

While ``--reference`` is not given, or names an empty or missing
directory, it prints a SKIP line and exits 0.  ``--self-test`` puts ``python -m alacjax_torch.cli --backend oracle
--independent-frames`` (the port's scalar host codec) in the reference
binary's place, so every part of the harness but the reference build is
exercised.  ``--frame-length N`` and ``--every K`` (every K-th corpus
file) cut the corpus for a quick run.

Usage:
  python tools/torch_reference_parity.py --reference DIR [--device cuda|cpu]
  python tools/torch_reference_parity.py --self-test [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # script lives in tools/


# ---------------------------------------------------------------------------
# reference build
# ---------------------------------------------------------------------------
def build_reference(src_dir: str, out_dir: str) -> str:
    """Build the reference alacconvert from a copy of ``src_dir`` made
    under ``out_dir``; returns the binary path."""
    ref_dir = os.path.join(out_dir, "reference")
    shutil.copytree(src_dir, ref_dir, symlinks=True)
    for root, _dirs, files in os.walk(ref_dir):
        if not any(f.lower() in ("makefile", "gnumakefile") for f in files):
            continue
        r = subprocess.run(["make", "-C", root, "-j1"],
                           capture_output=True, text=True, timeout=600)
        if r.returncode == 0:
            for broot, _d, bfiles in os.walk(ref_dir):
                for f in bfiles:
                    p = os.path.join(broot, f)
                    if f == "alacconvert" and os.access(p, os.X_OK):
                        return p
    srcs, incs = [], set()
    for root, _dirs, files in os.walk(ref_dir):
        for f in files:
            if f.endswith((".c", ".cpp")):
                srcs.append(os.path.join(root, f))
            if f.endswith(".h"):
                incs.add(root)
    if not srcs:
        raise RuntimeError("no C/C++ sources found in the reference "
                           "directory")
    binp = os.path.join(out_dir, "alacconvert")
    cmd = (["g++", "-O2", "-fwrapv", "-o", binp]
           + srcs + [f"-I{i}" for i in sorted(incs)])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"reference build failed:\n{r.stderr[-4000:]}")
    return binp


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------
CONFIGS = [  # (name, depth, channels)
    ("stereo16", 16, 2),
    ("mono16", 16, 1),
    ("hires24", 24, 2),
    ("surround51", 16, 6),
    ("escape32", 32, 2),
]
CONTENT = ["sine", "noise", "silence", "impulse"]


def gen_pcm(kind: str, nch: int, n: int, depth: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
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
    x = np.zeros((nch, n), dtype=np.int64)
    x[:, ::211] = full - 1
    x[:, 7::401] = -full
    return x


def write_corpus(d: str, frame_length: int, every: int = 1):
    """The corpus as WAV files in ``d``: three frames and a partial tail
    of each (config, content class), seeded by their names."""
    from alacjax_torch.containers.pcm import pack_pcm
    from alacjax_torch.containers.wav import WavFile, write_wav
    n = 3 * frame_length + 1234 % frame_length
    items = []
    for name, depth, nch in CONFIGS:
        for kind in CONTENT:
            seed = zlib.crc32(f"{name}_{kind}".encode()) & 0xFFFF
            pcm = gen_pcm(kind, nch, n, depth, seed)
            path = os.path.join(d, f"{name}_{kind}.wav")
            write_wav(WavFile(44100, depth, nch, pack_pcm(pcm, depth)), path)
            items.append(dict(name=f"{name}_{kind}", wav=path, pcm=pcm))
    return items[::every]


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------
def run_ref(binp: str, inp: str, outp: str) -> None:
    r = subprocess.run([binp, inp, outp], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{binp} {inp} -> {outp} rc={r.returncode}: "
                           f"{r.stderr[-500:]}")


def first_packet_diff(a: list[bytes], b: list[bytes]):
    for i, (pa, pb) in enumerate(zip(a, b)):
        if pa != pb:
            off = next((j for j, (x, y) in enumerate(zip(pa, pb)) if x != y),
                       min(len(pa), len(pb)))
            return dict(packet=i, byte=off, ours=len(pa), ref=len(pb))
    if len(a) != len(b):
        return dict(packet=min(len(a), len(b)), byte=-1,
                    ours=len(a), ref=len(b))
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--self-test", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reference", metavar="DIR")
    p.add_argument("--frame-length", type=int, default=4096, metavar="N")
    p.add_argument("--every", type=int, default=1, metavar="K")
    args = p.parse_args(argv)

    if not args.self_test and not (args.reference
                                   and os.path.isdir(args.reference)
                                   and os.listdir(args.reference)):
        reason = (f"{args.reference} is empty or missing" if args.reference
                  else "no --reference DIR given")
        print(json.dumps({"metric": "reference parity", "status": "SKIP",
                          "reason": reason}))
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_reference_parity: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2

    from alacjax_torch.cli import main as cli
    from alacjax_torch.containers.caf import read_caf
    from alacjax_torch.containers.pcm import unpack_pcm
    from alacjax_torch.containers.wav import read_wav
    from alacjax_torch.convert import convert_file

    S = args.frame_length
    work = tempfile.mkdtemp(prefix="refparity_")
    try:
        if args.self_test:
            def ref_conv(inp, outp):
                rc = cli([inp, outp, "--backend", "oracle",
                          "--independent-frames", "--frame-size", str(S)])
                if rc:
                    raise RuntimeError(f"self-test reference rc={rc}")
        else:
            binp = build_reference(args.reference, work)

            def ref_conv(inp, outp):
                run_ref(binp, inp, outp)

        def ours(inp, outp):
            convert_file(inp, outp, backend="torch", device=args.device,
                         frame_length=S, independent_frames=True)

        def lossless(wav, pcm):
            w = read_wav(wav)
            return bool(np.array_equal(
                unpack_pcm(w.data, w.bit_depth, w.num_channels), pcm))

        items = write_corpus(work, S, args.every)
        results, n_exact = [], 0
        for it in items:
            row = dict(name=it["name"])
            base = os.path.join(work, it["name"])
            ours(it["wav"], base + ".ours.caf")
            ref_conv(it["wav"], base + ".ref.caf")
            diff = first_packet_diff(read_caf(base + ".ours.caf").packets,
                                     read_caf(base + ".ref.caf").packets)
            row["encode_parity"] = diff is None
            if diff:
                row["first_diff"] = diff
            else:
                n_exact += 1
            ours(base + ".ref.caf", base + ".refdec.wav")
            row["ours_decodes_ref"] = lossless(base + ".refdec.wav",
                                               it["pcm"])
            ref_conv(base + ".ours.caf", base + ".oursdec.wav")
            row["ref_decodes_ours"] = lossless(base + ".oursdec.wav",
                                               it["pcm"])
            results.append(row)

        rate = n_exact / len(items)
        ok_cross = all(r["ours_decodes_ref"] and r["ref_decodes_ours"]
                       for r in results)
        print(json.dumps({
            "metric": "bit-exact parity rate vs reference",
            "value": rate, "unit": "fraction (target 1.0)",
            "cross_decode_lossless": ok_cross,
            "mode": "self-test" if args.self_test else "reference",
            "device": args.device, "frame_length": S, "files": len(items),
            "divergent": [r for r in results
                          if not (r["encode_parity"]
                                  and r["ours_decodes_ref"]
                                  and r["ref_decodes_ours"])],
        }))
        return 0 if (rate == 1.0 and ok_cross) else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
