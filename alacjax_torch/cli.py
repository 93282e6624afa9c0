"""alacconvert-compatible CLI (reference: convert-utility/main.cpp), the
port's copy of alacjax/cli.py.

Usage:
    python -m alacjax_torch.cli input.wav output.caf [options]
    python -m alacjax_torch.cli input.caf output.wav [options]
    python -m alacjax_torch.cli a.wav b.wav --outdir DIR [options]

Direction is inferred from the file extensions, exactly like the
reference's ``alacconvert``.  The torch backend (the default) runs on
``--device`` (default cuda); without a card it exits nonzero before it
writes anything: pass ``--backend oracle`` or ``--device cpu``.
``--devices N`` splits its frame batches across N devices (default:
every visible card); it reaches the codec as an argument.
"""

from __future__ import annotations

import argparse
import sys

from .types import AlacError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alacconvert",
        description="Apple Lossless converter (PyTorch/CUDA rebuild). "
                    "WAV->CAF/M4A encodes; CAF/M4A->WAV decodes; "
                    "CAF<->M4A repacks without transcoding.",
    )
    p.add_argument("files", nargs="+", metavar="FILE",
                   help="INPUT OUTPUT for a single conversion, or (with "
                        "--outdir) one or more INPUTs converted in shared "
                        "device batches")
    p.add_argument("--outdir", metavar="DIR", default=None,
                   help="batch mode: convert every FILE into DIR in "
                        "shared device batches (many short files encode/"
                        "decode as one accelerator stream); output names "
                        "keep the input basename")
    p.add_argument("--to", choices=("caf", "m4a", "wav"), default=None,
                   help="batch mode target container for encodes "
                        "(default caf; decodes always target wav)")
    p.add_argument("--frame-size", type=int, default=4096, metavar="N",
                   help="samples per packet (default 4096)")
    p.add_argument("--fast", action="store_true",
                   help="fast mode: skip the encoder parameter search")
    p.add_argument("--independent-frames", action="store_true",
                   help="reset predictor state each packet "
                        "(enables packet-parallel encode)")
    p.add_argument("--backend", choices=("oracle", "torch"),
                   default="torch",
                   help="packet codec backend (default: torch, the batched "
                        "device codec; oracle is the scalar host codec)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the torch backend (default: cuda; "
                        "cpu runs its plain torch versions on the host)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="split the torch backend's device batches across "
                        "up to N cards (default: all visible cards, "
                        "bounded by ALACJAX_DEVICES; frame-parallel, "
                        "byte-identical output); with --device cpu, N "
                        "shares on the host")
    p.add_argument("--search", choices=("standard", "exhaustive"),
                   default="standard",
                   help="encoder parameter search: standard (dilated "
                        "mixres trial) or exhaustive (full-rate trials "
                        "over every mixres; best rate — device-batched "
                        "with --independent-frames on the torch backend, "
                        "host codec otherwise)")
    p.add_argument("--resume", action="store_true",
                   help="checkpointed encode: journal progress next to the "
                        "output and resume after interruption "
                        "(WAV->CAF/M4A only); in batch mode (--outdir), "
                        "skip inputs whose output already exists and "
                        "parses cleanly")
    p.add_argument("--check", action="store_true",
                   help="after encoding, decode the output back and "
                        "verify it matches the source sample-for-sample "
                        "(exit nonzero on any mismatch)")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def _check_single(args, backend: str) -> None:
    """--check for single-file encodes: decode the output back and
    compare against the source sample-for-sample."""
    if not args.check:
        return
    from .convert import verify_lossless
    n = verify_lossless(args.input, args.output, backend=backend,
                        device=args.device, devices=args.devices)
    print(f"alacconvert: --check OK ({n} samples lossless)",
          file=sys.stderr)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.outdir is None:
        if len(args.files) != 2:
            parser.error("expected INPUT OUTPUT (or use --outdir for "
                         "batch mode)")
        args.input, args.output = args.files

    backend = args.backend
    if backend == "torch":
        # no fallback that hides the card: without one, stop before any
        # output is written
        import torch
        try:
            dev = torch.device(args.device)
        except RuntimeError as e:
            print(f"alacconvert: bad --device: {e}", file=sys.stderr)
            return 2
        if args.devices is not None and args.devices < 1:
            print("alacconvert: --devices must be at least 1",
                  file=sys.stderr)
            return 2
        if dev.type == "cuda" and not torch.cuda.is_available():
            print(f"alacconvert: --device {args.device}: no CUDA device is "
                  "available; pass --backend oracle (the scalar host "
                  "codec) or --device cpu (the torch backend on the host)",
                  file=sys.stderr)
            return 2

    import time

    from .convert import convert_file
    t0 = time.time()
    try:
        if args.outdir is not None:
            from .batch import convert_many
            outs = convert_many(
                args.files, args.outdir, to=args.to,
                frame_length=args.frame_size, fast_mode=args.fast,
                backend=backend, search=args.search,
                resume=args.resume, device=args.device,
                devices=args.devices)
            if args.check:
                from .convert import verify_lossless
                wavs = [(i, o) for i, o in zip(args.files, outs)
                        if i.lower().endswith(".wav")]
                if not wavs:
                    raise AlacError(-50, "--check applies to encodes "
                                    "(no .wav inputs in this batch)")
                total = sum(verify_lossless(i, o, backend=backend,
                                            device=args.device,
                                            devices=args.devices)
                            for i, o in wavs)
                print(f"alacconvert: --check OK ({len(wavs)} files, "
                      f"{total} samples lossless)", file=sys.stderr)
            if args.verbose:
                import os
                dt = time.time() - t0
                in_sz = sum(os.path.getsize(f) for f in args.files)
                out_sz = sum(os.path.getsize(f) for f in outs)
                print(f"{len(args.files)} files ({in_sz}B) -> "
                      f"{args.outdir} ({out_sz}B) "
                      f"[backend={backend}, {dt:.2f}s]")
            return 0
        if args.input == "-" or args.output == "-":
            # pipe mode: '-' reads stdin / writes stdout; input format is
            # sniffed from content, output format from the extension or
            # --to (default: wav -> caf, caf/m4a -> wav)
            if args.resume:
                raise AlacError(-50, "--resume requires real file paths")
            from .convert import convert_bytes, sniff_format
            blob = (sys.stdin.buffer.read() if args.input == "-"
                    else open(args.input, "rb").read())
            in_fmt = sniff_format(blob)
            if args.output == "-":
                out_fmt = args.to or ("caf" if in_fmt == "wav" else "wav")
            else:
                ext = args.output.rsplit(".", 1)[-1].lower()
                out_fmt = {"caf": "caf", "m4a": "m4a", "mp4": "m4a",
                           "wav": "wav"}.get(ext)
                if out_fmt is None:
                    raise AlacError(-50, f"unsupported output extension "
                                    f".{ext}")
            out = convert_bytes(
                blob, out_fmt, frame_length=args.frame_size,
                fast_mode=args.fast,
                independent_frames=args.independent_frames,
                backend=backend, search=args.search, device=args.device,
                devices=args.devices)
            if args.check:
                if in_fmt != "wav":
                    raise AlacError(-50, "--check applies to encodes")
                from .convert import verify_lossless
                n = verify_lossless(blob, out, backend=backend,
                                    device=args.device, devices=args.devices)
                print(f"alacconvert: --check OK ({n} samples lossless)",
                      file=sys.stderr)
            if args.output == "-":
                sys.stdout.buffer.write(out)
                sys.stdout.buffer.flush()
            else:
                with open(args.output, "wb") as f:
                    f.write(out)
        elif args.resume and args.input.lower().endswith(".wav"):
            from . import checkpoint
            checkpoint.resumable_encode(
                args.input, args.output, frame_length=args.frame_size,
                backend=backend, fast_mode=args.fast, device=args.device,
                devices=args.devices)
            checkpoint.finalize(args.input, args.output, backend=backend,
                                device=args.device)
            _check_single(args, backend)
        elif args.input.lower().endswith(".wav"):
            convert_file(
                args.input, args.output,
                frame_length=args.frame_size,
                fast_mode=args.fast,
                independent_frames=args.independent_frames,
                backend=backend,
                search=args.search,
                device=args.device,
                devices=args.devices,
            )
            _check_single(args, backend)
        else:
            if args.check:
                raise AlacError(-50, "--check applies to encodes")
            convert_file(args.input, args.output, backend=backend,
                         device=args.device, devices=args.devices)
    except AlacError as e:
        print(f"alacconvert: {e}", file=sys.stderr)
        return abs(e.status) % 256 or 1
    except OSError as e:
        print(f"alacconvert: {e}", file=sys.stderr)
        return 1
    if args.verbose:
        import os
        dt = time.time() - t0
        in_sz = os.path.getsize(args.input)
        out_sz = os.path.getsize(args.output)
        print(f"{args.input} ({in_sz}B) -> {args.output} ({out_sz}B) "
              f"ratio={out_sz / max(in_sz, 1):.3f} "
              f"[backend={backend}, {dt:.2f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
