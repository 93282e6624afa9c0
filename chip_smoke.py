#!/usr/bin/env python3
"""Smoke run of the alacjax_torch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits nonzero on failure:
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the CUDA kernels from alacjax_torch/csrc (one nvcc per source,
     all started together, sm_90a) and print ptxas's registers and
     spills for each kernel instance, and each instance's innermost
     loops in SASS (cuobjdump -sass: size and shortest trip, the
     instructions a kernel issues per lane-sample, to hold beside the
     operations the function needs);
  3. kernels against their plain torch versions on the card, on recorded
     inputs: every kernel call of one device-resident encode + decode of
     the phase-4 corpus, one call per distinct (taps, chanbits) of the
     phase-5 and phase-6 decodes, and one call per distinct signature of
     the phase-7 5.1 encode, of the standalone-predictor encodes
     (phase 8's stereo corpus and the 5.1 corpus), of one stream
     step with persistent banks (packet 2 of phase 10's streams, the
     banks carried from packet 1: the cost kernel with one block of
     starting coefficients per order), of phase 12's cursor calls
     (the cursor instance on each 8-tap launch's stream, stereo and
     5.1) and of its rice_decode (the raw instance) — a new signature's
     call at S = 4096 is compared on its first PREFIX samples (with num
     clamped there), a causal prefix being a whole input of its own, and
     on the whole input, whose time and bound are printed beside — and
     one synthetic emit call whose lanes and steps end mid-tile
     (RAGGED_EMIT); the standalone-predictor route's calls are one
     predictor launch for every order of a pass and one Rice cost
     launch pricing every order's residuals and, stage 2, their first
     difference (``dual``); then tests/torch_predict_cases.py's
     tile-edge inputs through both of those kernels (every order, per-
     lane chanbits 16..33 and num, L 33 and 67, S 1..100); the cost
     kernel and every decode instance at per-lane chanbits 16..33 on
     synthetic inputs (tests/torch_decode_cases.py); every decode
     instance on that file's window_lanes (WINDOW_CASES: the edges of the
     Rice decoder's staged window, with the usual starting mean and with
     MB0_JUMP); the 8-, 16- and 30-tap decode on its fir_lanes
     (FIR_CASES: Rice-coded small residuals that stop the sign-sign walk
     at every tap, warps of one order and of mixed orders, every
     denshift, coefficients at the 16-bit limits, samples that wrap at
     chanbits 32); and per merge
     signature torch's scatter_ (merge's compaction half) beside the
     merge kernel's scatter alone and the whole merge; the results
     must be exactly equal; each call's bound is printed beside (see
     ``work``: bytes at 3.35 TB/s or the operations the function needs
     at the SMs' issue rate, whichever is longer), each predictor
     call's walker warps' clock64 cycles per step, and each decode
     call's Rice warps' clock64 cycles per codeword (the FIR warps' per
     step beside, for a full decode, also per order mix of a warp's
     walking lanes), with those times S over the SM clock (the per-lane
     chain);
  4. the main path: TorchCodec encode_frames -> decode_frames_ex on the
     bench corpus (bench_torch.py :: make_music, B=4096 frames of 16-bit
     stereo, S=4096): lossless, no frame flagged, the first 256 packets
     byte-identical to the native C++ encoder, every kernel launched;
     encode/decode seconds and frames/s, then the device-resident steady
     state (PCM and words stay on the card) with its peak memory;
  5. layouts and depths: decode_frames_ex of B=4096 packets of 24-bit
     5.1 (SCE, CPE, CPE, LFE; every 64th frame partial) from the native
     C++ encoder: lossless, no frame to the oracle, equal to the native
     decoder on the first 256 packets; host-API and device-resident
     decode seconds, frames/s and peak memory;
  6. the retry ladder: decode_frames_ex of B=4096 stereo-16 packets with
     forced predictor orders 9..30 (modes 0 and 15): the 16- and 30-tap
     decodes both run, no frame reaches the oracle, the PCM equals the
     native decoder's; decode seconds beside phase 4's 8-tap decode;
  7. encode of every layout: encode_frames_ex of phase 5's PCM and
     sample counts (B=4096, 24-bit 5.1 with partial frames): every
     packet byte-identical to phase 5's native C++ packet at its
     position, decoded back losslessly with no frame to the oracle;
     host-API and device-resident encode seconds, frames/s and peak
     memory; then B=512 each of 20-bit stereo, 32-bit stereo, 16-bit
     stereo in fast mode and 16-bit stereo with the exhaustive search,
     every packet byte-identical to the native C++ encoder's;
  8. the standalone-predictor route: phase 4's corpus encoded with
     predict_legacy=True: every packet equal to phase 4's, the predict
     and rice_cost kernels launched (rice_cost at most 3 times for the
     one encode) and the cost kernel never; its device-resident encode
     seconds beside phase 4's;
  9. the converter: an album written as WAV files to a temporary
     directory (ALBUM_TRACKS stereo-16 44.1 kHz tracks of TRACK_SECONDS
     from make_music, and one 24-bit 5.1 48 kHz track of SURROUND_SECONDS
     from phase 5's signal), then ``alacjax_torch.cli.main``: the album
     batch-encoded to M4A with --check (one batched device stream at the
     default chunk), the 5.1 track to CAF with --check, and every M4A
     and the CAF batch-decoded back to WAV.  Every decoded WAV's PCM
     equals its source; track 0 and the 5.1 track, every packet, and the
     first N_ALBUM_NATIVE packets of the other tracks, equal the native
     C++ encoder's; an AlacReader range read through the torch backend
     equals the source; no frame reaches the oracle.  Each step's wall
     seconds and frames/s, and the host time split (WAV parse and
     unpack, host-to-device copies, device calls, readback waits,
     words_to_bytes / bytes_to_words, container reading and writing),
     for the pipelined host API and, on the same corpus, for the
     unpipelined loop it replaced (``unpipelined_encode_host`` /
     ``unpipelined_decode_frames_ex``, over the same device calls);
 10. persistent-bank streams: encode_stream_device of B stereo-16
     streams of N_STREAM consecutive make_music frames each, then of
     N51_STREAMS 24-bit 5.1 streams of N51 frames: the first
     N_NATIVE_STREAMS stereo and N_NATIVE_51 5.1 streams equal the
     stateful native C++ encoder's packets, packet by packet; some
     packet differs from the independent-frames encode of the same PCM
     (the banks are used); every packet decodes losslessly through
     decode_frames_ex with no frame to the oracle; ms per packet step
     and frames/s beside phase 4's device-resident encode;
 11. the frames axis: ShardedCodec over every visible card (one card is
     listed twice) on phase 4's batch: the split encode's words and
     bits, and its decode, equal the unsplit codec's; the host API's
     packets equal phase 4's and decode losslessly; roundtrip_step is
     lossless and its total_bytes is the sum of the packets' lengths;
 12. the Rice chain alone: the cursor instance (the Rice warp, on no
     codec path) on the stream of each 8-tap launch of the chained
     decodes of phase 4's stereo-16 words and phase 5's 24-bit 5.1
     words, ending where the launch ends; the cursor's ms per channel
     beside the 8-tap launch's, in turns; rice_decode of the stereo
     frames' first channel (the raw instance), ending where the cursor
     ends; then the encode of phase 4's batch and the decodes of phases
     4 and 5 up to each profiling cut (``stop_at``), ms per batch;
 13. the differential campaign of tools/torch_fuzz_soak.py at B=4096
     lanes of S=4096 (FUZZ_SIZES cuts only distinct packets and oracle
     lanes): one grammar round per shape (random legal header
     parameters, orders up to 30, tiled and permuted so each warp mixes
     packets; the 30-tap device decode flags no lane and equals the
     native decoder, decode_frames_ex's ladder returns the same PCM),
     the DSE/FIL and deviant-bytesShifted batches (the device flags
     exactly those lanes, decode_frames_ex gives the oracle's PCM), one
     content round per shape (adversarial frames with partial tails,
     packets equal to the native encoder on every lane), one exhaustive
     round per shape, then the pathological fixtures of five configs and
     the eight escape-flip pairs (packets equal to the native encoder's,
     the escape bit on its side, lossless); the oracle holds the first
     lanes of each.  Every kernel signature no earlier phase produced
     (``signature``: per-lane vectors marked uniform or mixed)
     is compared on its first PREFIX samples and FUZZ_LANES lanes with
     its plain version, run on the host in worker processes.  Prints
     rounds and lanes per kind, frames sent to the oracle, corpus
     building seconds and the phase's seconds;
 14. (a) the merge invariant on the widest layout: B=4096 16-bit 7.1
     frames of S=4096 (tests/test_chunk_budget.py's four rows tiled
     over the lanes, seeded) encoded with the merge wrapper recorded;
     per merge call, every lane's keys other than empty are 0..n-1 in
     slot order with n <= num_words, checked on the card; the first
     N_MERGE_NATIVE packets equal the native C++ encoder's, and every
     lane decodes losslessly; (b) the bench family once:
     bench_torch.measure (B=4096, BENCH_ITERS pairs, BENCH_REPEATS
     repeats) and bench_configs_torch's five configs (B=CONFIGS_B,
     CONFIGS_ITERS), each gated on losslessness, their JSON lines
     printed.
Each path (phases 4-14) runs with the launch counts set to 0 just before
it and read just after; a kernel of the path that was not launched
fails the run.  The line before the last is a JSON object of per-kernel
results ("launches" sums the paths' counts; "ms", "plain_ms" and
"bound_ms" sum a kernel's compared calls, on the inputs compared;
"library_ms" is merge's: torch's scatter_ computing its compaction half
on the same inputs, summed over phase 3's merge signatures; null for
the scans, which no single PyTorch call computes); the last line is
the JSON result line.  ``--profile DIR`` also writes torch.profiler tables
of one device-resident encode + decode of phase 4 (DIR/profile.txt), one
phase-5 decode (DIR/profile_51.txt), the three phase-6 rungs
(DIR/profile_ladder.txt), one phase-7 5.1 encode (DIR/profile_enc51.txt),
one phase-8 encode (DIR/profile_legacy.txt) and one phase-10 stream
encode (DIR/profile_streams.txt).
"""

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

B = 4096                 # frames per batch (bench.py's headline batch)
S = 4096                 # samples per frame
N_NATIVE = 256           # packets held against the native C++ codec
N_DISTINCT_51 = 512      # distinct 24-bit 5.1 frames, tiled to B
N_DISTINCT_HI = 256      # distinct forced-order packets, tiled to B
N_SMALL = 512            # frames of each small phase-7 encode
PARTIAL_EVERY = 64       # every 64th 5.1 frame is a partial frame
ALBUM_TRACKS = 8         # phase 9: stereo-16 44.1 kHz tracks ...
TRACK_SECONDS = 180      # ... of 180 s (1,937 full frames + 4,048)
SURROUND_SECONDS = 60    # and one 24-bit 5.1 48 kHz track (703 + 512)
N_ALBUM_NATIVE = 64      # packets of tracks 1.. held to the native codec
PREFIX = 1024            # samples of a new signature's phase-3 compare
RAGGED_EMIT = (4129, 1001)   # (L, S) of phase 3's synthetic emit call
N_STREAM = 4             # phase 10: packets per stereo-16 stream (B streams)
N_NATIVE_STREAMS = 64    # stereo streams held to the stateful native encoder
N51_STREAMS = 512        # phase 10: 24-bit 5.1 streams ...
N51 = 3                  # ... of 3 packets
N_NATIVE_51 = 8          # 5.1 streams held to the stateful native encoder
# phase 13: tools/torch_fuzz_soak.py's campaign at S = B = 4096, cut in
# distinct packets and oracle lanes (never S, B or a shape) to its budget
FUZZ_SIZES = dict(grammar=32, grammar_oracle=2, content_oracle=2,
                  exhaustive_oracle=1, special=2)
FUZZ_SEED = 0            # the round seed (grammar 10M + it, content 20M + ...)
FUZZ_LANES = 256         # lanes of a new phase-13 signature's compare
# phase 3: tests/torch_decode_cases.py :: window_lanes cases, (row width
# mod 4, lanes, samples, word rows or None for one per lane); the plain
# versions' loops set the samples (the cuda tests take S=4096)
WINDOW_CASES = ((1, 64, 96, None), (2, 64, 96, 8), (3, 96, 77, 16),
                (0, 40, 64, None), (1, 4096, 256, None),
                (3, 4096, 256, 1024))
# phase 3: tests/torch_decode_cases.py :: fir_lanes cases, (lanes,
# samples) at each tap count of the full decode
FIR_CASES = ((256, 256),)
# phase 14: the merge invariant on 7.1, then the bench family once
MERGE_SEED = 25          # the seed of the 7.1 rows' noise
N_MERGE_NATIVE = 64      # 7.1 packets held to the native C++ encoder
BENCH_ITERS = 6          # bench_torch.py's chained pairs per repeat ...
BENCH_REPEATS = 5        # ... and its repeats, its defaults
CONFIGS_B = 512          # bench_configs_torch.py's frames per config ...
CONFIGS_ITERS = 2        # ... and its iterations (5 by default)
REPLACES = {
    "cost": "alacjax/ops/pallas/cost_pallas.py:346",
    "emit": "alacjax/ops/pallas/emit_pallas.py:257",
    "merge": "alacjax/ops/pallas/merge.py:98",
    "decode": "alacjax/ops/pallas/decode_step.py:121",
    "decode_hi": "alacjax/ops/pallas/decode_pallas.py:381",
    "predict": "alacjax/ops/pallas/predict_pallas.py:128",
    # a glue kernel: the XLA scan the predict_legacy route prices with
    "rice_cost": "alacjax/ops/rice.py:195",
    # glue kernels: the XLA cursor scan (alacjax's stacked decode's first
    # pass; here on no codec path), and the raw mode of alacjax's
    # decode_channel behind rice_decode
    "decode_cursor": "alacjax/ops/fused_decode.py:337",
    "decode_raw": "alacjax/ops/rice.py:427",
    # the decode's per-element header parse (XLA glue in alacjax)
    "parse": "alacjax/codec.py:1166",
    # and the decode's per-element unmix, shift_in and escape select, then
    # the stack of the channels and the tail mask (XLA glue in alacjax)
    "pcm": "alacjax/codec.py:1336",
    # the encode search's stream glue (XLA in alacjax): the mixres trial's
    # candidate streams and each CPE's chosen mix, then each stream's
    # winning order, stage and residual row
    "search_mix": "alacjax/codec.py:109",
    "search_pick": "alacjax/codec.py:159",
    # the encode's chunk assembly (XLA glue in alacjax): every element's
    # header tokens, shift-byte block and Rice rows, the escape select,
    # the tails and the END tag
    "assemble": "alacjax/codec.py:696",
}
SOURCES = {name: f"alacjax_torch/csrc/{name}.cu" for name in REPLACES}
for _name in ("decode_hi", "decode_cursor", "decode_raw"):
    SOURCES[_name] = SOURCES["decode"]         # instances of csrc/decode.cu
SOURCES["rice_cost"] = SOURCES["predict"]      # its cost-only pass
SEARCHES = ("search_mix", "search_pick")
for _name in SEARCHES:
    SOURCES[_name] = "alacjax_torch/csrc/search.cu"
DECODES = ("decode", "decode_hi", "decode_cursor", "decode_raw")
# (wrapper module, wrapper, its plain version, LAUNCHES key); the decode
# wrapper's key follows its tap count and raw mode
WRAPPERS = (
    ("alacjax_torch.kernels.cost", "pc_block_cost2", "plain", "cost"),
    ("alacjax_torch.kernels.emit", "rice_encode_words", "plain", "emit"),
    ("alacjax_torch.kernels.merge", "merge_sorted_chunks", "plain", "merge"),
    ("alacjax_torch.kernels.decode", "decode_channel", "plain", None),
    ("alacjax_torch.kernels.decode", "cursor_scan", "plain_cursor",
     "decode_cursor"),
    ("alacjax_torch.kernels.predict", "pc_block", "plain_pc_block",
     "predict"),
    ("alacjax_torch.kernels.predict", "rice_cost", "plain_rice_cost",
     "rice_cost"),
    ("alacjax_torch.kernels.parse", "parse_element", "plain", "parse"),
    ("alacjax_torch.kernels.pcm", "element_pcm", "plain", "pcm"),
    ("alacjax_torch.kernels.search", "mix_trial", "plain_mix_trial",
     "search_mix"),
    ("alacjax_torch.kernels.search", "mix_streams", "plain_mix_streams",
     "search_mix"),
    ("alacjax_torch.kernels.search", "pick", "plain_pick", "search_pick"),
    ("alacjax_torch.kernels.assemble", "chunks", "plain", "assemble"),
)
ENCODES = ("cost", "emit", "merge", "search_mix", "search_pick", "assemble")
PATH_KERNELS = {         # the kernels each path must launch
    "phase 4": ENCODES + ("decode", "parse", "pcm"),
    "phase 5": ("decode", "parse", "pcm"),
    "phase 6": ("decode", "decode_hi", "parse", "pcm"),
    "phase 7": ENCODES,
    "phase 8": ("predict", "rice_cost", "emit", "merge", "search_mix",
                "search_pick", "assemble"),
    "phase 9": ENCODES + ("decode", "parse", "pcm"),
    "phase 10": ENCODES + ("decode", "parse", "pcm"),
    "phase 11": ENCODES + ("decode", "parse", "pcm"),
    "phase 12": ("decode", "decode_cursor", "parse", "pcm"),
    "phase 12 raw": ("decode_raw",),
    "phase 13": ENCODES + ("decode", "decode_hi", "parse", "pcm"),
    "phase 14": ENCODES + ("decode", "parse", "pcm"),
    "phase 14 bench": ENCODES + ("decode", "parse", "pcm"),
}
HBM_BYTES_PER_S = 3.35e12    # one H100 SXM's device memory rate
# Lane operations one Hopper SM issues per clock: four schedulers, each
# one warp instruction (32 lanes) a clock, whatever the pipe.  The scans'
# multiply-adds go down the FMA pipe and their adds, logic, shifts and
# selects down the ALU pipe, side by side, so for their mix the issue
# rate is the ceiling (ALU operations alone would be held to 64).
LANE_OPS_PER_SM_CLOCK = 128
# Operations one lane-sample of a scan needs, counted from the
# reference's arithmetic (dp_enc.c / dp_dec.c, ag_enc.c / ag_dec.c, as
# csrc/ writes it; a multiply-add, a three-input add and a sign extension
# are one operation each), whatever the kernel issues.  The counts that
# depend on the data (samples a Rice machine codes, steps the sign-sign
# walk takes) are the plain version's own on the same inputs
# (alacjax_torch.ops.tutils.WORK).
FIR_PER_TAP = 2      # per tap of the lane's order: lag difference, multiply-add
FIR_FIXED = 4        # per sample past the warm-up: the rounding shift, the
                     # residual's add, its sign extension, its sign
WALK_STEP = 8        # per walk step: the difference's sign (2), the
                     # coefficient's step and 16-bit wrap (2), |d|, the
                     # shift, the weighted multiply-subtract, the side test
RICE_PRICE = 30      # per coded sample of a cost machine: k (4), m (2), the
                     # folded value (3), the capped quotient and remainder
                     # (3), the length (3), the escape test and length (4),
                     # the running sum (1), the mean's update and clamp (6),
                     # the zero-run test and state (4)
RICE_EMIT = RICE_PRICE + 12  # + the codeword's value (4), the escape
                             # payload (2), the append to the word (6)
RICE_DECODE = 36     # per decoded sample: k (4), m (2), 32 bits cut at the
                     # cursor (3), the prefix (2), the suffix (3), the
                     # escape test (1), n (3), the cursor's advance (4),
                     # the unfolded residual (4), the mean (6), the
                     # zero-run test (4)
UNFOLD = 4           # the unfolded residual's share of RICE_DECODE
RICE_IDLE = 3        # per sample inside a zero run
DIFF_STAGE = 2       # per sample of a first difference or running sum
SMALL_ENCODES = (        # phase 7's B=512 stereo encodes
    ("20-bit stereo", dict(bit_depth=20)),
    ("32-bit stereo", dict(bit_depth=32)),
    ("16-bit stereo, fast_mode", dict(bit_depth=16, fast_mode=True)),
    ("16-bit stereo, exhaustive search",
     dict(bit_depth=16, search="exhaustive")),
)


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


def max_sm_clock_hz() -> float:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return float(proc.stdout.split()[0]) * 1e6


def sass_loops(lib_path: str) -> dict:
    """{kernel function: [(size, shortest path), ...] of its innermost
    loops, in SASS instructions} from `cuobjdump -sass` of the built
    library.  A loop is the span from a backward branch's target to the
    last branch back to it, innermost when it holds no other; its
    shortest path is the fewest instructions one trip from the top back
    to it can issue (every arm of a branch but the shortest skipped)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump failed: {proc.stderr.strip()[-2000:]}")
    loops = {}
    fn, labels, code, pending = None, {}, [], []

    def close():
        # code: [(addr, text, branch target or None)]
        targets = [(labels.get(t, t), addr, text) for addr, text, t in code
                   if t is not None]
        ends = {}
        for t, addr, _ in targets:
            if isinstance(t, int) and t <= addr:
                ends[t] = max(addr, ends.get(t, addr))
        spans = list(ends.items())
        index = {addr: i for i, (addr, _, _) in enumerate(code)}
        out = []
        for a, b in spans:
            if any((c, d) != (a, b) and a <= c and d <= b for c, d in spans):
                continue
            # breadth-first from the top until a branch back to it
            dist, frontier, best = {a: 1}, [a], None
            while frontier and best is None:
                step = []
                for addr in frontier:
                    _, text, t = code[index[addr]]
                    t = labels.get(t, t)
                    if t == a:
                        best = dist[addr]
                        break
                    stops = not text.startswith("@") and (
                        re.match(r"(EXIT|RET)\b", text)
                        or re.match(r"BRA\s+(`|0x)", text))
                    nxt = [] if stops else [addr + 16]
                    if isinstance(t, int):
                        nxt.append(t)
                    for n in nxt:
                        if n in index and n not in dist:
                            dist[n] = dist[addr] + 1
                            step.append(n)
                frontier = step
            out.append(((b - a) // 16 + 1, best))
        loops[fn] = sorted(out)

    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if fn is not None:
                close()
            fn, labels, code, pending = m.group(1), {}, [], []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and fn is not None:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            text = m.group(2)
            b = re.search(r"\bBRA\b[^;]*?(?:\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                          text)
            code.append((addr, text, None if not b else
                         b.group(1) or int(b.group(2), 16)))
    if fn is not None:
        close()
    return loops


def nbytes(values) -> int:
    import torch
    return sum(v.numel() * v.element_size() for v in values
               if isinstance(v, torch.Tensor))


def work(call, got, counts):
    """(bytes, operations, lane-samples) one kernel call must spend on
    these inputs: each input tensor read once and each output written
    once (a decode reads only the bits its lanes consumed); the
    operations at the counts above, each walk at its lane's own order,
    with the plain version's ``counts`` of coded samples and walk steps
    on the same inputs."""
    import inspect
    import torch
    name, wrapper, _, args, kwargs = call
    outs = got if isinstance(got, tuple) else (got,)
    moved = nbytes(list(args) + list(kwargs.values())) + nbytes(outs)
    if name == "merge":
        return moved, 0, 0
    if name == "pcm":
        return pcm_bytes(wrapper, args, kwargs), 0, nbytes(outs) // 4
    if name == "parse":
        return parse_bytes(wrapper, args, kwargs, outs), 0, args[0].shape[0]
    if name in SEARCHES:
        return search_bytes(wrapper, args, outs), 0, nbytes(outs[:1]) // 4
    if name == "assemble":
        return assemble_bytes(args, outs), 0, nbytes(outs[:1]) // 4
    a = inspect.signature(wrapper).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    x = next(iter(a.values()))
    L = x.shape[0]
    i64 = torch.int64
    from alacjax_torch.ops.tutils import work_total
    coded = work_total(counts, "coded")
    ops = WALK_STEP * work_total(counts, "taps")
    if name in DECODES:
        # lanes may stack on fewer word rows; the cursor's and the raw
        # decode's work is the Rice decode alone
        S = a["num_samples"]
        L = a["start_bits"].shape[0]
        used = (outs[-2].to(i64) - a["start_bits"].to(i64)).clamp(min=0)
        moved += int(used.sum().item()) // 8 - nbytes([x])
        n = (torch.full((L,), S, dtype=i64, device=x.device)
             if a["num"] is None else a["num"].to(i64).clamp(0, S))
        if a.get("skip") is not None:
            n = torch.where(a["skip"], 0, n)
        # the cursor emits only end bits and err: it never unfolds the
        # residual, so its coded samples cost RICE_DECODE less that term
        per = RICE_DECODE - UNFOLD if name == "decode_cursor" else RICE_DECODE
        ops += per * coded + RICE_IDLE * (int(n.sum().item()) - coded)
        if name in ("decode_cursor", "decode_raw"):
            return moved, ops, L * S
        na = a["numactive"].to(i64)
        order = na.clamp(max=a["taps"])
        past = (n - order - 1).clamp(min=0)     # samples past the warm-up
        fir = torch.where((na >= 1) & (na <= 30),
                          past * (FIR_PER_TAP * order + FIR_FIXED),
                          torch.where(na == 31, DIFF_STAGE * n, 0))
        diff = DIFF_STAGE * n[a["mode"] != 0].sum()
        ops += int((fir.sum() + diff).item())
        return moved, ops, L * S
    S = x.shape[1]
    n = S * L if a.get("num") is None else int(a["num"].sum().item())
    if name == "cost":
        machines = 2 if a["dual"] else 1
        orders = a["orders"]
        ops += sum(L * max(S - od - 1, 0) * (FIR_PER_TAP * od + FIR_FIXED)
                   for od in orders)
        ops += len(orders) * (machines - 1) * DIFF_STAGE * n
        machine_samples = len(orders) * machines * n
        ops += RICE_PRICE * coded + RICE_IDLE * (machine_samples - coded)
    elif name == "predict":
        orders = a["order"] if isinstance(a["order"], tuple) else (a["order"],)
        ops += sum(L * max(S - od - 1, 0) * (FIR_PER_TAP * od + FIR_FIXED)
                   for od in orders)
    else:
        per = RICE_EMIT if name == "emit" else RICE_PRICE
        machines = 2 if a.get("dual") else 1
        ops += (per * coded + RICE_IDLE * (machines * n - coded)
                + (machines - 1) * DIFF_STAGE * n)
    return moved, ops, L * S


def pcm_bytes(wrapper, args, kwargs) -> int:
    """The bytes a pcm call must move: per output sample its store (4),
    then on an escape lane its escape sample (depth bits), elsewhere its
    reconstructed sample (4) and shift bits (bs) where the element has
    streams; each per-lane vector once.  The word image counts for the
    bits read, not its width."""
    import inspect
    a = inspect.signature(wrapper).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    B, S, width = a["words"].shape[0], a["num_samples"], a["width"]
    n_esc = int(a["esc"].sum().item()) if a["unescape"] else 0
    stream = 4 + a["bs"] if a["r0"] is not None else 0
    lanes = nbytes([a[k] for k in ("num", "pos_shift", "pos_esc", "esc",
                                   "mixbits", "mixres")])
    return (width * S * (4 * B + stream * (B - n_esc))
            + n_esc * width * S * a["depth"] // 8 + lanes)


def search_bytes(wrapper, args, outs) -> int:
    """The bytes a search call must move.  A mix: each CPE's two channels
    read whole (the trial's reads at every 4th sample touch every 32-byte
    sector), a per-lane mixres once, every output row written once.  A
    pick: every candidate cost and the per-lane chanbits read, the
    winning residual row read and written, the (3, L) selection written."""
    if wrapper.__name__ != "pick":
        lanes = [m for m in (args[2] if wrapper.__name__ == "mix_streams"
                             else ()) if hasattr(m, "shape")]
        return nbytes(list(args[0]) + list(args[1]) + lanes) + nbytes(outs)
    _, cost1, cost2, _, chanbits = args[:5]
    return (nbytes([cost1, cost2, chanbits]) + 2 * nbytes(outs[:1])
            + nbytes(outs[1:]))


def assemble_bytes(args, outs) -> int:
    """The bytes an assemble call must move: every output written once;
    per element and lane, where the lane compressed its channels' Rice
    rows (word and key, 8 bytes a slot) and tails, its shift-byte rows
    to its sample count (4 bytes a sample) and its order's coefficients,
    where it escaped its samples to its sample count (4 bytes each); the
    per-lane fields once."""
    import torch
    from alacjax_torch.oracle.encoder import bytes_shifted_for_depth
    elems, emitted, total_c, cfg, nums = args
    B, S = total_c.shape[0], cfg.frame_length
    bs = bytes_shifted_for_depth(cfg.bit_depth)
    R = 0 if emitted is None else emitted[0].shape[1]
    nl = (torch.full((B,), S, dtype=torch.int64, device=total_c.device)
          if nums is None else nums.to(torch.int64))
    moved = nbytes(outs) + nbytes([total_c, nums])
    for e in elems:
        w = e["width"]
        esc = (torch.ones_like(nl, dtype=torch.bool) if emitted is None
               else e["use_escape"] if e["any_escape"]
               else torch.zeros_like(nl, dtype=torch.bool))
        moved += 4 * w * int(nl[esc].sum().item()) + nbytes([e["start"]])
        if emitted is None:
            continue
        comp = ~esc
        n_comp = int(comp.sum().item())
        moved += n_comp * w * (8 * R + 8)
        if bs:
            moved += 4 * w * int(nl[comp].sum().item())
        orders = sum(o[comp].sum() for o in e["orders"])
        moved += 4 * int(orders.item()) + nbytes(
            [e["mixres"] if w == 2 else None, *e["orders"], *e["modes"],
             e["use_escape"] if e["any_escape"] else None])
    return moved


def parse_bytes(wrapper, args, kwargs, outs) -> int:
    """The bytes a parse call must move: each lane's fields from its start
    to its last channel's last coefficient at max_ord (the header, the mix
    token, each channel's param header and max_ord coefficients), its
    per-lane inputs and every output once."""
    import inspect
    a = inspect.signature(wrapper).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    B = a["words"].shape[0]
    bits = 23 + 16 + a["width"] * 16 * (a["max_ord"] + 1)
    return (B * bits // 8 + nbytes([a["bitpos"], a["num"]])
            + nbytes(outs))


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


def fuzz_tool():
    """tools/torch_fuzz_soak.py beside this script: the repo's jax-free
    writer of legal packets and its differential campaign."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module("torch_fuzz_soak")


def forced_order_packet(cfg, pcm, orders, modes, mixres=2):
    """A legal packet with forced per-channel predictor orders and modes
    at the default knobs (denshift, pb factor, mixbits, bytesShifted 0):
    tools/torch_fuzz_soak.py :: build_packet.  pcm is planar (C, n);
    n < frame_length makes a partial frame."""
    return fuzz_tool().build_packet(cfg, pcm, orders, modes, mixres=mixres)


@contextlib.contextmanager
def recording(calls, keep=None):
    """Wrap every kernel wrapper with a recorder that appends
    (kernel, wrapper, plain version, args, kwargs) to ``calls`` or, with
    ``keep``, what ``keep`` returns for that tuple unless it is None."""
    saved = []
    for mod_name, fn_name, plain_name, key in WRAPPERS:
        mod = importlib.import_module(mod_name)
        wrapper = getattr(mod, fn_name)

        def recorder(*args, _mod=mod, _fn=wrapper, _plain=plain_name,
                     _key=key, **kwargs):
            name = _key or _mod.counter(
                kwargs.get("taps", _mod.fused_decode.TAPS),
                kwargs.get("raw", False))
            # the pcm and mix kernels write into the caller's output: a
            # call is kept without it, so a replay returns a tensor of its
            # own
            kept = {k: v for k, v in kwargs.items()
                    if k not in ("out", "c0", "rows")}
            call = (name, _fn, getattr(_mod, _plain), args, kept)
            call = call if keep is None else keep(call)
            if call is not None:
                calls.append(call)
            return _fn(*args, **kwargs)

        saved.append((mod, fn_name, wrapper))
        setattr(mod, fn_name, recorder)
    try:
        yield calls
    finally:
        for mod, fn_name, wrapper in saved:
            setattr(mod, fn_name, wrapper)


def signature(call):
    """What sets a call apart: the kernel, the sample count, the static
    arguments' values (order, chanbits, dual, taps, ...), which arguments
    are per-lane tensors, and whether each per-lane vector (per-lane
    chanbits, pb, mode, order, denshift and num, a decode's start bits)
    is uniform or mixed.  The width of a decode's word image is left
    out: it sets where the kernel reads, not what it computes, and the
    host API widens it chunk by chunk."""
    import torch
    name, _, _, args, kwargs = call

    def part(v):
        if not isinstance(v, torch.Tensor):
            return v
        if v.dim() == 1 and v.numel():
            return ("lane", "mixed" if bool((v.min() != v.max()).item())
                    else "uniform")
        return ("lane", v.dim())
    if name in SEARCHES:
        return search_signature(call)
    if name == "assemble":
        return assemble_signature(call)
    if name in DECODES:
        head = (name, ("lanes per row", args[1].shape[0] // args[0].shape[0]))
    elif name == "pcm":
        head = (name, ("samples", args[1]))
    elif name == "parse":
        head = (name, ("width", args[4]), ("max_ord", args[7]))
    else:
        head = (name, tuple(args[0].shape[1:]))
    return (head + tuple(map(part, args[1:]))
            + tuple((k, part(v)) for k, v in sorted(kwargs.items())))


def search_signature(call):
    """A search call's signature: the wrapper, the sample count, the
    pairs of a mix and each one's mixres (a value, or per-lane), a pick's
    orders, stages and chanbits (a value, or per-lane uniform or mixed)."""
    name, wrapper, _, args, _ = call
    if wrapper.__name__ == "pick":
        res, _, cost2, orders, cb = args[:5]
        if hasattr(cb, "shape"):
            cb = ("lane", "mixed" if bool((cb.min() != cb.max()).item())
                  else "uniform")
        return (name, "pick", res.shape[2], tuple(orders), cost2 is not None,
                cb)
    if wrapper.__name__ == "mix_trial":
        return (name, "trial", args[0][0].shape[1], len(args[0])) + args[2:]
    return (name, "streams", args[0][0].shape[1],
            tuple("lane" if hasattr(m, "shape") else m for m in args[2]),
            args[3])


def assemble_signature(call):
    """An assemble call's signature: the sample count, the depth, whether
    per-lane sample counts are given and uniform, each element's width
    and form (compressed, with the escape select, or escape only)."""
    _, _, _, args, _ = call
    elems, emitted, _, cfg, nums = args
    if nums is not None:
        nums = "mixed" if bool((nums.min() != nums.max()).item()) \
            else "uniform"
    forms = tuple((e["width"], "escape" if emitted is None
                   else "select" if e["any_escape"] else "compressed")
                  for e in elems)
    return ("assemble", cfg.frame_length, cfg.bit_depth, nums, forms)


def assemble_cut(call, lanes: int):
    """An assemble call on ``lanes`` lanes spread evenly over its lanes
    (each escaping element's escaped lanes first, so a select stays a
    select), every tensor copied: each element's per-lane rows, and each
    channel's block of B rows of the Rice emission."""
    import torch
    name, wrapper, plain, args, kwargs = call
    elems, emitted, total_c, cfg, nums = args
    B = total_c.shape[0]
    dev = total_c.device
    first = []
    for e in elems:
        if emitted is not None and e["any_escape"]:
            first += e["use_escape"].nonzero()[:4, 0].tolist()
    spread = torch.linspace(0, B - 1, min(lanes, B)).round().long().tolist()
    idx = torch.tensor(sorted(set(first + spread))[:lanes], device=dev)

    def cut(v):
        if isinstance(v, (list, tuple)):
            return type(v)(cut(x) for x in v)
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == B:
            return v.index_select(0, idx).contiguous()
        return v
    new = [{k: cut(v) for k, v in e.items()} for e in elems]
    if emitted is not None:
        rows = torch.cat([c * B + idx for c in range(
            sum(e["width"] for e in elems))])
        emitted = tuple(t.index_select(0, rows).contiguous()
                        for t in emitted)
    args = (new, emitted, cut(total_c), cfg, cut(nums))
    return (name, wrapper, plain, args, dict(kwargs))


def search_cut(call, lanes: int):
    """A search call on ``lanes`` lanes spread evenly over its lanes (so
    every stream of a pick keeps some, and a mixed chanbits stays mixed),
    every tensor copied."""
    import torch
    name, wrapper, plain, args, kwargs = call
    pick = wrapper.__name__ == "pick"
    L = args[0].shape[1] if pick else args[0][0].shape[0]
    idx = torch.linspace(0, L - 1, min(lanes, L),
                         device="cpu").round().long().unique()

    def cut(v, axis=0):
        if isinstance(v, (list, tuple)):
            return type(v)(cut(x, axis) for x in v)
        if not hasattr(v, "shape"):
            return v
        return v.index_select(axis, idx.to(v.device)).contiguous()
    if pick:
        res, c1, c2, orders, cb = args[:5]
        args = (cut(res, 1), cut(c1, 1), None if c2 is None else cut(c2, 1),
                orders, cut(cb)) + tuple(args[5:])
    else:
        args = tuple(cut(a) for a in args)
    return (name, wrapper, plain, args, dict(kwargs))


def one_per_signature(calls, seen=None):
    """The first call of each signature not in ``seen`` (updated)."""
    seen = set() if seen is None else seen
    out = []
    for call in calls:
        key = signature(call)
        if key not in seen:
            seen.add(key)
            out.append(call)
    return out


def prefix(call, n: int, lanes: int | None = None):
    """A scan kernel's call cut to its first n samples: the input's
    leading columns (a decode: its sample count; each lane's first n
    samples read the same bits), per-lane sample counts clamped to n.
    Merge calls, and calls already at most n long, keep their samples.
    With ``lanes`` a call of more lanes is also cut to that many (up to
    4 lanes of each value of every per-lane vector but a decode's start
    bits, so a mixed vector stays mixed, then its first lanes; a merge
    call's first rows), and every tensor is copied, so the call outlives
    the buffers it was made on."""
    import numpy as np
    import torch
    name, wrapper, plain, args, kwargs = call
    if name in SEARCHES:
        return (call if lanes is None else search_cut(call, lanes)), \
            lanes is not None
    if name == "assemble":
        return (call if lanes is None else assemble_cut(call, lanes)), \
            lanes is not None
    was_cut = True
    if name in DECODES:
        if args[2] <= n:
            was_cut = False
        else:
            args = tuple(args[:2]) + (n,) + tuple(args[3:])
    elif name not in ("cost", "emit", "predict", "rice_cost") or \
            args[0].shape[1] <= n:
        was_cut = False
    else:
        args = (args[0][:, :n].contiguous(),) + tuple(args[1:])
    if was_cut and kwargs.get("num") is not None:
        kwargs = dict(kwargs, num=torch.clamp(kwargs["num"], max=n))
    if lanes is None:
        return (name, wrapper, plain, args, kwargs), was_cut
    L = args[1].shape[0] if name in DECODES else args[0].shape[0]
    idx = None
    if L > lanes and args[0].shape[0] == L:
        pick = []
        for i, v in enumerate(list(args) + list(kwargs.values())):
            if (isinstance(v, torch.Tensor) and v.dim() == 1
                    and v.shape[0] == L and not (name in DECODES and i == 1)):
                vals = v.cpu().numpy()
                for u in np.unique(vals)[:lanes // 8]:
                    pick.extend(np.nonzero(vals == u)[0][:4].tolist())
        pick = set(pick[:lanes])
        pick.update(i for i in range(lanes * 2) if i not in pick)
        idx = torch.tensor(sorted(pick)[:lanes], device=args[0].device)

    def cut(v):
        if not isinstance(v, torch.Tensor):
            return v
        if idx is not None and v.dim() >= 1 and v.shape[0] == L:
            v = v[idx]
        elif idx is not None and v.dim() == 3 and v.shape[1] == L:
            v = v[:, idx]
        return v.clone().contiguous()
    return ((name, wrapper, plain, tuple(map(cut, args)),
             {k: cut(v) for k, v in kwargs.items()}),
            was_cut or idx is not None)


def describe(name: str, args, kwargs) -> str:
    """A call's static order / chanbits / taps and its per-lane
    arguments, for the phase-3 lines."""
    def v(x):
        return "lane" if hasattr(x, "shape") else x
    parts = []
    if name == "cost":
        parts = [f"orders {args[2]}", f"chanbits {v(args[3])}"]
        if args[1].dim() == 3:
            parts.append("coefs0 per order")
    elif name == "predict":
        parts = [f"order {args[2]}", f"chanbits {v(args[3])}"]
        if args[1].dim() == 3:
            parts.append("coefs0 per order")
    elif name in ("emit", "rice_cost"):
        parts = [f"bit_size {v(args[1])}"]
    elif name == "parse":
        parts = [f"width {args[4]} max_ord {args[7]}",
                 "lane start" if args[1] is not None else "start 0"]
        if args[2] is not None:
            parts.append("num lane")
    elif name == "pcm":
        parts = [f"width {args[2]} bs {args[3]} depth {args[4]}"]
        if len(args) < 10 or args[9] is None:
            parts.append("no streams")
        if kwargs.get("unescape", True):
            parts.append("escape select")
    elif name == "search_mix":
        parts = [f"{len(args[0])} pairs"]
        if len(args) == 5:
            parts.append(f"trial mixres 1..{args[3]} dilate {args[4]}")
        else:
            parts.append("mixres " + ",".join(
                "lane" if hasattr(m, "shape") else str(m) for m in args[2]))
    elif name == "assemble":
        elems, emitted, _, cfg, nums = args
        parts = [f"S {cfg.frame_length} depth {cfg.bit_depth}",
                 "elements " + ",".join(
                     f"{e['width']}{'e' if emitted is None else 's' if e['any_escape'] else ''}"
                     for e in elems)]
        if nums is not None:
            parts.append("num lane")
    elif name == "search_pick":
        parts = [f"orders {tuple(args[3])}",
                 "stages 1,2" if args[2] is not None else "stage 1",
                 f"chanbits {v(args[4])}"]
    elif name in DECODES:
        parts = ([f"taps {kwargs['taps']}"] if name in ("decode", "decode_hi")
                 else [])
        parts.append(f"{'bit_size' if name == 'decode_raw' else 'chanbits'} "
                     f"{v(args[3])}")
        if args[1].shape[0] != args[0].shape[0]:
            parts.append(f"stacked x{args[1].shape[0] // args[0].shape[0]}")
        if kwargs.get("skip") is not None:
            parts.append("skip lane")
    if name == "cost":
        parts.append(f"dual {kwargs.get('dual', True)}")
    if name == "rice_cost" and kwargs.get("dual"):
        parts.append("dual")
    if name in ("cost", "emit", "rice_cost", "decode_cursor") and \
            kwargs.get("num") is not None:
        parts.append("num lane")
    return " ".join(parts)


def against_plain(call, int_ops_per_s: float):
    """(kernel ms, plain ms, max_abs_err, bound ms, bytes ms, operations
    ms, operations per lane-sample) of one call: its kernel timed on the
    card, its plain version once with the work counters on."""
    from alacjax_torch.ops import tutils
    _, wrapper, plain, args, kwargs = call
    got, ms = timed(lambda: wrapper(*args, **kwargs), reps=3)
    tutils.WORK = {}
    want, plain_ms = timed_once(lambda: plain(*args, **kwargs))
    counts, tutils.WORK = tutils.WORK, None
    err = max_abs_err(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,))
    del want
    moved, ops, lane_samples = work(call, got, counts)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / int_ops_per_s * 1e3
    return (ms, plain_ms, err, max(bytes_ms, ops_ms), bytes_ms, ops_ms,
            ops / max(lane_samples, 1))


def host_plain(plain, args, kwargs, got):
    """compare_kernels' host route, in a worker process: the plain version on the
    host against the kernel's outputs ``got``: (max |kernel - plain|, or
    -1 where their shapes differ, and the plain version's ms)."""
    import torch
    t0 = time.perf_counter()
    want = plain(*args, **kwargs)
    ms = (time.perf_counter() - t0) * 1e3
    worst = 0
    for a, b in zip(got, want if isinstance(want, tuple) else (want,),
                    strict=True):
        if a.shape != b.shape:
            return -1, ms
        if a.numel():
            worst = max(worst, int((a.to(torch.int64) - b.to(torch.int64))
                                   .abs().max()))
    return worst, ms


def first_tensor(args):
    """A call's first tensor argument (a mix's first channel, an
    assembly's first channel of samples)."""
    x = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
    return x["chans"][0] if isinstance(x, dict) else x


def compare_kernels(calls, rows, int_ops_per_s: float = 0.0,
                    cut: bool = False, pool=None):
    """Each recorded call through its kernel and through its plain
    version on the same inputs, exactly equal, or the run fails.  Phase
    3: both on the card, beside the call's bound, all summed into
    ``rows``; with ``cut`` a scan call longer than PREFIX samples is
    compared on its first PREFIX; the kernel on the whole input is then
    held to its plain version too, and its time and bound are printed
    beside.  Phase 13 (``pool``, calls already cut by ``prefix``): the
    kernel once on the card and the plain version on the host in the
    pool's workers (``host_plain``); only max_abs_err enters ``rows``,
    since one launch on a cut input times its overhead."""
    import torch

    def host(v):
        if isinstance(v, (list, tuple)):
            return type(v)(map(host, v))
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v.cpu() if isinstance(v, torch.Tensor) else v
    jobs = []
    for call in calls:
        whole = call
        call, was_cut = prefix(call, PREFIX) if cut else (call, False)
        name, wrapper, plain, args, kwargs = call
        if pool is not None:
            got, ms = timed(lambda: wrapper(*args, **kwargs), reps=1)
            got = tuple(map(host, got if isinstance(got, tuple) else (got,)))
            jobs.append((name, args, kwargs, ms, pool.submit(
                host_plain, plain, tuple(map(host, args)),
                {k: host(v) for k, v in kwargs.items()}, got)))
            continue
        ms, plain_ms, err, bound_ms, bytes_ms, ops_ms, per = against_plain(
            call, int_ops_per_s)
        row = rows[name]
        shape = "x".join(str(d) for d in first_tensor(args).shape)
        note = ""
        if was_cut:
            full_ms, _, full_err, full_bound, full_bytes, full_ops, _ = \
                against_plain(whole, int_ops_per_s)
            err = max(err, full_err)
            note = (f"   [first {PREFIX} samples; kernel on the whole "
                    f"{'x'.join(map(str, first_tensor(whole[3]).shape))}: "
                    f"{full_ms:.4f} ms, bound {full_bound:.4f} ms (bytes "
                    f"{full_bytes:.4f}, operations {full_ops:.4f}), "
                    f"max_abs_err {full_err}]")
        print(f"  {name:9s} call {row['calls']} on {shape:12s} "
              f"{describe(name, args, kwargs)}: "
              f"kernel {ms:10.4f} ms   plain {plain_ms:12.3f} ms   "
              f"bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f}: {per:.1f} per lane-sample)   "
              f"max_abs_err {err}{note}",
              flush=True)
        if err != 0:
            fail(f"{name} kernel disagrees with its plain version")
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound_ms
        row["bytes_ms"] += bytes_ms
        row["ops_ms"] += ops_ms
    for name, args, kwargs, ms, job in jobs:
        err, plain_ms = job.result()
        lanes = (args[1].shape[0] if name in DECODES
                 else args[0].shape[1] if name == "search_pick"
                 else first_tensor(args).shape[0])
        print(f"  {name:9s} new signature on {lanes} lanes "
              f"{describe(name, args, kwargs)}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.1f} ms on a host core, max_abs_err {err}",
              flush=True)
        if err:
            fail(f"the {name} kernel disagrees with its plain version"
                 f"{' (shapes differ)' if err < 0 else ''}")
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    return len(calls)


def ragged_emit_call(seed: int = 5):
    """A synthetic emit call whose lanes and steps end mid-tile (L, S =
    RAGGED_EMIT; the kernel's tiles are 32 lanes by 32 steps): per-lane
    bit sizes 17 and 21 under bit_size_cap=21, per-lane num, random
    start phases, an all-zero lane, a lane of 21-bit escapes and lanes
    rich in zero runs."""
    import numpy as np
    import torch
    from alacjax_torch.kernels import emit
    from alacjax_torch.types import KB0, MB0, PB0
    L, S = RAGGED_EMIT
    rng = np.random.default_rng(seed)
    bs = np.where(np.arange(L) % 2 == 0, 17, 21)
    x = rng.integers(-30000, 30000, (L, S))
    x[:, ::3] *= rng.integers(0, 2, (L, 1))
    x[::7] = rng.integers(-2, 3, (len(x[::7]), S))      # zero-run rich
    x[0] = 0
    x[1] = rng.integers(-(1 << 20), 1 << 20, S)          # escapes at 21 bits
    bs[1] = 21
    num = np.where(rng.random(L) < 0.5, S, rng.integers(1, S + 1, L))
    start = rng.integers(0, 4000, L) * 32 + rng.integers(0, 32, L)
    dev = [torch.from_numpy(v.astype(np.int32)).to("cuda")
           for v in (x, bs, start, num)]
    args = (dev[0], dev[1], MB0, PB0, KB0, (1 << KB0) - 1, dev[2])
    return ("emit", emit.rice_encode_words, emit.plain, args,
            dict(bit_size_cap=21, num=dev[3]))


def predict_tile_edges(rows, repo: str):
    """Phase 3: the predictor and Rice cost kernels on the tile-edge
    inputs of tests/torch_predict_cases.py, each call exactly equal to
    its plain version: every order, two to a launch with a block of
    starting coefficients each, and the Rice pass single and dual, with
    and without num."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(repo, "tests"))
    from torch_predict_cases import (
        CASES, ORDER_PAIRS, predict_lanes, rice_lanes,
    )
    from alacjax_torch.kernels import predict as kp
    from alacjax_torch.types import DENSHIFT_DEFAULT, KB0, MB0, PB0
    rice_args = (MB0, PB0, KB0, (1 << KB0) - 1)
    n = dict(predict=0, rice_cost=0)
    for L, S in CASES:
        rng = np.random.default_rng(L * 1000 + S)
        x, cb, c0 = (torch.from_numpy(v).to("cuda")
                     for v in predict_lanes(rng, L, S))
        for pair in ORDER_PAIRS:
            err = max_abs_err(
                kp.pc_block(x, c0, pair, cb, DENSHIFT_DEFAULT),
                kp.plain_pc_block(x, c0, pair, cb, DENSHIFT_DEFAULT))
            rows["predict"]["max_abs_err"] = max(
                rows["predict"]["max_abs_err"], err)
            if err:
                fail(f"predict kernel disagrees with its plain version on "
                     f"the tile-edge case L={L} S={S} orders {pair}")
            n["predict"] += 1
        r, bs, num = (torch.from_numpy(v).to("cuda")
                      for v in rice_lanes(rng, L, S))
        for dual in (False, True):
            for nm in (None, num):
                got = kp.rice_cost(r, bs, *rice_args, num=nm, dual=dual)
                want = kp.plain_rice_cost(r, bs, *rice_args, num=nm,
                                          dual=dual)
                err = max_abs_err((got,), (want,))
                rows["rice_cost"]["max_abs_err"] = max(
                    rows["rice_cost"]["max_abs_err"], err)
                if err:
                    fail(f"rice_cost kernel disagrees with its plain version"
                         f" on the tile-edge case L={L} S={S} dual {dual}")
                n["rice_cost"] += 1
    print(f"  tile edges: {n['predict']} predict calls (L 33 and 67 by S "
          "1, 31, 32, 33, 65 and 100; orders 1..16, two to a launch) and "
          f"{n['rice_cost']} rice_cost calls (single and dual, with and "
          "without num), per-lane chanbits 16..33: max_abs_err 0",
          flush=True)


def walker_cycles(calls, clock_hz: float):
    """Phase 3: each predictor call once more with its walker warps'
    clock64 cycles inside the walk, printed per order as cycles per step
    (mean and most over the warps) and the most times S over the SM
    clock: the per-lane chain, in ms."""
    import torch
    for name, wrapper, _, args, kwargs in calls:
        if name != "predict":
            continue
        x, order = args[0], args[2]
        orders = order if isinstance(order, tuple) else (order,)
        L, S = x.shape
        cyc = torch.zeros((len(orders), -(-L // 32)), dtype=torch.int64,
                          device="cuda")
        wrapper(*args, **kwargs, cycles=cyc)
        per = cyc.double() / S
        for i, od in enumerate(orders):
            worst = per[i].max().item()
            print(f"  walker cycles per step, order {od} on {L}x{S}: mean "
                  f"{per[i].mean().item():.1f}, most {worst:.1f} (x S / "
                  f"clock: {worst * S / clock_hz * 1e3:.4f} ms)", flush=True)


def rice_cycles(calls, clock_hz: float):
    """Phase 3: each decode call (the cursor, the raw decode, the 8-, 16-
    and 30-tap decode) once more with its Rice warps' clock64 cycles
    inside their decode loops (csrc/decode.cu), printed as cycles per
    codeword (a step: one codeword or one sample of a zero run; mean and
    most over the warps) and the most times S over the SM clock: the
    Rice chain, in ms; for a full decode the FIR warps' cycles per step
    beside, and its mean per order mix of a warp's walking lanes
    (tools/torch_rice_ab.py :: order_mix); then the Rice warps' counts
    (kernels.decode.COUNTS), summed over the warps."""
    import torch
    from alacjax_torch.kernels import decode as kd
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    from torch_rice_ab import order_mix
    for name, wrapper, _, args, kwargs in calls:
        if name not in DECODES:
            continue
        L, steps = args[1].shape[0], args[2]
        blocks = -(-L // 32)
        full = name in ("decode", "decode_hi")
        cyc = torch.zeros((kd.cycle_rows(full), blocks), dtype=torch.int64,
                          device="cuda")
        wrapper(*args, **kwargs, cycles=cyc)
        per = cyc.double() / steps
        worst = per[0].max().item()
        counts = cyc[-len(kd.COUNTS):].sum(dim=1).tolist()
        line = (f"  Rice cycles per codeword, {name} on {L} lanes x {steps}"
                f" ({describe(name, args, kwargs)}): mean "
                f"{per[0].mean().item():.1f}, most {worst:.1f} (x S / "
                f"clock: {worst * steps / clock_hz * 1e3:.4f} ms); "
                + ", ".join(f"{k} {v}" for k, v in zip(kd.COUNTS, counts)))
        if full:
            line += (f"; FIR cycles per step: mean {per[1].mean().item():.1f}"
                     f", most {per[1].max().item():.1f}")
            mix = {}
            for key, c in zip(order_mix(args[10], kwargs.get("taps", 8)),
                              per[1].tolist()):
                mix.setdefault(key, []).append(c)
            line += "; by order mix: " + ", ".join(
                f"{k} {len(v)} warps mean {sum(v) / len(v):.1f}"
                for k, v in sorted(mix.items(), key=lambda kv: -len(kv[1])))
        print(line, flush=True)


@contextlib.contextmanager
def path_run(phase: str, counts: dict):
    """Run a path with the launch counts set to 0 just before it and
    read just after; fail if one of its kernels was not launched."""
    import torch
    from alacjax_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    yield
    torch.cuda.synchronize()
    counts[phase] = dict(kernels.LAUNCHES)
    print(f"  launches in the {phase} run: {counts[phase]}")
    missing = [k for k in PATH_KERNELS[phase] if counts[phase][k] < 1]
    if missing:
        fail(f"kernels not launched on the {phase} path: {missing}")


def device_words(codec, packets):
    import numpy as np
    import torch
    from alacjax_torch.ops import bitpack
    wh = bitpack.bytes_to_words(packets, codec.num_words)
    return torch.from_numpy(wh.view(np.int32)).to("cuda")


def main_path(pcm, cfg, codec, counts):
    """Phase 4: the round trip through the host API, then the
    device-resident steady state."""
    import numpy as np
    import torch
    from alacjax_torch import native

    torch.cuda.reset_peak_memory_stats()
    with path_run("phase 4", counts):
        t0 = time.perf_counter()
        packets = codec.encode_frames(pcm)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, nums = codec.decode_frames_ex(packets)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    if codec.fallback_frames:
        fail(f"{codec.fallback_frames} frames flagged by the device decode")
    if not (nums == cfg.frame_length).all() or not np.array_equal(out, pcm):
        fail("round trip is not lossless")
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
    return dict(host_dec_s=dec_s, dev_dec_s=dec_t / iters,
                dev_enc_s=enc_t / iters, packets=packets)


def make_51(cfg):
    """Phase 5's corpus: six channels of bench_torch.py make_music signal (three
    stereo renderings with different noise seeds) scaled to 24 bits with
    a random low byte, every 64th frame partial.  N_DISTINCT_51 frames
    are natively encoded and tiled to B.  Returns (pcm (B, 6, S) int32
    with zeros past each frame's length, packets, nums)."""
    import numpy as np
    from alacjax_torch import native
    n = N_DISTINCT_51
    x = music_51(n)
    nums = np.full((n,), S)
    nums[PARTIAL_EVERY - 1::PARTIAL_EVERY] = 1000 + 37 * np.arange(
        n // PARTIAL_EVERY)
    for i in np.nonzero(nums < S)[0]:
        x[i, :, nums[i]:] = 0
    enc = native.NativeEncoder(cfg, independent_frames=True)
    packets = [enc.encode_packet(x[i][:, :nums[i]]) for i in range(n)]
    reps = B // n
    return np.tile(x, (reps, 1, 1)), packets * reps, np.tile(nums, reps)


def music_51(n: int):
    """(n, 6, S) int32 frames of 24-bit 5.1: three stereo renderings of
    bench_torch.py make_music (noise seeds 7, 8, 9) up 8 bits with a random low
    byte."""
    import numpy as np
    from bench_torch import make_music
    hi = np.concatenate([make_music(n, S, seed=s) for s in (7, 8, 9)], axis=1)
    rng = np.random.default_rng(24)
    return (hi.astype(np.int32) << 8) | rng.integers(0, 256, hi.shape,
                                                     dtype=np.int32)


def layouts_and_depths(codec, pcm, packets, nums, counts):
    """Phase 5: the 24-bit 5.1 decode through the host API, then device
    resident."""
    import numpy as np
    import torch
    from alacjax_torch import native

    cfg = codec.config
    torch.cuda.reset_peak_memory_stats()
    with path_run("phase 5", counts):
        t0 = time.perf_counter()
        out, got_nums = codec.decode_frames_ex(packets)
        dec_s = time.perf_counter() - t0
    if codec.fallback_frames:
        fail(f"phase 5: {codec.fallback_frames} frames went to the oracle")
    if not np.array_equal(got_nums, nums) or not np.array_equal(out, pcm):
        fail("phase 5: the 24-bit 5.1 decode is not lossless")
    nd = native.NativeDecoder(cfg)
    for i in range(N_NATIVE):
        y, got = nd.decode_packet(packets[i])
        if got != nums[i] or not np.array_equal(out[i, :, :got], y):
            fail(f"phase 5: packet {i} differs from the native C++ decoder")
    print(f"  host API: lossless, 0 frames to the oracle, "
          f"{N_NATIVE}/{N_NATIVE} packets equal to the native C++ decoder; "
          f"decode {dec_s} s, {len(packets) / dec_s} frames/s")

    w = device_words(codec, packets)
    x = torch.from_numpy(pcm).to("cuda")
    iters = 3
    dec_t = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec, err, _ = codec._decode(w)
        torch.cuda.synchronize()
        dec_t += time.perf_counter() - t0
        if bool(err.any().item()) or not torch.equal(dec, x):
            fail("phase 5: device-resident decode is not lossless")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  device-resident: decode {dec_t / iters} s per batch of "
          f"{len(packets)}, {len(packets) * iters / dec_t} frames/s, "
          f"peak device memory {peak} GiB")
    return w


def make_hi(cfg):
    """Phase 6's corpus: N_DISTINCT_HI stereo-16 packets of bench.py
    make_music frames with forced orders spread over 9..30 on both
    channels and modes 0 and 15, tiled to B.  Returns (pcm (B, 2, S),
    packets)."""
    import numpy as np
    from bench_torch import make_music
    n = N_DISTINCT_HI
    x = make_music(n, S, seed=30)
    soak = fuzz_tool()
    params = []
    for i in range(n):
        mode = 15 if (i // 22) % 2 else 0
        params.append(soak.Params([9 + i % 22, 9 + (7 * i + 3) % 22],
                                  [mode, mode]))
    with soak.host_pool() as pool:
        packets = soak.build_packets(cfg, list(x), params, pool)
    reps = B // n
    return np.tile(x, (reps, 1, 1)), packets * reps


def retry_ladder(cfg, pcm, packets, counts, main4):
    """Phase 6: the ladder through the host API, then each rung's
    device-resident decode."""
    import numpy as np
    from alacjax_torch import native
    from alacjax_torch import TorchCodec

    codec = TorchCodec(cfg, chunk=B, device="cuda")
    calls = []
    with path_run("phase 6", counts), recording(calls):
        t0 = time.perf_counter()
        out, nums = codec.decode_frames_ex(packets)
        dec_s = time.perf_counter() - t0
    taps = sorted({c[4].get("taps") for c in calls
                   if c[0] in ("decode", "decode_hi")})
    if taps != [8, 16, 30]:
        fail(f"phase 6: the ladder ran taps {taps}, not [8, 16, 30]")
    if codec.fallback_frames:
        fail(f"phase 6: {codec.fallback_frames} frames reached the oracle")
    if not (nums == S).all() or not np.array_equal(out, pcm):
        fail("phase 6: the ladder's decode is not lossless")
    nd = native.NativeDecoder(cfg)
    for i in range(N_DISTINCT_HI):
        y, _ = nd.decode_packet(packets[i])
        if not np.array_equal(out[i::N_DISTINCT_HI], np.broadcast_to(
                y, out[i::N_DISTINCT_HI].shape)):
            fail(f"phase 6: packet {i} differs from the native C++ decoder")
    print(f"  host API: taps {taps}, 0 frames to the oracle, PCM equal to "
          f"the native C++ decoder; ladder decode {dec_s} s "
          f"({len(packets) / dec_s} frames/s) against phase 4's 8-tap "
          f"decode {main4['host_dec_s']} s")
    w = device_words(codec, packets)
    rungs = []
    for t in (8, 16, 30):
        _, ms = timed_once(lambda: codec._decode(w, taps=t))
        rungs.append(f"taps {t} {ms / 1e3} s")
    print(f"  device-resident decode per rung: {', '.join(rungs)}; phase 4's "
          f"8-tap decode {main4['dev_dec_s']} s")
    return w


def device_encode(codec, x, nums=None, iters: int = 3):
    """(words of the last call, mean seconds) of ``iters`` device-resident
    encodes after one warm-up, host clock around synchronised calls."""
    import torch
    codec._encode(x, nums)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        words, _ = codec._encode(x, nums)
    torch.cuda.synchronize()
    return words, (time.perf_counter() - t0) / iters


def encode_layouts(codec51, pcm, packets51, nums, x, n, counts):
    """Phase 7: the 24-bit 5.1 encode with partial frames through the
    host API (against phase 5's native packets), its decode back, the
    device-resident encode of the same PCM (x) and counts (n) already on
    the card; then the small stereo encodes."""
    import numpy as np
    import torch
    from alacjax_torch import native
    from alacjax_torch import AlacConfig, TorchCodec
    from bench_torch import make_music

    torch.cuda.reset_peak_memory_stats()
    with path_run("phase 7", counts):
        t0 = time.perf_counter()
        packets = codec51.encode_frames_ex(pcm, nums)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    bad = [i for i in range(len(pcm)) if packets[i] != packets51[i]]
    if bad:
        fail(f"phase 7: {len(bad)} of {len(pcm)} 5.1 packets differ from the "
             f"native C++ encoder's (first: frame {bad[0]})")
    codec51.fallback_frames = 0
    out, got_nums = codec51.decode_frames_ex(packets)
    if codec51.fallback_frames:
        fail(f"phase 7: {codec51.fallback_frames} frames went to the oracle")
    if not np.array_equal(got_nums, nums) or not np.array_equal(out, pcm):
        fail("phase 7: the 5.1 encode does not round-trip losslessly")
    print(f"  host API: {len(pcm)}/{len(pcm)} packets byte-identical to the "
          f"native C++ encoder, round trip lossless, 0 frames to the "
          f"oracle; encode {enc_s} s, {len(pcm) / enc_s} frames/s")
    words, enc_t = device_encode(codec51, x, n)
    if not torch.equal(words, device_words(codec51, packets)):
        fail("phase 7: device-resident words differ from the host API's")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  device-resident: encode {enc_t} s per batch of {len(pcm)}, "
          f"{len(pcm) / enc_t} frames/s, peak device memory {peak} GiB")
    del words

    for i, (label, kw) in enumerate(SMALL_ENCODES):
        cfg = AlacConfig(num_channels=2, frame_length=S, sample_rate=44100,
                         **kw)
        hi = make_music(N_SMALL, S, seed=40 + i)
        low = cfg.bit_depth - 16
        rng = np.random.default_rng(40 + i)
        xs = ((hi.astype(np.int32) << low)
              | rng.integers(0, 1 << low, hi.shape, dtype=np.int32))
        codec = TorchCodec(cfg, chunk=N_SMALL, device="cuda")
        t0 = time.perf_counter()
        got = codec.encode_frames(xs)
        enc_s = time.perf_counter() - t0
        enc = native.NativeEncoder(cfg, independent_frames=True)
        bad = [j for j, f in enumerate(xs) if enc.encode_packet(f) != got[j]]
        if bad:
            fail(f"phase 7: {label}: {len(bad)} of {N_SMALL} packets differ "
                 f"from the native C++ encoder's (first: frame {bad[0]})")
        print(f"  {label}: {N_SMALL}/{N_SMALL} packets byte-identical to the "
              f"native C++ encoder; host-API encode {enc_s} s (first call "
              f"of this configuration)")


def predict_legacy_route(cfg, pcm, counts, main):
    """Phase 8: phase 4's corpus through the standalone predictor kernel
    and the Rice cost kernel: the same packets, no cost kernel."""
    import torch
    from alacjax_torch import TorchCodec

    codec = TorchCodec(cfg, chunk=B, device="cuda", predict_legacy=True)
    with path_run("phase 8", counts):
        t0 = time.perf_counter()
        packets = codec.encode_frames(pcm)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    if counts["phase 8"]["cost"]:
        fail("phase 8: the cost kernel ran on the predict_legacy route")
    if counts["phase 8"]["rice_cost"] > 3:
        fail(f"phase 8: {counts['phase 8']['rice_cost']} rice_cost launches "
             "for one encode (at most 3: the trial and the search's one "
             "dual call)")
    bad = [i for i in range(len(pcm)) if packets[i] != main["packets"][i]]
    if bad:
        fail(f"phase 8: {len(bad)} packets differ from phase 4's "
             f"(first: frame {bad[0]})")
    x = torch.from_numpy(pcm).to("cuda")
    _, enc_t = device_encode(codec, x)
    print(f"  host API: {len(pcm)}/{len(pcm)} packets equal to phase 4's, "
          f"cost kernel launched 0 times; encode {enc_s} s")
    print(f"  device-resident encode {enc_t} s per batch of {len(pcm)} "
          f"({len(pcm) / enc_t} frames/s) against phase 4's "
          f"{main['dev_enc_s']} s through the cost kernel")
    return codec, x


def pageable_to_device(t, device):
    """The unpipelined loop's copy in: a pageable, blocking ``.to``."""
    return t.to(device)


def blocking_readback(t):
    """The unpipelined loop's copy out: a blocking ``.cpu()``."""
    return t.cpu().numpy()


def unpipelined_encode_host(self, pcm, nums):
    """TorchCodec._encode_host before the pipelining, for phase 9's
    comparison: each chunk to its end (a pageable copy in, the device
    encode, a blocking copy out, then words_to_bytes)."""
    import numpy as np
    import torch
    from alacjax_torch.ops import bitpack
    S = self.config.frame_length
    nf = pcm.shape[0]
    packets = []
    for off in range(0, nf, self.chunk):
        block = np.asarray(pcm[off:off + self.chunk])
        n = block.shape[0]
        pad = self.chunk - n
        if pad:
            block = np.concatenate(
                [block, np.zeros((pad,) + block.shape[1:],
                                 dtype=block.dtype)], axis=0)
        x = pageable_to_device(torch.from_numpy(block.astype(np.int32)),
                               self.device)
        if nums is None:
            words, bits = self._encode(x)
        else:
            nm = np.concatenate([nums[off:off + n],
                                 np.full((pad,), S, np.int32)])
            words, bits = self._encode(
                x, pageable_to_device(torch.from_numpy(nm), self.device))
        packets.extend(bitpack.words_to_bytes(
            blocking_readback(words[:n]), blocking_readback(bits[:n])))
    return packets


def unpipelined_decode_frames_ex(self, packets):
    """TorchCodec.decode_frames_ex before the pipelining, for phase 9's
    comparison: each chunk to its end, then the next."""
    import numpy as np
    import torch
    from alacjax_torch.codec import OracleDecoder
    from alacjax_torch.ops import bitpack, fused_decode
    cfg = self.config
    S = cfg.frame_length
    nf = len(packets)
    out = np.zeros((nf, cfg.num_channels, S), dtype=np.int64)
    nums = np.full((nf,), S, dtype=np.int64)
    for off in range(0, nf, self.chunk):
        blk = packets[off:off + self.chunk]
        n = len(blk)
        padded = list(blk) + [b""] * (self.chunk - n)
        wh = bitpack.bytes_to_words(padded, self.num_words)
        wdev = pageable_to_device(torch.from_numpy(wh.view(np.int32)),
                                  self.device)
        pcm, err, num = self._decode(wdev)
        out[off:off + n] = blocking_readback(pcm[:n])
        nums[off:off + n] = blocking_readback(num[:n])
        err = blocking_readback(err[:n])
        for retry_taps in fused_decode.LADDER_TAPS:
            if err.any() and err.sum() * 4 >= n and n >= 64:
                pcm_r, err_r, num_r = self._decode(wdev, taps=retry_taps)
                fixed = np.nonzero(err & ~err_r[:n].cpu().numpy())[0]
                idx = torch.from_numpy(fixed).to(self.device)
                out[off + fixed] = pcm_r[idx].cpu().numpy()
                nums[off + fixed] = num_r[idx].cpu().numpy()
                err[fixed] = False
        self.fallback_frames += int(err.sum())
        if err.any():
            dec = OracleDecoder(cfg)
            for j in np.nonzero(err)[0]:
                y, got = dec.decode_packet(blk[j])
                out[off + j, :, :got] = y[:, :got]
                out[off + j, :, got:] = 0
                nums[off + j] = got
    return out, nums


# phase 9's host-time split: (category, module or None for this script,
# function); each function is timed wherever the package imported it
SPLIT = (
    ("WAV parse + unpack", "alacjax_torch.containers.wav", "read_wav"),
    ("WAV parse + unpack", "alacjax_torch.containers.pcm", "unpack_pcm"),
    ("host-to-device copies", "alacjax_torch.codec", "TorchCodec._to_device"),
    ("host-to-device copies", None, "pageable_to_device"),
    ("device calls", "alacjax_torch.codec", "TorchCodec._encode"),
    ("device calls", "alacjax_torch.codec", "TorchCodec._decode"),
    ("device-to-host copies queued", "alacjax_torch.codec",
     "TorchCodec._to_host"),
    ("readback waits", "alacjax_torch.codec", "TorchCodec._ready"),
    ("readback waits", None, "blocking_readback"),
    ("words_to_bytes", "alacjax_torch.ops.bitpack", "words_to_bytes"),
    ("bytes_to_words", "alacjax_torch.ops.bitpack", "bytes_to_words"),
    ("container reading", "alacjax_torch.containers.caf", "read_caf"),
    ("container reading", "alacjax_torch.containers.mp4", "read_m4a"),
    ("container writing", "alacjax_torch.containers.caf", "write_caf"),
    ("container writing", "alacjax_torch.containers.mp4", "write_m4a"),
    ("container writing", "alacjax_torch.containers.wav", "write_wav"),
    ("container writing", "alacjax_torch.containers.pcm", "pack_pcm"),
)
HOST_API = ("encode_frames", "encode_frames_ex", "decode_frames_ex")


class HostSplit:
    """Phase 9's host clock: SPLIT's functions timed into the current
    run's ``split`` (seconds per category) and TorchCodec's host API
    into its ``api`` (seconds, frames).  The wrappers go in once, around
    every run, and each run only switches the dicts they write to, so no
    run's time can land in another's.  A call made inside another timed
    call is not timed again (counted in ``nested``), so the categories
    never sum past the wall.  A device call's time is its enqueue plus
    the waits inside it (the flag readbacks), not the card's busy time.
    With ``run(..., unpipelined=True)`` the host API runs the loops it
    had before the pipelining."""

    def __init__(self):
        self.saved = []
        self.target = None      # (split, api) of the run in progress
        self.unpipelined = False
        self.busy = False
        self.nested = 0
        self.missed = []        # copies of a timed function left untimed

    def _swap(self, owner, name, new):
        self.saved.append((owner, name, vars(owner)[name]))  # staticmethods too
        setattr(owner, name, new)

    def _timed(self, fn, key):
        def wrapped(*args, **kwargs):
            if self.target is None or self.busy:
                self.nested += self.target is not None
                return fn(*args, **kwargs)
            split = self.target[0]
            self.busy = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.busy = False
                split[key] = split.get(key, 0.0) + time.perf_counter() - t0
        return wrapped

    def _api(self, fn):
        def wrapped(codec, frames, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(codec, frames, *args, **kwargs)
            finally:
                if self.target is not None:
                    api = self.target[1]
                    api["seconds"] = (api.get("seconds", 0.0)
                                      + time.perf_counter() - t0)
                    api["frames"] = api.get("frames", 0) + len(frames)
        return wrapped

    def __enter__(self):
        from alacjax_torch.codec import TorchCodec
        # a module imported after this would keep a wrapper past the phase:
        # import every module that takes these functions by name first
        for name in ("batch", "checkpoint", "cli", "convert", "reader"):
            importlib.import_module(f"alacjax_torch.{name}")
        for key, mod_name, qual in SPLIT:
            if mod_name is None:
                me = sys.modules[__name__]
                self._swap(me, qual, self._timed(getattr(me, qual), key))
                continue
            mod = importlib.import_module(mod_name)
            if "." in qual:
                cls, name = qual.split(".")
                owner = getattr(mod, cls)
                fn = owner.__dict__[name]
                if isinstance(fn, staticmethod):
                    self._swap(owner, name,
                               staticmethod(self._timed(fn.__func__, key)))
                else:
                    self._swap(owner, name, self._timed(fn, key))
                continue
            fn = getattr(mod, qual)
            wrapped = self._timed(fn, key)
            for m in list(sys.modules.values()):
                if not getattr(m, "__name__", "").startswith("alacjax_torch"):
                    continue
                held = getattr(m, qual, None)
                if held is fn:
                    self._swap(m, qual, wrapped)
                elif (getattr(held, "__module__", None),
                      getattr(held, "__qualname__", None)) == (
                          fn.__module__, fn.__qualname__):
                    self.missed.append(f"{m.__name__}.{qual}")
        loops = {"_encode_host": unpipelined_encode_host,
                 "decode_frames_ex": unpipelined_decode_frames_ex}
        for name, old in loops.items():
            own = getattr(TorchCodec, name)
            self._swap(TorchCodec, name,
                       lambda *a, _own=own, _old=old:
                       (_old if self.unpipelined else _own)(*a))
        for name in HOST_API:
            self._swap(TorchCodec, name, self._api(getattr(TorchCodec, name)))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved.clear()

    @contextlib.contextmanager
    def run(self, split: dict, api: dict, unpipelined: bool = False):
        self.target, self.unpipelined = (split, api), unpipelined
        try:
            yield
        finally:
            self.target, self.unpipelined = None, False


def write_album(d: str):
    """Phase 9's album: ALBUM_TRACKS stereo-16 WAVs of make_music (noise
    seed 100 + track) and one 24-bit 5.1 WAV of music_51, in ``d``.
    Returns ([stereo paths], 5.1 path, [planar PCM of each])."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from alacjax_torch.containers.pcm import pack_pcm
    from alacjax_torch.containers.wav import WavFile, write_wav
    from bench_torch import make_music
    paths, pcms = [], []
    n = TRACK_SECONDS * 44100
    with ThreadPoolExecutor(os.cpu_count()) as pool:   # numpy frees the GIL
        music = list(pool.map(lambda i: make_music(-(-n // S), S,
                                                   seed=100 + i),
                              range(ALBUM_TRACKS)))
    for i, x in enumerate(music):
        pcm = np.transpose(x, (1, 0, 2)).reshape(2, -1)[:, :n]
        paths.append(os.path.join(d, f"track{i:02d}.wav"))
        write_wav(WavFile(44100, 16, 2, pack_pcm(pcm, 16)), paths[-1])
        pcms.append(pcm)
    n = SURROUND_SECONDS * 48000
    x = music_51(-(-n // S))
    pcm = np.transpose(x, (1, 0, 2)).reshape(6, -1)[:, :n]
    path51 = os.path.join(d, "surround51.wav")
    write_wav(WavFile(48000, 24, 6, pack_pcm(pcm, 24)), path51)
    pcms.append(pcm)
    return paths, path51, pcms


def convert_album(paths, path51, out: str, timing: HostSplit, split: dict,
                  api: dict, unpipelined: bool = False, extra=()):
    """Phase 9's three CLI calls into ``out``, timed by ``timing`` into
    ``split`` and ``api`` (``extra``: more CLI arguments); returns ([(step, wall s, frames through the codec)],
    M4A paths, CAF path, decode directory)."""
    from alacjax_torch.cli import main as cli
    n_frames = [-(-TRACK_SECONDS * 44100 // S)] * len(paths)
    n51 = -(-SURROUND_SECONDS * 48000 // S)
    enc, dec = os.path.join(out, "enc"), os.path.join(out, "dec")
    out51 = os.path.join(out, "surround51.caf")
    m4as = [os.path.join(enc, os.path.basename(p)[:-4] + ".m4a")
            for p in paths]
    steps = []
    for label, argv, frames in (
            ("1: album -> M4A, batch, --check",
             paths + ["--outdir", enc, "--to", "m4a", "--check"],
             2 * sum(n_frames)),
            ("2: 5.1 -> CAF, --check", [path51, out51, "--check"], 2 * n51),
            ("3: M4As + CAF -> WAV, batch", m4as + [out51, "--outdir", dec],
             sum(n_frames) + n51)):
        os.makedirs(out, exist_ok=True)
        with timing.run(split, api, unpipelined):
            t0 = time.perf_counter()
            rc = cli(argv + list(extra))
            wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"phase 9: step {label} exited {rc}")
        steps.append((label, wall, frames))
    return steps, m4as, out51, dec


def print_split(title: str, steps, split: dict, api: dict) -> float:
    wall = sum(w for _, w, _ in steps)
    for label, w, frames in steps:
        print(f"  {title} step {label}: wall {w} s, {frames} frames through "
              f"the codec, {frames / w} frames/s")
    other = wall - sum(split.values())
    parts = ", ".join(f"{k} {v} s" for k, v in split.items())
    print(f"  {title} host split over {wall} s: {parts}, other "
          f"(python, checks, the oracle) {other} s")
    rate = api["frames"] / api["seconds"]
    print(f"  {title} host API (encode_frames/_ex, decode_frames_ex): "
          f"{api['frames']} frames in {api['seconds']} s, {rate} frames/s")
    return rate


def converter(counts, card: str, kind: str, device: str = "cuda"):
    """Phase 9: the album through the CLI twice: with the pipelined host
    API (the run whose launches are counted and whose packets are
    checked), then with the unpipelined loop it replaced.  ``device``
    other than cuda is for rehearsals."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from alacjax_torch import AlacConfig, AlacReader, codec as tcodec
    from alacjax_torch import native
    from alacjax_torch.containers.caf import read_caf
    from alacjax_torch.containers.mp4 import read_m4a
    from alacjax_torch.containers.wav import read_wav

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_album_")
    try:
        t0 = time.perf_counter()
        paths, path51, pcms = write_album(d)
        wav_mb = sum(os.path.getsize(p) for p in paths + [path51]) / 1e6
        print(f"  album written in {time.perf_counter() - t0} s: "
              f"{len(paths)} stereo-16 tracks of {TRACK_SECONDS} s and one "
              f"24-bit 5.1 track of {SURROUND_SECONDS} s, {wav_mb} MB of WAV",
              flush=True)
        sources = {p: read_wav(p).data for p in paths + [path51]}
        tcodec._CODEC_CACHE.clear()
        extra = () if device == "cuda" else ("--device", device)
        runs = []       # (title, steps, split, api) in the order they ran
        with HostSplit() as timing:
            for title, unpiped in (("pipelined", False),
                                   ("unpipelined", True)):
                split, api = {}, {}
                out = os.path.join(d, f"run{len(runs)}")
                with (path_run("phase 9", counts) if not runs
                      else contextlib.nullcontext()):
                    steps, m4as, out51, dec = convert_album(
                        paths, path51, out, timing, split, api,
                        unpipelined=unpiped, extra=extra)
                for src, data in sources.items():
                    got = read_wav(os.path.join(dec, os.path.basename(src)))
                    if got.data != data:
                        fail(f"phase 9: {title}: {os.path.basename(src)} "
                             "is not lossless")
                runs.append((title, steps, split, api))
                if runs[1:]:
                    shutil.rmtree(out)
                else:
                    first = (m4as, out51)
        print(f"  host split: {timing.nested} timed calls made inside "
              "another timed call, counted once; copies left untimed: "
              f"{timing.missed or 'none'}")
        m4as, out51 = first
        bad = [c for c in tcodec._CODEC_CACHE.values() if c.fallback_frames]
        if bad:
            fail(f"phase 9: {sum(c.fallback_frames for c in bad)} frames "
                 "went to the oracle")
        cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                         sample_rate=44100)
        cfg51 = AlacConfig(bit_depth=24, num_channels=6, frame_length=S,
                           sample_rate=48000)
        held = 0
        for i, (pcm, c, blob) in enumerate(
                [(pcms[i], cfg, read_m4a(m4as[i])) for i in range(len(paths))]
                + [(pcms[-1], cfg51, read_caf(out51))]):
            whole = i in (0, len(paths))
            n_pk = len(blob.packets) if whole else N_ALBUM_NATIVE
            enc = native.NativeEncoder(c, independent_frames=True)
            for k in range(n_pk):
                if enc.encode_packet(pcm[:, k * S:(k + 1) * S]) != \
                        blob.packets[k]:
                    fail(f"phase 9: track {i} packet {k} differs from the "
                         "native C++ encoder's")
            held += n_pk
        rng = np.random.default_rng(9)
        start = int(rng.integers(0, pcms[3].shape[1] - 10 * S))
        count = int(rng.integers(1, 10 * S))
        reader = AlacReader(m4as[3], backend="torch", device=device)
        if not np.array_equal(reader.read(start, count),
                              pcms[3][:, start:start + count]):
            fail("phase 9: AlacReader's range read differs from the source")
        print(f"  lossless on all {len(pcms)} tracks, {held} packets "
              f"byte-identical to the native C++ encoder (tracks 0 and 5.1 "
              f"whole, the first {N_ALBUM_NATIVE} of the others), "
              f"AlacReader samples [{start}, {start + count}) of track 3 "
              f"equal to the source, 0 frames to the oracle")
        rates = [(title, print_split(title, steps, split, api),
                  sum(w for _, w, _ in steps))
                 for title, steps, split, api in runs]
        print(f"  host API frames/s and wall s on {kind} ({card}): "
              + "; ".join(f"{t} {r} frames/s, {w} s" for t, r, w in rates))
    finally:
        shutil.rmtree(d, ignore_errors=True)
        tcodec._CODEC_CACHE.clear()
        torch.cuda.empty_cache()
    print(f"  phase 9 took {time.perf_counter() - t_phase} s")


def stream_corpus(n_streams: int, n_packets: int, seed: int = 11):
    """(n_streams, n_packets, 2, S) int32: bench_torch.py make_music cut into
    consecutive frames, stream b holding frames b * n_packets onwards of
    one continuous signal."""
    from bench_torch import make_music
    return make_music(n_streams * n_packets, S, seed=seed).reshape(
        n_streams, n_packets, 2, S)


def bank_step(cfg, xs):
    """Packet 2 of every stream of xs ((B, N, C, S) on the card), its
    banks carried from packet 1 (run here): the call phase 3 records for
    the per-order cost signature.  Packet 1 starts every bank from the
    fresh coefficients, so it could not show a bank indexed wrongly."""
    from alacjax_torch.codec import _encode_packet_chunks, _num_words
    from alacjax_torch.oracle.encoder import SEARCH_ORDERS
    from alacjax_torch.state import init_coefs_batched
    init = init_coefs_batched(xs.shape[0], xs.device)
    banks = {ch: {od: init for od in SEARCH_ORDERS}
             for ch in range(cfg.num_channels)}
    nw = _num_words(cfg)
    _, _, banks = _encode_packet_chunks(xs[:, 0].contiguous(), cfg, nw,
                                        banks=banks)
    return lambda: _encode_packet_chunks(xs[:, 1].contiguous(), cfg, nw,
                                         banks=banks)


def stream_packets(words, bits):
    """(B, N, W) words and (B, N) bits on the card -> the B * N packets,
    stream by stream."""
    from alacjax_torch.ops import bitpack
    return bitpack.words_to_bytes(
        words.reshape(-1, words.shape[-1]).cpu().numpy(),
        bits.reshape(-1).cpu().numpy())


def hold_streams_to_native(cfg, pcm, packets, n_streams: int, label: str):
    """The first n_streams streams' packets against the stateful native
    C++ encoder (persistent coefficient banks), packet by packet."""
    from alacjax_torch import native
    n = pcm.shape[1]
    for b in range(n_streams):
        enc = native.NativeEncoder(cfg)
        for k in range(n):
            if enc.encode_packet(pcm[b, k]) != packets[b * n + k]:
                fail(f"phase 10: {label}: stream {b} packet {k} differs "
                     "from the stateful native C++ encoder's")
    return n_streams * n


def streams(cfg, cfg51, codec, codec51, pcm, counts, main4,
            device: str = "cuda"):
    """Phase 10: B stereo-16 streams of N_STREAM packets (pcm, the
    (B, N, 2, S) stream corpus) and N51_STREAMS 24-bit 5.1 streams of
    N51 packets through encode_stream_device on the card, every packet
    decoded back through the host API.  ``device`` other than cuda is
    for rehearsals."""
    import numpy as np
    import torch
    from alacjax_torch.codec import encode_stream_device

    x = torch.from_numpy(pcm).to(device)
    n_streams = pcm.shape[0]
    pcm51 = music_51(N51_STREAMS * N51).reshape(N51_STREAMS, N51, 6, S)
    x51 = torch.from_numpy(pcm51).to(device)
    torch.cuda.reset_peak_memory_stats()
    with path_run("phase 10", counts):
        t0 = time.perf_counter()
        words, bits, _ = encode_stream_device(x, cfg, codec.num_words)
        packets = stream_packets(words, bits)
        enc_s = time.perf_counter() - t0
        del words, bits
        t0 = time.perf_counter()
        out, nums = codec.decode_frames_ex(packets)
        dec_s = time.perf_counter() - t0
        packets51 = stream_packets(*encode_stream_device(
            x51, cfg51, codec51.num_words)[:2])
        out51, nums51 = codec51.decode_frames_ex(packets51)
    n_pk = len(packets)
    if codec.fallback_frames or codec51.fallback_frames:
        fail(f"phase 10: {codec.fallback_frames + codec51.fallback_frames} "
             "frames went to the oracle")
    if not (nums == S).all() or not np.array_equal(
            out, pcm.reshape(-1, 2, S)):
        fail("phase 10: the stereo-16 streams do not decode losslessly")
    if not (nums51 == S).all() or not np.array_equal(
            out51, pcm51.reshape(-1, 6, S)):
        fail("phase 10: the 5.1 streams do not decode losslessly")
    del out, out51
    held = hold_streams_to_native(cfg, pcm, packets, N_NATIVE_STREAMS,
                                  "stereo-16")
    held51 = hold_streams_to_native(cfg51, pcm51, packets51, N_NATIVE_51,
                                    "24-bit 5.1")
    indep = codec.encode_frames(pcm[:N_NATIVE_STREAMS].reshape(-1, 2, S))
    differ = sum(a != b for a, b in zip(packets, indep))
    if not differ:
        fail("phase 10: every stream packet equals the independent-frames "
             "packet: the banks were not used")
    escapes = sum(bool(p[2] & 0x02) for p in packets)
    print(f"  {n_pk} stereo-16 packets ({n_streams} streams x "
          f"{pcm.shape[1]}) and {len(packets51)} 24-bit 5.1 packets "
          f"({N51_STREAMS} x {N51}) decode losslessly, 0 frames to the "
          f"oracle; {held} stereo and {held51} 5.1 packets byte-identical "
          f"to the stateful native C++ encoder; {differ} of the first "
          f"{len(indep)} differ from the independent-frames encode; "
          f"{escapes} stereo packets escaped")
    print(f"  host API: stream encode + serialization {enc_s} s, "
          f"decode_frames_ex {dec_s} s")
    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        encode_stream_device(x, cfg, codec.num_words)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters / pcm.shape[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  device-resident stream encode: {step_s * 1e3} ms per packet "
          f"step of {n_streams} streams, {n_streams / step_s} frames/s, "
          f"against phase 4's independent-frames encode "
          f"{main4['dev_enc_s'] * 1e3} ms per batch of {B} "
          f"({B / main4['dev_enc_s']} frames/s); peak device memory "
          f"{peak} GiB")
    profile(lambda: encode_stream_device(x, cfg, codec.num_words),
            "profile_streams.txt")


def sharded(cfg, pcm, codec, counts, main4, device: str = "cuda"):
    """Phase 11: phase 4's batch through ShardedCodec over every visible
    card (a single card listed twice), against the unsplit codec.
    ``device`` other than cuda is for rehearsals."""
    import numpy as np
    import torch
    from alacjax_torch import ShardedCodec

    n = torch.cuda.device_count() if device == "cuda" else 1
    devices = ([torch.device(device, i) for i in range(n)] if n > 1
               else [torch.device(device)] * 2)
    split = ShardedCodec(cfg, devices, chunk=len(pcm))
    print(f"  devices: {[str(d) for d in split.devices]}"
          + ("" if n > 1 else " (one card, listed twice)"), flush=True)
    x = torch.from_numpy(pcm).to(device)
    want_w, want_b = codec._encode(x)
    with path_run("phase 11", counts):
        words, bits = split._encode(x)
        dec, err, num = split._decode(words)
        packets = split.encode_frames(pcm)
        out, nums = split.decode_frames_ex(packets)
        rt = split.roundtrip_step(x)
    if not (torch.equal(words, want_w) and torch.equal(bits, want_b)):
        fail("phase 11: the split encode's words differ from the unsplit "
             "codec's")
    if bool(err.any().item()) or not torch.equal(dec, x) or \
            not bool((num == S).all().item()):
        fail("phase 11: the split decode is not lossless")
    if packets != main4["packets"]:
        fail("phase 11: the split host API's packets differ from phase 4's")
    if split.fallback_frames or not (nums == S).all() or \
            not np.array_equal(out, pcm):
        fail("phase 11: the split host API's decode is not lossless")
    decoded, rw, _, total, mismatch, rerr = rt
    n_bytes = sum(map(len, packets))
    if int(mismatch.item()) or bool(rerr.any().item()) or \
            not torch.equal(decoded, x) or not torch.equal(rw, want_w) or \
            int(total.item()) != n_bytes:
        fail(f"phase 11: roundtrip_step: mismatch {int(mismatch.item())}, "
             f"total_bytes {int(total.item())} against {n_bytes}")
    del dec, out, rt, decoded, rw
    times = {}
    for label, c in (("unsplit", codec), ("split", split), ("split", split),
                     ("unsplit", codec)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, _ = c._encode(x)
        c._decode(w)
        torch.cuda.synchronize()
        times.setdefault(label, []).append(time.perf_counter() - t0)
    print(f"  split words and bits equal the unsplit codec's, its decode "
          f"and the host API's are lossless ({len(packets)} packets equal "
          f"to phase 4's), roundtrip_step mismatch 0 and total_bytes "
          f"{n_bytes} = the packets' bytes")
    print("  device-resident enc+dec s per batch (unsplit, split, split, "
          f"unsplit): {times['unsplit'][0]}, {times['split'][0]}, "
          f"{times['split'][1]}, {times['unsplit'][1]}")


def merge_library(calls):
    """Phase 3: per merge signature, torch.Tensor.scatter_ (one PyTorch
    call computing merge's compaction half: the (B, T) words into a
    (B, W + 1) image, empty keys sent to the spare last column) beside
    the merge kernel's scatter alone (csrc/merge.cu's merge_scatter: the
    kernel entry with no tails) and the whole merge, on the same inputs.
    Returns {B x T: (scatter_ ms, merge_scatter ms, merge ms)}."""
    import torch
    from alacjax_torch.kernels import launch
    out = {}
    for name, wrapper, _, args, kwargs in one_per_signature(calls):
        if name != "merge":
            continue
        vals, keys, tv, tk, W = args
        Bm, T = vals.shape
        idx = torch.where((keys >= 0) & (keys < W), keys, W).to(torch.int64)
        image = torch.zeros((Bm, W + 1), dtype=torch.int32, device="cuda")
        _, lib_ms = timed(lambda: image.scatter_(1, idx, vals), reps=5)
        if not torch.equal(image[:, :W], wrapper(vals, keys, tv[:, :0],
                                                 tk[:, :0], W)):
            fail("scatter_ disagrees with the merge kernel's compaction")
        dense = torch.zeros((Bm, W), dtype=torch.int32, device="cuda")
        _, scatter_ms = timed(lambda: launch(
            "alac_merge", vals, vals.data_ptr(), keys.data_ptr(),
            tv.data_ptr(), tk.data_ptr(), dense.data_ptr(), Bm, T, 0, W),
            reps=5)
        _, merge_ms = timed(lambda: wrapper(*args, **kwargs), reps=5)
        key = f"{Bm}x{T}"
        out[key] = (lib_ms, scatter_ms, merge_ms)
        print(f"  merge on {key} -> {Bm}x{W}: torch scatter_ {lib_ms:.4f} ms "
              f"(compaction only), merge_scatter alone {scatter_ms:.4f} ms, "
              f"whole merge kernel {merge_ms:.4f} ms (zeroed image and "
              "tails included)", flush=True)
    return out


def chanbits33_cases(rows, repo: str):
    """Phase 3: the cost kernel (search and trial) and every decode
    instance (8, 16 and 30 taps, the cursor, the raw decode; lanes one
    to a row and two to a row) at per-lane chanbits 16..33 on the
    synthetic inputs of tests/torch_predict_cases.py and
    tests/torch_decode_cases.py, each exactly equal to its plain
    version.  33 is one past a 32-bit channel: every sign extension at
    that width gives 0 (csrc/common.cuh :: sext_sh)."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(repo, "tests"))
    from torch_decode_cases import RICE, decode_lanes
    from torch_predict_cases import predict_lanes
    from alacjax_torch.kernels import cost as kc
    from alacjax_torch.kernels import decode as kd
    from alacjax_torch.types import DENSHIFT_DEFAULT, KB0, MB0, PB0

    def hold(name, got, want, what):
        err = max_abs_err(got, want)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        if err:
            fail(f"{name} kernel disagrees with its plain version at "
                 f"chanbits 16..33: {what}")

    n = 0
    mb0, kb, wb = RICE
    for L, Sc in ((66, 100), (4096, 256)):
        x, cb, c0 = (torch.from_numpy(v).to("cuda") for v in predict_lanes(
            np.random.default_rng(L + 33), L, Sc, n_orders=1))
        for orders, dual in (((4, 8), True), ((8,), False)):
            args = (x, c0[0], orders, cb, DENSHIFT_DEFAULT, MB0, PB0, KB0,
                    (1 << KB0) - 1)
            hold("cost", kc.pc_block_cost2(*args, dual=dual),
                 kc.plain(*args, dual=dual), f"L={L} S={Sc} orders {orders}")
            n += 1
        for rows_n in (L, L // 2):
            words, lane = decode_lanes(np.random.default_rng(L + rows_n), L,
                                       Sc, rows_n)
            w = torch.from_numpy(words.view(np.int32)).to("cuda")
            t = {k: torch.from_numpy(v).to("cuda") for k, v in lane.items()}
            head = (w, t["start"], Sc, t["cb"], mb0, t["pb"], kb, wb)
            what = f"L={L} on {rows_n} rows S={Sc}"
            for taps in (8, 16, 30):
                args = head + (t["coefs"][:, :taps].contiguous(), t["mode"],
                               t["order"], t["den"])
                kw = dict(num=t["num"], taps=taps, chanbits_max=33)
                hold(kd.counter(taps), kd.decode_channel(*args, **kw),
                     kd.plain(*args, **kw), f"{what} taps {taps}")
            kw = dict(chanbits_max=33, skip=t["skip"], num=t["num"])
            hold("decode_cursor", kd.cursor_scan(*head, **kw),
                 kd.plain_cursor(*head, **kw), what)
            args = head + (None,) * 4
            kw = dict(num=t["num"], chanbits_max=33, raw=True)
            hold("decode_raw", kd.decode_channel(*args, **kw),
                 kd.plain(*args, **kw), what)
            n += 5
    print(f"  chanbits 16..33 (33 included): {n} calls of the cost kernel "
          "(search and trial) and of the decode, cursor and raw instances "
          "(lanes one and two to a word row), L 66 and 4096: max_abs_err 0",
          flush=True)


def window_cases(rows, repo: str):
    """Phase 3: every decode instance (8, 16 and 30 taps, the cursor, the
    raw decode) on the staged window's edges (tests/torch_decode_cases.py
    :: window_lanes: start bits at every residue mod 32, near the row's
    end and the refill boundaries, streams past the row's last word,
    escapes at chanbits 32 and 33 with a zero-run codeword right behind,
    row widths 0..3 mod 4, lanes stacked on fewer rows) with the usual
    starting mean and with MB0_JUMP (zero runs millions of bits long),
    each exactly equal to its plain version."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(repo, "tests"))
    from torch_decode_cases import MB0_JUMP, RICE, window_lanes
    from alacjax_torch.kernels import decode as kd
    n = 0
    _, kb, wb = RICE
    for tail, L, Sc, rows_n in WINDOW_CASES:
        words, lane = window_lanes(np.random.default_rng(1000 * tail + L + Sc),
                                   L, Sc, rows_n, tail)
        w = torch.from_numpy(words.view(np.int32)).to("cuda")
        t = {k: torch.from_numpy(v).to("cuda") for k, v in lane.items()}
        for mb0 in (RICE[0], MB0_JUMP):
            head = (w, t["start"], Sc, t["cb"], mb0, t["pb"], kb, wb)
            what = (f"window L={L} on {rows_n or L} rows, W % 4 = {tail}, "
                    f"S={Sc}, mb0={mb0}")
            calls = [("decode_cursor", kd.cursor_scan, kd.plain_cursor, head,
                      dict(chanbits_max=33, skip=t["skip"], num=t["num"])),
                     ("decode_raw", kd.decode_channel, kd.plain,
                      head + (None,) * 4,
                      dict(num=t["num"], chanbits_max=33, raw=True))]
            pred = (t["coefs"], t["mode"], t["order"], t["den"])
            calls += [(kd.counter(taps), kd.decode_channel, kd.plain,
                       head + pred, dict(num=t["num"], taps=taps,
                                         chanbits_max=33))
                      for taps in (8, 16, 30)]
            for name, wrapper, plain, args, kw in calls:
                err = max_abs_err(wrapper(*args, **kw), plain(*args, **kw))
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                err)
                if err:
                    fail(f"{name} kernel disagrees with its plain version on "
                         f"the {what}")
                n += 1
    print(f"  staged-window edges: {n} calls of the decode, cursor and raw "
          f"instances on {len(WINDOW_CASES)} window_lanes cases x 2 "
          "starting means: max_abs_err 0", flush=True)


def fir_cases(rows, repo: str):
    """Phase 3: the 8-, 16- and 30-tap decode on tests/torch_decode_cases
    .py :: fir_lanes (the FIR walk's stops at every tap, one-order and
    mixed warps, every denshift, coefficients at the 16-bit limits,
    wrapping samples, counts inside the warm-up), each exactly equal to
    its plain version."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(repo, "tests"))
    from torch_decode_cases import RICE, fir_lanes
    from alacjax_torch.kernels import decode as kd
    mb0, kb, wb = RICE
    n = 0
    for L, Sc in FIR_CASES:
        for taps in (8, 16, 30):
            words, lane = fir_lanes(np.random.default_rng(taps), L, Sc, taps)
            w = torch.from_numpy(words.view(np.int32)).to("cuda")
            t = {k: torch.from_numpy(v).to("cuda") for k, v in lane.items()}
            args = (w, t["start"], Sc, t["cb"], mb0, t["pb"], kb, wb,
                    t["coefs"], t["mode"], t["order"], t["den"])
            for num in (t["num"], None):
                kw = dict(num=num, taps=taps, chanbits_max=33)
                name = kd.counter(taps)
                err = max_abs_err(kd.decode_channel(*args, **kw),
                                  kd.plain(*args, **kw))
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                err)
                if err:
                    fail(f"{name} kernel disagrees with its plain version on "
                         f"fir_lanes L={L} S={Sc} taps={taps} "
                         f"num={'per lane' if num is not None else 'S'}")
                n += 1
    print(f"  FIR walk: {n} calls of the 8-, 16- and 30-tap decode on "
          f"fir_lanes {FIR_CASES}, with and without num: max_abs_err 0",
          flush=True)


def raw_drive(codec, words):
    """alacjax_torch.ops.rice.rice_decode of every frame's first channel:
    its Rice start and parameter from decode_frames_device's "params"
    cut.  Returns (the rice_decode result, the start bits, pb,
    chanbits)."""
    import torch
    from alacjax_torch.codec import decode_frames_device
    from alacjax_torch.oracle.encoder import bytes_shifted_for_depth
    from alacjax_torch.ops import rice
    cfg = codec.config
    params, (start, _) = decode_frames_device(words, cfg, cfg.frame_length,
                                              stop_at="params")
    pb = ((cfg.pb * params[0][2]) // 4).to(torch.int32)
    chanbits = (cfg.bit_depth - 8 * bytes_shifted_for_depth(cfg.bit_depth)
                + (1 if cfg.elements[0][1] == 2 else 0))
    start = start.to(torch.int32)
    return (rice.rice_decode(words, start, cfg.frame_length, chanbits,
                             cfg.mb, pb, cfg.kb, (1 << cfg.kb) - 1),
            start, pb, chanbits)


def cursor_calls(codec, words):
    """The cursor instance (kernels.decode.cursor_scan, the Rice warp
    alone, on no codec path) on the stream of each 8-tap launch of
    codec's decode of ``words``: [(the decode's call, the cursor's
    (end bits, err))], one per channel."""
    from alacjax_torch.kernels import decode as kd
    with recording([], keep=lambda c: c if c[0] == "decode" else None) \
            as rec:
        codec._decode(words)
    return [(call, kd.cursor_scan(*call[3][:8], num=call[4]["num"]))
            for call in rec]


def rice_chain(codec, codec51, w4, w51, counts):
    """Phase 12: the cursor on each 8-tap launch's stream of the chained
    decodes of phase 4's stereo-16 and phase 5's 24-bit 5.1 words: it
    ends where the launch ends on every lane the launch does not flag,
    and flags no such lane; the cursor's ms per channel beside the 8-tap
    launch's, in turns (cursor, chained, chained, cursor); then
    rice_decode (the raw instance) of the stereo frames' first channel."""
    import torch
    from alacjax_torch.kernels import decode as kd
    out = {}
    with path_run("phase 12", counts):
        for label, c, w in (("stereo-16", codec, w4),
                            ("24-bit 5.1", codec51, w51)):
            pairs = cursor_calls(c, w)
            for k, (call, (c_end, c_err)) in enumerate(pairs):
                _, d_end, d_err = call[1](*call[3], **call[4])
                if not torch.equal(c_end[~d_err], d_end[~d_err]) or bool(
                        (c_err & ~d_err).any().item()):
                    fail(f"phase 12: {label} channel {k}: the cursor's end "
                         "bits or err differ from the 8-tap decode's")
            out[label] = [call for call, _ in pairs]
    print("  the cursor ends where each 8-tap launch ends on stereo-16 and "
          "24-bit 5.1, and flags no lane the launch does not", flush=True)
    for label, group in out.items():
        took = {"cursor": [], "chained": []}
        for which in ("cursor", "chained", "chained", "cursor"):
            took[which].append([
                timed(lambda: kd.cursor_scan(*a[:8], num=k["num"])
                      if which == "cursor" else f(*a, **k), reps=3)[1]
                for _, f, _, a, k in group])
        cur_ms, ch_ms = ([sum(t) / len(t) for t in zip(*took[which])]
                         for which in ("cursor", "chained"))
        print(f"  {label}: cursor ms per channel {cur_ms} (mean "
              f"{sum(cur_ms) / len(cur_ms):.4f}); chained 8-tap decode "
              f"launch ms per channel {ch_ms} (mean "
              f"{sum(ch_ms) / len(ch_ms):.4f}; cursor / full "
              f"{sum(cur_ms) / sum(ch_ms):.3f})", flush=True)
    del out
    with path_run("phase 12 raw", counts):
        (res, end, err), start, pb, cb = raw_drive(codec, w4)
        c_end, c_err = kd.cursor_scan(w4, start, S, cb, codec.config.mb, pb,
                                      codec.config.kb,
                                      (1 << codec.config.kb) - 1)
    if bool(err.any().item()) or not torch.equal(end, c_end) \
            or bool(c_err.any().item()):
        fail("phase 12: rice_decode's end bits differ from the cursor's")
    print(f"  rice_decode of the {B} stereo frames' first channel ({B}x{S} "
          "residuals, raw instance): ends where the cursor ends, no frame "
          "flagged", flush=True)


def cut_times(codec, codec51, x, w4, w51):
    """Phase 12: the device-resident encode of phase 4's batch up to each
    of _encode_packet_chunks's cuts, and the decode of phase 4's and
    phase 5's words up to each of decode_frames_device's cuts, ms per
    batch (card clock, 3 calls after a warm-up)."""
    from alacjax_torch.codec import (
        DECODE_CUTS, ENCODE_CUTS, _encode_packet_chunks, decode_frames_device,
    )
    cfg = codec.config
    enc = [(stop, timed(lambda: _encode_packet_chunks(
        x, cfg, codec.num_words, stop_at=stop), reps=3)[1])
        for stop in ENCODE_CUTS + (None,)]
    print("  encode of phase 4's batch up to each cut, ms: "
          + ", ".join(f"{stop or 'whole'} {ms:.3f}" for stop, ms in enc),
          flush=True)
    for label, c, w in (("phase 4 stereo-16", codec, w4),
                        ("phase 5 24-bit 5.1", codec51, w51)):
        dec = [(stop, timed(lambda: decode_frames_device(
            w, c.config, c.config.frame_length, stop_at=stop), reps=3)[1])
            for stop in DECODE_CUTS + (None,)]
        print(f"  decode of the {label} words up to each cut, ms: "
              + ", ".join(f"{stop or 'whole'} {ms:.3f}" for stop, ms in dec),
              flush=True)


def fuzz_campaign(counts, seen, rows, card: str):
    """Phase 13: the differential campaign of tools/torch_fuzz_soak.py on
    the card, one round of every kind at FUZZ_SEED and the fixed
    corpora, recording the first call of every kernel signature no
    earlier phase produced (``seen`` holds phase 3's) and holding each
    exactly against its plain version.  One pool of host workers builds
    the packets and runs the plain versions."""
    import dataclasses
    soak = fuzz_tool()
    sizes = dataclasses.replace(soak.CARD, **FUZZ_SIZES)
    t0 = time.perf_counter()
    pool = soak.host_pool()
    stats = soak.Stats()
    codecs = soak.make_codecs(sizes, "cuda")
    new = []

    def keep(call):
        key = signature(call)
        if key in seen:
            return None
        seen.add(key)
        return prefix(call, PREFIX, FUZZ_LANES)[0]

    def log(msg, **kw):
        print(f"  {msg}", **kw)
    try:
        try:
            with path_run("phase 13", counts), recording(new, keep):
                soak.one_round(FUZZ_SEED, sizes, "cuda", codecs, stats,
                               log=log, pool=pool)
                soak.fixed_corpora(sizes, "cuda", stats, log=log)
        except soak.Divergence as e:
            fail(f"phase 13: {e}")
        run_s = time.perf_counter() - t0
        report(stats, sizes, run_s)
        n = compare_kernels(new, rows, pool=pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"  {n} new kernel signatures held to their plain versions on "
          f"their first {PREFIX} samples and {FUZZ_LANES} lanes: "
          f"max_abs_err 0")
    print(f"  phase 13 took {time.perf_counter() - t0} s on {card}")


def report(stats, sizes, run_s: float):
    """Phase 13's counts: rounds and lanes per kind, frames to the
    oracle, corpus building time."""
    print(f"  rounds per kind {stats.rounds}, lanes per kind {stats.lanes} "
          f"(S={sizes.S}; grammar: {sizes.grammar} distinct packets a "
          f"shape, DSE/FIL and deviant batches: {sizes.special} lanes of "
          f"each), 0 divergences from the native codec and the oracle")
    print(f"  frames decode_frames_ex sent to the oracle per kind "
          f"{stats.fallback}; lanes the scalar oracle checked "
          f"{stats.oracle_lanes}")
    print(f"  corpus building {stats.build_s} s of the campaign's {run_s} s")


def merge_invariant(counts, kind: str, card: str, repo: str):
    """Phase 14 (a): 16-bit 7.1 (five elements) at B lanes of S, lane i
    of tests/test_chunk_budget.py's row i % 4 (sine, all escape,
    alternating, tiny residuals; seeded), encoded with the merge
    wrapper recorded.  Per merge call the invariant is checked on the
    card (each lane's keys other than empty are 0..n-1 in slot order,
    n <= num_words): the (B, T) keys stay there.  Then the first
    N_MERGE_NATIVE packets against the native C++ encoder and the decode
    of every lane, lossless."""
    import numpy as np
    import torch
    from alacjax_torch import AlacConfig, TorchCodec, native
    from alacjax_torch.ops import bitpack
    sys.path.insert(0, os.path.join(repo, "tests"))
    from torch_stress_cases import merge_key_faults, widest_layout_pcm

    t0 = time.perf_counter()
    cfg = AlacConfig(bit_depth=16, num_channels=8, frame_length=S)
    pcm = widest_layout_pcm(np.random.default_rng(MERGE_SEED), B, S,
                            np.int32)
    x = torch.from_numpy(pcm).to("cuda")
    codec = TorchCodec(cfg, chunk=B, device="cuda")

    def keep(call):
        if call[0] != "merge":
            return None
        keys, num_words = call[3][1], call[3][4]
        return (merge_key_faults(keys, num_words).sum(),
                (keys != -1).sum(dim=1).max(), tuple(keys.shape), num_words)
    with path_run("phase 14", counts), recording([], keep) as merges:
        words, bits = codec._encode(x)
        dec, err, num = codec._decode(words)
    if not merges:
        fail("phase 14: the merge kernel was never called")
    for bad, most, shape, num_words in merges:
        print(f"  merge on {shape[0]}x{shape[1]} -> {num_words} words: "
              f"{int(bad)} lanes break the invariant, at most {int(most)} "
              "keys a lane")
        if int(bad) or int(most) > num_words:
            fail(f"phase 14: {int(bad)} lanes' merge keys are not 0..n-1 "
                 f"or hold more than {num_words} words")
    if bool(err.any().item()) or not torch.equal(dec, x) \
            or not bool((num == S).all().item()):
        fail("phase 14: the 7.1 round trip is not lossless")
    packets = bitpack.words_to_bytes(words[:N_MERGE_NATIVE].cpu().numpy(),
                                     bits[:N_MERGE_NATIVE].cpu().numpy())
    enc = native.NativeEncoder(cfg, independent_frames=True)
    bad = [i for i in range(N_MERGE_NATIVE)
           if packets[i] != enc.encode_packet(pcm[i])]
    if bad:
        fail(f"phase 14: {len(bad)} of the first {N_MERGE_NATIVE} 7.1 packets "
             f"differ from the native C++ encoder (first: frame {bad[0]})")
    print(f"  7.1: {len(merges)} merge calls hold the invariant on every "
          f"lane, {N_MERGE_NATIVE}/{N_MERGE_NATIVE} packets byte-identical to "
          f"the native C++ encoder, {B} lanes lossless, on {kind} ({card}); "
          f"{time.perf_counter() - t0} s")


def bench_family(counts, kind: str, card: str):
    """Phase 14 (b): bench_torch.measure (bench.py's metric: R repeats
    of chained encode -> decode pairs, median and spread) and
    bench_configs_torch's five configs, each gated on losslessness;
    their JSON lines printed as they are."""
    import bench_configs_torch
    import bench_torch
    from alacjax_torch import AlacConfig

    t0 = time.perf_counter()
    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    with path_run("phase 14 bench", counts):
        line = bench_torch.measure(cfg, B, BENCH_ITERS, BENCH_REPEATS,
                                   device="cuda")
        configs = [bench_configs_torch.run_config(name, kw, k, CONFIGS_B,
                                                  CONFIGS_ITERS, "cuda")
                   for name, kw, k in bench_configs_torch.CONFIGS]
    print(f"  bench_torch.py (B={B}, iters {BENCH_ITERS}, repeats "
          f"{BENCH_REPEATS}) and bench_configs_torch.py (B={CONFIGS_B}, "
          f"iters {CONFIGS_ITERS}) on {kind} ({card}), "
          f"{time.perf_counter() - t0} s:")
    for obj in [line] + configs:
        print(json.dumps(obj), flush=True)


def profile(fn, name: str):
    """With --profile DIR: a torch.profiler table of one call of fn,
    written to DIR/name."""
    if "--profile" not in sys.argv:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    out_dir = sys.argv[sys.argv.index("--profile") + 1]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table)
    print(f"  profile written to {out_dir}/{name}")


def main() -> int:
    import numpy as np
    import torch

    t_start = time.perf_counter()
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
    from alacjax_torch import native
    from alacjax_torch import AlacConfig, TorchCodec
    from alacjax_torch.kernels import LAUNCHES, _build
    from bench_torch import make_music

    # phase 2: build
    _build.lib()
    print(f"phase 2: kernels built in {_build.build_seconds} s")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or any(
                k in line for k in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    for fn, sizes in sorted(sass_loops(_build.lib_path()).items()):
        print(f"  sass: {fn}: innermost loops (instructions, shortest "
              f"path): {[s for s in sizes if s[0] > 1]}")
    if not native.available():
        fail(f"native C++ codec unavailable: {native.build_error()}")

    cfg = AlacConfig(bit_depth=16, num_channels=2, frame_length=S,
                     sample_rate=44100)
    cfg51 = AlacConfig(bit_depth=24, num_channels=6, frame_length=S,
                       sample_rate=48000)
    t0 = time.perf_counter()
    pcm = make_music(B, S)
    pcm51, packets51, nums51 = make_51(cfg51)
    pcm_hi, packets_hi = make_hi(cfg)
    pcm10 = stream_corpus(B, N_STREAM)
    print(f"corpora made in {time.perf_counter() - t0} s: phase 5 tiles "
          f"{N_DISTINCT_51} distinct natively encoded 5.1 frames to {B}, "
          f"phase 6 tiles {N_DISTINCT_HI} distinct forced-order packets "
          f"to {B}, phase 10 cuts {B} streams of {N_STREAM} frames from one "
          "signal", flush=True)
    codec = TorchCodec(cfg, chunk=B, device="cuda")
    codec51 = TorchCodec(cfg51, chunk=B, device="cuda")
    x = torch.from_numpy(pcm).to("cuda")
    x51 = torch.from_numpy(pcm51).to("cuda")
    n51 = torch.from_numpy(nums51.astype(np.int32)).to("cuda")

    # phase 3: kernels vs plain versions on recorded inputs
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops = sms * LANE_OPS_PER_SM_CLOCK * clock
    print(f"phase 3: kernels vs plain torch on {kind} ({card}); bounds at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s and {sms} SMs x "
          f"{LANE_OPS_PER_SM_CLOCK} lane operations x {clock / 1e6} MHz",
          flush=True)
    with recording([]) as calls:
        words, _ = codec._encode(x)
        codec._decode(words)
    with recording([]) as calls51:
        codec51._decode(device_words(codec51, packets51))
    with recording([]) as calls_hi:
        w_hi = device_words(codec, packets_hi)
        for t in (16, 30):
            codec._decode(w_hi, taps=t)
    calls += one_per_signature(calls51) + one_per_signature(
        [c for c in calls_hi if c[0] == "decode_hi"])
    del words, w_hi, calls51, calls_hi
    rows = {k: dict(calls=0, ms=0.0, plain_ms=0.0, max_abs_err=0,
                    bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
            for k in REPLACES}
    compare_kernels(calls, rows, int_ops)
    merges = merge_library(calls)
    rice_cycles(calls, clock)
    # the new signatures: per-lane chanbits and num (the 5.1 encode), the
    # standalone-predictor route (stereo and 5.1), a stream step with
    # persistent banks (one block of starting coefficients per order),
    # the cursor on each 8-tap launch's stream (stereo and 5.1) and
    # rice_decode's raw decode
    seen = {signature(c) for c in calls}
    del calls
    legacy = TorchCodec(cfg, chunk=B, device="cuda", predict_legacy=True)
    legacy51 = TorchCodec(cfg51, chunk=B, device="cuda", predict_legacy=True)
    w4 = codec._encode(x)[0]
    w51 = device_words(codec51, packets51)
    new_calls = []
    for run in (lambda: codec51._encode(x51, n51), lambda: legacy._encode(x),
                lambda: legacy51._encode(x51, n51),
                bank_step(cfg, torch.from_numpy(pcm10[:, :2]).to("cuda")),
                lambda: cursor_calls(codec, w4),
                lambda: cursor_calls(codec51, w51),
                lambda: raw_drive(codec, w4)):
        with recording([]) as rec:
            run()
        new_calls += one_per_signature(rec, seen)
        del rec
    compare_kernels(new_calls, rows, int_ops, cut=True)
    merges.update(merge_library(new_calls))
    walker_cycles(new_calls, clock)
    rice_cycles(new_calls, clock)
    # one emit call that ends mid-tile in lanes and in steps
    compare_kernels([ragged_emit_call()], rows, int_ops)
    predict_tile_edges(rows, repo)
    chanbits33_cases(rows, repo)
    window_cases(rows, repo)
    fir_cases(rows, repo)
    del new_calls, legacy, legacy51, run
    missing = [k for k, r in rows.items() if r["calls"] == 0]
    if missing:
        fail(f"kernels never compared with their plain versions: {missing}")

    counts = {}
    # phase 4: main path
    print(f"phase 4: main path, B={B} stereo-16 frames of {S} on {kind} "
          f"({card})", flush=True)
    main4 = main_path(pcm, cfg, codec, counts)
    profile(lambda: codec._decode(codec._encode(x)[0]), "profile.txt")

    # phase 5: layouts and depths
    print(f"phase 5: B={B} 24-bit 5.1 frames of {S} on {kind} ({card})",
          flush=True)
    w51 = layouts_and_depths(codec51, pcm51, packets51, nums51, counts)
    profile(lambda: codec51._decode(w51), "profile_51.txt")

    # phase 6: the retry ladder
    print(f"phase 6: retry ladder, B={B} stereo-16 forced-order packets on "
          f"{kind} ({card})", flush=True)
    w_hi = retry_ladder(cfg, pcm_hi, packets_hi, counts, main4)
    profile(lambda: [codec._decode(w_hi, taps=t) for t in (8, 16, 30)],
            "profile_ladder.txt")
    del w_hi, pcm_hi, packets_hi

    # phase 7: encode of every layout
    print(f"phase 7: encode, B={B} 24-bit 5.1 frames of {S} with partial "
          f"frames, then B={N_SMALL} each of "
          f"{', '.join(label for label, _ in SMALL_ENCODES)}, on {kind} "
          f"({card})", flush=True)
    encode_layouts(codec51, pcm51, packets51, nums51, x51, n51, counts)
    profile(lambda: codec51._encode(x51, n51), "profile_enc51.txt")
    del x51, n51, packets51

    # phase 8: the standalone-predictor route
    print(f"phase 8: predict_legacy encode, B={B} stereo-16 frames of {S} on "
          f"{kind} ({card})", flush=True)
    legacy, x = predict_legacy_route(cfg, pcm, counts, main4)
    profile(lambda: legacy._encode(x), "profile_legacy.txt")
    del legacy, x

    # phase 9: the converter
    print(f"phase 9: converter, python -m alacjax_torch.cli on an album on "
          f"{kind} ({card})", flush=True)
    converter(counts, card, kind)

    # phase 10: persistent-bank streams
    print(f"phase 10: persistent-bank streams, {B} stereo-16 streams of "
          f"{N_STREAM} frames of {S}, then {N51_STREAMS} 24-bit 5.1 streams "
          f"of {N51}, on {kind} ({card})", flush=True)
    streams(cfg, cfg51, codec, codec51, pcm10, counts, main4)
    del pcm10

    # phase 11: the frames axis across devices
    print(f"phase 11: ShardedCodec on phase 4's batch of {B} stereo-16 "
          f"frames on {kind} ({card})", flush=True)
    sharded(cfg, pcm, codec, counts, main4)

    # phase 12: the cursor, the raw decode and the profiling cuts
    print(f"phase 12: the cursor on the 8-tap launches of phase 4's {B} "
          f"stereo-16 and phase 5's {B} 24-bit 5.1 frames, rice_decode, and "
          f"the encode and decode up to each profiling cut, on {kind} "
          f"({card})", flush=True)
    t12 = time.perf_counter()
    rice_chain(codec, codec51, w4, w51, counts)
    cut_times(codec, codec51, torch.from_numpy(pcm).to("cuda"), w4, w51)
    print(f"  phase 12 took {time.perf_counter() - t12} s")
    del pcm, pcm51, w4, w51

    # phase 13: the differential campaign
    print(f"phase 13: differential campaign (tools/torch_fuzz_soak.py), "
          f"B={B} lanes of S={S}, on {kind} ({card})", flush=True)
    fuzz_campaign(counts, seen, rows, card)

    # phase 14: the merge invariant on the widest layout, the bench family
    print(f"phase 14: merge invariant on B={B} 16-bit 7.1 frames of {S}, "
          f"then bench_torch.py and bench_configs_torch.py, on {kind} "
          f"({card})", flush=True)
    t14 = time.perf_counter()
    merge_invariant(counts, kind, card, repo)
    bench_family(counts, kind, card)
    print(f"  phase 14 took {time.perf_counter() - t14} s")
    for key, (lib_ms, scatter_ms, merge_ms) in merges.items():
        print(f"merge library call on {key}: torch scatter_ {lib_ms} ms, "
              f"merge_scatter alone {scatter_ms} ms, whole merge {merge_ms} "
              "ms")

    if "jax" in sys.modules:
        fail("jax was imported")
    if set(LAUNCHES) != set(REPLACES):
        fail(f"kernel set changed: {sorted(LAUNCHES)}")
    kernels = []
    for name, row in rows.items():
        entry = dict(name=name, route="cuda", source=SOURCES[name],
                     replaces=REPLACES[name],
                     launches=sum(c[name] for c in counts.values()),
                     max_abs_err=row["max_abs_err"], ms=row["ms"],
                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=("bytes" if row["bytes_ms"] >= row["ops_ms"]
                               else "operations"),
                     library_ms=(sum(m[0] for m in merges.values())
                                 if name == "merge" else None))
        kernels.append(entry)
    print(f"total wall time {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
