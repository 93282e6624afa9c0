#!/usr/bin/env python
"""Unbounded differential fuzz soak of the alacjax_torch port: grammar,
content and exhaustive rounds, then fixed corpora, through the port's
kernels (tools/tools_fuzz_soak.py's campaign, without jax).

Rounds run at fixed shapes, seeds 10M/20M/30M + round, until the time
is up:

  * grammar rounds, one per GRAMMAR_SHAPES entry: distinct packets with
    random legal header parameters (orders 0..31 up to 30 taps, mode
    nibbles, denshift, pb factor, hostile mixbits/mixres; the conforming
    bytesShifted), tiled to B lanes and permuted so every warp of 32
    lanes mixes packets of different parameters.  decode_frames_device
    at 30 taps flags no lane and equals the native decoder; the oracle
    equals the native decoder on the first packets; the host API's
    decode_frames_ex (the 8 -> 16 -> 30-tap ladder) returns the same PCM;
  * a batch per shape in SPECIAL_SHAPES of conforming packets with a
    few DSE/FIL-prefixed and bytesShifted-deviant lanes: the device
    flags exactly those lanes and decode_frames_ex returns the oracle's
    PCM for them;
  * content rounds, one per CONTENT_SHAPES entry: B adversarial frames
    (gen_adversarial, one content class drawn per lane) with partial
    tails; encode_frames_ex equals the native encoder on every lane and
    the oracle on the first lanes, and decodes losslessly;
  * exhaustive rounds, one per EXHAUSTIVE_SHAPES entry: the device's
    exhaustive search equals the native exhaustive encoder on every lane
    and the oracle on the first lanes.

After the rounds, the fixed corpora: the five pathological full-frame
fixtures (tests/test_pathological_4096.py) of each of its five configs,
interleaved lane by lane to B, and the escape-flip pair (amplitudes
flip - 1 and flip) of each depth in FLIP_DEPTHS and channel count in
FLIP_CHANNELS, tiled to B: packets equal the native encoder's, with the
escape bit on the same side, and the round trip is lossless.

The reference codecs are the port's own native C++ codec
(alacjax_torch.native) and scalar oracle (alacjax_torch.oracle).  The
legal-packet writer (build_packet, and build_packets over a process
pool) writes the wire grammar with forced parameters through the
oracle's predictor and Rice coder (tests/test_torch_decode_taps.py holds
it to tests/test_high_order_decode.py :: build_packet).

On the card (the default, --device cuda) the shapes are S=4096 samples
by B=4096 lanes, and the packets are built on all host cores but one;
--device cpu runs the kernels' plain torch versions at S=256, B=8, in
one process.  Without a card and without --device cpu the tool exits 2.

Usage:
  python tools/torch_fuzz_soak.py [minutes=30] [seed0=0] [--device cuda|cpu]
Exits 1 on the first divergence, printing its reproducer (shape, seed,
lane, first differing byte or sample).  No fallback hides the card: a
kernel that fails to build or launch ends the run with its traceback.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)  # script lives in tools/

from alacjax_torch.bitbuffer import BitBuffer  # noqa: E402
from alacjax_torch.oracle import ag, dp, matrix  # noqa: E402
from alacjax_torch.oracle.encoder import (  # noqa: E402
    DEFAULT_MIX_BITS, PB_FACTOR, _rice_params, _write_channel_params,
    _write_element_header, bytes_shifted_for_depth,
)
from alacjax_torch.types import (  # noqa: E402
    DENSHIFT_DEFAULT, AlacConfig, ElementTag,
)

GRAMMAR_SHAPES = [(16, 1), (16, 2), (16, 3), (16, 6), (16, 8),
                  (20, 2), (24, 2), (32, 2)]
CONTENT_SHAPES = [(16, 2), (16, 6), (20, 2), (24, 2), (32, 2), (16, 8)]
# device exhaustive search vs the host exhaustive encoders (the whole
# candidate grid's selection/tie-break logic under adversarial content)
EXHAUSTIVE_SHAPES = [(16, 2), (24, 2)]
# the DSE/FIL and deviant-bytesShifted batches
SPECIAL_SHAPES = [(16, 1), (16, 2)]
KINDS = ["sine", "noise", "silence", "impulse"]
PATHOLOGICAL_CONFIGS = [   # tests/test_pathological_4096.py :: CONFIGS
    ("stereo16", dict(bit_depth=16, num_channels=2)),
    ("mono16", dict(bit_depth=16, num_channels=1)),
    ("hires24", dict(bit_depth=24, num_channels=2, sample_rate=96000)),
    ("surround51", dict(bit_depth=16, num_channels=6, sample_rate=48000)),
    ("escape32", dict(bit_depth=32, num_channels=2, sample_rate=96000)),
]
PATHOLOGICAL_SEED = 4096     # the fixtures' noise bursts
FLIP_DEPTHS = (16, 20, 24, 32)
FLIP_CHANNELS = (1, 2)
FLIP_SEED = 5                # tests/test_escape_boundary.py :: _gen


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A campaign's shapes and how many lanes meet the scalar oracle."""
    S: int                   # samples per frame
    B: int                   # lanes per batch
    grammar: int             # distinct packets per grammar shape
    grammar_oracle: int      # of them decoded by the oracle too
    content_oracle: int      # content lanes encoded by the oracle too
    exhaustive_oracle: int   # exhaustive lanes encoded by the oracle too
    special: int             # DSE/FIL lanes and deviant lanes per batch


CARD = Sizes(S=4096, B=4096, grammar=256, grammar_oracle=16,
             content_oracle=8, exhaustive_oracle=4, special=8)
CPU = Sizes(S=256, B=8, grammar=8, grammar_oracle=8, content_oracle=8,
            exhaustive_oracle=4, special=2)


class Divergence(AssertionError):
    """A disagreement between the port and a reference codec; its
    message is the reproducer."""


# ---------------------------------------------------------------------------
# content
# ---------------------------------------------------------------------------
def gen_pcm(rng, kind: str, nch: int, n: int, depth: int) -> np.ndarray:
    """Fixture PCM (tests/conftest.py :: gen_pcm): white noise, sine
    mixtures, silence, impulse trains."""
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
    if kind == "impulse":
        x = np.zeros((nch, n), dtype=np.int64)
        x[:, ::211] = full - 1
        x[:, 7::401] = -full
        return x
    raise ValueError(kind)


def gen_adversarial(rng, nch: int, n: int, depth: int) -> np.ndarray:
    """Adversarial content classes beyond gen_pcm
    (tools/tools_fuzz_soak.py :: gen_adversarial)."""
    full = 1 << (depth - 1)
    kind = rng.integers(0, 7)
    t = np.arange(n)
    if kind == 0:  # transient bursts: cold predictor restarts
        x = np.zeros((nch, n))
        for _ in range(rng.integers(2, 6)):
            p = rng.integers(0, n - 8)
            x[:, p:p + 8] += rng.integers(-full, full, (nch, 8))
    elif kind == 1:  # amplitude ramp crossing the escape threshold
        env = np.linspace(0, 1.2, n)
        x = env[None, :] * rng.integers(-full, full, (nch, n))
    elif kind == 2:  # anti-phase / decorrelated stereo (mixres decisions)
        a = np.sin(t * 0.05) * (full // 2)
        x = np.stack([((-1) ** c) * a + rng.integers(-99, 100, n)
                      for c in range(nch)])
    elif kind == 3:  # zero-run churn: silence blocks + noise blocks
        x = rng.integers(-full, full, (nch, n))
        for _ in range(rng.integers(3, 9)):
            p = rng.integers(0, n - 16)
            x[:, p:p + rng.integers(4, 17)] = 0
    elif kind == 4:  # near-silence: mb estimate collapse
        x = rng.integers(-2, 3, (nch, n))
    elif kind == 5:  # DC plateaus with steps
        x = np.repeat(rng.integers(-full, full, (nch, max(1, n // 32))),
                      32, axis=1)[:, :n]
    else:  # sines at varying crest factor + noise floor
        x = sum(np.sin(t * f)[None, :] * (full >> k)
                for k, f in enumerate((0.01, 0.13, 0.71), start=2))
        x = x + rng.integers(-30, 31, (nch, n))
    return np.clip(x, -full, full - 1).astype(np.int64)


def pathological_fixtures(rng, nch: int, depth: int, S: int) -> np.ndarray:
    """(5, nch, S) full-frame fixtures of
    tests/test_pathological_4096.py :: _fixtures: zero runs of growing
    lengths between impulses, run/burst alternation, half silence then
    full-scale noise, per-sample zmode churn, and a music-like control."""
    full = (1 << (depth - 1)) - 1
    frames = []
    x = np.zeros((nch, S), np.int64)
    pos, step = 3, 5
    while pos < S:
        x[:, pos] = full
        pos += step
        step = step * 2 + 7
    frames.append(x)

    x = np.zeros((nch, S), np.int64)
    j = 0
    w = 30
    while j < S:
        burst = min(w // 3 + 1, S - j - w) if j + w < S else 0
        if burst > 0:
            x[:, j + w:j + w + burst] = rng.integers(
                -full - 1, full + 1, (nch, burst))
        j += w + burst
        w = 30 + (w * 13 + 7) % 41
    frames.append(x)

    x = np.zeros((nch, S), np.int64)
    x[:, S // 2:] = rng.integers(-full - 1, full + 1, (nch, S - S // 2))
    frames.append(x)

    x = np.zeros((nch, S), np.int64)
    x[:, 1::4] = full
    x[:, 3::4] = -full - 1
    frames.append(x)

    t = np.arange(S)
    sig = np.sin(2 * np.pi * 441 * t / 44100) * 0.6 * full
    frames.append(np.stack([np.roll(sig, 5 * c) for c in range(nch)])
                  .astype(np.int64))
    return np.stack(frames)


def flip_frame(seed: int, nch: int, depth: int, amp: int, S: int):
    """Noise frame at integer amplitude ``amp``
    (tests/test_escape_boundary.py :: _gen)."""
    rng = np.random.default_rng(seed)
    lim = 1 << (depth - 1)
    x = rng.integers(-amp, amp + 1, (nch, S))
    return np.clip(x, -lim, lim - 1).astype(np.int64)


def escaped(packet: bytes) -> bool:
    """The escape flag: bit 22 of the first element's 23-bit header."""
    hdr = (packet[0] << 16) | (packet[1] << 8) | packet[2]
    return bool((hdr >> 1) & 1)


# ---------------------------------------------------------------------------
# legal packets with forced parameters
# ---------------------------------------------------------------------------
def rand_params(rng, nch: int, max_order: int):
    """One packet's random legal parameters
    (tests/test_grammar_fuzz.py :: _rand_params): (orders, modes,
    denshifts, pb factors, mixbits, mixres)."""
    orders, modes, dens, pbfs = [], [], [], []
    for _ in range(nch):
        r = rng.random()
        if r < 0.1:
            order = 0
        elif r < 0.2:
            order = 31
        else:
            order = int(rng.integers(1, max_order + 1))
        orders.append(order)
        # mostly single-stage; some cascade, incl. mode nibbles > 1
        modes.append(int(rng.choice([0, 0, 0, 1, 1, 2, 7])))
        # denshift 0 is legal only when no FIR walk runs (order 0/31)
        dens.append(int(rng.integers(0 if order in (0, 31) else 1, 16)))
        pbfs.append(int(rng.integers(0, 8)))
    mixbits = int(rng.integers(1, 11))
    # mostly convex (lossless-roundtrip) mixres, some hostile values
    if rng.random() < 0.75:
        mixres = int(rng.integers(0, min((1 << mixbits), 256)))
    else:
        mixres = int(rng.integers(-128, 128))
    return orders, modes, dens, pbfs, mixbits, mixres


def _dse_fil_prefix(bits: BitBuffer) -> None:
    """A FIL element (3 fill bytes) and a DSE element (byte-aligned, 2
    data bytes) ahead of the frame's elements
    (tests/test_grammar_fuzz.py :: test_dse_fil_streams_...)."""
    bits.write(int(ElementTag.FIL), 3)
    bits.write(3, 4)
    bits.write(0xABCDEF, 24)
    bits.write(int(ElementTag.DSE), 3)
    bits.write(0, 4)
    bits.write(1, 1)                 # byte-align flag
    bits.write(2, 8)
    bits.byte_align(add_zeros=True)
    bits.write(0xBEEF, 16)


@dataclasses.dataclass
class Params:
    """The forced header parameters of one packet: per channel orders,
    modes, denshifts and pb factors; per CPE mixbits and mixres; the
    bytesShifted field; and whether a FIL and a DSE element lead it."""
    orders: list
    modes: list
    denshifts: list | None = None
    pbfs: list | None = None
    mixbits: int = DEFAULT_MIX_BITS
    mixres: int = 2
    bytes_shifted: int = 0
    dse_fil: bool = False


def build_packet(cfg, pcm, orders, modes, mixres=2, denshifts=None,
                 pbfs=None, mixbits=DEFAULT_MIX_BITS, bytes_shifted=0,
                 dse_fil=False) -> bytes:
    """A legal packet with forced parameters through the port's oracle
    (tests/test_high_order_decode.py :: build_packet: the element layout
    of ALACEncoder.cpp with the search replaced by the given parameters),
    led by a FIL and a DSE element if ``dse_fil``.  pcm is planar
    (C, n); n < frame_length makes a partial frame.  Each channel's
    coefficients beyond the first three are drawn from seed
    1000 * order + channel."""
    # a forced weak predictor on hostile content can pass the escape
    # bound the real encoder never crosses
    bits = BitBuffer(byte_size=4 * cfg.max_escape_packet_bytes(
        cfg.frame_length) + 256)
    if dse_fil:
        _dse_fil_prefix(bits)
    num = pcm.shape[1]
    nch = cfg.num_channels
    denshifts = [DENSHIFT_DEFAULT] * nch if denshifts is None \
        else list(denshifts)
    pbfs = [PB_FACTOR] * nch if pbfs is None else list(pbfs)
    bs = bytes_shifted
    ch = 0
    tag_counters = {}
    for tag, width in cfg.elements:
        instance = tag_counters.get(int(tag), 0)
        tag_counters[int(tag)] = instance + 1
        _write_element_header(bits, tag, instance, num < cfg.frame_length,
                              bs, False, num)
        his, los = [], []
        for i in range(width):
            hi, lo = matrix.shift_off(pcm[ch + i].astype(np.int64), bs)
            his.append(hi)
            los.append(lo)
        if width == 2:
            chanbits = cfg.bit_depth - 8 * bs + 1
            bits.write(mixbits, 8)
            bits.write(mixres & 0xFF, 8)
            u, v = matrix.mix(his[0], his[1], mixbits, mixres)
            # every residual must fit chanbits (dyn_comp's escape writes
            # chanbits bits): wrap the mixed streams, an identity for
            # every convex mix
            half, mask = 1 << (chanbits - 1), (1 << chanbits) - 1
            streams = [((u.astype(np.int64) + half) & mask) - half,
                       ((v.astype(np.int64) + half) & mask) - half]
        else:
            chanbits = cfg.bit_depth - 8 * bs
            bits.write(0, 8)   # mixBits: present in mono elements too
            bits.write(0, 8)   # mixRes
            streams = [his[0]]
        residuals = []
        for i, s in enumerate(streams):
            order, mode = orders[ch + i], modes[ch + i]
            den = denshifts[ch + i]
            coefs = np.zeros(32, dtype=np.int64)
            coefs[:3] = dp.init_coefs(max(den, 1))[:3]
            crng = np.random.default_rng(1000 * order + ch + i)
            if order > 3:
                coefs[3:order] = crng.integers(-64, 64, order - 3)
            res = dp.pc_block(s, coefs.copy(), order, chanbits, den)
            if mode:
                res = dp.pc_block(res, coefs[:0], 31, chanbits, 0)
            _write_channel_params(bits, mode, den, pbfs[ch + i], coefs,
                                  order)
            residuals.append(res)
        if bs:
            # the interleaved shift-byte block between the params and the
            # Rice streams (ALACEncoder.cpp's write order)
            for j in range(num):
                for i in range(width):
                    bits.write(int(los[i][j]), 8 * bs)
        for i, res in enumerate(residuals):
            ag.dyn_comp(_rice_params(cfg, num, pbfs[ch + i]), bits, res,
                        num, chanbits)
        ch += width
    bits.write(int(ElementTag.END), 3)
    bits.byte_align(add_zeros=True)
    return bits.to_bytes()


def _build(item) -> bytes:
    cfg, pcm, p = item
    return build_packet(cfg, pcm, p.orders, p.modes, p.mixres, p.denshifts,
                        p.pbfs, p.mixbits, p.bytes_shifted, p.dse_fil)


def build_packets(cfg, pcms, params, pool=None) -> list[bytes]:
    """build_packet of every (pcm, Params), of one config or, ``cfg`` a
    list, one config per packet; mapped over ``pool`` (a process pool:
    the oracle is scalar Python) where one is given."""
    cfgs = cfg if isinstance(cfg, list) else [cfg] * len(pcms)
    items = list(zip(cfgs, pcms, params))
    if pool is None:
        return [_build(item) for item in items]
    return list(pool.map(_build, items, chunksize=4))


def _single_threaded():
    import torch
    torch.set_num_threads(1)


def host_pool(workers: int = 7):
    """Spawned worker processes (not forked: the caller may hold a CUDA
    context), one torch thread each, at most one per host core but one:
    for build_packets, and for plain versions run on the host."""
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max(1, min(workers, (os.cpu_count() or 2) - 1)),
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_single_threaded)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------
def first_byte_diff(a: bytes, b: bytes) -> str:
    n = min(len(a), len(b))
    off = next((i for i in range(n) if a[i] != b[i]), n)
    return f"first differing byte {off} (lengths {len(a)}, {len(b)})"


def first_sample_diff(a, b) -> str:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return f"shapes {a.shape} and {b.shape}"
    idx = tuple(int(i) for i in np.argwhere(a != b)[0])
    return f"first differing sample {idx}: {a[idx]} against {b[idx]}"


def reproducer(cfg, seed: int, what: str) -> str:
    return (f"shape ({cfg.bit_depth}-bit, {cfg.num_channels} ch, "
            f"S={cfg.frame_length}), seed {seed}, {what}")


def check_packets(cfg, seed, got, want, label):
    """got[lane] == want[lane] for every lane of ``want``."""
    for lane, w in enumerate(want):
        if got[lane] != w:
            raise Divergence(reproducer(cfg, seed, f"lane {lane}: {label}: "
                                        f"{first_byte_diff(got[lane], w)}"))


def check_pcm(cfg, seed, got, want, label, lane):
    if not np.array_equal(got, want):
        raise Divergence(reproducer(cfg, seed, f"lane {lane}: {label}: "
                                    f"{first_sample_diff(got, want)}"))


def check_lanes(cfg, seed, bad, got, want, label):
    """Raise at the first lane ``bad`` marks, with got[lane] against
    want[lane] (each a numpy array or a callable of the lane)."""
    if bad.any():
        lane = int(np.argmax(bad))
        pick = [v(lane) if callable(v) else v[lane] for v in (got, want)]
        check_pcm(cfg, seed, *pick, label(lane), lane)
        raise Divergence(reproducer(cfg, seed, f"lane {lane}: {label(lane)}"))


def _parallel(fn, items, workers: int = 8):
    """fn over items in threads (the native codec's ctypes calls drop
    the GIL), in order."""
    chunks = [items[i::workers] for i in range(workers)]
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(fn, chunks))
    out = [None] * len(items)
    for w, part in enumerate(parts):
        out[w::workers] = part
    return out


def native_encode(cfg, frames, search: str = "standard"):
    """Packets of the native encoder with independent frames: frames is
    a list of (C, n) arrays."""
    from alacjax_torch import native

    def run(chunk):
        enc = native.NativeEncoder(cfg, independent_frames=True,
                                   search=search)
        return [enc.encode_packet(f) for f in chunk]
    return _parallel(run, list(frames))


def native_decode(cfg, packets):
    """(pcm (C, S) int64 zero-padded, num) of the native decoder."""
    from alacjax_torch import native

    def run(chunk):
        dec = native.NativeDecoder(cfg)
        out = []
        for p in chunk:
            y, got = dec.decode_packet(p)
            full = np.zeros((cfg.num_channels, cfg.frame_length), np.int64)
            full[:, :got] = y
            out.append((full, got))
        return out
    return _parallel(run, list(packets))


def words_of(packets, cfg, device):
    """The (B, W) word image of packets on ``device``, as wide as the
    codec's for the same chunk (``codec.packet_image_words``)."""
    import torch
    from alacjax_torch.codec import packet_image_words
    from alacjax_torch.ops import bitpack
    width, over = packet_image_words(cfg, packets)
    if over.any():
        raise ValueError(f"lanes {np.nonzero(over)[0][:8].tolist()} hold "
                         "packets longer than any legal one")
    wh = bitpack.bytes_to_words(packets, width)
    return torch.from_numpy(wh.view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Stats:
    """What a campaign ran: rounds and lanes per kind, frames sent to the
    oracle by decode_frames_ex, lanes the scalar oracle checked."""
    rounds: dict = dataclasses.field(default_factory=dict)
    lanes: dict = dataclasses.field(default_factory=dict)
    fallback: dict = dataclasses.field(default_factory=dict)
    oracle_lanes: int = 0
    build_s: float = 0.0

    def add(self, kind: str, lanes: int, fallback: int = 0):
        self.rounds[kind] = self.rounds.get(kind, 0) + 1
        self.lanes[kind] = self.lanes.get(kind, 0) + lanes
        self.fallback[kind] = self.fallback.get(kind, 0) + fallback


def codec_for(cfg, sizes: Sizes, device):
    from alacjax_torch import TorchCodec
    return TorchCodec(cfg, chunk=sizes.B, device=device)


def grammar_corpus(cfg, seed: int, sizes: Sizes, max_order: int = 30):
    """``sizes.grammar`` distinct random-parameter packets conforming on
    bytesShifted (the device decode treats the depth's value as static
    and flags deviant streams), and a permutation tiling them to
    ``sizes.B`` lanes: (packets, pcm, params, lane -> packet)."""
    bs = bytes_shifted_for_depth(cfg.bit_depth)
    rng = np.random.default_rng(seed)
    pcms, params = [], []
    for i in range(sizes.grammar):
        pcms.append(gen_pcm(rng, KINDS[i % len(KINDS)], cfg.num_channels,
                            sizes.S, cfg.bit_depth))
        o, m, d, p, mb, mr = rand_params(rng, cfg.num_channels, max_order)
        params.append(Params(o, m, d, p, mb, mr, bs))
    src = rng.permutation(np.resize(np.arange(sizes.grammar), sizes.B))
    return pcms, params, src


def grammar_round(cfg, seed: int, sizes: Sizes, device, stats: Stats,
                  built=None):
    """One grammar round (see the module docstring); returns (packets,
    lane -> packet, device pcm)."""
    import torch
    from alacjax_torch.codec import decode_frames_device
    from alacjax_torch.oracle import ALACDecoder
    S = sizes.S
    if built is None:
        t0 = time.perf_counter()
        pcms, params, src = grammar_corpus(cfg, seed, sizes)
        distinct = build_packets(cfg, pcms, params)
        stats.build_s += time.perf_counter() - t0
    else:
        distinct, params, src = built
    ref = native_decode(cfg, distinct)
    for i, (_, got) in enumerate(ref):
        if got != S:
            raise Divergence(reproducer(
                cfg, seed, f"packet {i} ({params[i]}): the native decoder "
                f"returned {got} samples"))
    oracle = ALACDecoder(cfg)
    for i in range(min(sizes.grammar_oracle, len(distinct))):
        y, got = oracle.decode_packet(distinct[i])
        check_pcm(cfg, seed, y[:, :got], ref[i][0][:, :got],
                  f"oracle against native decode of packet {i} "
                  f"({params[i]})", i)
    stats.oracle_lanes += min(sizes.grammar_oracle, len(distinct))
    packets = [distinct[j] for j in src]
    want = np.stack([r[0] for r in ref])[src]

    def label(what):
        return lambda lane: (f"{what}, packet {src[lane]} "
                             f"({params[src[lane]]})")
    pcm, err, num = decode_frames_device(words_of(packets, cfg, device), cfg,
                                         S, taps=30)
    bad = (err | (num != S)).cpu().numpy()
    check_lanes(cfg, seed, bad, lambda lane: int(num[lane]), [S] * len(src),
                label("the 30-tap device decode flagged it or its num"))
    bad = (pcm.to(torch.int64) != torch.from_numpy(want).to(pcm.device))
    check_lanes(cfg, seed, bad.flatten(1).any(dim=1).cpu().numpy(),
                lambda lane: pcm[lane].cpu().numpy(), want,
                label("30-tap device decode against native"))
    codec = codec_for(cfg, sizes, device)
    out, nums = codec.decode_frames_ex(packets)
    check_lanes(cfg, seed, (nums != S) | (out != want).reshape(
        len(src), -1).any(axis=1), out, want,
        label("decode_frames_ex against native"))
    stats.add("grammar", sizes.B, codec.fallback_frames)
    return packets, src, pcm


def special_corpus(cfg, seed: int, sizes: Sizes, pool=None):
    """Conforming random-grammar packets (orders up to 8) with
    ``sizes.special`` DSE/FIL-prefixed lanes and ``sizes.special``
    lanes of a deviant bytesShifted, each of those once in the batch:
    (packets, flagged lanes)."""
    bs = bytes_shifted_for_depth(cfg.bit_depth)
    rng = np.random.default_rng(seed)
    n_conf = max(1, min(sizes.grammar, sizes.B - 2 * sizes.special))
    pcms, params = [], []
    for i in range(n_conf + 2 * sizes.special):
        pcms.append(gen_pcm(rng, KINDS[i % len(KINDS)], cfg.num_channels,
                            sizes.S, cfg.bit_depth))
        o, m, d, p, mb, mr = rand_params(rng, cfg.num_channels, 8)
        kind = (i - n_conf) // sizes.special if i >= n_conf else -1
        params.append(Params(o, m, d, p, mb, mr,
                             (bs + 1) % 3 if kind == 1 else bs,
                             dse_fil=kind == 0))
    distinct = build_packets(cfg, pcms, params, pool)
    src = np.resize(np.arange(n_conf), sizes.B)
    flagged = rng.choice(sizes.B, 2 * sizes.special, replace=False)
    src[flagged] = n_conf + np.arange(2 * sizes.special)
    return [distinct[j] for j in src], np.sort(flagged), params, src


def special_round(cfg, seed: int, sizes: Sizes, device, stats: Stats,
                  pool=None):
    """DSE/FIL and deviant-bytesShifted lanes in a batch of conforming
    ones: the device flags exactly those lanes, and decode_frames_ex
    returns the oracle's PCM for them and the native decoder's for the
    rest."""
    from alacjax_torch.codec import decode_frames_device
    from alacjax_torch.oracle import ALACDecoder
    t0 = time.perf_counter()
    packets, flagged, params, src = special_corpus(cfg, seed, sizes, pool)
    stats.build_s += time.perf_counter() - t0
    _, err, _ = decode_frames_device(words_of(packets, cfg, device), cfg,
                                     sizes.S, taps=8)
    err = np.nonzero(err.cpu().numpy())[0]
    if not np.array_equal(err, flagged):
        raise Divergence(reproducer(
            cfg, seed, f"the device flagged lanes {err.tolist()[:16]}, not "
            f"the DSE/FIL and deviant lanes {flagged.tolist()[:16]}"))
    codec = codec_for(cfg, sizes, device)
    out, nums = codec.decode_frames_ex(packets)
    oracle = ALACDecoder(cfg)
    uniq = sorted(set(src.tolist()))
    ref = dict(zip(uniq, native_decode(cfg, [packets[int(np.nonzero(
        src == j)[0][0])] for j in uniq])))
    for lane in flagged:
        y, got = oracle.decode_packet(packets[lane])
        check_pcm(cfg, seed, out[lane, :, :got], y[:, :got],
                  f"decode_frames_ex against the oracle on a "
                  f"{'DSE/FIL' if params[src[lane]].dse_fil else 'deviant'} "
                  f"lane", lane)
        check_pcm(cfg, seed, y[:, :got], ref[src[lane]][0][:, :got],
                  "oracle against native", lane)
    stats.oracle_lanes += len(flagged)
    want = np.stack([ref[j][0] for j in src])
    check_lanes(cfg, seed, (out != want).reshape(len(src), -1).any(axis=1),
                out, want, lambda lane: "decode_frames_ex against native")
    stats.add("special", sizes.B, codec.fallback_frames)
    return packets, flagged


def content_corpus(cfg, seed: int, sizes: Sizes):
    """B adversarial frames, a content class drawn per lane, and their
    sample counts (partial tails as tools_fuzz_soak.py draws them)."""
    rng = np.random.default_rng(seed)
    x = np.stack([gen_adversarial(rng, cfg.num_channels, sizes.S,
                                  cfg.bit_depth) for _ in range(sizes.B)])
    nums = np.full(sizes.B, sizes.S)
    if rng.random() < 0.5:  # partial tails batched with full frames
        nums[rng.integers(0, sizes.B)] = int(rng.integers(1, sizes.S))
        nums[rng.integers(0, sizes.B)] = int(rng.integers(1, sizes.S))
    for b in range(sizes.B):
        x[b, :, nums[b]:] = 0
    return x, nums


def content_round(cfg, codec, seed: int, sizes: Sizes, stats: Stats):
    """encode_frames_ex == the native encoder (every lane) and the oracle
    (first lanes), then a lossless decode with the right nums."""
    from alacjax_torch.oracle import ALACEncoder
    t0 = time.perf_counter()
    x, nums = content_corpus(cfg, seed, sizes)
    stats.build_s += time.perf_counter() - t0
    pkts = codec.encode_frames_ex(x, nums)
    frames = [x[i, :, :nums[i]] for i in range(sizes.B)]
    check_packets(cfg, seed, pkts, native_encode(cfg, frames),
                  "encode_frames_ex against the native encoder")
    enc = ALACEncoder(cfg, independent_frames=True)
    n_or = min(sizes.content_oracle, sizes.B)
    check_packets(cfg, seed, pkts, [enc.encode_packet(frames[i])
                                    for i in range(n_or)],
                  "encode_frames_ex against the oracle")
    stats.oracle_lanes += n_or
    y, got = codec.decode_frames_ex(pkts)
    check_lanes(cfg, seed, got != nums, got, nums,
                lambda lane: "the decode's num against the encoded one")
    check_lanes(cfg, seed, (y != x).reshape(sizes.B, -1).any(axis=1), y, x,
                lambda lane: "decode of encode_frames_ex (lossless)")
    stats.add("content", sizes.B, codec.fallback_frames)
    return x, nums, pkts


def exhaustive_round(cfg, codec, seed: int, sizes: Sizes, stats: Stats):
    """Device exhaustive search == the native exhaustive encoder (every
    lane) and the oracle's (first lanes), byte for byte."""
    from alacjax_torch.oracle import ALACEncoder
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    x = np.stack([gen_adversarial(rng, cfg.num_channels, sizes.S,
                                  cfg.bit_depth) for _ in range(sizes.B)])
    stats.build_s += time.perf_counter() - t0
    pkts = codec.encode_frames(x)
    check_packets(cfg, seed, pkts, native_encode(cfg, list(x), "exhaustive"),
                  "exhaustive encode against the native exhaustive encoder")
    enc = ALACEncoder(cfg, independent_frames=True)  # inherits cfg.search
    n_or = min(sizes.exhaustive_oracle, sizes.B)
    check_packets(cfg, seed, pkts, [enc.encode_packet(x[i])
                                    for i in range(n_or)],
                  "exhaustive encode against the oracle")
    stats.oracle_lanes += n_or
    stats.add("exhaustive", sizes.B)
    return x, pkts


# ---------------------------------------------------------------------------
# fixed corpora
# ---------------------------------------------------------------------------
def _fixed_batch(cfg, codec, seed, distinct, label: str, stats: Stats):
    """``distinct`` (n, C, S) frames interleaved lane by lane to B: the
    packets equal the native encoder's, each with the native packet's
    escape bit, and decode losslessly."""
    B = codec.chunk
    x = distinct[np.arange(B) % len(distinct)]
    pkts = codec.encode_frames(x)
    want = native_encode(cfg, list(distinct))
    for lane in range(B):
        ref = want[lane % len(distinct)]
        if pkts[lane] != ref:
            raise Divergence(reproducer(cfg, seed, f"{label}, lane {lane} "
                                        f"(frame {lane % len(distinct)}): "
                                        f"{first_byte_diff(pkts[lane], ref)}"))
        if escaped(pkts[lane]) != escaped(ref):
            raise Divergence(reproducer(cfg, seed, f"{label}, lane {lane}: "
                                        "escape bit differs"))
    y = codec.decode_frames(pkts)
    check_lanes(cfg, seed, (y != x).reshape(B, -1).any(axis=1), y, x,
                lambda lane: f"{label} round trip")
    stats.add("fixed", B)
    return pkts


def pathological_round(kw: dict, sizes: Sizes, device, stats: Stats):
    """The five fixtures of one pathological config, interleaved to B."""
    cfg = AlacConfig(frame_length=sizes.S, **kw)
    x = pathological_fixtures(np.random.default_rng(PATHOLOGICAL_SEED),
                              cfg.num_channels, cfg.bit_depth, sizes.S)
    return x, _fixed_batch(cfg, codec_for(cfg, sizes, device),
                           PATHOLOGICAL_SEED, x, "pathological fixtures",
                           stats)


def find_flip(cfg, seed: int = FLIP_SEED) -> int:
    """The smallest noise amplitude whose frame escapes
    (tests/test_escape_boundary.py :: _find_flip), binary-searched with
    the native encoder; the oracle must escape at the flip and not one
    step below, or the run diverges."""
    from alacjax_torch import native
    from alacjax_torch.oracle import ALACEncoder
    depth, nch, S = cfg.bit_depth, cfg.num_channels, cfg.frame_length

    def escapes(amp, enc_cls):
        enc = enc_cls(cfg, independent_frames=True)
        return escaped(enc.encode_packet(flip_frame(seed, nch, depth, amp,
                                                    S)))

    lo, hi = 1, (1 << (depth - 1)) - 1
    if not escapes(hi, native.NativeEncoder):
        raise Divergence(reproducer(cfg, seed, "full-scale noise does not "
                                    "escape"))
    while lo < hi:
        mid = (lo + hi) // 2
        if escapes(mid, native.NativeEncoder):
            hi = mid
        else:
            lo = mid + 1
    if not escapes(lo, ALACEncoder) or escapes(lo - 1, ALACEncoder):
        raise Divergence(reproducer(cfg, seed, f"amplitude {lo} is not the "
                                    "oracle's escape flip"))
    return lo


def escape_flip_round(depth: int, nch: int, sizes: Sizes, device,
                      stats: Stats):
    """The pair (flip - 1, flip) of one depth and channel count, tiled
    lane by lane to B: the packets equal the native encoder's, the
    escape bit clear below the flip and set at it, lossless."""
    cfg = AlacConfig(bit_depth=depth, num_channels=nch,
                     frame_length=sizes.S)
    flip = find_flip(cfg)
    x = np.stack([flip_frame(FLIP_SEED, nch, depth, a, sizes.S)
                  for a in (flip - 1, flip)])
    pkts = _fixed_batch(cfg, codec_for(cfg, sizes, device), FLIP_SEED, x,
                        f"escape flip at amplitude {flip}", stats)
    if escaped(pkts[0]) or not escaped(pkts[1]):
        raise Divergence(reproducer(cfg, FLIP_SEED, f"the escape bit is "
                                    f"not on the sides of the flip {flip}"))
    return flip, x, pkts


def fixed_corpora(sizes: Sizes, device, stats: Stats, log=print):
    for name, kw in PATHOLOGICAL_CONFIGS:
        pathological_round(kw, sizes, device, stats)
        log(f"[soak] pathological {name}: {sizes.B} lanes clean")
    for depth in FLIP_DEPTHS:
        for nch in FLIP_CHANNELS:
            flip, _, _ = escape_flip_round(depth, nch, sizes, device, stats)
            log(f"[soak] escape flip {depth}-bit {nch} ch at amplitude "
                f"{flip}: {sizes.B} lanes clean")


def one_round(seed: int, sizes: Sizes, device, codecs, stats: Stats,
              log=print, pool=None):
    """Every grammar, DSE/FIL + deviant, content and exhaustive shape
    once at round seed ``seed``; the packets built over ``pool``."""
    # every grammar shape's packets in one build_packets call
    t0 = time.perf_counter()
    cfgs = [AlacConfig(bit_depth=d, num_channels=c, frame_length=sizes.S)
            for d, c in GRAMMAR_SHAPES]
    corpora = [grammar_corpus(cfg, 10_000_000 + seed, sizes) for cfg in cfgs]
    packets = build_packets(
        [cfg for cfg in cfgs for _ in range(sizes.grammar)],
        [p for c in corpora for p in c[0]], [p for c in corpora for p in c[1]],
        pool)
    stats.build_s += time.perf_counter() - t0
    for i, (cfg, (_, params, src)) in enumerate(zip(cfgs, corpora)):
        distinct = packets[i * sizes.grammar:(i + 1) * sizes.grammar]
        grammar_round(cfg, 10_000_000 + seed, sizes, device, stats,
                      built=(distinct, params, src))
    for d, c in SPECIAL_SHAPES:
        cfg = AlacConfig(bit_depth=d, num_channels=c, frame_length=sizes.S)
        special_round(cfg, 10_500_000 + seed, sizes, device, stats, pool)
    for cfg, codec in codecs["content"]:
        content_round(cfg, codec, 20_000_000 + seed, sizes, stats)
    for cfg, codec in codecs["exhaustive"]:
        exhaustive_round(cfg, codec, 30_000_000 + seed, sizes, stats)
    log(f"[soak] round seed {seed} clean ({len(GRAMMAR_SHAPES)} grammar + "
        f"{len(SPECIAL_SHAPES)} DSE/FIL and deviant + "
        f"{len(codecs['content'])} content + {len(codecs['exhaustive'])} "
        f"exhaustive shapes, {sizes.B} lanes each)", flush=True)


def make_codecs(sizes: Sizes, device):
    return dict(
        content=[(cfg, codec_for(cfg, sizes, device)) for cfg in (
            AlacConfig(bit_depth=d, num_channels=c, frame_length=sizes.S)
            for d, c in CONTENT_SHAPES)],
        exhaustive=[(cfg, codec_for(cfg, sizes, device)) for cfg in (
            AlacConfig(bit_depth=d, num_channels=c, frame_length=sizes.S,
                       search="exhaustive") for d, c in EXHAUSTIVE_SHAPES)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("minutes", nargs="?", type=float, default=30.0)
    p.add_argument("seed0", nargs="?", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device, seed0 = args.device, args.seed0
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("torch_fuzz_soak: no CUDA device (torch.cuda.is_available() "
              "is false); pass --device cpu to run the plain torch versions",
              file=sys.stderr)
        return 2
    sizes = CARD if device == "cuda" else CPU
    from alacjax_torch import native
    if not native.available():
        print(f"torch_fuzz_soak: native codec unavailable: "
              f"{native.build_error()}", file=sys.stderr)
        return 2
    t0 = time.time()
    deadline = t0 + args.minutes * 60
    codecs = make_codecs(sizes, device)
    stats = Stats()
    seed = seed0
    pool = host_pool() if device == "cuda" else None
    try:
        while time.time() < deadline:
            one_round(seed, sizes, device, codecs, stats, pool=pool)
            seed += 1
        fixed_corpora(sizes, device, stats)
    except Divergence as e:
        print(f"[soak] DIVERGENCE: {e}", flush=True)
        return 1
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    print(f"[soak] DONE: {seed - seed0} rounds clean at S={sizes.S}, "
          f"B={sizes.B} on {device}; rounds {stats.rounds}, lanes "
          f"{stats.lanes}; frames decode_frames_ex sent to the oracle "
          f"{stats.fallback}; lanes the scalar oracle checked "
          f"{stats.oracle_lanes}; corpus building {stats.build_s} s of "
          f"{time.time() - t0} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
