"""Whole-track encode on the card, the way a library is re-encoded: B
lanes, one track each, through ``alacjax_torch.codec.
encode_stream_device``, ``packets_per_call`` packets of every lane a
call, the predictor banks that a call returns handed to the next one.

Tracks and phases: the configuration's music, one continuous signal, is
cut into ``tracks`` tracks of ``track_packets`` packets.  Lane l plays
track l mod ``tracks`` over and over, starting at a phase drawn from the
seed, uniform over 0 .. track_packets - 1: at packet step s it encodes
the track's packet (phase + s) mod track_packets, and where that is
packet 0 a new track starts (``fresh``), its banks back at the fresh
coefficients; about lanes / track_packets lanes start a track a step.
The steps repeat with a period of track_packets, so the calls cycle over
track_packets / packets_per_call distinct inputs, made on the card in
the set-up.

Warm-up: one turn of that cycle, after which every lane has passed a
track start, so every packet of the window is its track's packet as the
stateful encoder writes it.

Traffic parameters: ``lanes`` (B), ``packets_per_call``,
``track_packets``, ``tracks``, ``check_lanes`` (lanes of every kept call
compared).

Counts: ``calls`` counts packet steps, the window's calls times
packets_per_call, so per-call metrics (launches, glue) read per step,
beside bulk_encode's per call at the same B.  ``encode_fps`` is lanes x
packets over the window's seconds.

Check: the benchmark's stateful reference (benchmark/ref/stream.py)
encodes every track once, track_packets sequential steps over
``tracks`` lanes, after the window; the packets of ``check_lanes`` lanes
drawn from the seed, every packet of each kept call, are compared byte
for byte, and any difference fails the call."""

from __future__ import annotations

import importlib
import sys
import time

import torch

from benchmark.lib import common, inputs, roofline
from benchmark.ref import codec as rc
from benchmark.ref import stream as rs

METRIC = "encode_fps"


class Cell:
    def __init__(self, ctx: common.Context):
        p = ctx.params
        self.ctx = ctx
        self.port = importlib.import_module("alacjax_torch.codec")
        self.B, self.K = p["lanes"], p["packets_per_call"]
        self.T, self.tracks = p["track_packets"], p["tracks"]
        if self.T % self.K:
            raise ValueError("track_packets must be a multiple of "
                             "packets_per_call")
        lay = ctx.layout
        dev = ctx.device
        self.pcm = inputs.music(self.tracks * self.T, lay,
                                ctx.config["sample_rate"], ctx.seed, 1,
                                dev).view(self.tracks, self.T, lay.channels,
                                          lay.frame_length)
        g = inputs.generator(ctx.seed, 4, "cpu")
        self.phase = torch.randint(0, self.T, (self.B,), generator=g)
        self.track = torch.arange(self.B) % self.tracks
        # input k holds steps k K .. k K + K - 1 of the cycle
        self.n_inputs = self.T // self.K
        self.packet = [(self.phase[:, None] + k * self.K
                        + torch.arange(self.K)[None, :]) % self.T
                       for k in range(self.n_inputs)]
        self.x, self.fresh = [], []
        tr = self.track.to(dev)[:, None]
        for pk in self.packet:
            self.x.append(self.pcm[tr, pk.to(dev)].contiguous())
            self.fresh.append((pk == 0).to(dev))
        self.words = self.port.TorchCodec(ctx.port_config, chunk=self.B,
                                          device=dev).num_words
        self.banks = None
        for k in range(self.n_inputs):     # warm-up: one turn of the cycle
            self.call(k)
        common.sync(dev)
        self.per_input = [0] * self.n_inputs
        self.keep = common.Keeper(ctx.seed)
        self.reference = None

    def call(self, k: int):
        words, bits, self.banks = self.port.encode_stream_device(
            self.x[k], self.ctx.port_config, self.words, banks=self.banks,
            fresh=self.fresh[k])
        return words, bits

    def run(self, seconds: float, tracer) -> dict:
        def step(i):
            k = i % self.n_inputs
            with tracer.span("call"):
                out = self.call(k)
            self.per_input[k] += 1
            self.keep.offer(i, (k, out))

        calls, self.seconds = common.closed_loop(seconds, tracer, step,
                                                 self.ctx.device)
        self.calls = calls * self.K
        return {METRIC: self.calls * self.B / self.seconds}

    def _reference(self):
        """The reference's packets and stats of every track, once."""
        if self.reference is None:
            t0 = time.perf_counter()
            img, bits, _, stats = rs.encode_stream(self.pcm, self.ctx.layout)
            packets = inputs.packet_bytes(
                inputs.as_i32(img.view(-1, img.shape[-1])), bits.view(-1))
            stats = {k: v.cpu() for k, v in stats.items()}
            self.reference = (packets, stats, time.perf_counter() - t0)
            print(f"[bench] reference: {self.tracks} tracks x {self.T} "
                  f"packets in {self.reference[2]} s", file=sys.stderr)
        return self.reference

    def check(self):
        """Checks and (attempted, failed), in packet steps: every kept
        call's packets of the sampled lanes byte for byte against the
        reference's packets of the same tracks."""
        ref, _, ref_s = self._reference()
        kept = self.keep.outputs()
        g = inputs.generator(self.ctx.seed, 98, "cpu")
        n = min(self.ctx.params["check_lanes"], self.B)
        bad_total = compared = failed = 0
        for _, (k, (words, bits)) in sorted(kept.items()):
            lanes = torch.randperm(self.B, generator=g)[:n]
            idx = lanes.to(words.device)
            got = inputs.packet_bytes(words[idx].view(-1, words.shape[-1]),
                                      bits[idx].view(-1))
            want = [ref[int(self.track[ln]) * self.T + int(p)]
                    for ln in lanes for p in self.packet[k][ln]]
            bad = sum(a != b for a, b in zip(got, want))
            bad_total += bad
            compared += len(got)
            failed += self.K if bad else 0
        checks = {"packets_differing": (bad_total, 0)}
        info = {"packets_compared": compared, "calls_compared": len(kept),
                "reference_s": ref_s}
        return checks, info, self.calls, failed

    def bounds(self, sms: int, clock: float) -> dict:
        """The cost kernel's least seconds for the window's steps: per
        step the trial (7 streams per CPE of every lane, every 4th sample,
        order 8, one machine) and the search (every channel, orders 4 and
        8 each from its own block of starting coefficients, two
        machines), counted by the reference over the tracks' packets each
        lane encodes at that step."""
        _, st, _ = self._reference()
        lay = self.ctx.layout
        C, S = lay.channels, lay.frame_length
        n_cpe = sum(1 for _, w in lay.elements if w == 2)
        nd = (S + rc.DILATE - 1) // rc.DILATE
        blocks = (len(rc.ORDERS) - 1) * C * self.B * rs.COEFS * roofline.I32
        total = 0.0
        for k in range(self.n_inputs):
            sec = 0.0
            for j in range(self.K):
                at = (self.track, self.packet[k][:, j])
                if n_cpe:
                    L = 7 * n_cpe * self.B
                    sec += roofline.seconds(*roofline.cost_launch(
                        L, nd, (rc.TRIAL_ORDER,), False, L * nd,
                        int(st["trial_steps"][at].sum()),
                        int(st["trial_coded"][at].sum())), sms, clock)
                L = C * self.B
                nbytes, ops = roofline.cost_launch(
                    L, S, rc.ORDERS, True, L * S,
                    int(st["search_steps"][at].sum()),
                    int(st["search_coded"][at].sum()))
                sec += roofline.seconds(nbytes + blocks, ops, sms, clock)
            total += sec * self.per_input[k]
        return {"cost": total}


def setup(ctx: common.Context) -> Cell:
    return Cell(ctx)
