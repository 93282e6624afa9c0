"""Bulk encode on the card: batches of B full frames of PCM that sit on
the card go through ``alacjax_torch.codec.encode_frames_device`` back
to back; the word images and bit counts stay there.

Traffic parameters: ``batch`` (B), ``distinct`` (distinct frames per
batch, tiled to B with that period), ``batches`` (distinct batches,
cycled), ``check_frames`` (frames of the kept calls compared).

Check: the packets of a seeded sample of the kept calls' frames, byte
for byte, against the reference encoder's packets of the same PCM."""

from __future__ import annotations

import importlib

import torch

from benchmark.lib import common, inputs, roofline
from benchmark.ref import codec as rc

METRIC = "encode_fps"


class Cell:
    def __init__(self, ctx: common.Context):
        p = ctx.params
        self.ctx = ctx
        self.port = importlib.import_module("alacjax_torch.codec")
        self.B, self.P, self.nb = p["batch"], p["distinct"], p["batches"]
        lay = ctx.layout
        self.pcm = inputs.music(self.nb * self.P, lay,
                                ctx.config["sample_rate"], ctx.seed, 1,
                                ctx.device).view(self.nb, self.P,
                                                 lay.channels,
                                                 lay.frame_length)
        lanes = inputs.tile(self.B, self.P, ctx.device)
        self.x = [self.pcm[b][lanes].contiguous() for b in range(self.nb)]
        self.words = self.port.TorchCodec(ctx.port_config, chunk=self.B,
                                          device=ctx.device).num_words
        for b in range(self.nb):          # warm-up: the cell's one shape
            self.call(b)
        common.sync(ctx.device)
        self.per_batch = [0] * self.nb
        self.keep = common.Keeper(ctx.seed)

    def call(self, b: int):
        return self.port.encode_frames_device(self.x[b], self.ctx.port_config,
                                              self.words)

    def run(self, seconds: float, tracer) -> dict:
        def step(i):
            b = i % self.nb
            with tracer.span("call"):
                out = self.call(b)
            self.per_batch[b] += 1
            self.keep.offer(i, (b, out))

        self.calls, self.seconds = common.closed_loop(seconds, tracer, step,
                                                      self.ctx.device)
        return {METRIC: self.calls * self.B / self.seconds}

    def check(self):
        """Checks and (attempted, failed): every kept call's sampled
        frames byte for byte against the reference encoder."""
        kept = self.keep.outputs()
        per = max(1, self.ctx.params["check_frames"] // len(kept))
        g = inputs.generator(self.ctx.seed, 98, "cpu")
        picks = []
        for i, (b, (words, bits)) in sorted(kept.items()):
            lanes = torch.randperm(self.B, generator=g)[:per]
            picks.append((i, b, lanes, words[lanes.to(words.device)],
                          bits[lanes.to(bits.device)]))
        frames = torch.cat([b * self.P + lanes % self.P
                            for _, b, lanes, _, _ in picks]).to(self.ctx.device)
        pcm = self.pcm.view(-1, *self.pcm.shape[2:])[frames]
        ref_img, ref_bits, _ = rc.encode(pcm, self.ctx.layout)
        ref = inputs.packet_bytes(inputs.as_i32(ref_img), ref_bits)
        got = []
        for _, _, _, w, bt in picks:
            got += inputs.packet_bytes(w, bt)
        bad = [a != b for a, b in zip(got, ref)]
        failed, k = 0, 0
        for _, _, lanes, _, _ in picks:
            failed += any(bad[k:k + len(lanes)])
            k += len(lanes)
        checks = {"packets_differing": (sum(bad), 0)}
        info = {"packets_compared": len(bad), "calls_compared": len(picks)}
        return checks, info, self.calls, failed

    def bounds(self, sms: int, clock: float) -> dict:
        """The cost kernel's least seconds for the window's calls: per call
        the trial (7 streams per CPE of every frame, every 4th sample,
        order 8, one machine) and the search (every channel, orders 4 and
        8, two machines), counted by the reference encoder over the
        distinct frames and tiled to the batch."""
        lay = self.ctx.layout
        C, S = lay.channels, lay.frame_length
        _, _, st = rc.encode(self.pcm.view(-1, C, S), lay)
        total = 0.0
        for b in range(self.nb):
            lanes = b * self.P + inputs.tile(self.B, self.P, self.ctx.device)
            n_cpe = sum(1 for _, w in lay.elements if w == 2)
            sec = 0.0
            if n_cpe:
                nd = (S + rc.DILATE - 1) // rc.DILATE
                L = 7 * n_cpe * self.B
                sec += roofline.seconds(*roofline.cost_launch(
                    L, nd, (rc.TRIAL_ORDER,), False, L * nd,
                    int(st["trial_steps"][lanes].sum()),
                    int(st["trial_coded"][lanes].sum())), sms, clock)
            L = C * self.B
            sec += roofline.seconds(*roofline.cost_launch(
                L, S, rc.ORDERS, True, L * S,
                int(st["search_steps"][lanes].sum()),
                int(st["search_coded"][lanes].sum())), sms, clock)
            total += sec * self.per_batch[b]
        return {"cost": total}


def setup(ctx: common.Context) -> Cell:
    return Cell(ctx)
