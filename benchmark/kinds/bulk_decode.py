"""Bulk decode on the card: (B, W) word images of the benchmark's own
packets sit on the card and go through
``alacjax_torch.codec.decode_frames_device`` (8 taps, chained) back to
back; the PCM stays there.

Traffic parameters: ``batch`` (B), ``distinct`` (distinct packets per
batch, tiled to B with that period), ``batches`` (distinct batches,
cycled), ``order8_share`` (the share of channels the writer codes at
order 8; the standard search picks order 4 on nearly every channel of
this music).

Check: every frame of every kept call against the PCM the packets were
written from: the samples, the error flags and the sample counts."""

from __future__ import annotations

import importlib

import torch

from benchmark.lib import common, inputs, roofline

METRIC = "decode_fps"


class Cell:
    def __init__(self, ctx: common.Context):
        p = ctx.params
        self.ctx = ctx
        self.port = importlib.import_module("alacjax_torch.codec")
        self.B, self.P, self.nb = p["batch"], p["distinct"], p["batches"]
        lay = ctx.layout
        C, S = lay.channels, lay.frame_length
        F = self.nb * self.P
        self.pcm = inputs.music(F, lay, ctx.config["sample_rate"], ctx.seed,
                                1, ctx.device)
        force8 = inputs.order8_mask(F, C, p["order8_share"], ctx.seed, 2,
                                    ctx.device)
        img, _, self.stats = inputs.write(self.pcm, lay, force8)
        words = self.port.TorchCodec(ctx.port_config, chunk=self.B,
                                     device=ctx.device).num_words
        if img.shape[1] != words:
            raise RuntimeError(f"the writer's images are {img.shape[1]} "
                               f"words wide, the port's {words}")
        self.lanes = [b * self.P + inputs.tile(self.B, self.P, ctx.device)
                      for b in range(self.nb)]
        self.words = [img[ln].contiguous() for ln in self.lanes]
        del img
        for b in range(self.nb):          # warm-up: the cell's one shape
            self.call(b)
        common.sync(ctx.device)
        self.per_batch = [0] * self.nb
        self.keep = common.Keeper(ctx.seed)

    def call(self, b: int):
        return self.port.decode_frames_device(
            self.words[b], self.ctx.port_config, self.ctx.layout.frame_length)

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
        """Checks and (attempted, failed): every frame of the kept calls."""
        S = self.ctx.layout.frame_length
        wrong = flagged = counts = failed = frames = 0
        for _, (b, (pcm, err, num)) in sorted(self.keep.outputs().items()):
            want = self.pcm[self.lanes[b]].to(torch.int64)
            if pcm.shape != want.shape:
                w = f = c = self.B        # an answer of another shape
            else:
                w = int((pcm.to(torch.int64) != want).flatten(1).any(1).sum())
                f = int(err.sum())
                c = int((num.to(torch.int64) != S).sum())
            wrong, flagged, counts = wrong + w, flagged + f, counts + c
            failed += (w + f + c) > 0
            frames += self.B
        checks = {"frames_wrong": (wrong, 0), "frames_flagged": (flagged, 0),
                  "counts_wrong": (counts, 0)}
        return checks, {"frames_compared": frames}, self.calls, failed

    def bounds(self, sms: int, clock: float) -> dict:
        """The 8-tap decode kernel's least seconds for the window's calls:
        one launch per channel of the batch, from the writer's counts."""
        st = self.stats
        S = self.ctx.layout.frame_length
        total = 0.0
        for b in range(self.nb):
            ln = self.lanes[b]
            n = torch.full((self.B,), S, dtype=torch.int64, device=ln.device)
            sec = 0.0
            for c in range(self.ctx.layout.channels):
                sec += roofline.seconds(*roofline.decode_launch(
                    n, st["order"][c][ln], st["mode"][c][ln],
                    st["coded"][c][ln], st["steps"][c][ln],
                    st["rice_bits"][c][ln], S), sms, clock)
            total += sec * self.per_batch[b]
        return {"decode": total}


def setup(ctx: common.Context) -> Cell:
    return Cell(ctx)
