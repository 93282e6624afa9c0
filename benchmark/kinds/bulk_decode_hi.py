"""Bulk decode of high-order packets on the card: ``bulk_decode`` with the
packets of FFmpeg's encoder at ``-max_prediction_order 30``
(benchmark/ref/highorder.py), each call
``alacjax_torch.codec.decode_frames_device(..., taps=30)``: the parse at
30 coefficients and every channel's scan on the 30-tap walk.

Traffic parameters: ``batch`` (B), ``distinct`` (distinct packets per
batch, tiled to B with that period), ``batches`` (distinct batches,
cycled), ``orders`` ([lowest, highest]: every channel of every distinct
frame takes an order drawn from the seed, uniform over that range).

Check: ``bulk_decode``'s, every frame of every kept call against the
PCM the packets were written from."""

from __future__ import annotations

import importlib

import torch

from benchmark.kinds import bulk_decode
from benchmark.lib import common, inputs
from benchmark.ref import highorder

TAPS = 30                 # the widest walk: every order the writer gives


class Cell(bulk_decode.Cell):
    def __init__(self, ctx: common.Context):
        p = ctx.params
        self.ctx = ctx
        self.port = importlib.import_module("alacjax_torch.codec")
        self.B, self.P, self.nb = p["batch"], p["distinct"], p["batches"]
        lay = ctx.layout
        C = lay.channels
        F = self.nb * self.P
        self.pcm = inputs.music(F, lay, ctx.config["sample_rate"], ctx.seed,
                                1, ctx.device)
        lo, hi = p["orders"]
        orders = torch.randint(lo, hi + 1, (F, C),
                               generator=inputs.generator(ctx.seed, 3,
                                                          ctx.device),
                               device=ctx.device)
        img, _, self.stats = highorder.encode(self.pcm, lay, orders)
        img = inputs.as_i32(img)
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
            self.words[b], self.ctx.port_config, self.ctx.layout.frame_length,
            taps=TAPS)

    def bounds(self, sms: int, clock: float) -> dict:
        """``bulk_decode``'s bound, one launch per channel of a batch from
        the writer's counts, here of the 30-tap launches."""
        return {"decode_hi": super().bounds(sms, clock)["decode"]}


def setup(ctx: common.Context) -> Cell:
    return Cell(ctx)
