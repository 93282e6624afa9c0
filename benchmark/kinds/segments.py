"""Segment decodes through the host API: one caller in a closed loop
hands ``TorchCodec.decode_frames_ex`` of ``get_codec(config)`` (its
default chunk) the packet bytes of one segment and gets numpy PCM back.
Each request is ``segment_packets`` consecutive packets of a track,
segments cut from the track's start; the tracks' last packets are
partial.  The requests are every segment of every track, in an order
drawn from the seed, cycled.

Traffic parameters: ``tracks``, ``track_seconds``, ``segment_packets``,
``order8_share`` (as in bulk_decode), ``check_requests`` (requests kept
for the check).

End to end: ``segment_ms``, the mean latency of all the window's
requests (the window over the requests, one caller in a closed loop).
The 95th percentile of the same latencies is kept in ``record`` for the
per-layer ``segment_p95_ms``: on one card's shared host it spreads too
widely between runs to carry a regression bound.

Check: the kept requests' PCM and sample counts against the PCM the
packets were written from, and the frames the host API sent to its
scalar oracle in the whole window (a request that sent any failed)."""

from __future__ import annotations

import time

import torch

from benchmark.lib import common, inputs

METRIC = "segment_ms"


class Cell:
    def __init__(self, ctx: common.Context):
        p = ctx.params
        self.ctx = ctx
        lay = ctx.layout
        S, C = lay.frame_length, lay.channels
        rate = ctx.config["sample_rate"]
        n_samples = p["track_seconds"] * rate
        self.F = -(-n_samples // S)              # packets per track
        T = p["tracks"]
        self.pcm = torch.stack([
            inputs.music(self.F, lay, rate, ctx.seed, 10 + t, ctx.device,
                         samples=n_samples) for t in range(T)])
        num = torch.full((self.F,), S, dtype=torch.int64, device=ctx.device)
        num[-1] = n_samples - (self.F - 1) * S
        self.num = num
        force8 = inputs.order8_mask(T * self.F, C, p["order8_share"],
                                    ctx.seed, 2, ctx.device)
        img, bits, _ = inputs.write(self.pcm.view(-1, C, S), lay, force8,
                                    num=num.repeat(T))
        packets = inputs.packet_bytes(img, bits)
        del img
        self.tracks = [packets[t * self.F:(t + 1) * self.F]
                       for t in range(T)]
        k = p["segment_packets"]
        self.pool = [(t, s) for t in range(T)
                     for s in range(0, self.F, k)]
        g = inputs.generator(ctx.seed, 3, "cpu")
        self.order = torch.randperm(len(self.pool), generator=g).tolist()
        from alacjax_torch import get_codec
        self.codec = get_codec(ctx.port_config, device=ctx.device, devices=1)
        # warm-up: a whole segment and the partial last one
        for t, s in (self.pool[0], self.pool[-1]):
            self.request(t, s)
        common.sync(ctx.device)
        self.keep = common.Keeper(ctx.seed, first=2,
                                  early=p["check_requests"] - 3,
                                  horizon=200)

    def request(self, t: int, s: int):
        return self.codec.decode_frames_ex(
            self.tracks[t][s:s + self.ctx.params["segment_packets"]])

    def run(self, seconds: float, tracer) -> dict:
        self.lat = []
        self.oracle_frames = 0
        self.failed_requests = 0

        def step(i):
            t, s = self.pool[self.order[i % len(self.pool)]]
            before = self.codec.fallback_frames
            with tracer.span("request"):
                t0 = time.perf_counter()
                out = self.request(t, s)
                self.lat.append(time.perf_counter() - t0)
            grew = self.codec.fallback_frames - before
            self.oracle_frames += grew
            self.failed_requests += grew > 0
            self.keep.offer(i, (t, s, out))

        self.calls, self.seconds = common.closed_loop(seconds, tracer, step,
                                                      self.ctx.device)
        self.record = {"latency_ms": [x * 1e3 for x in self.lat]}
        return {METRIC: self.seconds / self.calls * 1e3}

    def check(self):
        """Checks and (attempted, failed)."""
        k = self.ctx.params["segment_packets"]
        wrong = counts = frames = 0
        failed = self.failed_requests
        for _, (t, s, (pcm, nums)) in sorted(self.keep.outputs().items()):
            want = self.pcm[t, s:s + k].to(torch.int64).cpu().numpy()
            want_n = self.num[s:s + k].cpu().numpy()
            n = want.shape[0]
            if pcm.shape != want.shape or nums.shape != want_n.shape:
                w = c = n                 # an answer of another request
            else:
                w = int((pcm != want).reshape(n, -1).any(1).sum())
                c = int((nums != want_n).sum())
            wrong, counts = wrong + w, counts + c
            failed += (w + c) > 0
            frames += n
        checks = {"frames_wrong": (wrong, 0), "counts_wrong": (counts, 0),
                  "frames_to_oracle": (self.oracle_frames, 0)}
        return checks, {"frames_compared": frames}, self.calls, failed

    def bounds(self, sms: int, clock: float) -> dict:
        return {}


def setup(ctx: common.Context) -> Cell:
    return Cell(ctx)
