"""Bulk encode through the host API: one caller in a closed loop hands
``TorchCodec.encode_frames`` of ``get_codec(config)`` (its default
chunk) a batch of B full frames of planar int32 PCM in host memory and
gets the B packets back as ``bytes``: the pinned copy in, the device
encode of each chunk, the copy out and the packets' serdes.

Traffic parameters: ``batch`` (B), ``distinct`` (distinct frames per
batch, tiled to B with that period), ``batches`` (distinct batches,
cycled), ``check_frames`` (frames of the kept requests compared).

End to end: ``encode_fps``, the frames of the window's requests over
its seconds.  The benchmark's ``request`` span is around each request.

Check: the packets of a seeded sample of the kept requests' frames,
byte for byte, against the reference encoder's packets of the same
PCM."""

from __future__ import annotations

import torch

from benchmark.lib import common, inputs, roofline
from benchmark.ref import codec as rc

METRIC = "encode_fps"


class Cell:
    def __init__(self, ctx: common.Context):
        p = ctx.params
        self.ctx = ctx
        self.B, self.P, self.nb = p["batch"], p["distinct"], p["batches"]
        lay = ctx.layout
        self.pcm = inputs.music(self.nb * self.P, lay,
                                ctx.config["sample_rate"], ctx.seed, 1,
                                ctx.device).view(self.nb, self.P,
                                                 lay.channels,
                                                 lay.frame_length)
        host = self.pcm.cpu().numpy()
        lanes = inputs.tile(self.B, self.P, "cpu").numpy()
        self.x = [host[b][lanes] for b in range(self.nb)]
        from alacjax_torch import get_codec
        self.codec = get_codec(ctx.port_config, device=ctx.device, devices=1)
        for b in range(self.nb):          # warm-up: the cell's one shape
            self.request(b)
        common.sync(ctx.device)
        self.per_batch = [0] * self.nb
        self.keep = common.Keeper(ctx.seed)

    def request(self, b: int) -> list[bytes]:
        return self.codec.encode_frames(self.x[b])

    def run(self, seconds: float, tracer) -> dict:
        def step(i):
            b = i % self.nb
            with tracer.span("request"):
                out = self.request(b)
            self.per_batch[b] += 1
            self.keep.offer(i, (b, out))

        self.calls, self.seconds = common.closed_loop(seconds, tracer, step,
                                                      self.ctx.device)
        return {METRIC: self.calls * self.B / self.seconds}

    def check(self):
        """Checks and (attempted, failed): every kept request's sampled
        frames byte for byte against the reference encoder."""
        kept = self.keep.outputs()
        per = max(1, self.ctx.params["check_frames"] // len(kept))
        g = inputs.generator(self.ctx.seed, 98, "cpu")
        picks = [(b, torch.randperm(self.B, generator=g)[:per], out)
                 for _, (b, out) in sorted(kept.items())]
        frames = torch.cat([b * self.P + lanes % self.P
                            for b, lanes, _ in picks]).to(self.ctx.device)
        pcm = self.pcm.view(-1, *self.pcm.shape[2:])[frames]
        ref_img, ref_bits, _ = rc.encode(pcm, self.ctx.layout)
        ref = inputs.packet_bytes(inputs.as_i32(ref_img), ref_bits)
        failed = bad = k = 0
        for _, lanes, out in picks:
            got = ([out[int(ln)] for ln in lanes] if len(out) == self.B
                   else [None] * len(lanes))   # an answer of another size
            n = sum(a != b for a, b in zip(got, ref[k:k + len(lanes)]))
            bad += n
            failed += n > 0
            k += len(lanes)
        checks = {"packets_differing": (bad, 0)}
        info = {"packets_compared": k, "requests_compared": len(picks)}
        return checks, info, self.calls, failed

    def bounds(self, sms: int, clock: float) -> dict:
        """The cost kernel's least seconds for the window's requests: per
        device call of ``chunk`` frames the trial (7 streams per CPE of
        every frame, every 4th sample, order 8, one machine) and the
        search (every channel, orders 4 and 8, two machines), counted by
        the reference encoder over the distinct frames and tiled to the
        batch; the last chunk's padding frames are silent and left out."""
        lay = self.ctx.layout
        C, S = lay.channels, lay.frame_length
        _, _, st = rc.encode(self.pcm.view(-1, C, S), lay)
        st = {k: v.cpu() for k, v in st.items()
              if k.startswith(("trial", "search"))}
        n_cpe = sum(1 for _, w in lay.elements if w == 2)
        nd = (S + rc.DILATE - 1) // rc.DILATE
        chunk = self.codec.chunk
        total = 0.0
        for b in range(self.nb):
            lanes = b * self.P + inputs.tile(self.B, self.P, "cpu")
            sec = 0.0
            for off in range(0, self.B, chunk):
                part = lanes[off:off + chunk]
                if n_cpe:
                    L = 7 * n_cpe * chunk
                    sec += roofline.seconds(*roofline.cost_launch(
                        L, nd, (rc.TRIAL_ORDER,), False, L * nd,
                        int(st["trial_steps"][part].sum()),
                        int(st["trial_coded"][part].sum())), sms, clock)
                L = C * chunk
                sec += roofline.seconds(*roofline.cost_launch(
                    L, S, rc.ORDERS, True, L * S,
                    int(st["search_steps"][part].sum()),
                    int(st["search_coded"][part].sum())), sms, clock)
            total += sec * self.per_batch[b]
        return {"cost": total}


def setup(ctx: common.Context) -> Cell:
    return Cell(ctx)
