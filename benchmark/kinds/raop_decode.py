"""An AirPlay receiver's decode on the card: ``bulk_decode`` over RAOP
packets, one session a lane, each call
``alacjax_torch.codec.decode_frames_device(words, config, 352)`` (8 taps).

Two kinds of sender write the packets.  Apple's senders write compressed
CPE packets: the benchmark's writer (``inputs.write``: order 4, or 8 on
a seeded ``order8_share`` of channels, full frames).  PulseAudio's RAOP
sink writes every packet uncompressed, with the sample count in the
header and no END tag (``benchmark/ref/raop.py``).  A distinct packet is
PulseAudio's where a draw from the seed is below ``escape_share``, and
Apple's otherwise; lane l of a batch holds distinct packet l mod
``distinct``.

Traffic parameters: ``batch`` (B, sessions a call), ``distinct``
(distinct packets per batch, tiled to B with that period), ``batches``
(distinct batches, cycled), ``escape_share``, ``order8_share``.

Check: ``bulk_decode``'s, every frame of every kept call against the PCM
the packets were written from (samples, error flags, counts of 352);
and ``REF_LANES`` lanes of the window's last call, drawn from the seed
from both kinds, against the plain decoder ``benchmark/ref/codec.py ::
decode`` of the same packets, run on the same device: the same samples
and counts, and the reference flagging exactly PulseAudio's lanes (their
missing END tag, which it requires and the port does not)."""

from __future__ import annotations

import importlib

import torch

from benchmark.kinds import bulk_decode
from benchmark.lib import common, inputs, roofline
from benchmark.ref import codec as rc
from benchmark.ref import raop

REF_LANES = 256


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
        force8 = inputs.order8_mask(F, C, p["order8_share"], ctx.seed, 2,
                                    ctx.device)
        apple, _, self.stats = inputs.write(self.pcm, lay, force8)
        self.pulse = torch.rand((F,), generator=inputs.generator(
            ctx.seed, 4, ctx.device), device=ctx.device) < p["escape_share"]
        img = torch.where(self.pulse[:, None],
                          raop.write_uncompressed(self.pcm, lay), apple)
        del apple
        words = self.port.TorchCodec(ctx.port_config, chunk=self.B,
                                     device=ctx.device).num_words
        if img.shape[1] != words:
            raise RuntimeError(f"the writers' images are {img.shape[1]} "
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

    def ref_lanes(self, b: int):
        """Up to REF_LANES lanes of batch ``b`` drawn from the seed, half
        of them PulseAudio's and half Apple's where the batch holds
        enough of each."""
        g = inputs.generator(self.ctx.seed, 5, "cpu")
        kinds = self.pulse[self.lanes[b]].cpu()
        pulse = torch.nonzero(kinds)[:, 0]
        apple = torch.nonzero(~kinds)[:, 0]
        n_p = min(len(pulse), max(REF_LANES // 2, REF_LANES - len(apple)))
        n_a = min(len(apple), REF_LANES - n_p)
        pick = [pulse[torch.randperm(len(pulse), generator=g)[:n_p]],
                apple[torch.randperm(len(apple), generator=g)[:n_a]]]
        return torch.cat(pick).to(self.lanes[b].device)

    def check(self):
        """``bulk_decode``'s checks, and the reference's decode of the
        window's last call's ``ref_lanes``: a lane differs where its
        samples or count differ from the port's or where the reference's
        flag is not the lane's missing END tag (PulseAudio's lanes)."""
        checks, info, calls, failed = super().check()
        b, (pcm, port_err, num) = self.keep.last[1]
        ln = self.ref_lanes(b)
        want, n, err = rc.decode(inputs.as_u32(self.words[b][ln]),
                                 self.ctx.layout)
        if pcm.shape != self.pcm[self.lanes[b]].shape:
            differ = len(ln)              # an answer of another shape
            counted = True                # bulk_decode's check failed it
        else:
            differ = int(((pcm[ln].to(torch.int64) != want).flatten(1).any(1)
                          | (num[ln].to(torch.int64) != n)
                          | (err != self.pulse[self.lanes[b][ln]])).sum())
            counted = bool((pcm != self.pcm[self.lanes[b]]).any()
                           or port_err.any()
                           or (num != self.ctx.layout.frame_length).any())
        checks["ref_lanes_differ"] = (differ, 0)
        info = dict(info, ref_lanes_compared=len(ln),
                    pulse_share=float(self.pulse.float().mean()))
        return checks, info, calls, failed + (differ > 0 and not counted)

    def bounds(self, sms: int, clock: float) -> dict:
        """The 8-tap decode kernel's least seconds for the window's calls,
        from the writer's counts, as ``bulk_decode`` counts them, over
        Apple's lanes alone: an escaped lane's samples need no walk."""
        st = self.stats
        S = self.ctx.layout.frame_length
        total = 0.0
        for b in range(self.nb):
            ln = self.lanes[b][~self.pulse[self.lanes[b]]]
            if not len(ln):
                continue
            n = torch.full((len(ln),), S, dtype=torch.int64, device=ln.device)
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
