"""Inputs made from the seed, on the device: synthetic music (a copy of
bench_torch.py :: make_music, chords + vibrato + noise floor, with its
pitches, phases, delays and noise drawn from the seed), the tiling of
distinct frames to a batch, and the benchmark's packet writer."""

from __future__ import annotations

import math

import torch

from ..ref import codec as rc

I64 = torch.int64


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one purpose (``stream``) of one run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream * 7919) % (1 << 63))
    return g


def _voice(n: int, t, g, dev, base: float):
    """bench_torch.make_music's chord: a tone, its major third, and the
    octave below with a 5 Hz vibrato, over a noise floor of 120."""
    f = base * 2 ** (float(torch.randint(-12, 13, (1,), generator=g,
                                         device=dev).item()) / 12)
    ph = torch.rand((3,), generator=g, device=dev, dtype=torch.float64) \
        * 2 * math.pi
    two_pi = 2 * math.pi
    sig = (8000 * torch.sin(two_pi * f * t + ph[0])
           + 4000 * torch.sin(two_pi * f * 1.26 * t + ph[1])
           + 2000 * torch.sin(two_pi * f / 2 * t
                              * (1 + 0.001 * torch.sin(two_pi * 5 * t))
                              + ph[2]))
    return sig + 120 * torch.randn((n,), generator=g, device=dev,
                                   dtype=torch.float64)


def music(frames: int, lay: rc.Layout, sample_rate: int, seed: int,
          stream: int, device, samples: int | None = None):
    """(frames, C, S) int32 planar PCM of one continuous signal, cut into
    frames (zero past ``samples`` in all, when given).  Stereo: the chord
    and a delayed, quieter copy (bench_torch's right channel).  5.1: the
    centre and the front pair from one chord, the surround pair from a
    second, the LFE a low tone.  24-bit: scaled by 256 with noise in the
    low byte."""
    S = lay.frame_length
    n = frames * S
    dev = torch.device(device)
    g = generator(seed, stream, dev)
    t = torch.arange(n, device=dev, dtype=torch.float64) / sample_rate

    def delayed(sig):
        d = int(torch.randint(8, 41, (1,), generator=g, device=dev).item())
        return torch.roll(sig, d) * 0.92

    if lay.channels == 2:
        a = _voice(n, t, g, dev, 440.0)
        chans = [a, delayed(a)]
    elif lay.channels == 6:
        a = _voice(n, t, g, dev, 440.0)
        b = _voice(n, t, g, dev, 330.0)
        f_lfe = 30 + 50 * float(torch.rand((1,), generator=g, device=dev,
                                           dtype=torch.float64).item())
        lfe = 8000 * torch.sin(2 * math.pi * f_lfe * t)
        chans = [a * 0.8, a, delayed(a), b, delayed(b), lfe]
    else:
        raise ValueError(f"no music for {lay.channels} channels")
    x = torch.stack(chans)
    if lay.bit_depth == 24:
        x = x * 256 + torch.randint(-128, 128, x.shape, generator=g,
                                    device=dev, dtype=I64)
    lim = 1 << (lay.bit_depth - 1)
    x = torch.clamp(x.round(), -lim, lim - 1).to(torch.int32)
    if samples is not None:
        x[:, samples:] = 0
    return x.view(lay.channels, frames, S).transpose(0, 1).contiguous()


def order8_mask(frames: int, channels: int, share: float, seed: int,
                stream: int, device):
    """(frames, channels) bool: the channels the writer codes at order 8."""
    g = generator(seed, stream, torch.device(device))
    return torch.rand((frames, channels), generator=g, device=device) < share


def write(pcm, lay: rc.Layout, force8, num=None):
    """The benchmark's packets of ``pcm``: the reference encoder's stereo
    trial, then every channel at order 4 or, where ``force8`` (F, C) is
    set, order 8, stage 1 (no search).  Returns ((F, W) int32 word images
    as the port takes them, (F,) total bits, the encoder's stats)."""
    F, C = pcm.shape[:2]
    orders = torch.full((F, C), 4, dtype=I64, device=pcm.device)
    if force8 is not None:
        orders = torch.where(force8, 8, orders)
    img, bits, stats = rc.encode(pcm, lay, num=num, orders=orders)
    return as_i32(img), bits, stats


def as_i32(img):
    """uint32 words held in int64 -> the same bit patterns in int32."""
    return torch.where(img >= (1 << 31), img - (1 << 32), img).to(torch.int32)


def as_u32(words):
    return words.to(I64) & 0xFFFFFFFF


def packet_bytes(img_i32, bits) -> list[bytes]:
    """Per-frame packet bytes, truncated to ceil(bits / 8)."""
    w = img_i32.cpu().numpy().astype(">i4")
    nb = ((bits.cpu().to(I64) + 7) // 8).tolist()
    W4 = w.shape[1] * 4
    raw = w.tobytes()
    return [raw[i * W4:i * W4 + nb[i]] for i in range(w.shape[0])]


def tile(n: int, period: int, device):
    """Lane l of a batch of ``n`` holds distinct frame l % period."""
    return torch.arange(n, device=device) % period
