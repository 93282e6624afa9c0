"""Frame-axis split over several devices (alacjax/parallel/sharding.py).

A chunk of B frames splits into contiguous shares of ceil(B / n) frames,
one per device, the last shares shorter or empty when B is small.  Each
share runs through TorchCodec's own ``_encode`` / ``_decode`` on its
device (every kernel launch holds a device guard for its input's card),
and the results are gathered, in order, on the first device.  A copy
between two cards is ordered against both cards' current streams
(PyTorch's peer copy waits for the work queued before it on either
side), so the host API's per-chunk event, recorded on the first device
after the gather, covers every share's work.  The host API above
(encode_frames/_ex, decode_frames/_ex with the retry ladder) is
TorchCodec's, unchanged: the ladder reads the gathered flags of the
whole chunk.  The same card may be listed more than once; its shares
then run one after the other on it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .. import codec as _codec
from ..types import AlacConfig


def frame_mesh(devices=None) -> tuple[torch.device, ...]:
    """The devices of the frames axis: every visible card by default, or
    ``devices`` (torch devices or their names, all of one type, repeats
    allowed).  A CUDA device without a card raises."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)] or ["cuda"]
    devs = tuple(_codec._resolve_device(d, "frame_mesh") for d in devices)
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"frame_mesh: devices of one type, not "
                         f"{[str(d) for d in devs]}")
    return devs


class ShardedCodec(_codec.TorchCodec):
    """TorchCodec whose chunks split across the devices of ``devices``
    (frame_mesh's default: every visible card).  The chunk rounds up to
    a multiple of the device count, so the host API's chunks split
    evenly; packets are byte-identical to the one-device codec's.
    ``roundtrip_step`` is the encode -> byte count -> decode step of the
    reference, its one cross-device sum included."""

    def __init__(self, config: AlacConfig, devices=None,
                 chunk: int = _codec.DEFAULT_CHUNK,
                 predict_legacy: bool = False):
        self.devices = frame_mesh(devices)
        n = len(self.devices)
        chunk = -(-chunk // n) * n
        super().__init__(config, chunk, device=self.devices[0],
                         predict_legacy=predict_legacy)

    def _split(self, fn, *tensors):
        """``fn`` on each device's share of the leading (frames) axis of
        ``tensors`` (None passes through), its outputs gathered, in
        order, on the first device."""
        B = tensors[0].shape[0]
        share = -(-B // len(self.devices))
        outs = []
        for k, dev in enumerate(self.devices):
            lo, hi = k * share, min((k + 1) * share, B)
            if lo >= hi:            # fewer frames than devices
                continue
            args = [None if t is None else t[lo:hi].to(dev, non_blocking=True)
                    for t in tensors]
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(fn(*args))
        return tuple(torch.cat([o[i].to(self.device, non_blocking=True)
                                for o in outs])
                     for i in range(len(outs[0])))

    def _encode(self, pcm, nums=None):
        return self._split(super()._encode, pcm, nums)

    def _decode(self, words, taps: int = _codec.fused_decode.TAPS):
        return self._split(functools.partial(super()._decode, taps=taps),
                           words)

    def roundtrip_step(self, pcm):
        """One split encode + decode of a (B, C, S) block of full frames
        (a tensor or an array): (decoded (B, C, S), words (B, W), bits
        (B,), total_bytes, mismatch, err (B,)), all on the first device.
        total_bytes (the packets' bytes) and mismatch (samples that did
        not come back) are each share's, summed across the devices."""
        if not isinstance(pcm, torch.Tensor):
            pcm = torch.from_numpy(np.asarray(pcm, dtype=np.int32))
        x = pcm.to(self.device, torch.int32)
        encode, decode = super()._encode, super()._decode

        def step(p):
            words, bits = encode(p)
            decoded, err, _ = decode(words)
            total = ((bits.to(torch.int64) + 7) // 8).sum().reshape(1)
            mismatch = (decoded != p).sum().reshape(1)
            return decoded, words, bits, total, mismatch, err

        decoded, words, bits, total, mismatch, err = self._split(step, x)
        return decoded, words, bits, total.sum(), mismatch.sum(), err
