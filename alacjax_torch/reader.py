"""Random-access decoding over ALAC files (CAF or M4A): the port's copy
of alacjax/reader.py.

Not in the reference — `convert-utility/main.cpp` only streams a whole
file front to back — but the format makes it free: ALAC packets carry no
cross-packet decoder state (every element transmits its own predictor
coefficients and Rice parameters), so ANY packet range decodes
independently.  This reader exposes that as sample-accurate seeking:
``read(start, count)`` touches only the packets covering the range.

With the torch backend the covering packets decode as one device batch
(codec.decode_frames_ex — partial tails included), so scrubbing through
a long file stays on the accelerator path.
"""

from __future__ import annotations

import numpy as np

from .containers.caf import read_caf
from .cookie import parse_cookie
from .types import AlacParamError


class AlacReader:
    """Sample-accurate random access over a .caf / .m4a / .mp4 file.

    reader = AlacReader("music.m4a")
    reader.num_samples, reader.num_channels, reader.sample_rate
    chunk = reader.read(start=1_000_000, count=44100)   # (C, count) int64
    """

    def __init__(self, path_or_bytes, backend: str = "oracle",
                 chunk: int | None = None, device="cuda", devices=None):
        if isinstance(path_or_bytes, str) and path_or_bytes.lower().endswith(
                (".m4a", ".mp4")):
            from .containers.mp4 import read_m4a
            self._caf = read_m4a(path_or_bytes)
        else:
            try:
                self._caf = read_caf(path_or_bytes)
            except AlacParamError:
                from .containers.mp4 import read_m4a
                self._caf = read_m4a(path_or_bytes)
        self.config = parse_cookie(self._caf.cookie)
        if self.config.num_channels != self._caf.num_channels:
            raise AlacParamError("cookie/desc channel count mismatch")
        self.backend = backend
        self._chunk = chunk  # device frames per launch (torch backend)
        self._device = device
        self._devices = devices
        self._codec = None   # lazy (torch backend only)

    # -- metadata ---------------------------------------------------------
    @property
    def num_samples(self) -> int:
        return self._caf.num_valid_frames

    @property
    def num_channels(self) -> int:
        return self._caf.num_channels

    @property
    def sample_rate(self) -> int:
        return self._caf.sample_rate

    @property
    def bit_depth(self) -> int:
        return self._caf.bit_depth

    def __len__(self) -> int:
        return self.num_samples

    # -- decoding ---------------------------------------------------------
    def _decode_packets(self, k0: int, k1: int) -> np.ndarray:
        """Decode packets [k0, k1) -> (C, n) planar samples."""
        S = self.config.frame_length
        pkts = self._caf.packets[k0:k1]
        # expected per-packet sample counts (only the stream tail may be
        # partial; sizes come from the container's frame count)
        want = [min(S, self.num_samples - (k0 + i) * S)
                for i in range(len(pkts))]
        if self.backend == "torch":
            if self._codec is None:
                from .codec import (
                    DEFAULT_CHUNK, _codec_key_config, get_codec,
                )
                self._codec = get_codec(_codec_key_config(self.config),
                                        self._chunk or DEFAULT_CHUNK,
                                        device=self._device,
                                        devices=self._devices)
            pcm, nums = self._codec.decode_frames_ex(pkts)
            for i, w in enumerate(want):
                if nums[i] != w:
                    raise AlacParamError(
                        f"packet {k0 + i} decoded {int(nums[i])} samples, "
                        f"expected {w}")
            return np.concatenate(
                [pcm[i, :, :want[i]] for i in range(len(pkts))], axis=1) \
                if pkts else np.zeros((self.num_channels, 0), np.int64)
        from .oracle import ALACDecoder
        dec = ALACDecoder(self.config)
        outs = []
        for i, pkt in enumerate(pkts):
            y, got = dec.decode_packet(
                pkt, num_samples=want[i] if want[i] != S else None)
            if got != want[i]:
                raise AlacParamError(
                    f"packet {k0 + i} decoded {got} samples, "
                    f"expected {want[i]}")
            outs.append(y[:, :got])
        return (np.concatenate(outs, axis=1) if outs
                else np.zeros((self.num_channels, 0), np.int64))

    def read(self, start: int = 0, count: int | None = None) -> np.ndarray:
        """Decode ``count`` samples from sample index ``start`` ->
        planar (C, n) int64.  Clamps at end of stream (n <= count, like a
        file read); only the packets covering the range are decoded."""
        if start < 0:
            raise AlacParamError("negative start")
        start = min(start, self.num_samples)
        end = (self.num_samples if count is None
               else min(start + max(count, 0), self.num_samples))
        if end <= start:
            return np.zeros((self.num_channels, 0), dtype=np.int64)
        S = self.config.frame_length
        k0, k1 = start // S, (end + S - 1) // S
        if k1 > len(self._caf.packets):
            raise AlacParamError("missing packets for requested range")
        pcm = self._decode_packets(k0, k1)
        return pcm[:, start - k0 * S: end - k0 * S]
