"""Interleaved wire PCM <-> planar right-aligned int arrays (the port's
copy of alacjax/containers/pcm.py).

The reference fuses these conversions into matrix_enc.c/matrix_dec.c's
depth-specific mix/unmix variants; here they are a standalone, vectorized
boundary so the DSP core sees one canonical representation: planar int64,
each sample the right-aligned signed value at bit_depth.

Wire formats (little-endian, WAV convention):
  16-bit: int16
  20-bit: 3 bytes per sample, value left-justified (low 4 bits zero on
          typical sources; they are DROPPED on unpack, as the reference's
          mix20 drops them — 20-bit mode codes the top 20 bits only)
  24-bit: 3 bytes per sample
  32-bit: int32
"""

from __future__ import annotations

import numpy as np

from ..types import AlacParamError


def unpack_pcm(data: bytes, bit_depth: int, num_channels: int) -> np.ndarray:
    """Interleaved little-endian wire bytes -> planar (C, n) int64."""
    bpf = _bytes_per_sample(bit_depth) * num_channels
    if len(data) % bpf:
        raise AlacParamError("PCM byte count not a multiple of the frame size")
    n = len(data) // bpf
    if bit_depth == 16:
        vals = np.frombuffer(data, dtype="<i2").astype(np.int64)
    elif bit_depth == 32:
        vals = np.frombuffer(data, dtype="<i4").astype(np.int64)
    else:  # 20/24-bit in 3-byte containers
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3).astype(np.int64)
        vals = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        if bit_depth == 20:
            vals >>= 4
    return vals.reshape(n, num_channels).T.copy()


def pack_pcm(samples: np.ndarray, bit_depth: int) -> bytes:
    """Planar (C, n) int64 -> interleaved little-endian wire bytes."""
    samples = np.asarray(samples, dtype=np.int64)
    inter = samples.T.reshape(-1)
    if bit_depth == 16:
        return inter.astype("<i2").tobytes()
    if bit_depth == 32:
        return inter.astype("<i4").tobytes()
    vals = inter << 4 if bit_depth == 20 else inter
    vals = np.where(vals < 0, vals + (1 << 24), vals)
    out = np.empty((inter.size, 3), dtype=np.uint8)
    out[:, 0] = vals & 0xFF
    out[:, 1] = (vals >> 8) & 0xFF
    out[:, 2] = (vals >> 16) & 0xFF
    return out.tobytes()


def _bytes_per_sample(bit_depth: int) -> int:
    if bit_depth == 16:
        return 2
    if bit_depth in (20, 24):
        return 3
    if bit_depth == 32:
        return 4
    raise AlacParamError(f"unsupported bit depth {bit_depth}")


bytes_per_sample = _bytes_per_sample
