"""WAV (RIFF) read/write for PCM at 16/20/24/32 bits (the port's copy of
alacjax/containers/wav.py).

Rebuild of the reference CLI's WAV handling (convert-utility/main.cpp:
RIFF/fmt/data parse, PCM and WAVE_FORMAT_EXTENSIBLE; SURVEY.md §2 row 13).
"""

from __future__ import annotations

import dataclasses
import struct

from ..types import AlacParamError

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
_KSDATAFORMAT_SUBTYPE_PCM = (
    b"\x01\x00\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
)


@dataclasses.dataclass
class WavFile:
    sample_rate: int
    bit_depth: int          # valid bits: 16/20/24/32
    num_channels: int
    data: bytes             # interleaved little-endian PCM payload

    @property
    def container_bytes(self) -> int:
        return 3 if self.bit_depth in (20, 24) else self.bit_depth // 8

    @property
    def num_frames(self) -> int:
        return len(self.data) // (self.container_bytes * self.num_channels)


def _parse_fmt(fmt: bytes):
    """Validate a fmt chunk -> (rate, valid_bits, nch, container_bits)."""
    (tag, nch, rate, _brate, _align, container_bits) = struct.unpack_from(
        "<HHIIHH", fmt, 0)
    valid_bits = container_bits
    if tag == WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 40:
            raise AlacParamError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        (cb_size, valid_bits) = struct.unpack_from("<HH", fmt, 16)
        sub = fmt[24:40]
        if sub != _KSDATAFORMAT_SUBTYPE_PCM:
            raise AlacParamError("extensible WAV is not integer PCM")
    elif tag != WAVE_FORMAT_PCM:
        raise AlacParamError(f"unsupported WAV format tag 0x{tag:04x}")

    if valid_bits not in (16, 20, 24, 32):
        raise AlacParamError(f"unsupported WAV bit depth {valid_bits}")
    expected_container = 24 if valid_bits == 20 else valid_bits
    if container_bits != expected_container:
        raise AlacParamError(
            f"container {container_bits} bits with {valid_bits} valid bits unsupported")
    return rate, valid_bits, nch, container_bits


def read_wav(path_or_bytes) -> WavFile:
    blob = _as_bytes(path_or_bytes)
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise AlacParamError("not a RIFF/WAVE file")

    fmt = None
    data = None
    pos = 12
    while pos + 8 <= len(blob):
        cid, size = struct.unpack_from("<4sI", blob, pos)
        pos += 8
        body = blob[pos:pos + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += size + (size & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise AlacParamError("WAV missing fmt or data chunk")

    rate, valid_bits, nch, container_bits = _parse_fmt(fmt)
    frame_bytes = (container_bits // 8) * nch
    usable = len(data) - (len(data) % frame_bytes)
    return WavFile(sample_rate=rate, bit_depth=valid_bits, num_channels=nch,
                   data=data[:usable])


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    bit_depth: int
    num_channels: int
    num_samples: int


def probe_wav(path: str) -> WavInfo:
    """Header-only probe: fmt fields + the data chunk's sample count
    WITHOUT loading the payload — batch planning over thousands of files
    stays O(one header) in memory (batch.convert_many)."""
    import os

    with open(path, "rb") as f:
        file_size = os.fstat(f.fileno()).st_size
        head = f.read(12)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise AlacParamError("not a RIFF/WAVE file")
        fmt = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            size = min(size, max(0, file_size - f.tell()))  # truncated files
            if cid == b"fmt ":
                fmt = f.read(size)
                if size & 1:
                    f.seek(1, 1)
            else:
                if cid == b"data":
                    data_size = size
                f.seek(size + (size & 1), 1)
    if fmt is None or data_size is None:
        raise AlacParamError("WAV missing fmt or data chunk")
    rate, valid_bits, nch, container_bits = _parse_fmt(fmt)
    frame_bytes = (container_bits // 8) * nch
    return WavInfo(sample_rate=rate, bit_depth=valid_bits, num_channels=nch,
                   num_samples=data_size // frame_bytes)


def write_wav(wav: WavFile, path: str | None = None) -> bytes:
    container_bits = wav.container_bytes * 8
    block_align = wav.container_bytes * wav.num_channels
    byte_rate = wav.sample_rate * block_align

    if wav.bit_depth == 16:
        fmt = struct.pack("<HHIIHH", WAVE_FORMAT_PCM, wav.num_channels,
                          wav.sample_rate, byte_rate, block_align, container_bits)
    else:
        # >16-bit: WAVE_FORMAT_EXTENSIBLE, as the reference CLI emits
        fmt = struct.pack(
            "<HHIIHHHHI", WAVE_FORMAT_EXTENSIBLE, wav.num_channels,
            wav.sample_rate, byte_rate, block_align, container_bits,
            22, wav.bit_depth, (1 << wav.num_channels) - 1,
        ) + _KSDATAFORMAT_SUBTYPE_PCM

    chunks = b"".join([
        b"fmt ", struct.pack("<I", len(fmt)), fmt,
        b"data", struct.pack("<I", len(wav.data)), wav.data,
        b"\x00" if len(wav.data) & 1 else b"",
    ])
    blob = b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _as_bytes(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()
