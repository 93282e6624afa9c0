"""CAF (Core Audio Format) container for ALAC packets (the port's copy of
alacjax/containers/caf.py).

Rebuild of the reference's convert-utility/CAFFileALAC.{h,cpp}
(SURVEY.md §2 row 12): 'caff' header, 'desc' audio description, optional
'chan' layout, 'kuki' magic cookie, 'pakt' packet table with BER
variable-length packet sizes, and the 'data' chunk.  Big-endian throughout.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..types import AlacConfig, AlacParamError, ALAC_CHANNEL_LAYOUT_TAGS

# desc.mFormatFlags for fourcc 'alac' encodes the source bit depth
# (CAFFileALAC.h kALACFormatFlag_*BitSourceData)
_DEPTH_TO_FLAG = {16: 1, 20: 2, 24: 3, 32: 4}
_FLAG_TO_DEPTH = {v: k for k, v in _DEPTH_TO_FLAG.items()}


@dataclasses.dataclass
class CafFile:
    sample_rate: int
    bit_depth: int
    num_channels: int
    frames_per_packet: int
    cookie: bytes
    packets: list[bytes]
    num_valid_frames: int
    priming_frames: int = 0
    remainder_frames: int = 0


# ---------------------------------------------------------------------------
# BER variable-length integers (pakt packet sizes)
# ---------------------------------------------------------------------------
def ber_encode(values) -> bytes:
    """Encode u32 values as BER: 7 bits/byte, MSB-first groups, high bit set
    on all but the final byte of each value (CAFFileALAC :: packet table)."""
    out = bytearray()
    for v in values:
        v = int(v)
        if v < 0:
            raise AlacParamError("negative packet size")
        groups = [v & 0x7F]
        v >>= 7
        while v:
            groups.append(0x80 | (v & 0x7F))
            v >>= 7
        out.extend(reversed(groups))
    return bytes(out)


def ber_decode(data: bytes, count: int) -> tuple[list[int], int]:
    """Decode ``count`` BER integers; returns (values, bytes_consumed)."""
    values = []
    pos = 0
    for _ in range(count):
        v = 0
        while True:
            if pos >= len(data):
                raise AlacParamError("truncated BER packet table")
            byte = data[pos]
            pos += 1
            v = (v << 7) | (byte & 0x7F)
            if not byte & 0x80:
                break
            if v > 0xFFFFFFFF:
                raise AlacParamError("BER integer overflow")
        values.append(v)
    return values, pos


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------
def write_caf(caf: CafFile, path: str | None = None) -> bytes:
    def chunk(cid: bytes, body: bytes) -> bytes:
        return cid + struct.pack(">q", len(body)) + body

    desc = struct.pack(
        ">d4sIIIII",
        float(caf.sample_rate), b"alac", _DEPTH_TO_FLAG[caf.bit_depth],
        0,                          # bytesPerPacket (0 = variable)
        caf.frames_per_packet,
        caf.num_channels,
        0,                          # bitsPerChannel (0 for compressed)
    )

    parts = [b"caff", struct.pack(">HH", 1, 0), chunk(b"desc", desc)]

    if caf.num_channels > 2:
        tag = ALAC_CHANNEL_LAYOUT_TAGS[caf.num_channels]
        parts.append(chunk(b"chan", struct.pack(">III", tag, 0, 0)))

    parts.append(chunk(b"kuki", caf.cookie))

    pakt_body = struct.pack(
        ">qqii", len(caf.packets), caf.num_valid_frames,
        caf.priming_frames, caf.remainder_frames,
    ) + ber_encode(map(len, caf.packets))
    parts.append(chunk(b"pakt", pakt_body))

    data_body = struct.pack(">I", 0) + b"".join(caf.packets)  # u32 editCount
    parts.append(chunk(b"data", data_body))

    blob = b"".join(parts)
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------
def read_caf(path_or_bytes) -> CafFile:
    blob = _as_bytes(path_or_bytes)
    if len(blob) < 8 or blob[0:4] != b"caff":
        raise AlacParamError("not a CAF file")

    chunks: dict[bytes, bytes] = {}
    pos = 8
    while pos + 12 <= len(blob):
        cid, size = struct.unpack_from(">4sq", blob, pos)
        pos += 12
        if size == -1:  # data chunk may declare unknown size: runs to EOF
            size = len(blob) - pos
        if size < 0 or pos + size > len(blob):
            raise AlacParamError(f"truncated CAF chunk {cid!r}")
        if cid not in chunks:  # first occurrence wins; skip unknown chunks
            chunks[cid] = blob[pos:pos + size]
        pos += size

    for required in (b"desc", b"kuki", b"pakt", b"data"):
        if required not in chunks:
            raise AlacParamError(f"CAF missing {required!r} chunk")

    (rate, fourcc, flags, _bpp, fpp, nch, _bits) = struct.unpack(
        ">d4sIIIII", chunks[b"desc"][:32])
    if fourcc != b"alac":
        raise AlacParamError(f"CAF desc format {fourcc!r} is not alac")
    if flags == 0:
        # third-party CAF writers (e.g. libavformat's muxer) leave the
        # Apple depth-encoding flags (1..4) at 0; the kuki cookie is
        # authoritative for the depth, so fall back to it
        from ..cookie import parse_cookie
        depth = parse_cookie(chunks[b"kuki"]).bit_depth
    elif flags in _FLAG_TO_DEPTH:
        depth = _FLAG_TO_DEPTH[flags]
    else:
        raise AlacParamError(f"unknown alac format flags {flags}")

    pakt = chunks[b"pakt"]
    if len(pakt) < 24:
        raise AlacParamError("truncated pakt header")
    num_packets, num_valid, priming, remainder = struct.unpack(">qqii", pakt[:24])
    sizes, _ = ber_decode(pakt[24:], num_packets)

    data = chunks[b"data"]
    if len(data) < 4:
        raise AlacParamError("truncated data chunk")
    payload = data[4:]  # skip u32 editCount
    packets = []
    off = 0
    for s in sizes:
        if off + s > len(payload):
            raise AlacParamError("packet table overruns data chunk")
        packets.append(payload[off:off + s])
        off += s

    return CafFile(
        sample_rate=int(rate), bit_depth=depth,
        num_channels=nch, frames_per_packet=fpp, cookie=chunks[b"kuki"],
        packets=packets, num_valid_frames=num_valid,
        priming_frames=priming, remainder_frames=remainder,
    )


def _as_bytes(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()
