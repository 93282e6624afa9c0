"""MP4/M4A (ISO base media) container for ALAC packets (the port's copy
of alacjax/containers/mp4.py).

The reference convert utility speaks WAV<->CAF only (convert-utility/
main.cpp; SURVEY.md §2 row 13), but deployed ALAC overwhelmingly ships
in .m4a (iTunes/Apple Music).  This module extends the framework's L4
container layer with a mux/demux of the ISO base media file format
carrying an 'alac' audio sample entry — the layout Apple's own mov
family and libavformat's mov/mp4 muxer produce.

The in-memory carrier is containers.caf.CafFile (packetized ALAC stream
+ cookie + stream stats) — the container-agnostic interchange struct the
convert layer already uses; only the serialization differs.

Box layout written (everything big-endian):

    ftyp (M4A , isom mp42)
    mdat (concatenated packets; written before moov so the single stco
          chunk offset is closed-form)
    moov
      mvhd
      trak
        tkhd
        mdia
          mdhd                      (timescale = sample rate,
                                     duration = valid frames)
          hdlr ('soun')
          minf
            smhd
            dinf > dref > url (self-contained)
            stbl
              stsd > AudioSampleEntry('alac') > 'alac' box
                     ([u32 size]['alac'][u32 version/flags=0]
                      [24/48-byte magic cookie — cookie.py layout])
              stts  (full packets, then the tail packet)
              stsc  (all samples in one chunk)
              stsz  (per-packet byte sizes)
              stco  (one offset: mdat payload)

The reader implements the general stsc/stco/co64 resolution (chunk walk
with intra-chunk size accumulation), so third-party files with
interleaved chunk layouts (libavformat writes those) demux correctly;
alacjax's original is validated against libavformat in
tests/test_ffmpeg_interop.py.
"""

from __future__ import annotations

import struct

from ..types import AlacParamError
from .caf import CafFile


# ---------------------------------------------------------------------------
# box primitives
# ---------------------------------------------------------------------------
def _box(fourcc: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), fourcc) + body


def _full(fourcc: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + body)


def _walk(blob: bytes, start: int, end: int):
    """Yield (fourcc, body_start, body_end) for the child boxes of
    blob[start:end]; tolerates 64-bit sizes and stops on malformed
    headers rather than raising (containers skip unknown content)."""
    pos = start
    while pos + 8 <= end:
        size, fourcc = struct.unpack_from(">I4s", blob, pos)
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = struct.unpack_from(">Q", blob, pos + 8)[0]
            hdr = 16
        elif size == 0:          # box runs to the end of the enclosure
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield fourcc, pos + hdr, pos + size
        pos += size


def _find(blob: bytes, start: int, end: int, fourcc: bytes):
    for fc, b0, b1 in _walk(blob, start, end):
        if fc == fourcc:
            return b0, b1
    return None


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def write_m4a(caf: CafFile, path: str | None = None) -> bytes:
    """Serialize a packetized ALAC stream (CafFile carrier) as .m4a."""
    ftyp = _box(b"ftyp", b"M4A " + struct.pack(">I", 0) + b"M4A isommp42")
    payload = b"".join(caf.packets)
    mdat = _box(b"mdat", payload)
    mdat_payload_off = len(ftyp) + 8      # mdat precedes moov: closed-form

    rate = caf.sample_rate
    dur = caf.num_valid_frames
    n_pkt = len(caf.packets)

    # ---- stbl ----
    alac_box = _box(b"alac", struct.pack(">I", 0) + caf.cookie)
    entry = (b"\x00" * 6 + struct.pack(">H", 1)             # data_ref_index
             + struct.pack(">HHI", 0, 0, 0)                 # ver/rev/vendor
             + struct.pack(">HHHH", caf.num_channels, 16, 0, 0)
             + struct.pack(">I", min(rate, 0xFFFF) << 16)   # 16.16; mdhd and
             + alac_box)                                    # cookie carry >64k
    stsd = _full(b"stsd", 0, 0,
                 struct.pack(">I", 1) + _box(b"alac", entry))

    S = caf.frames_per_packet
    tail = dur - S * (n_pkt - 1) if n_pkt else 0
    if n_pkt and not 1 <= tail <= S:
        raise AlacParamError("valid frames inconsistent with packet count")
    stts_entries = []
    if n_pkt:
        if tail == S:
            stts_entries.append((n_pkt, S))
        else:
            if n_pkt > 1:
                stts_entries.append((n_pkt - 1, S))
            stts_entries.append((1, tail))
    stts = _full(b"stts", 0, 0, struct.pack(">I", len(stts_entries))
                 + b"".join(struct.pack(">II", c, d)
                            for c, d in stts_entries))
    stsc = _full(b"stsc", 0, 0,
                 struct.pack(">I", 1) + struct.pack(">III", 1, n_pkt, 1)
                 if n_pkt else struct.pack(">I", 0))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n_pkt)
                 + b"".join(struct.pack(">I", len(p)) for p in caf.packets))
    stco = _full(b"stco", 0, 0,
                 struct.pack(">II", 1, mdat_payload_off)
                 if n_pkt else struct.pack(">I", 0))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    # ---- minf / mdia / trak / moov ----
    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    dref = _full(b"dref", 0, 0,
                 struct.pack(">I", 1) + _full(b"url ", 0, 1, b""))
    minf = _box(b"minf", smhd + _box(b"dinf", dref) + stbl)
    mdhd = _full(b"mdhd", 0, 0,
                 struct.pack(">IIIIHH", 0, 0, rate, dur, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0,
                 struct.pack(">I4s", 0, b"soun") + b"\x00" * 12
                 + b"SoundHandler\x00")
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(b"tkhd", 0, 3,
                 struct.pack(">IIIII", 0, 0, 1, 0, dur)
                 + struct.pack(">IIHHHH", 0, 0, 0, 0, 0x0100, 0)
                 + _MATRIX + struct.pack(">II", 0, 0))
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(b"mvhd", 0, 0,
                 struct.pack(">IIIII", 0, 0, rate, dur, 0x00010000)
                 + struct.pack(">HH", 0x0100, 0) + b"\x00" * 8 + _MATRIX
                 + b"\x00" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)

    blob = ftyp + mdat + moov
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------
def read_m4a(path_or_bytes) -> CafFile:
    """Parse an .m4a/.mp4 file carrying an ALAC track into the CafFile
    carrier.  Handles the general sample-table layout (multi-entry stsc,
    stco or co64, interleaved chunks) so third-party muxers' files
    (libavformat, Apple) demux, not just our own writer's."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()

    moov = _find(blob, 0, len(blob), b"moov")
    if moov is None:
        raise AlacParamError("mp4: no moov box")

    for fc, t0, t1 in _walk(blob, *moov):
        if fc != b"trak":
            continue
        got = _parse_alac_trak(blob, t0, t1)
        if got is not None:
            return got
    raise AlacParamError("mp4: no ALAC audio track")


def _parse_alac_trak(blob: bytes, t0: int, t1: int) -> CafFile | None:
    mdia = _find(blob, t0, t1, b"mdia")
    if mdia is None:
        return None
    mdhd = _find(blob, *mdia, b"mdhd")
    minf = _find(blob, *mdia, b"minf")
    if mdhd is None or minf is None:
        return None
    stbl = _find(blob, *minf, b"stbl")
    if stbl is None:
        return None
    stsd = _find(blob, *stbl, b"stsd")
    if stsd is None:
        return None

    # ---- stsd: locate the 'alac' sample entry + cookie child box ----
    e0, e1 = stsd
    entry = _find(blob, e0 + 8, e1, b"alac")   # skip ver/flags + count
    if entry is None:
        return None
    s0, s1 = entry
    if s1 - s0 < 28:
        raise AlacParamError("mp4: short alac sample entry")
    child = _find(blob, s0 + 28, s1, b"alac")  # fixed AudioSampleEntry head
    if child is None:
        raise AlacParamError("mp4: alac entry missing cookie box")
    c0, c1 = child
    cookie = blob[c0 + 4:c1]                   # skip u32 version/flags
    from ..cookie import parse_cookie
    config = parse_cookie(cookie)

    # ---- mdhd: timescale (authoritative rate) + duration ----
    m0, _ = mdhd
    version = blob[m0]
    if version == 1:
        timescale, duration = struct.unpack_from(">IQ", blob, m0 + 20)
    else:
        timescale, duration = struct.unpack_from(">II", blob, m0 + 12)

    # ---- sample tables ----
    sizes = _read_stsz(blob, stbl)
    offsets = _resolve_sample_offsets(blob, stbl, sizes)
    packets = []
    for off, size in zip(offsets, sizes):
        if off + size > len(blob):
            raise AlacParamError("mp4: sample overruns file")
        packets.append(blob[off:off + size])

    num_valid = _read_stts_total(blob, stbl)
    if num_valid is None:
        num_valid = duration

    return CafFile(
        sample_rate=int(timescale) or config.sample_rate,
        bit_depth=config.bit_depth,
        num_channels=config.num_channels,
        frames_per_packet=config.frame_length,
        cookie=cookie, packets=packets,
        num_valid_frames=int(num_valid),
    )


def _read_stsz(blob: bytes, stbl) -> list[int]:
    stsz = _find(blob, *stbl, b"stsz")
    if stsz is None:
        raise AlacParamError("mp4: no stsz box")
    b0, b1 = stsz
    fixed, count = struct.unpack_from(">II", blob, b0 + 4)
    if fixed:
        return [fixed] * count
    if b0 + 12 + 4 * count > b1:
        raise AlacParamError("mp4: truncated stsz")
    return list(struct.unpack_from(f">{count}I", blob, b0 + 12))


def _read_stts_total(blob: bytes, stbl):
    stts = _find(blob, *stbl, b"stts")
    if stts is None:
        return None
    b0, b1 = stts
    n = struct.unpack_from(">I", blob, b0 + 4)[0]
    if b0 + 8 + 8 * n > b1:
        raise AlacParamError("mp4: truncated stts")
    total = 0
    for i in range(n):
        c, d = struct.unpack_from(">II", blob, b0 + 8 + 8 * i)
        total += c * d
    return total


def _resolve_sample_offsets(blob: bytes, stbl, sizes: list[int]) -> list[int]:
    """General stsc x (stco|co64) resolution: expand the chunk map, then
    each sample's offset = its chunk's offset + the cumulative size of
    the samples before it within that chunk."""
    stco = _find(blob, *stbl, b"stco")
    if stco is not None:
        b0, b1 = stco
        n = struct.unpack_from(">I", blob, b0 + 4)[0]
        if b0 + 8 + 4 * n > b1:
            raise AlacParamError("mp4: truncated stco")
        chunk_offs = list(struct.unpack_from(f">{n}I", blob, b0 + 8))
    else:
        co64 = _find(blob, *stbl, b"co64")
        if co64 is None:
            raise AlacParamError("mp4: no stco/co64 box")
        b0, b1 = co64
        n = struct.unpack_from(">I", blob, b0 + 4)[0]
        if b0 + 8 + 8 * n > b1:
            raise AlacParamError("mp4: truncated co64")
        chunk_offs = list(struct.unpack_from(f">{n}Q", blob, b0 + 8))

    stsc = _find(blob, *stbl, b"stsc")
    if stsc is None:
        raise AlacParamError("mp4: no stsc box")
    b0, b1 = stsc
    n = struct.unpack_from(">I", blob, b0 + 4)[0]
    if b0 + 8 + 12 * n > b1:
        raise AlacParamError("mp4: truncated stsc")
    runs = [struct.unpack_from(">III", blob, b0 + 8 + 12 * i)
            for i in range(n)]  # (first_chunk 1-based, samples/chunk, sdi)

    offsets = []
    si = 0
    for ri, (first, per_chunk, _sdi) in enumerate(runs):
        last = (runs[ri + 1][0] - 1 if ri + 1 < len(runs)
                else len(chunk_offs))
        for ci in range(first - 1, last):
            if si >= len(sizes):
                break
            pos = chunk_offs[ci]
            for _ in range(per_chunk):
                if si >= len(sizes):
                    break
                offsets.append(pos)
                pos += sizes[si]
                si += 1
    if si < len(sizes):
        raise AlacParamError("mp4: chunk map covers fewer samples than stsz")
    return offsets
