"""Magic-cookie serialization — the encoder↔decoder configuration contract:
the port's copy of alacjax/cookie.py.

Rebuild of the reference's cookie handling (ALACEncoder.cpp ::
GetMagicCookie/GetConfig and ALACDecoder.cpp :: Init; layout per
ALACMagicCookieDescription.txt).

Wire layout, all big-endian:
  ALACSpecificConfig (24 bytes):
    u32 frameLength | u8 compatibleVersion | u8 bitDepth | u8 pb | u8 mb
    | u8 kb | u8 numChannels | u16 maxRun | u32 maxFrameBytes
    | u32 avgBitRate | u32 sampleRate
  For numChannels > 2, followed by a 24-byte ALACAudioChannelLayout atom:
    u32 channelLayoutInfoSize(=24) | 'chan' | u32 versionFlags(=0)
    | u32 channelLayoutTag | u32 reserved1(=0) | u32 reserved2(=0)
Decoders must also accept the cookie wrapped in optional 12-byte
'frma' and 'alac' atom headers (ALACDecoder.cpp :: Init skips them).
"""

from __future__ import annotations

import struct

from .types import AlacConfig, AlacParamError, ALAC_CHANNEL_LAYOUT_TAGS

_CONFIG_FMT = ">IBBBBBBHIII"
CONFIG_SIZE = struct.calcsize(_CONFIG_FMT)          # 24
CHANNEL_ATOM_SIZE = 24
_CHAN_FOURCC = b"chan"


def serialize_cookie(config: AlacConfig) -> bytes:
    """Produce the 24-byte (≤2ch) or 48-byte (>2ch) magic cookie."""
    core = struct.pack(
        _CONFIG_FMT,
        config.frame_length,
        config.compatible_version,
        config.bit_depth,
        config.pb,
        config.mb,
        config.kb,
        config.num_channels,
        config.max_run,
        config.max_frame_bytes,
        config.avg_bit_rate,
        config.sample_rate,
    )
    if config.num_channels <= 2:
        return core
    atom = struct.pack(
        ">I4sIIII", CHANNEL_ATOM_SIZE, _CHAN_FOURCC, 0,
        config.channel_layout_tag, 0, 0,
    )
    return core + atom


def cookie_size(num_channels: int) -> int:
    return CONFIG_SIZE if num_channels <= 2 else CONFIG_SIZE + CHANNEL_ATOM_SIZE


def parse_cookie(cookie: bytes) -> AlacConfig:
    """Inverse of serialize_cookie, tolerating 'frma'/'alac' atom wrappers."""
    buf = bytes(cookie)

    # Skip optional atom wrappers exactly as ALACDecoder::Init does:
    # [u32 size]['frma']['alac'] then [u32 size]['alac'][u32 version/flags].
    if len(buf) >= 12 and buf[4:8] == b"frma" and buf[8:12] == b"alac":
        buf = buf[12:]
    if len(buf) >= 12 and buf[4:8] == b"alac":
        buf = buf[12:]

    if len(buf) < CONFIG_SIZE:
        raise AlacParamError(f"cookie too small ({len(buf)} bytes)")

    (frame_length, compatible_version, bit_depth, pb, mb, kb, num_channels,
     max_run, max_frame_bytes, avg_bit_rate, sample_rate) = struct.unpack(
        _CONFIG_FMT, buf[:CONFIG_SIZE])

    if compatible_version != 0:
        raise AlacParamError("unsupported compatibleVersion in cookie")

    config = AlacConfig(
        frame_length=frame_length,
        compatible_version=compatible_version,
        bit_depth=bit_depth,
        pb=pb,
        mb=mb,
        kb=kb,
        num_channels=num_channels,
        max_run=max_run,
        max_frame_bytes=max_frame_bytes,
        avg_bit_rate=avg_bit_rate,
        sample_rate=sample_rate,
    )

    rest = buf[CONFIG_SIZE:]
    if num_channels > 2 and len(rest) >= CHANNEL_ATOM_SIZE:
        size, fourcc = struct.unpack(">I4s", rest[:8])
        if fourcc == _CHAN_FOURCC:
            (_, tag, _, _) = struct.unpack(">IIII", rest[8:24])
            if tag != ALAC_CHANNEL_LAYOUT_TAGS[num_channels]:
                # Accept but do not remap — the reference only validates
                # channel count, which already came from the config core.
                pass
    return config
