"""High-level file conversion: WAV <-> CAF/ALAC.

The port's copy of alacjax/convert.py: a rebuild of the reference CLI's
encode/decode loops (convert-utility/main.cpp; SURVEY.md §3.1/§3.2), with
a pluggable packet-codec backend: 'oracle' (scalar host reference) or
'torch' (batched device path, registered by alacjax_torch.codec when
imported).  Every entry point takes ``device`` (default "cuda"), which
the torch backend's codec runs on, and ``devices`` (default None: every
visible card), which it splits its frame batches across
(codec.get_codec); the oracle ignores both.
"""

from __future__ import annotations

import numpy as np

from .containers.caf import CafFile, read_caf, write_caf
from .containers.pcm import pack_pcm, unpack_pcm
from .containers.wav import WavFile, read_wav, write_wav
from .cookie import parse_cookie
from .oracle import ALACDecoder, ALACEncoder
from .types import AlacConfig, AlacParamError

_BACKENDS: dict[str, tuple] = {}


def register_backend(name: str, encode_stream, decode_stream) -> None:
    """Register a packet-codec backend.

    encode_stream(config, pcm (C,N) int64, device, devices) -> list[bytes]
    packets
    decode_stream(config, packets, num_valid_frames, device, devices) ->
    pcm (C,N) int64
    """
    _BACKENDS[name] = (encode_stream, decode_stream)


def _oracle_encode_stream(config: AlacConfig, pcm: np.ndarray,
                          device=None, devices=None) -> list[bytes]:
    enc = ALACEncoder(config)
    packets = []
    n = pcm.shape[1]
    for off in range(0, n, config.frame_length):
        packets.append(enc.encode_packet(pcm[:, off:off + config.frame_length]))
    return packets


def _oracle_decode_stream(config: AlacConfig, packets, num_valid_frames: int,
                          device=None, devices=None) -> np.ndarray:
    dec = ALACDecoder(config)
    out = []
    remaining = num_valid_frames
    for pkt in packets:
        want = min(config.frame_length, remaining)
        y, got = dec.decode_packet(
            pkt, num_samples=want if want != config.frame_length else None)
        out.append(y[:, :got])
        remaining -= got
    return np.concatenate(out, axis=1) if out else np.zeros(
        (config.num_channels, 0), dtype=np.int64)


register_backend("oracle", _oracle_encode_stream, _oracle_decode_stream)


def get_backend(name: str):
    if name == "torch" and "torch" not in _BACKENDS:
        from . import codec  # noqa: F401  — registers the 'torch' backend
    if name not in _BACKENDS:
        raise AlacParamError(f"unknown backend {name!r} (have {sorted(_BACKENDS)})")
    return _BACKENDS[name]


def encode_wav_to_caf(wav: WavFile, frame_length: int = 4096,
                      fast_mode: bool = False, backend: str = "oracle",
                      independent_frames: bool = False,
                      search: str = "standard",
                      device="cuda", devices=None) -> CafFile:
    config = AlacConfig(
        frame_length=frame_length, bit_depth=wav.bit_depth,
        num_channels=wav.num_channels, sample_rate=wav.sample_rate,
        fast_mode=fast_mode,
    )
    pcm = unpack_pcm(wav.data, wav.bit_depth, wav.num_channels)
    if search == "exhaustive" and backend == "torch" and independent_frames:
        # exhaustive at DEVICE speed: the whole (mixres x order x stage)
        # candidate grid rides the same stacked scan as the standard
        # search (codec.py exhaustive branch); independent-frames only
        # (the device encoder's state policy), byte-identical to the
        # stateless host exhaustive encoders
        import dataclasses as _dc
        encode_stream, _ = get_backend(backend)
        packets = encode_stream(_dc.replace(config, search="exhaustive"),
                                pcm, device, devices)
    elif search == "exhaustive":
        # maximal-rate host path (full-rate trials over every mixres);
        # native C++ if built, scalar oracle otherwise — byte-identical
        try:
            from .native import NativeEncoder
            enc = NativeEncoder(config, independent_frames=independent_frames,
                                search="exhaustive")
        except Exception:
            enc = ALACEncoder(config, independent_frames=independent_frames,
                              search="exhaustive")
        packets = [enc.encode_packet(pcm[:, o:o + frame_length])
                   for o in range(0, pcm.shape[1], frame_length)]
    elif backend == "oracle" and independent_frames:
        encode_stream, _ = get_backend(backend)
        enc = ALACEncoder(config, independent_frames=True)
        packets = [enc.encode_packet(pcm[:, o:o + frame_length])
                   for o in range(0, pcm.shape[1], frame_length)]
    else:
        encode_stream, _ = get_backend(backend)
        packets = encode_stream(config, pcm, device, devices)

    # stats for the cookie (maxFrameBytes / avgBitRate like the reference)
    import dataclasses
    n = pcm.shape[1]
    total = sum(map(len, packets))
    cfg_out = dataclasses.replace(
        config,
        max_frame_bytes=max(map(len, packets)) if packets else 0,
        avg_bit_rate=int(total * 8 * wav.sample_rate // n) if n else 0,
    )
    from .cookie import serialize_cookie
    return CafFile(
        sample_rate=wav.sample_rate, bit_depth=wav.bit_depth,
        num_channels=wav.num_channels, frames_per_packet=frame_length,
        cookie=serialize_cookie(cfg_out), packets=packets,
        num_valid_frames=n,
    )


def decode_caf_to_wav(caf: CafFile, backend: str = "oracle",
                      device="cuda", devices=None) -> WavFile:
    config = parse_cookie(caf.cookie)
    if config.num_channels != caf.num_channels:
        raise AlacParamError("cookie/desc channel count mismatch")
    _, decode_stream = get_backend(backend)
    pcm = decode_stream(config, caf.packets, caf.num_valid_frames, device,
                        devices)
    if pcm.shape[1] > caf.num_valid_frames:
        pcm = pcm[:, :caf.num_valid_frames]
    return WavFile(
        sample_rate=caf.sample_rate, bit_depth=caf.bit_depth,
        num_channels=caf.num_channels,
        data=pack_pcm(pcm, caf.bit_depth),
    )


def verify_lossless(wav_src, alac_bytes_or_path, backend: str = "oracle",
                    device="cuda", devices=None) -> int:
    """Decode an encoded output back and compare against the source WAV
    sample-for-sample (CLI --check).  Returns the number of samples
    verified; raises AlacParamError on any mismatch."""
    from .containers.mp4 import read_m4a

    wav = read_wav(wav_src)
    pcm = unpack_pcm(wav.data, wav.bit_depth, wav.num_channels)
    blob = alac_bytes_or_path
    if isinstance(blob, str):
        with open(blob, "rb") as f:
            blob = f.read()
    caf = read_caf(blob) if blob[:4] == b"caff" else read_m4a(blob)
    got = decode_caf_to_wav(caf, backend=backend, device=device,
                            devices=devices)
    back = unpack_pcm(got.data, got.bit_depth, got.num_channels)
    if back.shape != pcm.shape or not (back == pcm).all():
        raise AlacParamError("lossless check FAILED: decoded audio does "
                             "not match the source")
    return int(pcm.shape[1])


def sniff_format(blob: bytes) -> str:
    """Identify a container by CONTENT (pipe inputs have no extension)."""
    if blob[:4] == b"RIFF" and blob[8:12] == b"WAVE":
        return "wav"
    if blob[:4] == b"caff":
        return "caf"
    if len(blob) >= 12 and blob[4:8] == b"ftyp":
        return "m4a"
    raise AlacParamError("unrecognized container (expected WAV, CAF, or M4A)")


def convert_bytes(blob: bytes, out_fmt: str, **kw) -> bytes:
    """In-memory conversion for pipe I/O (CLI '-' paths): input format
    sniffed from content; returns the output container bytes.  Encode
    kwargs (frame_length/fast_mode/...) apply only on the wav side;
    decode honors ``backend``."""
    from .containers.mp4 import read_m4a, write_m4a

    in_fmt = sniff_format(blob)
    if in_fmt == "wav" and out_fmt in ("caf", "m4a"):
        caf = encode_wav_to_caf(read_wav(blob), **kw)
        return write_caf(caf) if out_fmt == "caf" else write_m4a(caf)
    if in_fmt in ("caf", "m4a") and out_fmt == "wav":
        caf = read_caf(blob) if in_fmt == "caf" else read_m4a(blob)
        return write_wav(decode_caf_to_wav(
            caf, backend=kw.get("backend", "oracle"),
            device=kw.get("device", "cuda"), devices=kw.get("devices")))
    if in_fmt == "caf" and out_fmt == "m4a":
        return write_m4a(read_caf(blob))      # repack, no transcode
    if in_fmt == "m4a" and out_fmt == "caf":
        return write_caf(read_m4a(blob))
    raise AlacParamError(f"unsupported conversion {in_fmt} -> {out_fmt}")


def convert_file(in_path: str, out_path: str, **kw) -> None:
    """alacconvert-compatible: direction inferred from extensions.

    Beyond the reference's WAV<->CAF pair, .m4a/.mp4 is accepted on
    either side (the container deployed ALAC actually ships in); the
    packetized stream carrier is identical, only the serialization
    differs (containers/mp4.py)."""
    from .containers.mp4 import read_m4a, write_m4a

    lo_in, lo_out = in_path.lower(), out_path.lower()
    m4a = (".m4a", ".mp4")
    dec_kw = dict(backend=kw.get("backend", "oracle"),
                  device=kw.get("device", "cuda"),
                  devices=kw.get("devices"))
    if lo_in.endswith(".wav") and lo_out.endswith(".caf"):
        write_caf(encode_wav_to_caf(read_wav(in_path), **kw), out_path)
    elif lo_in.endswith(".wav") and lo_out.endswith(m4a):
        write_m4a(encode_wav_to_caf(read_wav(in_path), **kw), out_path)
    elif lo_in.endswith(".caf") and lo_out.endswith(".wav"):
        write_wav(decode_caf_to_wav(read_caf(in_path), **dec_kw), out_path)
    elif lo_in.endswith(m4a) and lo_out.endswith(".wav"):
        write_wav(decode_caf_to_wav(read_m4a(in_path), **dec_kw), out_path)
    elif lo_in.endswith(".caf") and lo_out.endswith(m4a):
        write_m4a(read_caf(in_path), out_path)       # repack, no transcode
    elif lo_in.endswith(m4a) and lo_out.endswith(".caf"):
        write_caf(read_m4a(in_path), out_path)
    else:
        raise AlacParamError(
            "unsupported conversion (wav <-> caf/m4a, caf <-> m4a)")
