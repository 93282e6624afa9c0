"""Many-file batched transcoding — the device codec's lane dimension
applied ACROSS files (the port's copy of alacjax/batch.py; its batches
run on ``device``, default "cuda").

The reference CLI converts one file per invocation (convert-utility/
main.cpp :: main); on a batch accelerator that wastes the lane axis — a
30-frame file pads to the 256-frame device chunk, so 100 short files pay
100 chunk launches where two would do.  Here the frames of MANY files
share device batches: files group by codec parameters, their frames
(full frames AND partial tails together, via per-lane sample counts —
codec.encode_frames_ex / decode_frames_ex) concatenate into one frame
stream, and the packet list splits back per file afterwards.

Byte-identical to converting each file alone: the device encoder is
independent-frames by design (packets carry no cross-frame state), so
cross-FILE batching cannot change any packet — tests/test_batch.py
asserts equality against the single-file path for every file.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .containers.caf import CafFile, read_caf, write_caf
from .containers.pcm import pack_pcm, unpack_pcm
from .containers.wav import WavFile, probe_wav, read_wav, write_wav
from .cookie import parse_cookie, serialize_cookie
from .types import AlacConfig, AlacParamError

_ENC_EXTS = (".wav",)
_DEC_EXTS = (".caf", ".m4a", ".mp4")

# sample_rate / cookie stats do not enter the packet math (they are
# cookie-only fields); normalizing them in the CODEC key lets files with
# different rates share one codec
_CANON_RATE = 44100


def _read_container(path: str) -> CafFile:
    if path.lower().endswith(".caf"):
        return read_caf(path)
    from .containers.mp4 import read_m4a
    return read_m4a(path)


def _write_container(caf: CafFile, path: str) -> None:
    if path.lower().endswith(".caf"):
        write_caf(caf, path)
    else:
        from .containers.mp4 import write_m4a
        write_m4a(caf, path)


def _frames_of(pcm: np.ndarray, S: int):
    """(C, N) planar -> ((n_pk, C, S) int32 zero-padded frames, (n_pk,)
    per-frame sample counts).  Mirrors codec._torch_encode_stream's
    split."""
    C, N = pcm.shape
    nf, rem = divmod(N, S)
    n_pk = nf + (1 if rem else 0)
    frames = np.zeros((n_pk, C, S), dtype=np.int32)
    if nf:
        frames[:nf] = np.transpose(pcm[:, : nf * S].reshape(C, nf, S),
                                   (1, 0, 2))
    nums = np.full((n_pk,), S, dtype=np.int32)
    if rem:
        frames[nf, :, :rem] = pcm[:, nf * S:]
        nums[nf] = rem
    return frames, nums


def _caf_for(wav: WavFile, packets: list[bytes], frame_length: int,
             n_samples: int, fast_mode: bool) -> CafFile:
    """Cookie stats computed per file (maxFrameBytes / avgBitRate), like
    convert.encode_wav_to_caf."""
    total = sum(map(len, packets))
    cfg = AlacConfig(
        frame_length=frame_length, bit_depth=wav.bit_depth,
        num_channels=wav.num_channels, sample_rate=wav.sample_rate,
        fast_mode=fast_mode,
        max_frame_bytes=max(map(len, packets)) if packets else 0,
        avg_bit_rate=(int(total * 8 * wav.sample_rate // n_samples)
                      if n_samples else 0),
    )
    return CafFile(
        sample_rate=wav.sample_rate, bit_depth=wav.bit_depth,
        num_channels=wav.num_channels, frames_per_packet=frame_length,
        cookie=serialize_cookie(cfg), packets=packets,
        num_valid_frames=n_samples,
    )


def _slice_budget(chunk: int | None) -> int:
    """Packets per device slice: a few chunks' worth, so huge batches
    stream through bounded memory (files load lazily per slice)."""
    from .codec import DEFAULT_CHUNK
    return 4 * (chunk or DEFAULT_CHUNK)


def _encode_group(jobs, frame_length: int, fast_mode: bool,
                  chunk: int | None, search: str, device,
                  devices) -> None:
    """jobs: list of dicts with src/out (planned via header probes);
    PCM loads lazily, a slice of files at a time, each slice one batched
    device stream — a 10k-file batch never holds 10k files in memory."""
    from .codec import DEFAULT_CHUNK, get_codec

    config = AlacConfig(
        frame_length=frame_length, bit_depth=jobs[0]["info"].bit_depth,
        num_channels=jobs[0]["info"].num_channels, sample_rate=_CANON_RATE,
        fast_mode=fast_mode, search=search)
    codec = get_codec(config, chunk or DEFAULT_CHUNK, device=device,
                      devices=devices)
    budget = _slice_budget(chunk)

    pend: list[tuple] = []  # (job, wav, frames, nums, n_samples)
    pend_pk = 0

    def flush():
        nonlocal pend, pend_pk
        if not pend:
            return
        all_frames = np.concatenate([p[2] for p in pend], axis=0)
        all_nums = np.concatenate([p[3] for p in pend], axis=0)
        if all_frames.shape[0] == 0:
            packets = []
        elif (all_nums == frame_length).all():
            packets = codec.encode_frames(all_frames)
        else:
            packets = codec.encode_frames_ex(all_frames, all_nums)
        off = 0
        for j, wav, frames, _nums, n_samples in pend:
            n_pk = frames.shape[0]
            caf = _caf_for(wav, packets[off:off + n_pk], frame_length,
                           n_samples, fast_mode)
            _write_container(caf, j["out"])
            off += n_pk
        pend, pend_pk = [], 0

    for j in jobs:
        wav = read_wav(j["src"])
        if (wav.bit_depth, wav.num_channels) != (
                jobs[0]["info"].bit_depth, jobs[0]["info"].num_channels):
            raise AlacParamError(f"{j['src']}: file changed during batch")
        pcm = unpack_pcm(wav.data, wav.bit_depth, wav.num_channels)
        frames, nums = _frames_of(pcm, frame_length)
        pend.append((j, wav, frames, nums, pcm.shape[1]))
        pend_pk += frames.shape[0]
        if pend_pk >= budget:
            flush()
    flush()


def _decode_group(jobs, chunk: int | None, device, devices) -> None:
    """jobs: list of dicts with src/out/key (planned via a cookie pass);
    containers re-read lazily per slice, each slice one device batch."""
    from .codec import DEFAULT_CHUNK, get_codec

    key = jobs[0]["key"]
    S = key.frame_length
    codec = get_codec(key, chunk or DEFAULT_CHUNK, device=device,
                      devices=devices)
    budget = _slice_budget(chunk)

    pend: list[tuple] = []  # (job, caf, n_pk, n_full, rem)
    pend_pk = 0

    def flush():
        nonlocal pend, pend_pk
        if not pend:
            return
        all_pkts = []
        for _j, caf, n_pk, _nf, _r in pend:
            all_pkts.extend(caf.packets[:n_pk])
        pcm_all, nums = codec.decode_frames_ex(all_pkts)
        off = 0
        for j, caf, n_pk, n_full, rem in pend:
            f_nums = nums[off:off + n_pk]
            if (f_nums[:n_full] != S).any():
                raise AlacParamError(
                    f"{j['src']}: unexpected partial frame")
            if rem and f_nums[n_full] != rem:
                raise AlacParamError(
                    f"{j['src']}: tail packet has {int(f_nums[n_full])} "
                    f"samples, expected {rem}")
            out = np.zeros((caf.num_channels, caf.num_valid_frames),
                           dtype=np.int64)
            if n_full:
                out[:, : n_full * S] = np.transpose(
                    pcm_all[off:off + n_full], (1, 0, 2)).reshape(
                        caf.num_channels, n_full * S)
            if rem:
                out[:, n_full * S:] = pcm_all[off + n_full, :, :rem]
            write_wav(WavFile(sample_rate=caf.sample_rate,
                              bit_depth=caf.bit_depth,
                              num_channels=caf.num_channels,
                              data=pack_pcm(out, caf.bit_depth)), j["out"])
            off += n_pk
        pend, pend_pk = [], 0

    for j in jobs:
        caf = _read_container(j["src"])
        config = parse_cookie(caf.cookie)
        if dataclasses.replace(config, max_frame_bytes=0, avg_bit_rate=0,
                               sample_rate=_CANON_RATE) != key:
            raise AlacParamError(f"{j['src']}: file changed during batch")
        n_full, rem = divmod(caf.num_valid_frames, S)
        n_full = min(n_full, len(caf.packets))
        rem = caf.num_valid_frames - n_full * S
        if rem and len(caf.packets) <= n_full:
            raise AlacParamError(
                f"{j['src']}: missing packets for trailing samples")
        n_pk = n_full + (1 if rem else 0)
        pend.append((j, caf, n_pk, n_full, rem))
        pend_pk += n_pk
        if pend_pk >= budget:
            flush()
    flush()


def _out_path(in_path: str, outdir: str, to: str | None) -> str:
    stem = os.path.splitext(os.path.basename(in_path))[0]
    if in_path.lower().endswith(_ENC_EXTS):
        ext = to or "caf"
        if ext == "wav":
            raise AlacParamError(f"{in_path}: wav -> wav is not a conversion")
    elif in_path.lower().endswith(_DEC_EXTS):
        ext = to or "wav"
        if ext != "wav":
            raise AlacParamError(
                f"{in_path}: batch decode targets wav (got --to {ext})")
    else:
        raise AlacParamError(f"{in_path}: unsupported input extension")
    return os.path.join(outdir, stem + "." + ext)


def _output_valid(out: str) -> bool:
    """Resume check: does an existing output parse cleanly?  (Outputs
    are written whole via the container writers, so a parseable file is
    a completed file; a crash mid-write leaves an unparseable one.)"""
    if not os.path.exists(out):
        return False
    try:
        if out.lower().endswith(".wav"):
            read_wav(out)
        else:
            _read_container(out)
        return True
    except Exception:
        return False


def convert_many(inputs: list[str], outdir: str, to: str | None = None,
                 frame_length: int = 4096, fast_mode: bool = False,
                 backend: str = "torch", chunk: int | None = None,
                 search: str = "standard", resume: bool = False,
                 device="cuda", devices=None) -> list[str]:
    """Convert many files in shared device batches.

    inputs: .wav files (encoded to .caf/.m4a per ``to``) and/or
    .caf/.m4a files (decoded to .wav), mixed freely; outputs land in
    ``outdir`` under the input basename.  Encode jobs group by
    (bit_depth, channels) and decode jobs by codec cookie parameters;
    each group runs as ONE batched device stream on ``device``, its
    frame batches split across ``devices`` (codec.get_codec).  With a
    non-torch backend the files convert one by one through convert.convert_file
    (no cross-file batching on a scalar host codec).

    resume=True skips inputs whose output already exists and parses
    cleanly — rerun the same command after an interruption and only the
    missing/corrupt outputs are redone.

    Returns the output paths in input order.
    """
    outs = [_out_path(p, outdir, to) for p in inputs]
    seen: dict[str, str] = {}
    for i, o in zip(inputs, outs):
        if o in seen:
            raise AlacParamError(
                f"output collision: {seen[o]} and {i} both -> {o}")
        seen[o] = i
    os.makedirs(outdir, exist_ok=True)

    if resume:
        todo = [(i, o) for i, o in zip(inputs, outs)
                if not _output_valid(o)]
        if not todo:
            return outs
        inputs, pend_outs = [list(t) for t in zip(*todo)]
    else:
        pend_outs = outs

    if backend != "torch":
        from .convert import convert_file
        for i, o in zip(inputs, pend_outs):
            if i.lower().endswith(_ENC_EXTS):
                convert_file(i, o, frame_length=frame_length,
                             fast_mode=fast_mode, backend=backend,
                             search=search, device=device, devices=devices)
            else:
                convert_file(i, o, backend=backend, device=device,
                             devices=devices)
        return outs

    # planning pass holds only header metadata (probe_wav / the cookie);
    # payloads load lazily inside the group processors, a slice at a time
    enc_groups: dict[tuple, list] = {}
    dec_groups: dict[AlacConfig, list] = {}
    for i, o in zip(inputs, pend_outs):
        if i.lower().endswith(_ENC_EXTS):
            info = probe_wav(i)
            key = (info.bit_depth, info.num_channels)
            enc_groups.setdefault(key, []).append(
                dict(info=info, out=o, src=i))
        elif i.lower().endswith(_DEC_EXTS):
            caf = _read_container(i)
            config = parse_cookie(caf.cookie)
            if config.num_channels != caf.num_channels:
                raise AlacParamError(
                    f"{i}: cookie/desc channel count mismatch")
            key = dataclasses.replace(config, max_frame_bytes=0,
                                      avg_bit_rate=0,
                                      sample_rate=_CANON_RATE)
            dec_groups.setdefault(key, []).append(
                dict(key=key, out=o, src=i))
            del caf
        else:
            raise AlacParamError(f"{i}: unsupported input extension")

    for jobs in enc_groups.values():
        _encode_group(jobs, frame_length, fast_mode, chunk, search, device,
                      devices)
    for jobs in dec_groups.values():
        _decode_group(jobs, chunk, device, devices)
    return outs
