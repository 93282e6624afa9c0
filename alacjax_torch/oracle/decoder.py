"""Decoder orchestration oracle (reference: codec/ALACDecoder.{h,cpp};
SURVEY.md §2 row 11, §3.2).

Parses one ALAC packet: loops over 3-bit element tags until ID_END,
dispatching SCE/LFE (mono), CPE (stereo), DSE/FIL (parse-and-skip),
CCE/PCE (unsupported error).  Returns planar int64 samples right-aligned
at bit_depth.  Supports the two-stage predictor cascade (mode != 0: a
numactive==31 first-difference stage feeding the FIR stage), escape
frames, partial frames, and the shifted-off-byte side channel (read via a
cursor snapshot, consumed after prediction, exactly as the reference).
"""

from __future__ import annotations

import numpy as np

from ..bitbuffer import BitBuffer
from ..cookie import parse_cookie
from ..types import (
    ElementTag, AlacConfig, AlacParamError, AlacUnimplementedError,
    kALACMaxCoefs, sign_extend,
)
from . import ag, dp, matrix


class ALACDecoder:
    """Stateless-per-packet decoder mirroring the reference class surface."""

    def __init__(self, cookie_or_config):
        if isinstance(cookie_or_config, AlacConfig):
            self.config = cookie_or_config
        else:
            self.config = parse_cookie(cookie_or_config)

    def decode_packet(self, data: bytes, num_samples: int | None = None
                      ) -> tuple[np.ndarray, int]:
        """Decode one packet -> (planar (num_channels, n) int64, n)."""
        cfg = self.config
        if num_samples is None:
            num_samples = cfg.frame_length
        bits = BitBuffer(data)
        out = np.zeros((cfg.num_channels, cfg.frame_length), dtype=np.int64)
        ch = 0
        got_samples = num_samples

        while True:
            tag = bits.read(3)
            if tag == ElementTag.END:
                bits.byte_align(add_zeros=False)
                break
            if tag in (ElementTag.SCE, ElementTag.LFE):
                if ch + 1 > cfg.num_channels:
                    raise AlacParamError("too many channels in packet")
                n = self._decode_mono(bits, out[ch], num_samples)
                got_samples = n
                ch += 1
            elif tag == ElementTag.CPE:
                if ch + 2 > cfg.num_channels:
                    raise AlacParamError("too many channels in packet")
                n = self._decode_stereo(bits, out[ch], out[ch + 1], num_samples)
                got_samples = n
                ch += 2
            elif tag == ElementTag.DSE:
                self._skip_dse(bits)
            elif tag == ElementTag.FIL:
                self._skip_fil(bits)
            else:  # CCE / PCE
                raise AlacUnimplementedError(f"element tag {tag} unsupported")

        if ch != cfg.num_channels:
            raise AlacParamError(f"packet had {ch} channels, expected {cfg.num_channels}")
        return out[:, :got_samples], got_samples

    # -- shared element header ----------------------------------------------
    def _read_element_header(self, bits: BitBuffer, num_samples: int):
        _instance = bits.read(4)
        unused = bits.read(12)
        if unused != 0:
            raise AlacParamError("nonzero unused element header bits")
        header = bits.read(4)
        partial = header >> 3
        bytes_shifted = (header >> 1) & 0x3
        if bytes_shifted == 3:
            raise AlacParamError("bytesShifted == 3 is invalid")
        escape = header & 1
        if partial:
            num_samples = bits.read(32)
        return num_samples, bytes_shifted, escape

    def _read_channel_params(self, bits: BitBuffer):
        header = bits.read(8)
        mode = header >> 4
        denshift = header & 0xF
        header = bits.read(8)
        pb_factor = header >> 5
        order = header & 0x1F
        # the 5-bit field admits up to 31 coefs; the reference decoder's
        # buffers are 32 wide even though its encoder emits <= kALACMaxCoefs
        coefs = np.zeros(32, dtype=np.int64)
        for k in range(order):
            coefs[k] = sign_extend(bits.read(16), 16)
        return mode, denshift, pb_factor, order, coefs

    def _rice_params(self, num_samples: int, pb_factor: int) -> ag.AGParams:
        cfg = self.config
        return ag.set_ag_params(
            cfg.mb, (cfg.pb * pb_factor) // 4, cfg.kb,
            num_samples, num_samples, cfg.max_run)

    def _predict(self, residuals, mode, coefs, order, chanbits, denshift):
        if mode == 0:
            return dp.unpc_block(residuals, coefs, order, chanbits, denshift)
        # mode != 0: undo the first-difference stage, then the FIR stage
        stage1 = dp.unpc_block(residuals, coefs[:0], 31, chanbits, 0)
        return dp.unpc_block(stage1, coefs, order, chanbits, denshift)

    # -- stereo (CPE) --------------------------------------------------------
    def _decode_stereo(self, bits: BitBuffer, out_l, out_r, num_samples: int) -> int:
        cfg = self.config
        num_samples, bytes_shifted, escape = self._read_element_header(bits, num_samples)

        if not escape:
            chanbits = cfg.bit_depth - 8 * bytes_shifted + 1
            mixbits = bits.read(8)
            mixres = sign_extend(bits.read(8), 8)
            mode_u, den_u, pbf_u, ord_u, coefs_u = self._read_channel_params(bits)
            mode_v, den_v, pbf_v, ord_v, coefs_v = self._read_channel_params(bits)

            shift_l = np.zeros(num_samples, dtype=np.int64)
            shift_r = np.zeros(num_samples, dtype=np.int64)
            if bytes_shifted:
                # snapshot cursor, skip shift bytes, consume after prediction
                shift_pos = bits.get_position()
                bits.advance(num_samples * bytes_shifted * 8 * 2)

            res_u = ag.dyn_decomp(self._rice_params(num_samples, pbf_u), bits,
                                  num_samples, chanbits)
            u = self._predict(res_u, mode_u, coefs_u, ord_u, chanbits, den_u)
            res_v = ag.dyn_decomp(self._rice_params(num_samples, pbf_v), bits,
                                  num_samples, chanbits)
            v = self._predict(res_v, mode_v, coefs_v, ord_v, chanbits, den_v)

            if bytes_shifted:
                sbits = BitBuffer(bytes(bits.buf))
                sbits.set_position(shift_pos)
                w = bytes_shifted * 8
                for j in range(num_samples):
                    shift_l[j] = sbits.read(w)
                    shift_r[j] = sbits.read(w)

            l, r = matrix.unmix(u, v, mixbits, mixres)
            out_l[:num_samples] = matrix.shift_in(l, shift_l, bytes_shifted)
            out_r[:num_samples] = matrix.shift_in(r, shift_r, bytes_shifted)
        else:
            depth = cfg.bit_depth
            for j in range(num_samples):
                out_l[j] = sign_extend(bits.read(depth), depth)
                out_r[j] = sign_extend(bits.read(depth), depth)
        return num_samples

    # -- mono (SCE / LFE) ----------------------------------------------------
    def _decode_mono(self, bits: BitBuffer, out_c, num_samples: int) -> int:
        cfg = self.config
        num_samples, bytes_shifted, escape = self._read_element_header(bits, num_samples)

        if not escape:
            chanbits = cfg.bit_depth - 8 * bytes_shifted
            # mixBits/mixRes are present in EVERY non-escape element —
            # mono included, written as (0, 0) — and read blind (the
            # reference decoder does the same; confirmed vs libavcodec,
            # tests/test_ffmpeg_interop.py).  Values are meaningless
            # without a second channel; read and ignore.
            bits.read(8)
            bits.read(8)
            mode, den, pbf, order, coefs = self._read_channel_params(bits)

            shift = np.zeros(num_samples, dtype=np.int64)
            if bytes_shifted:
                shift_pos = bits.get_position()
                bits.advance(num_samples * bytes_shifted * 8)

            res = ag.dyn_decomp(self._rice_params(num_samples, pbf), bits,
                                num_samples, chanbits)
            s = self._predict(res, mode, coefs, order, chanbits, den)

            if bytes_shifted:
                sbits = BitBuffer(bytes(bits.buf))
                sbits.set_position(shift_pos)
                w = bytes_shifted * 8
                for j in range(num_samples):
                    shift[j] = sbits.read(w)

            out_c[:num_samples] = matrix.shift_in(s, shift, bytes_shifted)
        else:
            depth = cfg.bit_depth
            for j in range(num_samples):
                out_c[j] = sign_extend(bits.read(depth), depth)
        return num_samples

    # -- skip elements -------------------------------------------------------
    @staticmethod
    def _skip_dse(bits: BitBuffer) -> None:
        """ALACDecoder.cpp :: DataStreamElement — parse and skip."""
        _instance = bits.read(4)
        align_flag = bits.read(1)
        count = bits.read(8)
        if count == 255:
            count += bits.read(8)
        if align_flag:
            bits.byte_align(add_zeros=False)
        bits.advance(count * 8)

    @staticmethod
    def _skip_fil(bits: BitBuffer) -> None:
        """ALACDecoder.cpp :: FillElement — parse and skip."""
        count = bits.read(4)
        if count == 15:
            count += bits.read(8) - 1
        bits.advance(count * 8)
