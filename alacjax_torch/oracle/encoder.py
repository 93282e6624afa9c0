"""Encoder orchestration oracle (reference: codec/ALACEncoder.{h,cpp};
SURVEY.md §2 row 10, §3.1).

Operates on *planar int arrays of right-aligned signed samples at
bit_depth* (container code handles wire PCM).  Produces one self-contained
ALAC packet per call, bit-compatible with our decoder's element grammar:

  per element: 3b tag | 4b instance | 12b unused(0) | 1b partialFrame
               | 2b bytesShifted | 1b escapeFlag
  partial  -> 32b numSamples
  !escape  -> (CPE) 8b mixBits + 8b mixRes;
              per channel: 8b (mode<<4|denShift), 8b (pbFactor<<5|num),
              num x 16b coefs;
              raw shifted-off low bytes (interleaved per sample/channel);
              Rice residual stream per channel (U then V)
  escape   -> raw samples at bit_depth (CPE: interleaved L,R)
  final    -> 3b ID_END, byte-align with zeros

Search policy (our dialect, v2 — the reference's exact dilated trial
search is ⚠ VERIFY per SURVEY.md §0; this mirrors its structure:
subsampled trial compression for the stereo mode, then exact trials over
predictor configurations, codec/ALACEncoder.cpp :: EncodeStereo):

  * mixres ∈ 0..4 (CPE): exact *dilated* trial — mix every
    MIXRES_DILATE-th sample, predict with a fresh order-8 coef set, and
    Rice-cost both streams; argmin total bits, first minimum wins.
  * per channel, independently: order ∈ {4, 8} × stage ∈ {1, 2}
    (stage 2 = the two-stage cascade, mode != 0: FIR residuals pass
    through a numactive==31 first-difference stage).  Cost = exact
    channel bits (chparams + coefs + Rice); first minimum wins, in
    candidate order (4,1),(4,2),(8,1),(8,2).

fast_mode uses (mixres=2, order=8, stage=1) with no search.  Escape when
the compressed body >= the escape body (element headers cancel).
``search="exhaustive"`` replaces the dilated mixres trial with full-rate
exact trials over every mixres (the compression-benchmark upper bound —
same grammar, maximal search).  Encoder coefficient banks persist across
packets per (channel, order) unless independent_frames.
"""

from __future__ import annotations

import numpy as np

from ..bitbuffer import BitBuffer
from ..cookie import serialize_cookie
from ..types import (
    DENSHIFT_DEFAULT, ElementTag, AlacConfig, AlacParamError, sign_extend,
)
from . import ag, dp, matrix

# dialect constants (ALACEncoder.cpp defaults)
DEFAULT_MIX_BITS = 2
MAX_RES = 4
SEARCH_ORDERS = (4, 8)
SEARCH_STAGES = (1, 2)   # 1 = FIR only (mode 0); 2 = FIR + first-diff (mode 15)
MIXRES_DILATE = 4        # mixres trial subsampling (reference uses dilation)
FAST_ORDER = 8
FAST_MIX_RES = 2
PB_FACTOR = 4


def bytes_shifted_for_depth(bit_depth: int) -> int:
    """Low-byte shift-off per depth (ALACEncoder.cpp :: EncodeStereo):
    32-bit -> 2 bytes, 24-bit -> 1, else 0."""
    if bit_depth == 32:
        return 2
    if bit_depth == 24:
        return 1
    return 0


def _write_element_header(bits: BitBuffer, tag: ElementTag, instance: int,
                          partial: bool, bytes_shifted: int, escape: bool,
                          num_samples: int) -> None:
    bits.write(int(tag), 3)
    bits.write(instance, 4)
    bits.write(0, 12)
    bits.write(1 if partial else 0, 1)
    bits.write(bytes_shifted, 2)
    bits.write(1 if escape else 0, 1)
    if partial:
        bits.write(num_samples, 32)


def _write_channel_params(bits: BitBuffer, mode: int, denshift: int,
                          pb_factor: int, coefs: np.ndarray, order: int) -> None:
    bits.write((mode << 4) | denshift, 8)
    bits.write((pb_factor << 5) | order, 8)
    for k in range(order):
        bits.write(int(coefs[k]) & 0xFFFF, 16)


def _rice_params(config: AlacConfig, num_samples: int, pb_factor: int) -> ag.AGParams:
    return ag.set_ag_params(
        config.mb, (config.pb * pb_factor) // 4, config.kb,
        num_samples, num_samples, config.max_run)


class ALACEncoder:
    """Stateful packet encoder mirroring the reference class surface."""

    def __init__(self, config: AlacConfig, independent_frames: bool = False,
                 search: str | None = None):
        if search is None:  # inherit the config knob (default "standard")
            search = getattr(config, "search", "standard")
        if search not in ("standard", "exhaustive"):
            raise AlacParamError(f"unknown search mode {search!r}")
        self.config = config
        self.search = search
        self.independent_frames = independent_frames
        # persistent coef banks: {(channel_index, order): coefs}
        self._coef_banks: dict[tuple[int, int], np.ndarray] = {}
        # stats (ALACEncoder members mTotalBytesGenerated etc.)
        self.total_bytes_generated = 0
        self.max_frame_bytes = 0
        self.frames_encoded = 0

    # -- public API --------------------------------------------------------
    def get_magic_cookie(self) -> bytes:
        cfg = self.config
        avg_bit_rate = 0
        if self.frames_encoded:
            total_samples = self.frames_encoded  # sample-frames encoded
            if total_samples:
                avg_bit_rate = int(
                    self.total_bytes_generated * 8 * cfg.sample_rate // total_samples)
        import dataclasses
        cfg_out = dataclasses.replace(
            cfg, max_frame_bytes=self.max_frame_bytes, avg_bit_rate=avg_bit_rate)
        return serialize_cookie(cfg_out)

    def encode_packet(self, pcm: np.ndarray) -> bytes:
        """Encode one packet of planar samples (num_channels, num_samples)."""
        pcm = np.asarray(pcm, dtype=np.int64)
        if pcm.ndim != 2 or pcm.shape[0] != self.config.num_channels:
            raise AlacParamError(f"expected ({self.config.num_channels}, n) planar pcm")
        num_samples = pcm.shape[1]
        if num_samples > self.config.frame_length or num_samples <= 0:
            raise AlacParamError("bad packet length")

        bits = BitBuffer(byte_size=self.config.max_escape_packet_bytes(num_samples))
        partial = num_samples != self.config.frame_length

        ch = 0
        tag_counters: dict[int, int] = {}
        for tag, width in self.config.elements:
            instance = tag_counters.get(int(tag), 0)
            tag_counters[int(tag)] = instance + 1
            if width == 2:
                self._encode_cpe(bits, tag, instance, pcm[ch], pcm[ch + 1],
                                 num_samples, partial, ch)
            else:
                self._encode_sce(bits, tag, instance, pcm[ch], num_samples,
                                 partial, ch)
            ch += width

        bits.write(int(ElementTag.END), 3)
        bits.byte_align(add_zeros=True)
        out = bits.to_bytes()

        self.total_bytes_generated += len(out)
        self.max_frame_bytes = max(self.max_frame_bytes, len(out))
        self.frames_encoded += num_samples
        return out

    # -- coef banks --------------------------------------------------------
    def _bank(self, channel: int, order: int) -> np.ndarray:
        key = (channel, order)
        if self.independent_frames or key not in self._coef_banks:
            self._coef_banks[key] = dp.init_coefs(DENSHIFT_DEFAULT)
        return self._coef_banks[key]

    # -- search ------------------------------------------------------------
    def _rice_cost(self, res: np.ndarray, num_samples: int,
                   chanbits: int) -> int:
        trial = BitBuffer(byte_size=6 * num_samples + 64)
        ag.dyn_comp(_rice_params(self.config, num_samples, PB_FACTOR), trial,
                    res, num_samples, chanbits)
        return trial.get_position()

    def _mixres_trial(self, l_hi: np.ndarray, r_hi: np.ndarray,
                      chanbits: int, num_samples: int) -> int:
        """Exact dilated stereo-mode trial (reference: EncodeStereo's
        subsampled search): mix every MIXRES_DILATE-th sample, predict
        with fresh order-8 coefs, Rice-cost both streams; argmin."""
        ld = np.asarray(l_hi[::MIXRES_DILATE])
        rd = np.asarray(r_hi[::MIXRES_DILATE])
        nd = len(ld)
        best_mr, best_cost = 0, None
        for mr in range(MAX_RES + 1):
            u, v = matrix.mix(ld, rd, DEFAULT_MIX_BITS, mr)
            cost = 0
            for s in (u, v):
                coefs = dp.init_coefs(DENSHIFT_DEFAULT)
                res = dp.pc_block(s, coefs, FAST_ORDER, chanbits,
                                  DENSHIFT_DEFAULT)
                cost += self._rice_cost(res, nd, chanbits)
            if best_cost is None or cost < best_cost:
                best_mr, best_cost = mr, cost
        return best_mr

    def _search_channel(self, stream: np.ndarray, ch_index: int,
                        chanbits: int, num_samples: int) -> dict:
        """Per-channel candidate search over order x stage.

        Returns the winner as dict(cost, mode, order, res, coefs0,
        coefs_adapted); cost = chparam + coef + Rice bits for this
        channel only (shared element fields are candidate-invariant).
        Candidate order (4,1),(4,2),(8,1),(8,2); first minimum wins.
        """
        if self.config.fast_mode:
            orders, stages = (FAST_ORDER,), (1,)
        else:
            orders, stages = SEARCH_ORDERS, SEARCH_STAGES
        best = None
        for order in orders:
            coefs0 = dp.copy_coefs(self._bank(ch_index, order))
            coefs = coefs0.copy()
            res1 = dp.pc_block(stream, coefs, order, chanbits,
                               DENSHIFT_DEFAULT)
            for stage in stages:
                if stage == 1:
                    res, mode = res1, 0
                else:
                    res = dp.pc_block(res1, coefs[:0], 31, chanbits, 0)
                    # wire value 15, matching the reference encoder
                    # (libavcodec cascades only on 15; decoders accept
                    # any nonzero)
                    mode = 15
                cost = 16 + 16 * order + self._rice_cost(
                    res, num_samples, chanbits)
                if best is None or cost < best["cost"]:
                    best = dict(cost=cost, mode=mode, order=order, res=res,
                                coefs0=coefs0, coefs_adapted=coefs)
        return best

    def _write_channel_body(self, bits: BitBuffer, win: dict,
                            num_samples: int, chanbits: int) -> None:
        ag.dyn_comp(_rice_params(self.config, num_samples, PB_FACTOR), bits,
                    win["res"], num_samples, chanbits)

    # -- CPE ---------------------------------------------------------------
    def _encode_cpe(self, bits: BitBuffer, tag: ElementTag, instance: int,
                    left: np.ndarray, right: np.ndarray, num_samples: int,
                    partial: bool, ch_index: int) -> None:
        cfg = self.config
        bs = bytes_shifted_for_depth(cfg.bit_depth)
        chanbits = cfg.bit_depth - 8 * bs + 1
        mixbits = DEFAULT_MIX_BITS

        l_hi, l_lo = matrix.shift_off(left, bs)
        r_hi, r_lo = matrix.shift_off(right, bs)

        # stereo mode: fast constant / dilated exact trial / exhaustive
        if cfg.fast_mode:
            mix_list = [FAST_MIX_RES]
        elif self.search == "exhaustive":
            mix_list = list(range(MAX_RES + 1))
        else:
            mix_list = [self._mixres_trial(l_hi, r_hi, chanbits, num_samples)]

        best = None  # (total_cost, mixres, winU, winV)
        for mixres in mix_list:
            u, v = matrix.mix(l_hi, r_hi, mixbits, mixres)
            win_u = self._search_channel(u, ch_index, chanbits, num_samples)
            win_v = self._search_channel(v, ch_index + 1, chanbits,
                                         num_samples)
            total = win_u["cost"] + win_v["cost"]
            if best is None or total < best[0]:
                best = (total, mixres, win_u, win_v)

        _, mixres, win_u, win_v = best
        shift_bits = 2 * num_samples * 8 * bs
        body_bits = 16 + win_u["cost"] + win_v["cost"] + shift_bits
        escape_bits = num_samples * cfg.bit_depth * 2
        # element headers are identical in both forms, so compare bodies
        if body_bits >= escape_bits:
            # escape frame: raw interleaved PCM at full depth
            _write_element_header(bits, tag, instance, partial, 0, True, num_samples)
            for j in range(num_samples):
                bits.write(int(left[j]) & ((1 << cfg.bit_depth) - 1), cfg.bit_depth)
                bits.write(int(right[j]) & ((1 << cfg.bit_depth) - 1), cfg.bit_depth)
            return

        # commit winning coef adaptation to the persistent banks
        self._coef_banks[(ch_index, win_u["order"])] = win_u["coefs_adapted"]
        self._coef_banks[(ch_index + 1, win_v["order"])] = win_v["coefs_adapted"]

        _write_element_header(bits, tag, instance, partial, bs, False, num_samples)
        bits.write(mixbits, 8)
        bits.write(mixres, 8)
        for win in (win_u, win_v):
            _write_channel_params(bits, win["mode"], DENSHIFT_DEFAULT,
                                  PB_FACTOR, win["coefs0"], win["order"])
        if bs:
            for j in range(num_samples):
                bits.write(int(l_lo[j]), bs * 8)
                bits.write(int(r_lo[j]), bs * 8)
        for win in (win_u, win_v):
            self._write_channel_body(bits, win, num_samples, chanbits)

    # -- SCE / LFE ---------------------------------------------------------
    def _encode_sce(self, bits: BitBuffer, tag: ElementTag, instance: int,
                    samples: np.ndarray, num_samples: int, partial: bool,
                    ch_index: int) -> None:
        cfg = self.config
        bs = bytes_shifted_for_depth(cfg.bit_depth)
        chanbits = cfg.bit_depth - 8 * bs
        s_hi, s_lo = matrix.shift_off(samples, bs)

        win = self._search_channel(s_hi, ch_index, chanbits, num_samples)

        # the 16 = mixBits/mixRes, written as (0, 0) in mono too — the
        # reference emits them in EVERY non-escape element and its
        # decoder reads them unconditionally (confirmed against
        # libavcodec's independent implementation, which interops with
        # Apple's: tests/test_ffmpeg_interop.py)
        body_bits = 16 + win["cost"] + num_samples * 8 * bs
        escape_bits = num_samples * cfg.bit_depth
        if body_bits >= escape_bits:
            _write_element_header(bits, tag, instance, partial, 0, True, num_samples)
            for j in range(num_samples):
                bits.write(int(samples[j]) & ((1 << cfg.bit_depth) - 1), cfg.bit_depth)
            return

        self._coef_banks[(ch_index, win["order"])] = win["coefs_adapted"]
        _write_element_header(bits, tag, instance, partial, bs, False, num_samples)
        bits.write(0, 8)   # mixBits (always 0 for mono)
        bits.write(0, 8)   # mixRes (always 0 for mono)
        _write_channel_params(bits, win["mode"], DENSHIFT_DEFAULT, PB_FACTOR,
                              win["coefs0"], win["order"])
        if bs:
            for j in range(num_samples):
                bits.write(int(s_lo[j]), bs * 8)
        self._write_channel_body(bits, win, num_samples, chanbits)


