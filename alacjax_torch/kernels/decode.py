"""Wrappers of the fused decode kernel (csrc/decode.cu), one source with
an instance per tap count and two of its Rice warp alone.  The 8-tap
instance is the port of alacjax/ops/pallas/decode_step.py and counts
under ``LAUNCHES["decode"]``; the 16- and 30-tap instances, which the
codec's retry ladder runs, are the port of
alacjax/ops/pallas/decode_pallas.py and count under
``LAUNCHES["decode_hi"]``.  The cursor instance (``cursor_scan``, the
Rice warp alone, on no codec path: the instrument that times the Rice
chain apart from the FIR walk, and the counterpart of alacjax's
fused_decode.cursor_scan) counts under
``LAUNCHES["decode_cursor"]``, the raw instance (``decode_channel(...,
raw=True)``, behind ops.rice.rice_decode) under ``LAUNCHES["decode_raw"]``.
Every instance reads lane l's bits from row l % rows of the (rows, W)
word image (decode_step_pallas's stacked row map), so a launch over n
channels of B packets reads the (B, W) image in place.  Plain versions:
alacjax_torch.ops.fused_decode.decode_channel and cursor_scan."""

from __future__ import annotations

import torch

from ..ops import fused_decode
from . import LAUNCHES, expect, lane_vector, launch, on_cuda

plain = fused_decode.decode_channel     # the plain version, same signature
plain_cursor = fused_decode.cursor_scan
KERNEL_TAPS = (fused_decode.TAPS,) + fused_decode.LADDER_TAPS
MAX_CHANBITS = 33        # one past a 32-bit channel: sign extensions give 0


# The Rice warps' counts of lane-steps per block that follow the cycles in
# ``cycles=``: those on which the zero-run guard fired, those on which a
# zero run began, and those whose window the ring did not hold (read from
# device memory, or for the cursor its ring restaged).
COUNTS = ("guard_fired", "run_triggered", "window_unstaged")


def cycle_rows(full: bool) -> int:
    """Rows of an instance's ``cycles=`` tensor: the Rice warps' cycles,
    the FIR warps' for a full decode (``full``), then ``COUNTS``."""
    return (2 if full else 1) + len(COUNTS)


def counter(taps: int, raw: bool = False) -> str:
    """The LAUNCHES key of the instance with this tap count (or raw)."""
    if raw:
        return "decode_raw"
    return "decode" if taps == fused_decode.TAPS else "decode_hi"


def _lanes(words, start_bits, named):
    """Check the image and the (L,) per-lane tensors; return (L, rows)."""
    rows, W = words.shape
    expect(words, "words", (rows, W))
    L = start_bits.shape[0]
    if rows < 1 or L % rows:
        raise ValueError(f"{L} lanes do not stack on {rows} word rows")
    expect(start_bits, "start_bits", (L,))
    for name, t in named:
        if t is not None:
            expect(t, name, (L,))
    return L, rows


def _chanbits(chanbits, chanbits_max, L: int, dev):
    """(per-lane int32 chanbits, their bound) for the kernel."""
    if isinstance(chanbits, torch.Tensor):
        if chanbits_max is None:
            raise ValueError("per-lane chanbits need chanbits_max")
    else:
        chanbits_max = chanbits
    if not 1 <= chanbits_max <= MAX_CHANBITS:
        raise ValueError(f"chanbits_max must be in 1..{MAX_CHANBITS}, "
                         f"got {chanbits_max}")
    return lane_vector(chanbits, L, dev, "chanbits"), chanbits_max


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_channel(words, start_bits, num_samples: int, chanbits,
                   mb0: int, pb, kb: int, wb: int, coefs0, mode, numactive,
                   denshift, num=None, taps: int = fused_decode.TAPS,
                   chanbits_max: int | None = None, raw: bool = False,
                   cycles=None):
    """(rows, W) int32 word image -> (samples (L, S) int32, end_bits (L,)
    int32, err (L,) bool): one channel (L = rows) or n stacked channels
    (L = n rows, lane l on row l % rows) through the ``taps``-wide walk
    (8, 16 or 30).  Per-lane args are (L,) int32; coefs0 is (L, n)
    int32.  ``chanbits`` is an int, or an (L,) int32 tensor whose values
    are at most ``chanbits_max`` (at most 33).  ``raw=True`` launches the
    raw instance: the signed residuals, ``chanbits`` the escape width,
    the predictor arguments not read (None will do), err the zero-run
    overrun alone.  ``cycles`` (CUDA only, int64) receives the Rice
    warps' clock64 cycles inside their decode loops, one per block of 32
    lanes, in its first row; the full decode's second row holds the FIR
    warps' cycles inside their walks; the last ``len(COUNTS)`` rows the
    Rice warps' counts (``COUNTS``): shape (4, ceil(L / 32)) for the raw
    instance, (5, ceil(L / 32)) for the full decode."""
    lane = (start_bits, pb, coefs0, mode, numactive, denshift, num)
    if isinstance(chanbits, torch.Tensor):
        lane = lane + (chanbits,)
    if not on_cuda(words, *lane):
        return plain(words, start_bits, num_samples, chanbits, mb0, pb, kb,
                     wb, coefs0, mode, numactive, denshift, num=num,
                     taps=taps, chanbits_max=chanbits_max, raw=raw)
    if not raw and taps not in KERNEL_TAPS:
        raise ValueError(f"no decode kernel instance for taps={taps}; "
                         f"built: {KERNEL_TAPS}")
    S = num_samples
    per_lane = [("pb", pb), ("num", num)]
    if not raw:
        per_lane += [("mode", mode), ("numactive", numactive),
                     ("denshift", denshift)]
    L, rows = _lanes(words, start_bits, per_lane)
    dev = words.device
    cb_lane, chanbits_max = _chanbits(chanbits, chanbits_max, L, dev)
    samples = torch.empty((L, S), dtype=torch.int32, device=dev)
    end = torch.empty((L,), dtype=torch.int32, device=dev)
    err = torch.empty((L,), dtype=torch.int32, device=dev)
    W = words.shape[1]
    if cycles is not None:
        expect(cycles, "cycles", (cycle_rows(not raw), -(-L // 32)),
               torch.int64)
    if raw:
        launch("alac_decode_raw", words,
               words.data_ptr(), start_bits.data_ptr(), cb_lane.data_ptr(),
               pb.data_ptr(), _ptr(num), samples.data_ptr(), end.data_ptr(),
               err.data_ptr(), _ptr(cycles), L, rows, W, S, chanbits_max,
               mb0, kb, wb)
    else:
        expect(coefs0, "coefs0", (L, coefs0.shape[1]))
        launch("alac_decode", words,
               words.data_ptr(), start_bits.data_ptr(), cb_lane.data_ptr(),
               pb.data_ptr(), coefs0.data_ptr(), coefs0.shape[1],
               mode.data_ptr(), numactive.data_ptr(), denshift.data_ptr(),
               _ptr(num), samples.data_ptr(), end.data_ptr(), err.data_ptr(),
               _ptr(cycles), L, rows, W, S, taps, chanbits_max, mb0, kb, wb)
    LAUNCHES[counter(taps, raw)] += 1
    return samples, end, err != 0


def cursor_scan(words, start_bits, num_samples: int, chanbits, mb0: int, pb,
                kb: int, wb: int, chanbits_max: int | None = None,
                skip=None, num=None, cycles=None):
    """The cursor instance, on no codec path (the Rice chain's timing
    instrument): (rows, W) int32 word image -> (end_bits (L,)
    int32, err (L,) bool) of each lane's Rice stream over
    ``num_samples`` (or ``num``) samples, with no samples out; lane l
    reads row l % rows.  ``skip`` ((L,) bool) lanes stay at their start
    with err 0.  err is the decode's own zero-run overrun: alacjax's
    cursor_scan also sets it for its TPU bit cache's drift or underrun
    (fused_decode.py:398-399), a structure this port does not have, so
    the two agree wherever no such drift arises.  ``cycles`` (CUDA only:
    a (4, ceil(L / 32)) int64 tensor) receives each Rice warp's clock64
    cycles inside its loop, then its counts (``COUNTS``; a restage of
    its ring counts as a window not staged)."""
    lane = (start_bits, pb, skip, num)
    if isinstance(chanbits, torch.Tensor):
        lane = lane + (chanbits,)
    if not on_cuda(words, *lane):
        return plain_cursor(words, start_bits, num_samples, chanbits, mb0,
                            pb, kb, wb, chanbits_max=chanbits_max, skip=skip,
                            num=num)
    L, rows = _lanes(words, start_bits, [("pb", pb), ("num", num)])
    dev = words.device
    cb_lane, chanbits_max = _chanbits(chanbits, chanbits_max, L, dev)
    skip_i = None
    if skip is not None:
        if skip.shape != (L,):
            raise ValueError(f"skip: expected shape {(L,)}, got "
                             f"{tuple(skip.shape)}")
        skip_i = skip.to(torch.int32).contiguous()
    if cycles is not None:
        expect(cycles, "cycles", (cycle_rows(False), -(-L // 32)),
               torch.int64)
    end = torch.empty((L,), dtype=torch.int32, device=dev)
    err = torch.empty((L,), dtype=torch.int32, device=dev)
    launch("alac_decode_cursor", words,
           words.data_ptr(), start_bits.data_ptr(), cb_lane.data_ptr(),
           pb.data_ptr(), _ptr(skip_i), _ptr(num), end.data_ptr(),
           err.data_ptr(), _ptr(cycles), L, rows, words.shape[1], num_samples,
           chanbits_max, mb0, kb, wb)
    LAUNCHES["decode_cursor"] += 1
    return end, err != 0
