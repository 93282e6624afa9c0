"""Fused Rice-decode + inverse-predictor scan (counterpart of
alacjax/ops/fused_decode.py; reference: codec/ag_dec.c :: dyn_decomp,
then codec/dp_dec.c :: unpc_block once or twice for the mode != 0
cascade).

Every substep decodes one Rice residual (or consumes one sample of a
pending zero run), feeds it through the first-difference stage
(mode != 0) and the ``taps``-wide adaptive FIR, and emits the
reconstructed sample — exactly alacjax's ``_rice_substep`` +
``_substep_core``.  ``taps`` is 8 on the production program and 16 or
30 on the codec's retry ladder.

One Rice cursor (``_RiceCursor``) serves three functions, as in
alacjax: the full decode, its ``raw`` mode (the signed residuals, behind
rice.rice_decode) and ``cursor_scan`` (end bits only; on no codec
path, the plain version of the Rice chain's timing instrument).  Lane l
of a call reads row l % rows of the (rows, W) word image, so one call
decodes stacked channels of the same packets without repeating the
image.

What the port drops: the TPU reads its bits through a sliding cache
refilled one row per scan step, with a drift budget whose underrun
flags a lane.  Here a lane reads its words directly, by an index
clamped to the image, so there is no refill, no cache shift and no
underrun flag; ``err`` is the zero-run overrun or an order the walk does
not cover.  These Python loops are the plain versions the decode
kernels (alacjax_torch/kernels/decode.py) are held to.
"""

from __future__ import annotations

import torch

from ..types import (
    MAX_PREFIX_16, MAX_PREFIX_32, MMULSHIFT, N_MAX_MEAN_CLAMP,
    N_MEAN_CLAMP_VAL, PBSHIFT, QB, QBSHIFT,
)

from . import tutils
from .tutils import (
    I32, I64, MASK32, clz32, count_work, iota1, sign_extend, u32, wrap_i32,
)

TAPS = 8                # the production FIR walk (fused_decode taps=8)
LADDER_TAPS = (16, 30)  # the codec's retry programs
_MAX_TAPS = 30          # largest 5-bit order that is not the mode-31 special


def _read32(words, bitpos):
    """32 bits at per-lane bit offset ``bitpos`` from the (rows, W) u32
    image, words addressed by a clamped index; lane l reads row
    l % rows."""
    R, W = words.shape
    L = bitpos.shape[0]
    flat = words.reshape(-1)
    base = (iota1(L, device=bitpos.device) % R) * W
    w = bitpos >> 5
    sh = bitpos & 31
    a = flat[base + torch.clamp(w, 0, W - 1)]
    b = flat[base + torch.clamp(w + 1, 0, W - 1)]
    return torch.where(sh == 0, a,
                       ((a << sh) & MASK32) | (b >> ((32 - sh) & 31)))


def _read_bits(words, bitpos, nbits):
    """``nbits`` (1..32, an int or per-lane) bits at per-lane ``bitpos``."""
    one = 1 if isinstance(nbits, int) else torch.ones_like(nbits)
    return _read32(words, bitpos) >> ((32 - nbits) & 31) & ((one << nbits) - 1)


def _codeword(stream, k):
    """Shared Rice prefix/suffix parse of a 32-bit window: returns
    (pre, v) with pre = number of leading ones, v = the k bits after the
    prefix's terminating zero."""
    pre = clz32(stream ^ MASK32)
    v = ((stream << torch.clamp(pre + 1, max=32)) & MASK32) >> ((32 - k) & 31)
    return pre, v


def coef_table(coefs0, taps: int):
    """(B, n) coefficient table -> (B, taps): cut, or padded with zeros
    (lanes whose order exceeds the table flag err anyway)."""
    n = coefs0.shape[1]
    return (coefs0[:, :taps] if n >= taps
            else torch.nn.functional.pad(coefs0, (0, taps - n)))


def _lane_rows(words, L: int) -> None:
    """Raise unless the L lanes map onto the image's rows: lane l reads
    row l % rows, so rows must divide L (rows = L: one row per lane;
    rows = B: n stacked channels of B packets)."""
    if L % words.shape[0]:
        raise ValueError(f"{L} lanes do not stack on {words.shape[0]} rows")


class _RiceCursor:
    """Per-lane adaptive-Rice decode state (alacjax fused_decode.
    _rice_substep): the bit cursor, the mean, the zero-run state, the
    sample counter and the overrun flag.  ``c0`` starts the counter
    (cursor_scan's skipped lanes start at S and never move)."""

    def __init__(self, words, start_bits, chanbits, mb0: int, pb, kb: int,
                 wb: int, n_eff, c0=None):
        L = start_bits.shape[0]
        dev = words.device
        zero = torch.zeros((L,), dtype=I64, device=dev)
        self.words = words
        self.chanbits = chanbits
        self.pb, self.kb, self.wb, self.n_eff = pb.to(I64), kb, wb, n_eff
        self.bitpos = start_bits.to(I64)
        self.mb = zero + mb0
        self.zmode = zero
        self.run_rem = zero
        self.c = zero if c0 is None else c0
        self.err = torch.zeros((L,), dtype=torch.bool, device=dev)

    def step(self):
        """One substep: (res (L,) int64, the residual, 0 inside a zero run
        or past the lane's count; active (L,) bool, the lane's counter
        still below its count)."""
        words, chanbits, kb, wb, n_eff = (self.words, self.chanbits, self.kb,
                                          self.wb, self.n_eff)
        bitpos, mb, zmode, run_rem, c = (self.bitpos, self.mb, self.zmode,
                                         self.run_rem, self.c)
        active = c < n_eff
        in_run = run_rem > 0
        decode_now = active & ~in_run
        count_work("coded", decode_now)
        m0 = mb >> QBSHIFT
        k = torch.clamp(31 - clz32(m0 + 3), max=kb)
        m = (1 << k) - 1

        stream = _read32(words, bitpos)
        pre, v = _codeword(stream, k)
        esc = pre >= MAX_PREFIX_32
        use_v = (k != 1) & ~esc
        vge2 = v >= 2
        n_plain = (pre * m + torch.where(use_v & vge2, v - 1, 0)) & MASK32
        adv_plain = pre + 1 + torch.where(use_v, torch.where(vge2, k, k - 1), 0)
        raw = _read_bits(words, bitpos + MAX_PREFIX_32, chanbits)
        n = torch.where(esc, raw, n_plain)
        adv = torch.where(esc, MAX_PREFIX_32 + chanbits, adv_plain)

        ndecode = (n + zmode) & MASK32
        half = ndecode >> 1
        delta = torch.where((ndecode & 1) == 1, -(half + 1), half)

        c1 = c + 1
        mb_upd = (self.pb * ndecode + mb
                  - (((self.pb * mb) & MASK32) >> PBSHIFT)) & MASK32
        mb_upd = torch.where(n > N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, mb_upd)
        trigger = (decode_now & (((mb_upd << MMULSHIFT) & MASK32) < QB)
                   & (c1 < n_eff))
        count_work("runs", trigger)

        # zero-run codeword (speculative; used where trigger)
        kz = clz32(mb_upd) - 24 + (((mb_upd + 16) & MASK32) >> 6)
        kzc = torch.clamp(kz, 0, 31)
        mz = ((1 << kzc) - 1) & wb
        pos2 = bitpos + adv
        pre2, v2 = _codeword(_read32(words, pos2), kzc)
        esc2 = pre2 >= MAX_PREFIX_16
        v2ge2 = v2 >= 2
        nz_plain = (pre2 * torch.where(mz == 0, 1, mz)
                    + torch.where((kz != 1) & v2ge2, v2 - 1, 0)) & MASK32
        adv2_plain = pre2 + 1 + torch.where(
            kz != 1, torch.where(v2ge2, kz, kz - 1), 0)
        raw2 = _read_bits(words, pos2 + MAX_PREFIX_16, 16)
        nz = torch.where(esc2, raw2, nz_plain)
        adv2 = torch.where(esc2, MAX_PREFIX_16 + 16, adv2_plain)

        overrun = trigger & (((c1 + nz) & MASK32) > (n_eff & MASK32))
        self.err = self.err | overrun
        nz_safe = torch.where(overrun, 0, nz)

        self.run_rem = torch.where(
            active, torch.where(in_run, run_rem - 1,
                                torch.where(trigger, nz_safe, 0)), run_rem)
        self.zmode = torch.where(
            decode_now, (trigger & (nz_safe < 65535) & ~overrun).to(I64),
            zmode)
        self.mb = torch.where(decode_now, torch.where(trigger, 0, mb_upd), mb)
        self.bitpos = torch.where(
            decode_now, bitpos + adv + torch.where(trigger, adv2, 0), bitpos)
        self.c = torch.where(active, c1, c)
        return torch.where(decode_now, delta, 0), active


def _sample_counts(L: int, S: int, num, device):
    return (torch.full((L,), S, dtype=I64, device=device) if num is None
            else num.to(I64))


def cursor_scan(words, start_bits, num_samples: int, chanbits, mb0: int, pb,
                kb: int, wb: int, chanbits_max: int | None = None,
                skip=None, num=None):
    """The Rice cursor alone (alacjax fused_decode.cursor_scan): walk each
    lane's codewords over ``num_samples`` substeps without reconstructing
    samples: where the lane's stream ends, which is where the next
    channel's starts.  The codec's decode does not call it; it is the
    plain version of the Rice chain's timing instrument.  Lane l of the L
    per-lane arguments reads row l % rows of the (rows, W) image.
    ``skip`` ((L,) bool) lanes do not move: their end is their start and
    their err 0.  ``num`` (per-lane, <= S) walks only the first num
    samples.  ``chanbits_max`` bounds a per-lane ``chanbits`` (only the
    kernel reads it).  Returns (end_bits (L,) int32, err (L,) bool): err
    is the zero-run overrun (alacjax's also holds its TPU bit cache's
    drift flag, which this port has no cache for)."""
    L = start_bits.shape[0]
    S = num_samples
    _lane_rows(words, L)
    dev = words.device
    if not isinstance(chanbits, int):
        chanbits = chanbits.to(I64)
    n_eff = _sample_counts(L, S, num, dev)
    c0 = None
    if skip is not None:
        c0 = torch.where(skip, S, 0).to(I64)
    cur = _RiceCursor(u32(words), start_bits, chanbits, mb0, pb, kb, wb,
                      n_eff, c0)
    for _ in range(S):
        cur.step()
    end, err = cur.bitpos, cur.err
    if skip is not None:
        end = torch.where(skip, start_bits.to(I64), end)
        err = err & ~skip
    return end.to(I32), err


def decode_channel(words, start_bits, num_samples: int, chanbits,
                   mb0: int, pb, kb: int, wb: int, coefs0, mode, numactive,
                   denshift, num=None, taps: int = TAPS,
                   chanbits_max: int | None = None, raw: bool = False):
    """Decode + reconstruct one channel, or stacked channels: (rows, W)
    words -> (L, S) samples.

    start_bits/pb/coefs0/mode/numactive/denshift are per-lane tensors of
    L lanes; lane l reads row l % rows of the image (rows = L for one
    channel; rows = B for n channels of B packets stacked channel-major,
    without repeating the image).
    ``chanbits`` is an int or a per-lane (L,) tensor whose values are at
    most ``chanbits_max`` (only the kernel reads the bound).  ``num``
    (per-lane, <= S) decodes only the first num samples of each lane.
    ``taps`` (1..30) is the width of the FIR walk.  Returns (samples
    (L, S) int32, end_bits (L,) int32, err (L,) bool).  Lanes with an
    order above the walk (other than 31) flag err.

    ``raw=True`` (alacjax's raw mode, behind rice.rice_decode) returns
    the signed residual stream instead of samples, with ``chanbits`` the
    escape payload width; the predictor arguments are then not read
    (None will do) and err is the zero-run overrun alone."""
    if not 1 <= taps <= _MAX_TAPS:
        raise ValueError(f"taps must be in 1..{_MAX_TAPS}, got {taps}")
    L = start_bits.shape[0]
    S = num_samples
    _lane_rows(words, L)
    dev = words.device
    if not isinstance(chanbits, int):
        chanbits = chanbits.to(I64)
    n_eff = _sample_counts(L, S, num, dev)
    cur = _RiceCursor(u32(words), start_bits, chanbits, mb0, pb, kb, wb,
                      n_eff)
    if raw:
        outs = [cur.step()[0] for _ in range(S)]
        return (torch.stack(outs, dim=1).to(I32), cur.bitpos.to(I32),
                cur.err)
    na = numactive.to(I64)
    na_k = torch.clamp(torch.clamp(na, 1, _MAX_TAPS), max=taps)
    den = torch.clamp(denshift.to(I64), min=1)
    denhalf = 1 << (den - 1)
    mode_nz = mode.to(I64) != 0
    is0 = na == 0
    is31 = na == 31
    tap = iota1(taps, device=dev)[None, :]
    tap_on = tap < na_k[:, None]             # the taps this lane's walk uses
    walks = ~(is0 | is31)[:, None]           # lanes whose output is the walk's
    weight = na_k[:, None] - tap             # (na - k): a tap's step weight

    zero = torch.zeros((L,), dtype=I64, device=dev)
    c = zero
    lags = torch.zeros((L, taps + 1), dtype=I64, device=dev)
    coefs = coef_table(coefs0, taps).to(I64)
    s1_acc = zero
    acc31 = zero
    outs = []
    for _ in range(S):
        # ---- Rice codeword (fused_decode._rice_substep) ----
        res, active = cur.step()

        # ---- fused predictor (fused_decode._substep_core) ----
        s1_acc2 = torch.where(active, wrap_i32(s1_acc + res), s1_acc)
        x_t = torch.where(mode_nz, sign_extend(s1_acc2, chanbits), res)
        top = torch.gather(lags, 1, na_k[:, None])[:, 0]
        in_warm = c <= na_k
        diff = lags[:, :taps] - top[:, None]
        sum1 = denhalf + torch.where(tap_on, coefs * diff, 0).sum(dim=1)
        pred_adj = wrap_i32(sum1) >> den
        out_gen = sign_extend(x_t + top + pred_adj, chanbits)
        out_warm = sign_extend(x_t + lags[:, 0], chanbits)
        out = torch.where(c == 0, x_t, torch.where(in_warm, out_warm, out_gen))

        # sign-sign adaptation, from the last tap down; a tap acts only
        # while the error keeps its side (dp_dec.c early exit).  Tap k
        # sees the error less the steps of every acting tap above it, so
        # the walk is a reversed cumulative sum of the steps, cut at the
        # first tap that finds the error on the wrong side.
        sg = torch.sign(x_t)
        pos = (sg > 0)[:, None]
        dd = wrap_i32(-diff)
        sgn = torch.sign(dd)
        mag = wrap_i32(sgn * dd)
        step = weight * torch.where(pos, mag >> den[:, None],
                                    wrap_i32(-mag) >> den[:, None])
        can = tap_on & (active & ~in_warm & (sg != 0))[:, None]
        step_c = torch.where(can, step, 0)
        above = torch.flip(torch.cumsum(torch.flip(step_c, [1]), 1), [1]) - step_c
        err_k = wrap_i32(x_t[:, None] - above)     # the error tap k sees
        ok = ~can | (torch.sign(err_k) == sg[:, None])
        still = torch.flip(torch.cumprod(torch.flip(ok.to(I64), [1]), 1), [1])
        acts = can & (still == 1)
        count_work("taps", acts & walks)
        if tutils.WORK is not None:
            # how many taps act in each step that may adapt: 0..na_k
            n_act = acts.sum(dim=1)
            stops = torch.nn.functional.one_hot(n_act, taps + 1).bool()
            count_work("stops", stops & (walks & active[:, None]
                                         & ~in_warm[:, None]))
        upd = torch.where(acts, torch.where(pos, -sgn, sgn), 0)
        new_coefs = sign_extend(coefs + upd, 16)

        # special-mode overlays (mode 0: pass-through; mode 31: cumsum)
        acc31_2 = torch.where(active, wrap_i32(acc31 + x_t), acc31)
        out = torch.where(is0, x_t,
                          torch.where(is31, sign_extend(acc31_2, chanbits), out))
        outs.append(out)

        on = active[:, None]
        lags = torch.where(on, torch.cat([out[:, None], lags[:, :taps]], 1),
                           lags)
        coefs = torch.where(on, new_coefs, coefs)
        s1_acc, acc31 = s1_acc2, acc31_2
        c = torch.where(active, c + 1, c)

    big = (na > taps) & (na != 31)
    samples = torch.stack(outs, dim=1).to(I32)
    return samples, cur.bitpos.to(I32), cur.err | big
