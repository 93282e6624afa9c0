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

What the port drops: the TPU reads its bits through a sliding cache
refilled one row per scan step, with a drift budget whose underrun
flags a lane.  Here a lane reads its words directly, by an index
clamped to the image, so there is no refill, no cache shift and no
underrun flag; ``err`` is the zero-run overrun or an order the walk does
not cover.  This Python loop is the plain version the decode kernels
(alacjax_torch/kernels/decode.py) are held to.
"""

from __future__ import annotations

import torch

from ..types import (
    MAX_PREFIX_16, MAX_PREFIX_32, MMULSHIFT, N_MAX_MEAN_CLAMP,
    N_MEAN_CLAMP_VAL, PBSHIFT, QB, QBSHIFT,
)

from .tutils import (
    I32, I64, MASK32, clz32, count_work, iota1, sign_extend, u32, wrap_i32,
)

TAPS = 8                # the production FIR walk (fused_decode taps=8)
LADDER_TAPS = (16, 30)  # the codec's retry programs
_MAX_TAPS = 30          # largest 5-bit order that is not the mode-31 special


def _read32(words, bitpos):
    """32 bits at per-lane bit offset ``bitpos`` from the (B, W) u32
    image, words addressed by a clamped index."""
    W = words.shape[1]
    w = bitpos >> 5
    sh = bitpos & 31
    a = torch.gather(words, 1, torch.clamp(w, 0, W - 1)[:, None])[:, 0]
    b = torch.gather(words, 1, torch.clamp(w + 1, 0, W - 1)[:, None])[:, 0]
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


def decode_channel(words, start_bits, num_samples: int, chanbits,
                   mb0: int, pb, kb: int, wb: int, coefs0, mode, numactive,
                   denshift, num=None, taps: int = TAPS,
                   chanbits_max: int | None = None):
    """Decode + reconstruct one channel: (B, W) words -> (B, S) samples.

    start_bits/pb/coefs0/mode/numactive/denshift are per-lane tensors.
    ``chanbits`` is an int or a per-lane (B,) tensor whose values are at
    most ``chanbits_max`` (only the kernel reads the bound).  ``num``
    (per-lane, <= S) decodes only the first num samples of each lane.
    ``taps`` (1..30) is the width of the FIR walk.  Returns (samples
    (B, S) int32, end_bits (B,) int32, err (B,) bool).  Lanes with an
    order above the walk (other than 31) flag err."""
    if not 1 <= taps <= _MAX_TAPS:
        raise ValueError(f"taps must be in 1..{_MAX_TAPS}, got {taps}")
    B, W = words.shape
    S = num_samples
    dev = words.device
    words = u32(words)
    if not isinstance(chanbits, int):
        chanbits = chanbits.to(I64)
    n_eff = (torch.full((B,), S, dtype=I64, device=dev) if num is None
             else num.to(I64))
    pb_v = pb.to(I64)
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

    zero = torch.zeros((B,), dtype=I64, device=dev)
    bitpos = start_bits.to(I64)
    mb = zero + mb0
    zmode = zero
    run_rem = zero
    c = zero
    err = torch.zeros((B,), dtype=torch.bool, device=dev)
    lags = torch.zeros((B, taps + 1), dtype=I64, device=dev)
    coefs = coef_table(coefs0, taps).to(I64)
    s1_acc = zero
    acc31 = zero
    outs = []
    for _ in range(S):
        # ---- Rice codeword (fused_decode._rice_substep) ----
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
        mb_upd = (pb_v * ndecode + mb
                  - (((pb_v * mb) & MASK32) >> PBSHIFT)) & MASK32
        mb_upd = torch.where(n > N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, mb_upd)
        trigger = (decode_now & (((mb_upd << MMULSHIFT) & MASK32) < QB)
                   & (c1 < n_eff))

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
        err = err | overrun
        nz_safe = torch.where(overrun, 0, nz)

        res = torch.where(decode_now, delta, 0)
        run_rem = torch.where(
            active, torch.where(in_run, run_rem - 1,
                                torch.where(trigger, nz_safe, 0)), run_rem)
        zmode = torch.where(
            decode_now, (trigger & (nz_safe < 65535) & ~overrun).to(I64),
            zmode)
        mb = torch.where(decode_now, torch.where(trigger, 0, mb_upd), mb)
        bitpos = torch.where(
            decode_now, bitpos + adv + torch.where(trigger, adv2, 0), bitpos)

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
        c = torch.where(active, c1, c)

    big = (na > taps) & (na != 31)
    samples = torch.stack(outs, dim=1).to(I32)
    return samples, bitpos.to(I32), err | big
