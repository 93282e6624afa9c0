"""Batched adaptive Rice coding, encode side (counterpart of
alacjax/ops/rice.py; oracle: alacjax.oracle.ag; reference:
codec/ag_enc.c).

The token machine runs as a Python loop over the sample axis with every
frame lane in a (B,) tensor — the plain version that the emission
kernel (alacjax_torch/kernels/emit.py) and the cost machines of the
predict kernel are held to.  Unsigned state is int64 in [0, 2^32)
(see ops/tutils.py); results are int32, words and keys as bit patterns.
"""

from __future__ import annotations

import torch

from ..types import (
    BITOFF, MAX_PREFIX_16, MAX_PREFIX_32, MAX_RICE_NUMBITS, MDENSHIFT,
    MMULSHIFT, MOFF, N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, PBSHIFT, QB,
    QBSHIFT,
)

from .tutils import (
    I32, I64, MASK32, as_i32_bits, clz32, count_work, lg3a, wrap_i32,
)


def _divmod_capped(n, m):
    """(min(n // m, 9), n mod m — exact for quotients <= 8): the same
    threshold count as alacjax (m <= 16383, so 9*m cannot wrap)."""
    j = torch.arange(1, 10, dtype=I64, device=n.device)
    div = (n[:, None] >= m[:, None] * j).sum(dim=1)
    return div, (n - m * div) & MASK32


def _dyn_code_32(m, k, n):
    """ag_enc.c :: dyn_code_32bit -> (esc, val1, len1); the escape
    payload (n, bit_size) is appended by the caller."""
    div, mod = _divmod_capped(n, m)
    de = (mod == 0).to(I64)
    nb = div + k + 1 - de
    esc = (div >= MAX_PREFIX_32) | (nb > MAX_RICE_NUMBITS)
    prefix = (1 << div) - 1
    val = ((prefix << (nb - div)) + mod + 1 - de) & MASK32
    val1 = torch.where(esc, (1 << MAX_PREFIX_32) - 1, val)
    len1 = torch.where(esc, MAX_PREFIX_32, nb)
    return esc, val1, len1


def _dyn_code_16(m, k, n):
    """ag_enc.c :: dyn_code (zero-run lengths; n <= 65535)."""
    m = torch.clamp(m, min=1)
    div, mod = _divmod_capped(n, m)
    esc = div >= MAX_PREFIX_16
    de = (mod == 0).to(I64)
    nb = div + k + 1 - de
    sh = torch.clamp(nb - div, min=0)
    val = ((((1 << div) - 1) << sh) + mod + 1 - de) & MASK32
    val_esc = (((1 << MAX_PREFIX_16) - 1) << 16) | n
    return (torch.where(esc, val_esc, val),
            torch.where(esc, MAX_PREFIX_16 + 16, nb))


def _run_kz_mz(mb, wb: int):
    """Zero-run Rice parameter from the collapsed mean.  Only lanes that
    start a run read it (mb < 128 there, so 1 <= kz <= 10); the clamp
    keeps the others' shift in range."""
    kz = clz32(mb) - BITOFF + (((mb + MOFF) & MASK32) >> MDENSHIFT)
    mz = ((1 << torch.clamp(kz, 0, 31)) - 1) & wb
    return kz, mz


def init_state(B: int, mb0: int, device=None):
    """(mb, in_run, run_len, run_kz, run_mz) per lane."""
    z = torch.zeros((B,), dtype=I64, device=device)
    return (z + mb0, torch.zeros((B,), dtype=torch.bool, device=device),
            z, z, z)


def encode_step_tokens(x, t: int, state, *, S, bit_size, pb: int, kb: int,
                       wb: int):
    """One step of the token machine (rice._encode_step_tokens): returns
    (new_state, vals, lens) with token slots [zero-run codeword, residual
    codeword, escape payload].  ``t == S`` is the virtual end step that
    flushes a pending run token.  ``x`` is the (B,) residual.  ``S`` and
    ``bit_size`` are ints or per-lane (B,) int64 tensors: with a per-lane
    ``S`` (partial frames) a lane is past its end once t >= S, so its
    pending run flushes exactly at S and later steps emit nothing."""
    mb, in_run, run_len, run_kz, run_mz = state
    valid = t < S
    x = wrap_i32(x)

    nonzero = x != 0
    run_end_nonzero = in_run & nonzero & valid
    run_len_new = run_len + 1
    cap = in_run & ~nonzero & valid & (run_len_new >= 65535)
    flush = in_run & (~valid if isinstance(valid, torch.Tensor) else not valid)
    emit_run = run_end_nonzero | cap | flush
    nz = torch.where(cap, run_len_new, run_len)
    run_val, run_bits = _dyn_code_16(run_mz, run_kz, nz)
    run_bits = torch.where(emit_run, run_bits, 0)

    code_now = valid & (~in_run | run_end_nonzero)
    count_work("coded", code_now)
    zmode = run_end_nonzero.to(I64)

    m0 = mb >> QBSHIFT
    k = torch.clamp(lg3a(m0), max=kb)
    m = (1 << k) - 1
    n = (x.abs() * 2 - (x < 0).to(I64) - zmode) & MASK32
    esc, val1, len1 = _dyn_code_32(m, k, n)
    len1 = torch.where(code_now, len1, 0)
    len2 = torch.where(code_now & esc, bit_size, 0)

    # mb EMA update + clamp (uint32 wrap: pb*mb wraps before the shift)
    mb_upd = (pb * (n + zmode) + mb - (((pb * mb) & MASK32) >> PBSHIFT)) & MASK32
    mb_upd = torch.where(n > N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, mb_upd)
    mb1 = torch.where(code_now, mb_upd, mb)

    trigger = code_now & (((mb1 << MMULSHIFT) & MASK32) < QB) & (t + 1 < S)
    kz, mz = _run_kz_mz(mb1, wb)
    run_kz2 = torch.where(trigger, kz, run_kz)
    run_mz2 = torch.where(trigger, mz, run_mz)
    mb2 = torch.where(trigger, 0, mb1)

    continuing = in_run & ~nonzero & valid & ~cap
    in_run2 = continuing | trigger
    run_len2 = torch.where(continuing, run_len_new, 0)
    return ((mb2, in_run2, run_len2, run_kz2, run_mz2),
            (run_val, val1, n), (run_bits, len1, len2))


def step_bits(x, t: int, state, **kw):
    """Cost-only step: (new_state, bits spent this step)."""
    state, _, lens = encode_step_tokens(x, t, state, **kw)
    return state, lens[0] + lens[1] + lens[2]


def lane_arg(v):
    """An int, or a per-lane tensor as int64 (the machines' arithmetic)."""
    return v if isinstance(v, int) else v.to(I64)


def rice_cost(res, bit_size, mb0: int, pb: int, kb: int, wb: int, num=None):
    """Total Rice bits per frame lane (B,) int32 — the search's cost
    metric (rice.rice_cost).  ``bit_size`` is an int or per-lane (B,);
    ``num`` (per-lane (B,), <= S) costs only each lane's first num
    samples (partial frames)."""
    B, S = res.shape
    kw = dict(S=S if num is None else lane_arg(num),
              bit_size=lane_arg(bit_size), pb=pb, kb=kb, wb=wb)
    state = init_state(B, mb0, res.device)
    total = torch.zeros((B,), dtype=I64, device=res.device)
    ones = torch.ones((B,), dtype=I64, device=res.device)
    for t in range(S + 1):
        x = res[:, t].to(I64) if t < S else ones
        state, bits = step_bits(x, t, state, **kw)
        total = total + bits
    return total.to(I32)


def _append_bits(acc, fill, wcount, v, L):
    """Append the low-L bits of v (L <= 32, possibly 0) to the MSB-first
    word accumulator.  Returns (acc', fill', wcount', word, emitted)."""
    vmask = torch.where(L >= 32, MASK32, (1 << torch.clamp(L, max=31)) - 1)
    v = v & vmask
    total = fill + L
    ge = total >= 32
    sh_out = torch.clamp(total - 32, 0, 31)
    out_word = acc | (v >> sh_out)
    acc_ge = torch.where(sh_out == 0, 0, (v << ((32 - sh_out) % 32)) & MASK32)
    sh_in = torch.clamp(32 - total, 0, 31)
    acc_lt = acc | torch.where(ge, 0, (v << sh_in) & MASK32)
    acc2 = torch.where(ge, acc_ge, acc_lt)
    fill2 = torch.where(ge, total - 32, total)
    return acc2, fill2, wcount + ge.to(I64), out_word, ge


def emit_slots(bit_size_cap: int) -> int:
    """Word slots per step: at most (31 + run <= 25 + prefix 9 + the
    escape payload) // 32 words complete in one step."""
    return (31 + 25 + MAX_PREFIX_32 + bit_size_cap) // 32


def rice_encode_words(res, bit_size, mb0: int, pb: int, kb: int, wb: int,
                      start_bits, bit_size_cap: int | None = None, num=None):
    """Residuals (B, S) -> phase-aligned packed word chunks
    (rice.rice_encode_words with emit_flush=False: the codec's mode,
    which leaves the final partial word out of the chunks as the tail).
    ``bit_size`` is an int or a per-lane (B,) tensor whose values are at
    most ``bit_size_cap`` (which sizes the slots); ``num`` (per-lane
    (B,), <= S) encodes only each lane's first num samples.

    Returns (chunk_words (B, n_slots*(S+1)), chunk_keys (same) — int32
    bit patterns, -1 (0xFFFFFFFF) marking empty slots — end_bits (B,),
    tail_val (B,), tail_key (B,))."""
    B, S = res.shape
    dev = res.device
    kw = dict(S=S if num is None else lane_arg(num),
              bit_size=lane_arg(bit_size), pb=pb, kb=kb, wb=wb)
    start_bits = start_bits.to(I64)
    base_word = start_bits >> 5
    n_slots = emit_slots(bit_size if isinstance(bit_size, int)
                         else bit_size_cap)
    words = torch.zeros((B, S + 1, n_slots), dtype=I64, device=dev)
    keys = torch.full((B, S + 1, n_slots), MASK32, dtype=I64, device=dev)

    state = init_state(B, mb0, dev)
    acc = torch.zeros((B,), dtype=I64, device=dev)
    fill = start_bits & 31
    wcount = torch.zeros((B,), dtype=I64, device=dev)
    ones = torch.ones((B,), dtype=I64, device=dev)
    for t in range(S + 1):
        x = res[:, t].to(I64) if t < S else ones
        state, vals, lens = encode_step_tokens(x, t, state, **kw)
        n_emitted = torch.zeros((B,), dtype=I64, device=dev)
        for v, L in zip(vals, lens):
            key = (base_word + wcount) & MASK32
            acc, fill, wcount, w, emit = _append_bits(acc, fill, wcount, v, L)
            for si in range(n_slots):
                hit = emit & (n_emitted == si)
                words[:, t, si] = torch.where(hit, w, words[:, t, si])
                keys[:, t, si] = torch.where(hit, key, keys[:, t, si])
            n_emitted = n_emitted + emit.to(I64)
    end_bits = (base_word + wcount) * 32 + fill
    tail_val = torch.where(fill > 0, acc, 0)
    tail_key = base_word + wcount
    return (as_i32_bits(words.reshape(B, -1)), as_i32_bits(keys.reshape(B, -1)),
            end_bits.to(I32), as_i32_bits(tail_val), as_i32_bits(tail_key))


def rice_encode_tokens(res, bit_size: int, mb0: int, pb: int, kb: int,
                       wb: int):
    """Residuals (B, S) -> the token stream in bitstream order
    (alacjax.ops.rice.rice_encode_tokens): (vals (B, 3*(S+1)) int32 bit
    patterns, lens (B, 3*(S+1)) int32), per step the slots [zero-run
    codeword, residual codeword, escape payload], step S the virtual end
    step that flushes a pending run.  XLA glue in alacjax with no kernel;
    no codec path calls it (the codec emits words through
    rice_encode_words)."""
    B, S = res.shape
    dev = res.device
    kw = dict(S=S, bit_size=lane_arg(bit_size), pb=pb, kb=kb, wb=wb)
    state = init_state(B, mb0, dev)
    ones = torch.ones((B,), dtype=I64, device=dev)
    vals, lens = [], []
    for t in range(S + 1):
        x = res[:, t].to(I64) if t < S else ones
        state, v, ln = encode_step_tokens(x, t, state, **kw)
        vals.append(torch.stack([torch.as_tensor(a, device=dev).to(I64)
                                 .expand(B) for a in v], dim=1))
        lens.append(torch.stack([torch.as_tensor(a, device=dev).to(I64)
                                 .expand(B) for a in ln], dim=1))
    return (as_i32_bits(torch.stack(vals, dim=1).reshape(B, -1)),
            torch.stack(lens, dim=1).reshape(B, -1).to(I32))


def rice_decode(words, start_bits, num_samples: int, bit_size, mb0: int,
                pb, kb: int, wb: int, max_bit_size: int = 32):
    """Decode ``num_samples`` residuals per lane from packed words
    (alacjax.ops.rice.rice_decode): words (B, W) int32 bit patterns of
    each frame's big-endian bit image, start_bits (B,) int32, bit_size
    the escape payload width (an int or per-lane (B,) int32, at most
    ``max_bit_size``), pb an int or per-lane.  Returns (residuals (B, S)
    int32, end_bits (B,) int32, err (B,) bool).  One Rice cursor serves
    this and the decode: it is the decode kernel wrapper's raw mode, so
    on the card it launches csrc/decode.cu's raw instance; no codec path
    calls it."""
    from ..kernels import decode as k_decode
    B = start_bits.shape[0]
    dev = start_bits.device
    if isinstance(pb, int):
        pb = torch.full((B,), pb, dtype=I32, device=dev)
    return k_decode.decode_channel(
        words, start_bits, num_samples, bit_size, mb0, pb, kb, wb, None,
        None, None, None,
        chanbits_max=None if isinstance(bit_size, int) else max_bit_size,
        raw=True)
