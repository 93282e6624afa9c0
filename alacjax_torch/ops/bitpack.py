"""Bitstream assembly: token streams and field blocks -> packed uint32
word images (counterpart of alacjax/ops/bitpack.py).

Word images are big-endian bit order: bit 0 of the stream is the MSB of
word 0.  On the torch side an image is an int32 tensor of bit patterns.
``merge_sorted_chunks`` here is the plain version the merge kernel
(alacjax_torch/kernels/merge.py) is held to; ``words_to_bytes`` /
``bytes_to_words`` are the host-side numpy serializers, copied because
alacjax.ops.bitpack imports jax.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .tutils import I32, I64, MASK32, as_i32_bits, iota1, u32


def assemble(vals, lens, num_words: int):
    """Pack per-frame token streams into word images.

    vals: (B, T) token values (low ``lens`` bits significant); lens:
    (B, T) bit lengths (0 = empty slot), each <= 32.  Returns (words
    (B, num_words) int32 bit patterns, total_bits (B,) int32)."""
    v = u32(vals)
    lens = lens.to(I64)
    B, T = v.shape
    offs = torch.cumsum(lens, dim=1) - lens          # exclusive prefix sum
    total_bits = offs[:, -1] + lens[:, -1]
    nonempty = lens > 0
    mask = torch.where(lens >= 32, MASK32, (1 << torch.clamp(lens, max=31)) - 1)
    v = v & mask
    s = 32 - (offs & 31) - lens                       # in [-31, 32]
    w0 = offs >> 5
    hi = torch.where(s >= 0, (v << torch.clamp(s, min=0)) & MASK32,
                     v >> torch.clamp(-s, min=0))
    hi = torch.where(nonempty, hi, 0)
    lo = torch.where(nonempty & (s < 0),
                     (v << torch.clamp(32 + s, 1, 31)) & MASK32, 0)
    # disjoint bit regions: add == or; out-of-range words are dropped
    out = torch.zeros((B, num_words + 1), dtype=I64, device=v.device)
    out.scatter_add_(1, torch.clamp(w0, max=num_words), hi)
    out.scatter_add_(1, torch.clamp(w0 + 1, max=num_words), lo)
    return as_i32_bits(out[:, :num_words]), total_bits.to(I32)


def pack_fields(fields, d: int):
    """Pack (B, F) fixed-width fields (``d`` bits each, MSB-first, field
    k at bit offset d*k) into a phase-0 word image with static reshapes
    and shifts only (periodic layout: P words hold Q fields).
    Returns (B, W) int32 bit patterns."""
    B, F = fields.shape
    g = math.gcd(d, 32)
    P, Q = d // g, 32 // g
    n_groups = -(-F // Q)
    v = u32(fields)
    if d < 32:
        v = v & ((1 << d) - 1)
    if n_groups * Q != F:
        v = torch.nn.functional.pad(v, (0, n_groups * Q - F))
    vg = v.reshape(B, n_groups, Q)
    per_p = []
    for p in range(P):
        w = torch.zeros((B, n_groups), dtype=I64, device=v.device)
        for q in range(Q):
            s = d * q - 32 * p          # field start, relative to word p
            if s >= 32 or s + d <= 0:
                continue
            if s + d <= 32:
                w = w | ((vg[:, :, q] << (32 - s - d)) & MASK32)
            else:
                w = w | (vg[:, :, q] >> (s + d - 32))
        per_p.append(w)
    words = torch.stack(per_p, dim=-1).reshape(B, n_groups * P)
    need = (F * d + 31) // 32
    return as_i32_bits(words[:, :need])


def unpack_fields(words, d: int, F: int):
    """Inverse of pack_fields: (B, W) phase-0 image -> (B, F) fields of
    ``d`` bits each, zero-extended (int64)."""
    B, W = words.shape
    g = math.gcd(d, 32)
    P, Q = d // g, 32 // g
    n_groups = -(-F // Q)
    needW = n_groups * P
    w = u32(words)
    if W < needW:
        w = torch.nn.functional.pad(w, (0, needW - W))
    wg = w[:, :needW].reshape(B, n_groups, P)
    mask = MASK32 if d == 32 else (1 << d) - 1
    outs = []
    for q in range(Q):
        s = d * q
        p0, off = s // 32, s % 32
        a = wg[:, :, p0]
        if off + d <= 32:
            f = (a >> (32 - off - d)) & mask
        else:
            hi = (a << (off + d - 32)) & MASK32
            f = (hi | (wg[:, :, p0 + 1] >> (64 - off - d))) & mask
        outs.append(f)
    fields = torch.stack(outs, dim=-1).reshape(B, n_groups * Q)
    return fields[:, :F]


def place_segment(words, phase):
    """Shift a phase-0 image right by a per-lane bit phase (0..31):
    returns (B, W+1) int32 bit patterns (one spill word)."""
    w = u32(words)
    p = phase.to(I64)[:, None]
    prev = torch.nn.functional.pad(w, (1, 0))       # w[j-1], w[-1] = 0
    cur = torch.nn.functional.pad(w, (0, 1))        # w[j],   w[W] = 0
    hi = torch.where(p == 0, 0, (prev << ((32 - p) % 32)) & MASK32)
    lo = torch.where(p == 0, cur, cur >> p)
    return as_i32_bits(hi | lo)


def extract_segment(words, start_bits, num_out: int):
    """Cut ``num_out`` phase-0 words starting at a per-lane bit offset
    from the (B, W) image (inverse of place_segment).  int32 bits."""
    B, W = words.shape
    w = u32(words)
    sb = start_bits.to(I64)
    w0 = (sb >> 5)[:, None]
    ph = (sb & 31)[:, None]
    idx = w0 + iota1(num_out + 1, device=w.device)[None, :]
    wv = torch.where(idx < W, torch.gather(w, 1, torch.clamp(idx, 0, W - 1)), 0)
    hi = torch.where(ph == 0, wv[:, :-1], (wv[:, :-1] << ph) & MASK32)
    lo = torch.where(ph == 0, 0, wv[:, 1:] >> ((32 - ph) % 32))
    return as_i32_bits(hi | lo)


def merge_sorted_chunks(vals, keys, tail_vals, tail_keys, num_words: int):
    """Compact per-lane sparse chunk streams into a dense (B, num_words)
    word image, then OR the per-lane boundary ("tail") words on top.

    INVARIANT (bitpack.merge_sorted_chunks): per lane, the non-empty
    keys cover [0, n_lane) with no duplicates, so each key IS its word's
    output index and compaction is a scatter ``out[b, key] = val``
    (keys >= num_words, the empty-slot 0xFFFFFFFF among them, drop).
    Tails (B, n_t) may repeat keys; their bits are disjoint, so they OR
    in one pass per tail column.  All arrays are int32 bit patterns."""
    B, T = vals.shape
    dev = vals.device
    k = u32(keys)
    out = torch.zeros((B, num_words + 1), dtype=I32, device=dev)
    out.scatter_(1, torch.clamp(k, max=num_words), vals.to(I32))
    out[:, num_words] = 0
    tk = u32(tail_keys)
    for t in range(tail_vals.shape[1]):
        idx = torch.clamp(tk[:, t:t + 1], max=num_words)
        cur = torch.gather(out, 1, idx)
        out.scatter_(1, idx, cur | tail_vals[:, t:t + 1].to(I32))
    return out[:, :num_words].contiguous()


def words_to_bytes(words: np.ndarray, total_bits: np.ndarray) -> list[bytes]:
    """Host-side: big-endian word images -> per-frame byte strings,
    truncated to ceil(total_bits/8)."""
    words = np.ascontiguousarray(words).view(np.uint32)
    if words.size == 0:
        return [b""] * words.shape[0]
    if sys.byteorder == "little":
        words = words.byteswap()
    mv = memoryview(words).cast("B")
    W4 = words.shape[1] * 4
    nb = ((np.asarray(total_bits, dtype=np.int64) + 7) // 8).tolist()
    return [bytes(mv[b * W4: b * W4 + nb[b]])
            for b in range(words.shape[0])]


def bytes_to_words(packets: list[bytes], num_words: int) -> np.ndarray:
    """Host-side: per-frame packet bytes -> (B, W) big-endian word
    images, zero-padded, as uint32."""
    B = len(packets)
    W4 = num_words * 4
    buf = bytearray(B * W4)
    mv = memoryview(buf)
    for i, p in enumerate(packets):
        if len(p) > W4:
            raise ValueError("packet larger than word image")
        mv[i * W4: i * W4 + len(p)] = p
    return np.frombuffer(buf, dtype=">u4").reshape(B, num_words).astype(
        np.uint32)


def combine_chunks(words, keys, num_words: int, max_dups: int = 8):
    """The sort-based assembler (alacjax.ops.bitpack.combine_chunks):
    sparse (absolute word index, word value) chunk streams (B, T) ->
    dense (B, num_words) word image, int32 bit patterns.  Keys sort per
    lane; runs of a duplicated key (boundary words shared by neighbouring
    segments, their bits disjoint) add into the run's first entry; the
    entry for word j then sits at sorted position j + (duplicates before
    j) <= j + max_dups, so max_dups + 1 shifted compares place it.  A
    lane whose duplicates exceed max_dups has its whole image inverted
    (poisoned) rather than silently lose a word.  No codec path calls it
    (the codec merges through merge_sorted_chunks)."""
    B, T = words.shape
    dev = words.device
    keys_s, order = torch.sort(u32(keys), dim=1, stable=True)
    words_s = torch.gather(u32(words), 1, order)
    no = torch.zeros((B, max_dups + 1), dtype=torch.bool, device=dev)
    same_prev = torch.cat([no[:, :1], keys_s[:, 1:] == keys_s[:, :-1]], 1)
    combined = words_s
    run = torch.ones((B, T), dtype=torch.bool, device=dev)
    for r in range(1, max_dups + 1):
        run = run & torch.cat([same_prev[:, r:], no[:, :r]], 1)[:, :T]
        shifted = torch.nn.functional.pad(words_s[:, r:], (0, r))[:, :T]
        combined = combined + torch.where(run, shifted, 0)
    combined = combined & MASK32
    first = ~same_prev
    if T < num_words:
        raise ValueError("chunk slot count smaller than output width")
    pad = max_dups + 1
    keys_p = torch.nn.functional.pad(keys_s, (0, pad), value=MASK32)
    comb_p = torch.nn.functional.pad(combined, (0, pad))
    first_p = torch.cat([first, no], 1)
    jq = iota1(num_words, device=dev)[None, :]
    out = torch.zeros((B, num_words), dtype=I64, device=dev)
    for r in range(max_dups + 1):
        hit = (keys_p[:, r:r + num_words] == jq) & first_p[:, r:r + num_words]
        out = out + torch.where(hit, comb_p[:, r:r + num_words], 0)
    out = out & MASK32
    pos = iota1(T, device=dev)[None, :]
    real = keys_s != MASK32
    over = (first & real & (((pos - keys_s) & MASK32) > max_dups)).any(1)
    return as_i32_bits(torch.where(over[:, None], out ^ MASK32, out))
