"""Wrapper of the packet-merge kernel (csrc/merge.cu), the port of
alacjax/ops/pallas/merge.py plus the tail OR of
bitpack.merge_sorted_chunks.  Plain version:
alacjax_torch.ops.bitpack.merge_sorted_chunks."""

from __future__ import annotations

import torch

from ..ops import bitpack
from . import LAUNCHES, expect, launch, on_cuda

plain = bitpack.merge_sorted_chunks     # the plain version, same signature


def merge_sorted_chunks(vals, keys, tail_vals, tail_keys, num_words: int):
    """(B, T) chunk words + keys and (B, n_t) tail words + keys, all int32
    bit patterns -> (B, num_words) packet image."""
    if not on_cuda(vals, keys, tail_vals, tail_keys):
        return plain(vals, keys, tail_vals, tail_keys, num_words)
    B, T = vals.shape
    n_t = tail_vals.shape[1]
    expect(vals, "vals", (B, T))
    expect(keys, "keys", (B, T))
    expect(tail_vals, "tail_vals", (B, n_t))
    expect(tail_keys, "tail_keys", (B, n_t))
    out = torch.zeros((B, num_words), dtype=torch.int32, device=vals.device)
    launch("alac_merge", vals,
           vals.data_ptr(), keys.data_ptr(), tail_vals.data_ptr(),
           tail_keys.data_ptr(), out.data_ptr(), B, T, n_t, num_words)
    LAUNCHES["merge"] += 1
    return out
