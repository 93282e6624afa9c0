"""The codec's carried state on the torch side.

ALAC keeps no weights: besides the shared ``AlacConfig``, the only state
is the predictor coefficient tables.  These helpers turn the JAX side's
numpy int32 tables into torch tensors on an explicit device, so both
packages start from identical ``coefs0``.  The device is a required
argument: carried state never lands on the CPU by default.
"""

from __future__ import annotations

import numpy as np
import torch

from .oracle import dp as oracle_dp
from .types import DENSHIFT_DEFAULT, kALACMaxCoefs


def coefs_from_numpy(coefs, device) -> torch.Tensor:
    """(B, 16) int coefficient table -> int32 tensor on ``device``."""
    a = np.asarray(coefs)
    if a.ndim != 2 or a.shape[1] != kALACMaxCoefs:
        raise ValueError(f"coefficient table must be (B, {kALACMaxCoefs}), "
                         f"got {a.shape}")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def banks_from_numpy(banks, device) -> dict:
    """{channel: {order: (B, 16)}} numpy banks -> the same nesting of
    int32 tensors on ``device``."""
    return {ch: {od: coefs_from_numpy(tab, device) for od, tab in by.items()}
            for ch, by in banks.items()}


def init_coefs_batched(B: int, device) -> torch.Tensor:
    """The encoder's fresh per-packet coefficients (dp_enc.c ::
    init_coefs at the default denshift), one row per lane.  Built with
    fills on ``device``: no host-to-device copy, so the encode does not
    wait here for the work queued before it."""
    out = torch.zeros((B, kALACMaxCoefs), dtype=torch.int32, device=device)
    for j, v in enumerate(oracle_dp.init_coefs(DENSHIFT_DEFAULT)):
        if v:
            out[:, j] = int(v)
    return out
