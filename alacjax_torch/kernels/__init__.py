"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

One wrapper per kernel: cost (the fused predict + Rice-cost search
scan), emit (Rice emission), merge (packet compaction), decode (the
channel decode at 8 taps, and at 16/30 taps as ``decode_hi``, one
channel or stacked channels; its Rice warp alone as ``decode_cursor``,
end bits only and on no codec path, and ``decode_raw``, the residuals),
predict (the standalone predictor), rice_cost (its second, cost-only
pass), parse (the decode's per-element header parse), pcm (the
decode's unmix, shift bytes, escape select and tail mask) and search
(the encode search's stream glue: ``search_mix``, the stereo mixes of
every CPE, the mixres trial's candidates or the chosen streams;
``search_pick``, each searched lane's winning order, stage and residual
row) and assemble (the encode's chunk image: every element's header
tokens, shift-byte block and Rice rows, the escape select, the tails).
A wrapper checks its inputs, allocates its outputs, and for CUDA tensors
launches its kernel (or raises — there is no fallback); for CPU tensors
it runs the plain torch version from ``alacjax_torch.ops``.  Every
launch goes through ``launch``, which holds a device guard for the
input's card, so a tensor on ``cuda:1`` runs on card 1.
``LAUNCHES`` counts kernel launches, one key per kernel, so a run can
show that a path went through the kernels.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"cost": 0, "emit": 0, "merge": 0, "decode": 0, "decode_hi": 0,
            "decode_cursor": 0, "decode_raw": 0, "predict": 0,
            "rice_cost": 0, "parse": 0, "pcm": 0, "search_mix": 0,
            "search_pick": 0, "assemble": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cuda(*tensors) -> bool:
    """True if the tensors lie on a CUDA device (all of them must agree);
    False for CPU tensors, which take the plain version."""
    devs = {t.device.type for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    dev = devs.pop()
    if dev == "cuda":
        return True
    if dev == "cpu":
        return False
    raise ValueError(f"unsupported device type {dev!r}")


def expect(t, name: str, shape: tuple, dtype=torch.int32) -> None:
    """Raise unless ``t`` has this dtype, shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def lane_vector(v, L: int, device, name: str):
    """A per-lane int32 (L,) argument: an int widens to a vector, a
    tensor is checked."""
    if isinstance(v, int):
        return torch.full((L,), v, dtype=torch.int32, device=device)
    expect(v, name, (L,))
    return v


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, like, *args) -> None:
    """Call the C entry point ``name`` of the kernel library with
    ``args`` and the current stream of ``like``'s device, under a device
    guard for that device; raise unless it returns 0."""
    with torch.cuda.device(like.device):
        status = getattr(_build.lib(), name)(*args, stream_ptr(like))
    _build.check(status, name)
