"""Native host codec — ctypes bindings for alac_host.cpp, the port's copy
of alacjax/native/ (a single-core C++ ALAC encoder and decoder).
``chip_smoke.py`` holds every packet of the port against it.

The library builds with g++ at first use into
``build/alacjax_torch/native/<hash>/`` at the repository root (the
gitignored tree the CUDA kernels build into), keyed by a hash of the
source and flags; a finished library is reused.  The build runs under a
file lock, so processes that start together (test workers) build it
once.  ``available()`` is False when no compiler is present, and
``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..types import AlacConfig, AlacError, AlacParamError

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "alac_host.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "alacjax_torch", "native")
# -fwrapv: the codec deliberately relies on two's-complement signed
# wraparound
CXX_FLAGS = ["-O2", "-fwrapv", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libalac_host.so")


def _build(lib_path: str) -> str | None:
    """Compile the shared library unless it exists (under a file lock);
    returns an error string or None."""
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return None
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++"] + CXX_FLAGS + [_SRC, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"g++ invocation failed: {e}"
        if proc.returncode != 0:
            return f"g++ failed:\n{proc.stderr[-2000:]}"
        os.replace(tmp, lib_path)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = _lib_path()
        _build_error = _build(path)
        if _build_error:
            return None
        lib = ctypes.CDLL(path)
        lib.alac_encoder_new.restype = ctypes.c_void_p
        lib.alac_encoder_free.argtypes = [ctypes.c_void_p]
        lib.alac_encode_packet.restype = ctypes.c_int
        lib.alac_encode_packet.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)] + \
            [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.alac_decode_packet.restype = ctypes.c_int
        lib.alac_decode_packet.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int] + \
            [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


class NativeEncoder:
    """Stateful native packet encoder (mirrors oracle.ALACEncoder)."""

    def __init__(self, config: AlacConfig, independent_frames: bool = False,
                 search: str | None = None):
        lib = _load()
        if lib is None:
            raise AlacError(-4, f"native codec unavailable: {_build_error}")
        if search is None:  # inherit the config knob (default "standard")
            search = getattr(config, "search", "standard")
        if search not in ("standard", "exhaustive"):
            raise AlacParamError(f"unknown search mode {search!r}")
        self._lib = lib
        self.config = config
        self.search = search
        self.independent = independent_frames
        self._state = lib.alac_encoder_new()

    def __del__(self):
        if getattr(self, "_state", None):
            self._lib.alac_encoder_free(self._state)
            self._state = None

    def encode_packet(self, pcm: np.ndarray) -> bytes:
        cfg = self.config
        pcm = np.ascontiguousarray(pcm, dtype=np.int32)
        if pcm.ndim != 2 or pcm.shape[0] != cfg.num_channels:
            raise AlacParamError("expected planar (C, n) pcm")
        n = pcm.shape[1]
        cap = cfg.max_escape_packet_bytes(n)
        out = np.zeros(cap, dtype=np.uint8)
        rc = self._lib.alac_encode_packet(
            self._state,
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, cfg.frame_length, cfg.bit_depth, cfg.num_channels,
            cfg.pb, cfg.mb, cfg.kb, cfg.max_run,
            # search-mode selector: 0 standard, 1 fast, 2 exhaustive
            1 if cfg.fast_mode else (2 if self.search == "exhaustive" else 0),
            1 if self.independent else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if rc < 0:
            raise AlacError(rc, "native encode failed")
        return out[:rc].tobytes()


class NativeDecoder:
    """Native packet decoder (mirrors oracle.ALACDecoder)."""

    def __init__(self, config: AlacConfig):
        lib = _load()
        if lib is None:
            raise AlacError(-4, f"native codec unavailable: {_build_error}")
        self._lib = lib
        self.config = config

    def decode_packet(self, data: bytes, num_samples: int | None = None):
        cfg = self.config
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.zeros((cfg.num_channels, cfg.frame_length), dtype=np.int32)
        rc = self._lib.alac_decode_packet(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            cfg.frame_length, cfg.bit_depth, cfg.num_channels,
            cfg.pb, cfg.mb, cfg.kb, cfg.max_run,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc < 0:
            raise AlacError(rc, "native decode failed")
        if num_samples is not None and rc != num_samples:
            raise AlacParamError(f"expected {num_samples} samples, got {rc}")
        return out[:, :rc].astype(np.int64), rc
