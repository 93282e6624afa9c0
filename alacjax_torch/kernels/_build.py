"""Build and load the port's CUDA kernels.

Each ``alacjax_torch/csrc/*.cu`` compiles with its own nvcc process, all
started together, and the objects link into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds, not minutes).  The build happens at first use, into
``build/alacjax_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags; a finished library is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "alacjax_torch")
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C signatures: name -> argtypes (every function returns int)
SIGNATURES = {
    "alac_cost": [_P] * 8 + [_I] * 8 + [_U, _U, _I, _U, _P],
    "alac_emit": [_P] * 9 + [_I] * 3 + [_U, _U, _I, _U, _P],
    "alac_predict": [_P] * 6 + [_I] * 7 + [_P],
    "alac_rice_cost": [_P] * 4 + [_I] * 3 + [_U, _U, _I, _U, _P],
    "alac_merge": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "alac_decode": [_P] * 5 + [_I] + [_P] * 8 + [_I] * 6 + [_U, _I, _U, _P],
    "alac_decode_cursor": [_P] * 9 + [_I] * 5 + [_U, _I, _U, _P],
    "alac_decode_raw": [_P] * 9 + [_I] * 5 + [_U, _I, _U, _P],
    "alac_parse": [_P] * 7 + [_I] * 8 + [_P],
    "alac_pcm": [_P] * 10 + [_I] * 9 + [_P],
    "alac_search_mix": [_P] * 5 + [_I] * 8 + [_P],
    "alac_search_pick": [_P] * 6 + [_I] * 6 + [_P],
    "alac_assemble": [_P] * 12 + [_I] * 10 + [_P],
}

_lock = threading.Lock()
_lib = None
_path = None
build_seconds = None     # wall time of the build (or load) that ran here
build_log = ""           # nvcc's stderr per source (-Xptxas -v report)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),) + NVCC_CANDIDATES:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands side by side; kill any still running if one
    times out or the caller is interrupted."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        done = []
        for cmd, p in zip(cmds, procs):
            out, err = p.communicate(timeout=900)
            done.append(subprocess.CompletedProcess(cmd, p.returncode,
                                                    out, err))
        return done
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _build(out_dir: str) -> str:
    lib_path = os.path.join(out_dir, "libalacjax_torch.so")
    if os.path.exists(lib_path):
        return lib_path
    global build_log
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(cu) + f".{tag}.o")
            for cu in cus]
    compiled = _run_all([[nvcc] + NVCC_FLAGS + ["-c", "-o", obj, cu]
                         for cu, obj in zip(cus, objs)])
    build_log = "".join(f"== {os.path.basename(cu)}\n{p.stderr}"
                        for cu, p in zip(cus, compiled))
    tmp = f"{lib_path}.{tag}"
    procs = compiled
    if all(p.returncode == 0 for p in compiled):
        procs = procs + _run_all([[nvcc, "-shared", "-o", tmp] + objs])
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        for p in procs:
            f.write(" ".join(p.args) + "\n" + p.stdout + p.stderr)
    for p in procs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(p.args)}\n{p.stderr[-4000:]}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, lib_path)      # atomic: concurrent builds agree
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _path, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = _build(os.path.join(BUILD_ROOT, _key()))
            cdll = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _path = cdll, path
            build_seconds = time.perf_counter() - t0
        return _lib


def lib_path() -> str:
    """The built library's file (built on first use)."""
    lib()
    return _path


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
