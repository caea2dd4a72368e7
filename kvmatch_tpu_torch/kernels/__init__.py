"""Build and bind the hand-written CUDA kernels (``kvmatch_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The library lands in ``build/kernels/``
at the repository root, named by a hash of the sources, so an edited source
rebuilds and an unchanged one is reused (the same caching rule as
kvmatch_tpu/native/__init__.py).

Nothing here runs at import: tests on a machine without ``nvcc`` import every
module of the port.  Each C entry point returns ``cudaGetLastError()`` after
its launch; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("probe.cu", "window_ed.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


class _State:
    lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libkvmatch_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is already built."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if _State.lib is None:
        so = build()
        cdll = ctypes.CDLL(str(so))
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        cdll.kvm_probe_flags.restype = I
        cdll.kvm_probe_flags.argtypes = [
            P, L, L,                    # bstack, row stride, column of bstack[:, 0]
            P, P, P, P, P, P,           # sidx, order, valid, mean_lo, mean_hi, width
            P, P,                       # eps2, cons
            I, I,                       # Q, S_SEG
            L, L, L,                    # p0, npos, m
            I, F, F, I, I,              # unit, d, slack, qlen, norm
            P, L, P,                    # flags, flag row stride, counts
            P]                          # stream
        cdll.kvm_window_ed.restype = I
        cdll.kvm_window_ed.argtypes = [
            P, L, P, I, F,              # data, n, queries, L, 1/L (f32)
            P, P, I, I,                 # offsets (int64), qids (int32), B, znorm
            P, P, P,                    # d2, mean, std
            P]                          # stream
        _State.lib = cdll
    return _State.lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
