"""Build and bind the hand-written CUDA kernels (``kvmatch_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, then linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
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
SOURCES = ("probe.cu", "window_ed.cu", "dtw.cu")
# --fmad=false: K1 repeats its plain version's f32 operations exactly, and
# the double-single DP's TwoSum is error-free only without contraction.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")
_BUILD_TIMEOUT_S = 600


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


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errors = []
    try:
        for cmd, p in zip(cmds, procs):
            _out, err = p.communicate(timeout=_BUILD_TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n({p.returncode}):\n{err}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))


def build() -> Path:
    """Compile the kernels unless this source hash is already built."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
                  for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            if f.exists():
                f.unlink()
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
        for name, n_out in (("kvm_dtw_diag", 1), ("kvm_dtw_rows", 1),
                            ("kvm_dtw_ds", 2)):
            fn = getattr(cdll, name)
            fn.restype = I
            fn.argtypes = [P, P, P,     # rows (B, L), queries (Q, L), qids
                           I, I, I, I,  # B, L, Q, r (<= L - 1)
                           *[P] * n_out,  # outputs (B,) f32
                           P]           # stream
        _State.lib = cdll
    return _State.lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
