"""Host allocator tuning for the big-array runtime.

glibc malloc services every allocation above MMAP_THRESHOLD (default 128 KB)
with a fresh mmap and munmaps it on free — so every multi-MB NumPy temp is
re-faulted from the kernel on each use.  On slow-fault hosts (some
fault fresh pages at tens of MB/s) that dominates index builds and phase-1
interval algebra.  Raising the threshold keeps large blocks on the reusable
heap: a 160 MB array copy measured 9.7 s -> 0.03 s steady-state.

A copy of kvmatch_tpu/utils/hostmem.py.  Applied best-effort at package
import (see kvmatch_tpu_torch/__init__.py); opt out with
KVMATCH_NO_MALLOC_TUNE=1.  Blocks above ``mmap_threshold`` (default 1 GB)
still go to mmap so truly huge one-off buffers are returned to the OS.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_APPLIED = False


def tune_glibc_malloc(mmap_threshold: int = 1 << 30,
                      trim_threshold: int = 1 << 28) -> bool:
    """mallopt(M_MMAP_THRESHOLD/M_TRIM_THRESHOLD); returns True if applied."""
    global _APPLIED
    if _APPLIED or os.environ.get("KVMATCH_NO_MALLOC_TUNE"):
        return _APPLIED
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(mmap_threshold))
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(trim_threshold))
        _APPLIED = bool(ok1) and bool(ok2)
    except Exception:  # non-glibc platforms: leave defaults
        _APPLIED = False
    return _APPLIED
