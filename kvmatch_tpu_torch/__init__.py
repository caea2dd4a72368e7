"""kvmatch_tpu_torch — the PyTorch + CUDA port of kvmatch_tpu.

Public surface:

    from kvmatch_tpu_torch import (QueryEngine, NormQueryEngine,
                                   QueryEngineDtw, NormQueryEngineDtw,
                                   IndexConfig, QueryConfig, generate_series)
    from kvmatch_tpu_torch import oracle   # float64 brute force, on a device
    from kvmatch_tpu_torch import verify   # phase-2 guard bands

The port runs the four engines' serving path: the index builds
(index/device_build.py: the stats-only build and the full device build;
index/build.py: the device bucket pass with host grouping, the engines'
default, and the host build), the dense phase-1 flag probe (kernel K1,
csrc/probe.cu) with the alpha/beta constraint AND, and phase 2 on the
device with the exact f64 confirmation on the host.  The ED engines verify
with FFT region near-sets and kernel K2 (csrc/window_ed.cu); the DTW engines
(RSM-DTW, cNSM-DTW) with the LB cascade, the f32 banded DP (kernel K3, or
its row-form twin K4) and the double-single DP (csrc/dtw.cu).  A series
larger than device memory is served with ``device_data="stream"`` (host
phase 1, candidate runs staged to the device per batch), and
``device_data="host"`` answers small candidate loads with no device at all.

The port stands alone: it imports nothing of ``kvmatch_tpu``.  It keeps its
own copies of the host modules it needs, under the same relative paths
(config, plan, verify, utils/{intervals, rounding, sparse_prefix, hostmem},
the native host runtime, index/{structure, build}, data/generators and the
host skeleton of engine/base), each held equal to its JAX original by
tests/test_torch_host_parity.py.

Every entry point runs on the current CUDA device unless the caller passes
``device="cpu"`` (or tensors on the CPU); without a card it raises.
Importing this package loads neither jax nor a CUDA kernel; kernels build
at their first launch.
"""

from .utils.hostmem import tune_glibc_malloc as _tune_malloc

# Large NumPy temporaries (streamed staging, host phase 1 at n=1e8)
# otherwise mmap/munmap-cycle and re-fault on every use (utils/hostmem.py).
# Best-effort, opt-out via KVMATCH_NO_MALLOC_TUNE=1.
_tune_malloc()

__all__ = ["QueryEngine", "NormQueryEngine", "QueryEngineDtw",
           "NormQueryEngineDtw", "IndexConfig", "QueryConfig",
           "generate_series"]


def __getattr__(name):
    # Lazy, like kvmatch_tpu/__init__.py: importing the package builds nothing.
    if name == "QueryEngine":
        from .engine.rsm_ed import QueryEngine
        return QueryEngine
    if name == "NormQueryEngine":
        from .engine.norm_ed import NormQueryEngine
        return NormQueryEngine
    if name == "QueryEngineDtw":
        from .engine.rsm_dtw import QueryEngineDtw
        return QueryEngineDtw
    if name == "NormQueryEngineDtw":
        from .engine.norm_dtw import NormQueryEngineDtw
        return NormQueryEngineDtw
    if name == "IndexConfig":
        from .config import IndexConfig
        return IndexConfig
    if name == "QueryConfig":
        from .config import QueryConfig
        return QueryConfig
    if name == "generate_series":
        from .data.generators import generate_series
        return generate_series
    raise AttributeError(name)
