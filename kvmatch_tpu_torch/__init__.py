"""kvmatch_tpu_torch — the PyTorch + CUDA port of kvmatch_tpu.

Public surface:

    from kvmatch_tpu_torch import (QueryEngine, NormQueryEngine,
                                   QueryEngineDtw, NormQueryEngineDtw,
                                   IndexConfig, QueryConfig, generate_series)
    from kvmatch_tpu_torch import oracle   # float64 brute force, on a device
    from kvmatch_tpu_torch import verify   # phase-2 guard bands (shared)

The port runs the four engines' serving path: the stats-only index build
(index/device_build.py), the dense phase-1 flag probe (kernel K1,
csrc/probe.cu) with the alpha/beta constraint AND, and phase 2 on the
device with the exact f64 confirmation on the host.  The ED engines verify
with FFT region near-sets and kernel K2 (csrc/window_ed.cu); the DTW engines
(RSM-DTW, cNSM-DTW) with the LB cascade, the f32 banded DP (kernel K3, or
its row-form twin K4) and the double-single DP (csrc/dtw.cu).  Host code
without jax (config, plan, verify, the index structure and host index
build, the native interval kernels, the data generators) is shared with
``kvmatch_tpu`` by import, and config, verify and the generators are
re-exported here, so a caller names only this package.  Importing this
package loads neither jax nor a CUDA kernel; kernels build at their first
launch.
"""

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
    if name in ("IndexConfig", "QueryConfig"):
        from kvmatch_tpu import config
        return getattr(config, name)
    if name == "verify":
        from kvmatch_tpu import verify
        return verify
    if name == "generate_series":
        from kvmatch_tpu.data.generators import generate_series
        return generate_series
    raise AttributeError(name)
