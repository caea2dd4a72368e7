"""kvmatch_tpu_torch — the PyTorch + CUDA port of kvmatch_tpu.

Public surface:

    from kvmatch_tpu_torch import (QueryEngine, NormQueryEngine, IndexConfig,
                                   QueryConfig, generate_series)
    from kvmatch_tpu_torch import oracle   # float64 brute force, on a device

The port runs the RSM-ED and cNSM-ED serving path: the stats-only index
build (index/device_build.py), the dense phase-1 flag probe (kernel K1,
csrc/probe.cu) with the alpha/beta constraint AND, and phase 2 on the device
(FFT region near-sets and kernel K2, csrc/window_ed.cu) with the exact f64
confirmation on the host.  Host code without jax (config, plan, verify, the
index structure and host index build, the native interval kernels, the data
generators) is shared with ``kvmatch_tpu`` by import and re-exported here,
so a caller names only this package.  Importing this package loads neither
jax nor a CUDA kernel; kernels build at their first launch.
"""

__all__ = ["QueryEngine", "NormQueryEngine", "IndexConfig", "QueryConfig",
           "generate_series"]


def __getattr__(name):
    # Lazy, like kvmatch_tpu/__init__.py: importing the package builds nothing.
    if name == "QueryEngine":
        from .engine.rsm_ed import QueryEngine
        return QueryEngine
    if name == "NormQueryEngine":
        from .engine.norm_ed import NormQueryEngine
        return NormQueryEngine
    if name in ("IndexConfig", "QueryConfig"):
        from kvmatch_tpu import config
        return getattr(config, name)
    if name == "generate_series":
        from kvmatch_tpu.data.generators import generate_series
        return generate_series
    raise AttributeError(name)
