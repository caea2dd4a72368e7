"""kvmatch_tpu_torch — the PyTorch + CUDA port of kvmatch_tpu.

Public surface:

    from kvmatch_tpu_torch import (QueryEngine, NormQueryEngine,
                                   QueryEngineDtw, NormQueryEngineDtw,
                                   IndexConfig, QueryConfig, generate_series)
    from kvmatch_tpu_torch import oracle   # float64 brute force, on a device
    from kvmatch_tpu_torch import verify   # phase-2 guard bands
    # persistence, the append build, the baselines:
    from kvmatch_tpu_torch import (IndexNpzStore, IndexFileStore,
                                   TimeSeriesFileStore, HbmStore,
                                   StreamingIndexBuilder, UcrScanner, TWINS,
                                   build_index_host,
                                   build_index_device_buckets)

    python -m kvmatch_tpu_torch.cli ...    # the command line (cli.py)

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
Indexes are saved and loaded by storage/file.py (the reference's per-scale
file layout, or one ``.npz``); index/streaming.py absorbs appends;
baselines.py is the index-free UCR full scan and baseline_twin.py the
engines with the reference's scalar phase 2 (native/baseline_scalar.c).

The port stands alone: it imports nothing of ``kvmatch_tpu``.  It keeps its
own copies of the host modules it needs, under the same relative paths
(config, plan, verify, utils/{intervals, rounding, sparse_prefix, hostmem,
codec, profiling}, the native host runtime, index/{structure, build,
streaming}, storage, experiments, data/generators and the host skeleton of
engine/base), each held equal to its JAX original by
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

# Lazy exports, like kvmatch_tpu/__init__.py: importing the package builds
# nothing.  name -> submodule holding it.
_EXPORTS = {
    "QueryEngine": "engine.rsm_ed",
    "NormQueryEngine": "engine.norm_ed",
    "QueryEngineDtw": "engine.rsm_dtw",
    "NormQueryEngineDtw": "engine.norm_dtw",
    "IndexConfig": "config",
    "QueryConfig": "config",
    "generate_series": "data.generators",
    "build_index_host": "index.build",
    "build_index_device_buckets": "index.build",
    "StreamingIndexBuilder": "index.streaming",
    "HbmStore": "storage.memory",
    "IndexFileStore": "storage.file",
    "IndexNpzStore": "storage.file",
    "TimeSeriesFileStore": "storage.file",
    "UcrScanner": "baselines",
    "TWINS": "baseline_twin",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
