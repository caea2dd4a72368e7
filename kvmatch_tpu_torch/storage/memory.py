"""In-RAM and device-resident stores.

``MemoryStore`` is a copy of kvmatch_tpu/storage/memory.py's, mirroring
TimeSeriesMemoryOperator (operator/memory/TimeSeriesMemoryOperator.java:
29-82).  ``HbmStore`` is the port of the JAX package's device store, which
replaces the reference's HBase/Kudu tables (SURVEY.md section 2.6): the
series lives as a float32 tensor on the torch device (the card's HBM3 by
default), or split by offset range over a ``parallel.mesh.Mesh``, with a
float64 host shadow; range reads are host slices.
"""

from __future__ import annotations

import numpy as np

from .. import backend
from ..state import host_series, series_to_device


class MemoryStore:
    def __init__(self, data: np.ndarray):
        self._data = np.asarray(data, np.float64)

    def read(self, left: int, length: int) -> np.ndarray:
        if left < 0 or left + length > self._data.size:
            raise ValueError(f"read out of range: left={left} length={length}")
        return self._data[left:left + length]

    def read_all(self) -> np.ndarray:
        return self._data

    def length(self) -> int:
        return int(self._data.size)


class HbmStore:
    """Device-resident series (float32 tensor) + host float64 shadow.

    The float32 tensor feeds the probe and verify kernels, and an engine
    takes it as ``device_data=store.device``; the float64 shadow serves the
    exact host confirmations.  ``device`` is the current CUDA device unless
    the caller passes ``device="cpu"``.  With ``sharding`` (a
    ``parallel.mesh.Mesh``) ``self.device`` is instead the zero-padded
    series split by offset range, one float32 tensor per shard on its
    shard's device (``parallel.build.shard_series``), and ``device`` must be
    None."""

    def __init__(self, data: np.ndarray, device=None, sharding=None):
        if sharding is None:
            self.host, self.device = series_to_device(
                data, backend.resolve_device(device))
            return
        if device is not None:
            raise ValueError("pass device= or sharding=, not both")
        from ..parallel.build import shard_series
        self.host = host_series(data)
        self.device = shard_series(self.host, sharding)

    def read(self, left: int, length: int) -> np.ndarray:
        return self.host[left:left + length]

    def read_all(self) -> np.ndarray:
        return self.host

    def length(self) -> int:
        return int(self.host.size)
