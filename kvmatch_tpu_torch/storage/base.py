"""Storage protocol — the pluggable backend seam of the framework.

A copy of kvmatch_tpu/storage/base.py.  Equivalent of the reference's L2
operator interfaces (operator/TimeSeriesOperator.java:29-54,
operator/IndexOperator.java:29-58), with the KV-store backends (HBase/Kudu,
operator/hbase/*, operator/kudu/*) replaced by ``HbmStore``: the series is a
device tensor, so "range scans" are slices and "RPCs" disappear.  The file
store remains for persistence and interchange, the memory store for tests.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from ..index.structure import Index


class TimeSeriesStore(Protocol):
    """readTimeSeries/readAllTimeSeries/writeTimeSeriesNode equivalent."""

    def read(self, left: int, length: int) -> np.ndarray:  # 0-based
        ...

    def length(self) -> int:
        ...


class IndexStore(Protocol):
    """readIndexes/readStatisticInfo/writeAll equivalent."""

    def load(self) -> Index:
        ...

    def save(self, index: Index) -> None:
        ...
