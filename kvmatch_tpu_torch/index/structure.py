"""KV-index array layout: one ``IndexScale`` per window width in Sigma.

A copy of kvmatch_tpu/index/structure.py without the device-resident
interval view of the JAX package's full device build (ROADMAP queue-1
item 10).  Array (CSR) re-design of the reference's row-oriented index
(entity/IndexNode.java:29-159, operator/file/IndexFileOperator.java:127-164):

  keys      f64[R]     sorted ascending; key = lower edge of the mean range a row
                       covers (after variable-width row merging the upper edge is
                       the next key, exactly as in MeanIntervalUtils.toUpper with
                       statisticInfo, MeanIntervalUtils.java:104-114)
  row_ptr   i64[R+1]   CSR offsets into the interval arrays
  left/right i64[P]    position intervals (0-based window starts, inclusive), sorted
                       by left within each row, each covering <= 256 offsets
                       (IndexNode.java:31)
  cum_intervals i64[R] cumulative #intervals per row (ascending key order) — the
  cum_offsets   i64[R] "meta table" prefix sums the planner's selectivity estimates
                       binary-search (ByteUtils.java:89-95, QueryEngine.java:382-402)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class IndexScale:
    w: int
    n: int
    keys: np.ndarray          # f64[R]
    row_ptr: np.ndarray       # i64[R+1]
    left: np.ndarray          # i64[P], None for a stats-only scale
    right: np.ndarray         # i64[P], None for a stats-only scale
    cum_intervals: np.ndarray  # i64[R]
    cum_offsets: np.ndarray   # i64[R]
    # Strict upper bound on every window mean in this scale (upper edge of the
    # highest occupied bucket) — closes the last row's mean range, which the
    # reference leaves open-ended (MeanIntervalUtils.java:109 returns +10000).
    mean_upper_bound: float = float("inf")

    # Serving-mode scale (index/device_build.build_index_device_stats):
    # planner statistics only, NO intervals anywhere.  Host interval access
    # raises; phase 1 must run as the device dense probe.
    stats_only: bool = False

    # Lazy position-sorted view: intervals ordered by left edge with their row id.
    # Lets a probe restrict itself to the running candidate span
    # (BaseEngine._gather_rows) — later phase-1 segments then cost O(span
    # intervals) instead of O(all intervals in the key range).
    _pos_sorted: tuple = None
    # Cumulative interval count served by per-row merges (engine-maintained);
    # once it exceeds ~2x the scale's interval count, building the global
    # position-sorted view amortizes (BaseEngine._use_pos_view).
    gather_work: int = 0

    def pos_sorted(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Position-sorted view (left, right, row_of_interval) of ALL intervals.

        Costly to materialize (O(T log R) C k-way merge over the row lists)
        and 24 bytes/interval to hold, so callers must only reach for it
        when per-row access cannot serve the scan; see
        BaseEngine.POS_VIEW_MIN."""
        if self._pos_sorted is None:
            from .. import native
            mr = native.merge_rows(self.row_ptr[:-1], self.row_ptr[1:],
                                   self.left, self.right)
            if mr is not None:
                row_of, p_l, p_r = mr
                # copies: merge_rows returns scratch views; this cache persists
                self._pos_sorted = (p_l.copy(), p_r.copy(), row_of.copy())
            else:
                order = np.argsort(self.left, kind="stable")
                row_of = np.repeat(np.arange(self.num_rows, dtype=np.int64),
                                   np.diff(self.row_ptr))
                self._pos_sorted = (self.left[order], self.right[order],
                                    row_of[order])
        return self._pos_sorted

    @property
    def has_pos_sorted(self) -> bool:
        return self._pos_sorted is not None

    @property
    def num_rows(self) -> int:
        return int(self.keys.size)

    @property
    def num_intervals(self) -> int:
        return int(self.row_ptr[-1]) if self.row_ptr.size else 0

    def counts_between_batch(self, begin_round: np.ndarray, end_round: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """(#intervals, #offsets) the probes for ranges [begin_round,
        end_round] will touch (the reference estimates this from its
        cumulative meta table, getCountsFromStatisticInfo,
        QueryEngine.java:382-402).  Mirrors probe_rows(snap_down(begin),
        end): rows j0..j1 inclusive where j0 is the row containing begin (0
        when begin precedes all keys) and j1 the last row with key <= end.
        The planner must count that containing row too: in sparse key-range
        tails it can hold thousands of intervals."""
        keys = self.keys
        if keys.size == 0:
            z = np.zeros(np.shape(begin_round), np.int64)
            return z, z
        j0 = np.maximum(np.searchsorted(keys, begin_round, side="right") - 1, 0)
        j1 = np.searchsorted(keys, end_round, side="right") - 1
        lo_i = np.where(j0 > 0, self.cum_intervals[np.maximum(j0 - 1, 0)], 0)
        lo_o = np.where(j0 > 0, self.cum_offsets[np.maximum(j0 - 1, 0)], 0)
        hi_i = np.where(j1 >= 0, self.cum_intervals[np.maximum(j1, 0)], 0)
        hi_o = np.where(j1 >= 0, self.cum_offsets[np.maximum(j1, 0)], 0)
        return np.maximum(hi_i - lo_i, 0), np.maximum(hi_o - lo_o, 0)

    def probe_rows(self, begin_key: float, end_key: float) -> np.ndarray:
        """Indices of rows whose key lies in [begin_key, end_key] (inclusive).

        Equivalent to IndexFileOperator.readIndexes' lowerBound/upperBound binary
        searches (IndexFileOperator.java:65-119) — but O(log R) on an in-RAM array
        instead of per-probe file reads.
        """
        i0 = int(np.searchsorted(self.keys, begin_key, side="left"))
        i1 = int(np.searchsorted(self.keys, end_key, side="right"))
        return np.arange(i0, i1)


def _interval_field(name: str):
    """left/right read through a property: a stats-only scale holds none,
    and host phase 1 must not run on it."""
    priv = "_" + name

    def get(self):
        v = getattr(self, priv)
        if v is None and self.stats_only:
            raise RuntimeError(
                "stats-only index scale (build_index_device_stats) holds "
                "no intervals: serve phase 1 through the device dense "
                "probe (QueryConfig.dense_probe_min_count) or rebuild "
                "with index.build.build_index_host")
        return v

    def set_(self, v):
        object.__setattr__(self, priv, v)

    return property(get, set_)


IndexScale.left = _interval_field("left")
IndexScale.right = _interval_field("right")


Index = Dict[int, IndexScale]
