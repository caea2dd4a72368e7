"""Run-local float64 prefix sums over a union of candidate ranges.

A copy of kvmatch_tpu/utils/sparse_prefix.py.

The cNSM/PAA prefilters (engine/norm_ed.py, engine/rsm_ed.py) are pure
prefix-sum arithmetic: every lookup pair they difference lies inside one
candidate window ``[offset, offset+L]``.  At reference scales (n=1e10+,
LongRandomQueryTest.java:33-50) the full-series cumsum those prefilters
normally use costs 8 bytes/point — 80 GB per array — so the host-only route
previously skipped them entirely.  ``SparsePrefix`` stages ONLY the candidate
runs (plus their window tails) and presents the same ``c1[g]`` fancy-indexing
interface with an arbitrary per-run base, which cancels in every difference
the prefilters take.  Lookups outside the covered runs are a caller bug; in
covered ranges the values differ from the dense cumsum only by the per-run
base (and carry LESS rounding, since each run accumulates locally).
"""

from __future__ import annotations

import numpy as np


class _PrefixView:
    """One staged prefix array addressed by GLOBAL series index."""

    __slots__ = ("run_lo", "bases", "vals")

    def __init__(self, run_lo: np.ndarray, bases: np.ndarray,
                 vals: np.ndarray):
        self.run_lo = run_lo
        self.bases = bases
        self.vals = vals

    def __getitem__(self, g):
        g = np.asarray(g, np.int64)
        flat = g.ravel()
        rid = np.searchsorted(self.run_lo, flat, side="right") - 1
        pos = flat - self.run_lo[rid] + self.bases[rid]
        return self.vals[pos].reshape(g.shape)


def sparse_prefixes(data, left: np.ndarray, right: np.ndarray, length: int,
                    want_sq: bool = False, max_staged: int | None = None):
    """Build prefix views covering windows ``[o, o+length)`` for every offset
    o in the candidate intervals ``[left_i, right_i]`` (inclusive).

    Returns ``(c1, c2, staged_points)`` where ``c2`` is None unless
    ``want_sq``.  ``c1[b+k] - c1[b]`` equals ``sum(data[b:b+k])`` in float64
    for any pair inside one covered window, exactly like the dense cumsum.
    With ``max_staged``, returns ``(None, None, staged_points)`` instead of
    allocating when the merged coverage exceeds the budget.
    """
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    if left.size == 0:
        empty = _PrefixView(np.zeros(1, np.int64), np.zeros(1, np.int64),
                            np.zeros(1))
        return empty, (empty if want_sq else None), 0
    order = np.argsort(left, kind="stable")
    lo = left[order]
    hi = np.maximum.accumulate(right[order] + length - 1)  # last data index
    new = np.empty(lo.size, bool)
    new[0] = True
    # runs merge when they touch or overlap (gap <= 1 keeps lookups at a
    # run's end index run_hi+1 unambiguous: the next run starts >= run_hi+2)
    np.greater(lo[1:], hi[:-1] + 1, out=new[1:])
    starts = np.flatnonzero(new)
    run_lo = lo[starts]
    run_hi = hi[np.concatenate((starts[1:] - 1, [lo.size - 1]))]
    ext = run_hi - run_lo + 1
    bases = np.concatenate(([0], np.cumsum(ext + 1)))
    total = int(bases[-1])
    if max_staged is not None and total > max_staged:
        return None, None, total
    c1 = np.empty(total)
    c2 = np.empty(total) if want_sq else None
    for i in range(run_lo.size):
        seg = np.asarray(data[run_lo[i]: run_hi[i] + 1], np.float64)
        b, e = int(bases[i]), int(bases[i + 1])
        c1[b] = 0.0
        np.cumsum(seg, out=c1[b + 1: e])
        if want_sq:
            c2[b] = 0.0
            np.cumsum(seg * seg, out=c2[b + 1: e])
    v1 = _PrefixView(run_lo, bases[:-1], c1)
    v2 = _PrefixView(run_lo, bases[:-1], c2) if want_sq else None
    return v1, v2, total
