"""Vectorized interval algebra over flat NumPy arrays.

A copy of kvmatch_tpu/utils/intervals.py.

The reference manipulates candidate sets as Java lists of ``Interval`` objects with
serial two-pointer loops (QueryEngine.java:279-305, 593-693).  Here a candidate set is
a struct-of-arrays: ``left[i] <= right[i]`` (int64, inclusive), plus any number of
payload columns (accumulated epsilon lower bound, Ex/Ex2 tracks, beta bitmask).  All
operations are O(k log k) NumPy vector ops — no Python-level loops over intervals.

Soundness note: ``merge_intervals`` merges *overlapping or adjacent* intervals and
combines payloads with a segment-min (epsilon) / segment-OR (bitmask).  The reference
merges adjacent intervals only when their epsilons are close (QueryEngine.java:609);
merging unconditionally is strictly *more* conservative for a lower bound (min of the
two) and therefore can never cause a false dismissal — it may only pass a few more
candidates to the exact phase-2 check.  Answer sets are unaffected.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def empty_set(payloads: Tuple[str, ...] = ("eps",)) -> Dict[str, np.ndarray]:
    out = {"left": np.empty(0, np.int64), "right": np.empty(0, np.int64)}
    for name in payloads:
        dtype = np.uint64 if name == "beta" else np.float64
        out[name] = np.empty(0, dtype)
    return out


def _segment_reduce_min(values: np.ndarray, group: np.ndarray, ngroups: int) -> np.ndarray:
    out = np.full(ngroups, np.inf)
    np.minimum.at(out, group, values)
    return out


def _segment_reduce_or(values: np.ndarray, group: np.ndarray, ngroups: int) -> np.ndarray:
    out = np.zeros(ngroups, np.uint64)
    np.bitwise_or.at(out, group, values.astype(np.uint64))
    return out


def merge_intervals(cs: Dict[str, np.ndarray], adjacent: bool = True) -> Dict[str, np.ndarray]:
    """Sort by left edge and coalesce overlapping (and optionally adjacent) intervals.

    Payload combination: 'eps', 'ex*' columns take the group minimum (sound lower
    bound); 'beta' takes the group OR (union of still-possible beta partitions).
    Replaces sortButNotMergeIntervals / sortAndMergeIntervals
    (QueryEngine.java:593-693, NormQueryEngine.java:788-897).
    """
    left, right = cs["left"], cs["right"]
    k = left.size
    if k <= 1:
        return cs
    # Fast path: already sorted and strictly disjoint (true for scans served by
    # the position-sorted index view) — valid as-is for intersection; adjacent
    # coalescing would only compact it.
    if np.all(left[1:] > right[:-1]):
        return cs
    order = np.argsort(left, kind="stable")
    left, right = left[order], right[order]
    # Group starts where this interval does not touch the running max end.
    cummax_right = np.maximum.accumulate(right)
    gap = 0 if adjacent else -1  # adjacent: left-1 <= prev_end merges
    starts = np.empty(k, bool)
    starts[0] = True
    starts[1:] = left[1:] - 1 > cummax_right[:-1] + gap
    group = np.cumsum(starts) - 1
    ngroups = int(group[-1]) + 1
    first = np.flatnonzero(starts)
    out = {
        "left": left[first],
        "right": np.maximum.reduceat(right, first),
    }
    for name, col in cs.items():
        if name in ("left", "right"):
            continue
        col = col[order]
        if name == "beta":
            out[name] = _segment_reduce_or(col, group, ngroups)
        elif name == "ex_up":
            # Upper-track mean sum: the conservative (filter-weakening) combine is max.
            neg = _segment_reduce_min(-col, group, ngroups)
            out[name] = -neg
        else:
            out[name] = _segment_reduce_min(col, group, ngroups)
    return out


def count_stats(cs: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """(#disjoint candidate windows, #candidate offsets) after merging —
    the quantities fed to the phase-2 cost model (QueryEngine.java:312-313)."""
    if cs["left"].size == 0:
        return 0, 0
    n_off = int(np.sum(cs["right"] - cs["left"] + 1))
    return int(cs["left"].size), n_off


def shift(cs: Dict[str, np.ndarray], delta: int) -> Dict[str, np.ndarray]:
    """Translate all intervals by ``delta`` (the reference's deltaW re-framing,
    QueryEngine.java:192, 265-303)."""
    if delta == 0:
        return cs
    out = dict(cs)
    out["left"] = cs["left"] + delta
    out["right"] = cs["right"] + delta
    return out


def clip_first_segment(cs: Dict[str, np.ndarray], order_1b: int, unit: int,
                       n: int, length: int) -> Dict[str, np.ndarray]:
    """Boundary clamping applied to the first probed segment
    (QueryEngine.java:261-277).  Positions here are 1-based window starts of the
    probed segment; a position p is viable iff the full query window fits:
    1 <= p - (order-1)*unit  and  p - (order-1)*unit + length - 1 <= n.
    """
    base = (order_1b - 1) * unit
    lo = 1 + base
    hi = n - length + 1 + base
    left = np.maximum(cs["left"], lo)
    right = np.minimum(cs["right"], hi)
    keep = left <= right
    out = {k: v[keep] for k, v in cs.items()}
    out["left"], out["right"] = left[keep], right[keep]
    return out


def intersect(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """All overlapping pieces of two sorted disjoint interval sets.

    Returns (pieces, ia, ib) where pieces[k] = [max(a.l, b.l), min(a.r, b.r)] and
    ia/ib index the source intervals, letting the caller combine payload columns
    (epsilon sums, Ex/Ex2 sums, beta AND) before filtering.  Vectorized version of
    the reference's two-pointer CS x CS_i merge (QueryEngine.java:279-305).
    """
    al, ar = a["left"], a["right"]
    bl, br = b["left"], b["right"]
    if al.size == 0 or bl.size == 0:
        e = empty_set(tuple(k for k in a if k not in ("left", "right")))
        return e, np.empty(0, np.int64), np.empty(0, np.int64)
    # For each a-interval: b-intervals with br >= al and bl <= ar.
    j0 = np.searchsorted(br, al, side="left")
    j1 = np.searchsorted(bl, ar, side="right")
    counts = np.maximum(j1 - j0, 0)
    total = int(counts.sum())
    ia = np.repeat(np.arange(al.size), counts)
    # b-index within each a's range: arange trick.
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    ib = (np.arange(total) - np.repeat(offs, counts)) + np.repeat(j0, counts)
    pieces = {
        "left": np.maximum(al[ia], bl[ib]),
        "right": np.minimum(ar[ia], br[ib]),
    }
    return pieces, ia, ib


def intersect_with_sorted(cs: Dict[str, np.ndarray], raw: Dict[str, np.ndarray]
                          ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Overlap pieces of a *sorted disjoint* set ``cs`` with an *arbitrary-order,
    possibly overlapping* set ``raw`` (a freshly scanned segment).

    Sorting a segment's raw interval list costs O(P log P) on the hot path; this
    variant only binary-searches the (small) running candidate set, so the large
    first-scan arrays are never sorted after segment 0.  Overlapping raw
    intervals simply emit multiple pieces — the caller's merge combines their
    payloads with the same min/or semantics as pre-merging would have.
    Returns (pieces, i_cs, i_raw).
    """
    cl, cr = cs["left"], cs["right"]
    rl, rr = raw["left"], raw["right"]
    if cl.size == 0 or rl.size == 0:
        e = empty_set(tuple(k for k in cs if k not in ("left", "right")))
        return e, np.empty(0, np.int64), np.empty(0, np.int64)
    j0 = np.searchsorted(cr, rl, side="left")   # first cs with right >= raw.left
    j1 = np.searchsorted(cl, rr, side="right")  # first cs with left > raw.right
    counts = np.maximum(j1 - j0, 0)
    total = int(counts.sum())
    i_raw = np.repeat(np.arange(rl.size), counts)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    i_cs = (np.arange(total) - np.repeat(offs, counts)) + np.repeat(j0, counts)
    pieces = {
        "left": np.maximum(cl[i_cs], rl[i_raw]),
        "right": np.minimum(cr[i_cs], rr[i_raw]),
    }
    return pieces, i_cs, i_raw


def expand_offsets(cs: Dict[str, np.ndarray], limit: int | None = None) -> np.ndarray:
    """Materialize every offset contained in the interval set as a flat int64 array."""
    left, right = cs["left"], cs["right"]
    if left.size == 0:
        return np.empty(0, np.int64)
    counts = (right - left + 1).astype(np.int64)
    total = int(counts.sum())
    if limit is not None and total > limit:
        raise ValueError(f"candidate offsets {total} exceed limit {limit}")
    starts = np.repeat(left, counts)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    return starts + (np.arange(total) - np.repeat(offs, counts))
