"""Phase 0 — query segmentation by dynamic programming.

A copy of kvmatch_tpu/plan.py: the same plans from the same index
statistics.

Host-side re-implementation of determineQueryPlan (QueryEngine.java:424-501,
QueryEngineDtw.java:515-644, NormQueryEngine.java:593-670): split the query's
m = L/unit unit windows into at most 30 variable-width segments drawn from the
enabled scale set, minimizing the average log-selectivity estimated from the index
meta tables.  The DP is O(m * 30 * |scales|) on arrays of size m <= L/25 — far too
small to benefit from the device, so it stays in NumPy (SURVEY.md section 7 'DP
segmentation under jit').

Cost evaluation is delegated to a callable so each engine variant can plug in its
own probe-range arithmetic (plain ED range, DTW envelope range, alpha/beta
normalized bounds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

import numpy as np

from .config import IndexConfig, QueryConfig


@dataclasses.dataclass
class QuerySegment:
    """One probe segment (common/QuerySegment.java:23-76, RangeQuerySegment.java:23-87).

    ``order`` is the 1-based unit-window position of the segment's left edge;
    ``mean_lo == mean_hi`` for the ED engines, and they carry the averaged Lemire
    envelope bounds for the DTW engines.
    """
    order: int
    w: int
    mean_lo: float
    mean_hi: float
    count: int  # selectivity estimate (#index intervals in probe range)


def unit_sums(query: np.ndarray, unit: int) -> np.ndarray:
    """Sum of each disjoint unit window of the query (QueryEngine.java:427-436)."""
    m = query.size // unit
    return query[: m * unit].reshape(m, unit).sum(axis=1, dtype=np.float64)


def envelope(query: np.ndarray, radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """Edge-clamped Lemire envelope of the query (QueryEngineDtw.java:518-560).

    Returns (L, U) with L[i] = min(query[i-r : i+r+1]), clamped at the ends.
    """
    if radius <= 0:
        return query.astype(np.float64), query.astype(np.float64)
    pad = np.concatenate([np.repeat(query[0], radius), query,
                          np.repeat(query[-1], radius)]).astype(np.float64)
    win = np.lib.stride_tricks.sliding_window_view(pad, 2 * radius + 1)
    return win.min(axis=1), win.max(axis=1)


# cost_batch_fn(w, mean_lo[], mean_hi[]) -> (log_cost[], interval_count[]) for all
# segments of width w at unit starts 0..m-k, fully vectorized.
CostBatchFn = Callable[[int, np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def determine_query_plan(
    length: int,
    sums_lo: np.ndarray,
    sums_hi: np.ndarray,
    cost_batch_fn: CostBatchFn,
    icfg: IndexConfig,
    qcfg: QueryConfig,
) -> List[QuerySegment]:
    """DP segmentation; ``sums_lo``/``sums_hi`` are per-unit-window sums of the lower
    and upper mean tracks (equal for ED).  Semantics mirror QueryEngine.java:438-500;
    the cost table and the DP transitions are evaluated as whole-array NumPy ops
    (the reference's per-(l,r) getCost cache becomes one batch call per scale)."""
    unit = icfg.unit
    m = sums_lo.size
    max_j = min(m, qcfg.max_segments)
    enabled_k = [k for k in range(1, len(icfg.wu_list) + 1)
                 if icfg.wu_enabled[k - 1] and icfg.wu_list[k - 1] == unit * k
                 and k <= m]

    pre_lo = np.concatenate(([0.0], np.cumsum(sums_lo)))
    pre_hi = np.concatenate(([0.0], np.cumsum(sums_hi)))

    # Per-scale cost arrays over all valid starts.  Costs are path SUMS with a
    # large negative clip standing in for log(0) — see
    # determine_query_plans_batched for why this matches the average form.
    NEG_CLIP = -1e18
    means_lo, means_hi, costs, counts = {}, {}, {}, {}
    for k in enabled_k:
        w = unit * k
        mlo = (pre_lo[k:] - pre_lo[:m - k + 1]) / w
        mhi = (pre_hi[k:] - pre_hi[:m - k + 1]) / w
        c, cnt = cost_batch_fn(w, mlo, mhi)
        means_lo[k], means_hi[k] = mlo, mhi
        costs[k] = np.maximum(c, NEG_CLIP)
        counts[k] = cnt

    INF = float("inf")
    dp = np.full((max_j + 1, m + 1), INF)
    pre = np.full((max_j + 1, m + 1), -1, np.int16)
    dp[0, 0] = 0.0
    for j in range(1, max_j + 1):
        best = np.full(m + 1, INF)
        best_k = np.full(m + 1, -1, np.int16)
        for k in enabled_k:
            # segment covers units [i-k, i-1] -> ends at i in [k, m]
            cand = dp[j - 1, : m - k + 1] + costs[k]
            cur = best[k:]
            better = cand < cur
            best[k:] = np.where(better, cand, cur)
            best_k[k:] = np.where(better, np.int16(k), best_k[k:])
        dp[j] = best
        pre[j] = best_k

    # Minimum segment count: (floor(log2 L) - 1) // 2  (QueryEngine.java:480);
    # ties prefer more segments (<=, QueryEngine.java:481).
    j_lo = max(1, (int(math.floor(math.log2(length))) - 1) // 2)
    best_v, p = INF, -1
    for j in range(j_lo, max_j + 1):
        if dp[j, m] / j <= best_v:
            best_v, p = dp[j, m] / j, j
    if p < 0 or not np.isfinite(dp[p, m]):
        for j in range(1, max_j + 1):
            if np.isfinite(dp[j, m]):
                best_v, p = dp[j, m], j
                break
    segments: List[QuerySegment] = []
    index, j = m, p
    while index > 0 and j > 0 and pre[j, index] > 0:
        k = int(pre[j, index])
        l = index - k
        segments.append(QuerySegment(order=l + 1, w=unit * k,
                                     mean_lo=float(means_lo[k][l]),
                                     mean_hi=float(means_hi[k][l]),
                                     count=int(counts[k][l])))
        index -= k
        j -= 1
    segments.reverse()

    if qcfg.enable_query_reordering:
        segments.sort(key=lambda s: s.count)  # most selective first
    return segments


def determine_query_plans_batched(
    length: int,
    sums_lo_q: np.ndarray,
    sums_hi_q: np.ndarray,
    cost_batch_fns: List[CostBatchFn],
    icfg: IndexConfig,
    qcfg: QueryConfig,
    cost_batch_multi: CostBatchFn | None = None,
) -> List[List[QuerySegment]]:
    """Batched ``determine_query_plan``: the same DP with all queries stacked on
    a leading axis, so the 30x5 small-array transition ops amortize across the
    batch (they dominate planning time for 100+-query batches).  Inputs are
    (Q, m) unit-sum tracks and one cost function per query; output plans are
    identical to per-query calls (tested).

    ``cost_batch_multi``, when given, replaces the per-query cost loop: it
    receives the full (Q, S) mean tracks and returns (Q, S) costs/counts in one
    vectorized call per scale (engines build it from per-query parameter
    arrays).

    The DP stores per-path cost SUMS, not averages: within a fixed segment
    count j, comparing sums and comparing averages pick the same argmin, so
    the j-division happens once at the final j selection.  Minus-infinite
    per-segment costs (log of a zero count) are clipped to a large negative
    sentinel so INF + cost never produces NaN."""
    unit = icfg.unit
    Q, m = sums_lo_q.shape
    max_j = min(m, qcfg.max_segments)
    enabled_k = [k for k in range(1, len(icfg.wu_list) + 1)
                 if icfg.wu_enabled[k - 1] and icfg.wu_list[k - 1] == unit * k
                 and k <= m]

    pre_lo = np.concatenate([np.zeros((Q, 1)), np.cumsum(sums_lo_q, axis=1)], axis=1)
    pre_hi = np.concatenate([np.zeros((Q, 1)), np.cumsum(sums_hi_q, axis=1)], axis=1)

    NEG_CLIP = -1e18
    means_lo, means_hi, costs, counts = {}, {}, {}, {}
    for k in enabled_k:
        w = unit * k
        mlo = (pre_lo[:, k:] - pre_lo[:, : m - k + 1]) / w
        mhi = (pre_hi[:, k:] - pre_hi[:, : m - k + 1]) / w
        if cost_batch_multi is not None:
            c, cnt = cost_batch_multi(w, mlo, mhi)
        else:
            c = np.empty_like(mlo)
            cnt = np.empty(mlo.shape, np.int64)
            for qi in range(Q):
                c[qi], cnt[qi] = cost_batch_fns[qi](w, mlo[qi], mhi[qi])
        means_lo[k], means_hi[k] = mlo, mhi
        costs[k] = np.maximum(c, NEG_CLIP)
        counts[k] = cnt

    INF = float("inf")
    dp = np.full((max_j + 1, Q, m + 1), INF)
    pre = np.full((max_j + 1, Q, m + 1), -1, np.int16)
    dp[0, :, 0] = 0.0
    for j in range(1, max_j + 1):
        best = np.full((Q, m + 1), INF)
        best_k = np.full((Q, m + 1), -1, np.int16)
        for k in enabled_k:
            cand = dp[j - 1, :, : m - k + 1] + costs[k]
            cur = best[:, k:]
            better = cand < cur
            best[:, k:] = np.where(better, cand, cur)
            best_k[:, k:] = np.where(better, np.int16(k), best_k[:, k:])
        dp[j] = best
        pre[j] = best_k

    j_lo = max(1, (int(math.floor(math.log2(length))) - 1) // 2)
    out: List[List[QuerySegment]] = []
    for qi in range(Q):
        best_v, p = INF, -1
        for j in range(j_lo, max_j + 1):
            if dp[j, qi, m] / j <= best_v:
                best_v, p = dp[j, qi, m] / j, j
        if p < 0 or not np.isfinite(dp[p, qi, m]):
            for j in range(1, max_j + 1):
                if np.isfinite(dp[j, qi, m]):
                    best_v, p = dp[j, qi, m], j
                    break
        segments: List[QuerySegment] = []
        index, j = m, p
        while index > 0 and j > 0 and pre[j, qi, index] > 0:
            k = int(pre[j, qi, index])
            l = index - k
            segments.append(QuerySegment(order=l + 1, w=unit * k,
                                         mean_lo=float(means_lo[k][qi, l]),
                                         mean_hi=float(means_hi[k][qi, l]),
                                         count=int(counts[k][qi, l])))
            index -= k
            j -= 1
        segments.reverse()
        if qcfg.enable_query_reordering:
            segments.sort(key=lambda s: s.count)
        out.append(segments)
    return out
