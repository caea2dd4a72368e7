"""Engine base of the PyTorch port: the two-phase query skeleton over the
KV-index.

The host skeleton of kvmatch_tpu/engine/base.py, carried over (the
reference's four engine classes, QueryEngine.java:162-380 and siblings): the
query driver, planning, host phase 1 over the index intervals,
``_flags_to_intervals`` and the chunked exact confirms.  The device half
runs on tensors of an explicit device, the current CUDA device unless the
caller passes ``device="cpu"``:

* ``__init__``: f64 host shadow + f32 device tensor of the series; an index
  built with the device bucket pass (index/build.py:
  build_index_device_buckets) when none is given.  ``device_data="stream"``
  keeps no series on the device (a series larger than device memory): phase
  1 runs on the host over a prebuilt index and phase 2 stages the candidate
  runs of each batch to the device (``_verify_multi_streamed``).
  ``device_data="host"`` (``host_only``) uses no device at all: small loads
  take the exact f64 host route, larger ones raise.
* ``data_envelope_dev``: the series' Sakoe-Chiba envelope for the DTW
  cascade, cached per band radius (``_run_chunked`` drives that cascade's
  stages over unpadded chunks).
* ``probe``: the resident probe (engine/probe.py) of an engine whose
  series is on the device; ``_dense_probe_retry`` runs one pass of it for a
  same-length group and ``_probe_dense`` drives the groups of every entry.
  Dense phase 1 always takes the flag route (K1 + the constraint AND) at
  granularity 128; the JAX package's run-emission ladder is a TPU
  workaround and is not ported.
* ``_verify_routed``: device phase 2, the batch routed to the region route
  or the gather route (kernel K2) by its joint ``_region_plan``.
* ``query_batch_device``: ``query_batch`` with the device probe for every
  query.

While a torch profiler records, each request records the spans of
``utils/profiling.py`` (``kv.query``, ``kv.plan``, ``kv.probe``,
``kv.verify`` and their stages) into ``QueryStats.trace``.

Subclasses provide the hooks ``_plan_inputs`` and ``_cost_batch_multi``
(planning), ``_scan``, ``_combine``, ``_intersect_native`` and ``_scan_join``
(host phase 1) and ``_verify_multi`` (phase 2).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import backend, native
from .. import verify as vf
from ..config import (DEFAULT_INDEX_CONFIG, DEFAULT_QUERY_CONFIG, IndexConfig,
                      QueryConfig)
from ..index.build import build_index_device_buckets
from ..index.structure import Index, IndexScale
from ..ops.probe import FLAG, pack_segments_batch
from ..ops.regions import coalesce_intervals, pack_regions
from ..ops.sliding import sliding_min_max
from ..plan import (QuerySegment, determine_query_plan,
                    determine_query_plans_batched)
from ..state import host_series, series_to_device
from ..utils import intervals as iv
from ..utils.profiling import fetch, request, span
from ..utils.sparse_prefix import sparse_prefixes
from .probe import ResidentProbe

__all__ = ["BaseEngine", "QueryResult", "QueryStats", "_Ctx"]

logger = logging.getLogger("kvmatch_tpu_torch")

NEAR_K = 16384  # near-set capacity of one region launch
_EMPTY = (np.empty(0, np.int64), np.empty(0))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@dataclasses.dataclass
class QueryStats:
    """Per-query observability counters — the six StatisticInfo slots of the
    reference (QueryEngine.java:136-140, 365-371) plus extras."""
    t_total_ms: float = 0.0
    t_phase1_ms: float = 0.0
    t_phase2_ms: float = 0.0
    n_candidates: int = 0
    n_disjoint: int = 0
    n_answers: int = 0
    n_scans: int = 0
    n_segments_used: int = 0
    n_device_checked: int = 0
    # Windows confirmed exactly in f64 on the host, and on the device
    # (cNSM-ED's confirm, engine/norm_ed.py:_confirm_znorm_device).
    n_host_rechecked: int = 0
    n_device_confirmed: int = 0
    # Candidates verified ENTIRELY on host (exact f64, no device launch) by the
    # tiny-load fast path (QueryConfig.host_verify_max_points).
    n_host_checked: int = 0
    # PROBE_BLOCK tables the dense probe pass that served the query made
    # (its group's, shared by the group's queries; 0 on the cached path):
    # engine/probe.py:ResidentProbe.run.
    n_probe_blocks: int = 0
    # Region rows (padding left out) that the region near-set served for
    # the query, and the passes of its batch that overflowed the near-set's
    # capacity (NEAR_K) into the full-matrix fallback (cNSM-ED's region
    # route, engine/norm_ed.py:_verify_regions).
    n_region_rows: int = 0
    n_near_overflows: int = 0
    early_terminated: bool = False
    # The request's span records (utils/profiling.py), shared by the
    # request's queries; None unless a profiler recorded.
    trace: Optional[list] = None


@dataclasses.dataclass
class QueryResult:
    offsets: np.ndarray    # 0-based answer offsets, sorted by distance
    distances: np.ndarray  # exact float64 distances
    stats: QueryStats

    @property
    def found(self) -> bool:
        return self.offsets.size > 0

    def best(self) -> Optional[Tuple[int, float]]:
        if not self.found:
            return None
        return int(self.offsets[0]), float(self.distances[0])


@dataclasses.dataclass
class _Ctx:
    """Per-query context threaded through the hooks."""
    query: np.ndarray
    length: int
    epsilon: float
    eps2: float
    params: dict
    stats: QueryStats
    last_min_eps: float = 0.0
    processed_units: int = 0
    # Current candidate span (min left, max right) in the frame of the NEXT
    # segment to scan; lets _gather_rows use the position-sorted index view.
    span: tuple = None


class BaseEngine:
    """Series (f64 on host + f32 on ``device``) and the index.

    ``device_data``: the series' f32 tensor when the caller holds it on a
    device already; ``"stream"`` to keep no series on the device (phase 2
    stages candidate runs per batch; an index must be given, and f32 host
    data stays f32: no f64 copy of a series larger than device memory); or
    ``"host"`` for no device at all (``host_only``: the exact f64 host
    route for small candidate loads, larger loads raise).  The reference
    for the modes is kvmatch_tpu/engine/base.py:107-145."""

    use_dtw_cost_model = False
    #: Share of free device memory one cached probe table may take.
    CACHE_MEM_FRACTION = 0.2

    def __init__(self, data: np.ndarray, index: Index | None = None,
                 icfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                 qcfg: QueryConfig = DEFAULT_QUERY_CONFIG,
                 device_data: torch.Tensor | str | None = None, device=None):
        mode = device_data if isinstance(device_data, str) else None
        if mode not in (None, "stream", "host"):
            raise ValueError(f"device_data={device_data!r}: pass the series' "
                             f"tensor, 'stream' or 'host'")
        self.host_only = mode == "host"
        self.icfg = icfg
        self.qcfg = qcfg
        if mode is not None:
            if index is None:
                raise ValueError(
                    f"device_data={mode!r} requires a prebuilt index (build "
                    f"it with index.device_build.build_index_device or "
                    f"index.build.build_index_device_buckets)")
            self.device = None if self.host_only else \
                backend.resolve_device(device)
            self.data = host_series(data, keep_f32=True)
            self.data_dev = None
        else:
            if device_data is not None:
                device = device_data.device
            self.device = backend.resolve_device(device)
            if device_data is None:
                self.data, device_data = series_to_device(data, self.device)
            else:
                self.data = host_series(data)
                if (device_data.dtype != torch.float32
                        or tuple(device_data.shape) != (self.data.size,)
                        or not device_data.is_contiguous()):
                    raise ValueError("device_data must be a contiguous "
                                     "float32 tensor of the series' length")
            self.data_dev = device_data
        self.probe = None if self.data_dev is None else \
            ResidentProbe(self.data_dev, icfg)
        self.n = self.data.size
        self.index = index if index is not None else \
            build_index_device_buckets(self.data, icfg, device=self.device)

    # ------------------------------------------------------------ helpers
    def scale(self, w: int) -> IndexScale:
        return self.index[w]

    def _dev(self, a, dtype) -> torch.Tensor:
        """numpy -> tensor on the engine's device."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def data_envelope_dev(self, rho: int):
        """Global Sakoe-Chiba envelope (lo, hi) of the series on the
        device, cached per band radius; the data-side LB_Keogh of the DTW
        cascade gathers its windows (ops/dtw.lb_stage_multi)."""
        cache = self.__dict__.setdefault("_env_dev_cache", {})
        if rho not in cache:
            cache[rho] = sliding_min_max(self.data_dev, rho)
        return cache[rho]

    def _run_chunked(self, kernel, m: int, *arrays: np.ndarray,
                     width: int):
        """``kernel(*device slices)`` over chunks of the parallel host
        arrays (int64 offsets to int64, int32 qids to int32, floats to f32
        on the device); returns its outputs on the host, concatenated.
        Chunks hold ``verify.bucket_size`` rows for rows of ``width`` (the
        launch working-set cap); unlike ``verify.run_bucketed`` nothing is
        padded, as eager PyTorch keeps no shape-keyed compile cache."""
        step = vf.bucket_size(m, lo=1, width=width)
        dt = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32}
        outs = []
        for s in range(0, m, step):
            res = kernel(*(self._dev(a[s:s + step],
                                     dt.get(a.dtype, torch.float32))
                           for a in arrays))
            res = res if isinstance(res, tuple) else (res,)
            outs.append([_np(t) for t in res])
        cat = tuple(np.concatenate(parts) for parts in zip(*outs))
        return cat if len(cat) > 1 else cat[0]

    def _row_bounds(self, sc: IndexScale, rows: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row mean range [key_i - slack, next_key + slack]; the slack widens the
        reference's [key, toUpper(key)] (QueryEngine.java:578-591) to absorb f32
        build-side bucket flips — sound: it can only weaken lower bounds."""
        slack = self.icfg.probe_guard
        keys = sc.keys
        lo = keys[rows] - slack
        hi = np.where(rows + 1 < keys.size,
                      keys[np.minimum(rows + 1, keys.size - 1)],
                      sc.mean_upper_bound) + slack
        return lo, hi

    # Scans below this interval count are served per-row (C k-way merge over
    # just the probed rows); a scale's GLOBAL position-sorted view — whose
    # build costs O(T log R) over ALL intervals (~10 s/scale at n=1e9) — is
    # materialized only when a single scan is huge (POS_VIEW_MIN) or when the
    # cumulative per-row-merge work on that scale has exceeded ~2x its
    # interval count (the build then amortizes across the workload).
    POS_VIEW_MIN = 1 << 22

    def _use_pos_view(self, sc: IndexScale, row_total: int) -> bool:
        if sc.has_pos_sorted or row_total > self.POS_VIEW_MIN:
            return True
        sc.gather_work += row_total
        return sc.gather_work > 2 * sc.num_intervals

    def _gather_rows(self, sc: IndexScale, rows: np.ndarray, ctx: "_Ctx" = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flatten the interval lists of the probed rows.  Returns
        (row_of_interval, left, right) with row_of_interval indexing into ``rows``.

        When the running candidate span (ctx.span) is narrower than the rows'
        total interval count, switch to the position-sorted view and materialize
        only intervals overlapping the span — intervals are <= maximum_diff wide,
        so the span selection is two binary searches on the left edges."""
        if rows.size == 0:
            e = np.empty(0, np.int64)
            return e, e, e
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        row_total = int(sc.row_ptr[i1] - sc.row_ptr[i0])
        if sc.has_pos_sorted:
            p_left, p_right, p_row = sc.pos_sorted()
            if ctx is not None and ctx.span is not None:
                lo, hi = ctx.span
                a = np.searchsorted(p_left, lo - self.icfg.maximum_diff, side="left")
                b = np.searchsorted(p_left, hi, side="right")
                if (b - a) < row_total:
                    sl_row = p_row[a:b]
                    keep = (sl_row >= i0) & (sl_row < i1) & (p_right[a:b] >= lo)
                    return (sl_row[keep] - i0, p_left[a:b][keep], p_right[a:b][keep])
            # A scale's intervals are mutually DISJOINT (every position has
            # exactly one bucket), so the position-sorted view filtered to the
            # probed rows is already sorted AND disjoint.  Use the linear
            # filter when the selected fraction is large.
            if row_total * 16 > p_row.size:
                keep = (p_row >= i0) & (p_row < i1)
                return p_row[keep] - i0, p_left[keep], p_right[keep]
        # Rows are internally position-sorted and mutually disjoint, so the
        # left-sorted union is a k-way merge — O(T log R) in C, no argsort.
        mr = native.merge_rows(sc.row_ptr[rows], sc.row_ptr[rows + 1],
                               sc.left, sc.right)
        if mr is not None:
            return mr
        # Probed rows are contiguous (probe_rows returns a key range), so their
        # CSR interval block is one contiguous slice — no index arithmetic.
        counts = sc.row_ptr[rows + 1] - sc.row_ptr[rows]
        rep_rows = np.repeat(np.arange(rows.size), counts)
        sl = slice(int(sc.row_ptr[i0]), int(sc.row_ptr[i1]))
        left = sc.left[sl]
        # Invariant: every scan returns intervals sorted by left (and disjoint,
        # since a scale's intervals partition the positions).  The pos-sorted
        # paths above are sorted for free; this small-selection fallback sorts.
        order = np.argsort(left, kind="stable")
        return rep_rows[order], left[order], sc.right[sl][order]

    def _scan_fill(self, sc: IndexScale, rows: np.ndarray, ctx: "_Ctx",
                   row_payloads: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Emit the probed rows' intervals with per-row payload columns attached.

        Uses the fused native walk over the position-sorted view when available
        (native/interval_kernels.c scan_fill); otherwise expands payloads through
        the NumPy gather path.  Output is sorted by left and disjoint."""
        cols = tuple(row_payloads)
        if rows.size == 0:
            return iv.empty_set(cols)
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        row_total = int(sc.row_ptr[i1] - sc.row_ptr[i0])
        if self._use_pos_view(sc, row_total):
            p_left, p_right, p_row = sc.pos_sorted()
            a, b, min_right = 0, int(p_row.size), 0
            span_ok = False
            if ctx is not None and ctx.span is not None:
                lo, hi = ctx.span
                a2 = int(np.searchsorted(p_left, lo - self.icfg.maximum_diff, side="left"))
                b2 = int(np.searchsorted(p_left, hi, side="right"))
                if (b2 - a2) < row_total:
                    a, b, min_right = a2, b2, int(lo)
                    span_ok = True
            if span_ok or row_total * 16 > p_row.size:
                res = native.scan_fill(p_left, p_right, p_row, a, b, i0, i1,
                                       min_right, row_payloads)
                if res is not None:
                    return res
        rep_rows, left, right = self._gather_rows(sc, rows, ctx)
        out = {"left": left, "right": right}
        for name, colv in row_payloads.items():
            out[name] = colv[rep_rows]
        return out

    CONFIRM_CHUNK = 32768  # caps host (chunk, L) f64 gathers at ~2 GB for L=8192

    @classmethod
    def _chunked_confirm(cls, near: np.ndarray, piece_fn):
        """Run an exact host confirmation over ``near`` in bounded chunks so a
        candidate flood (possible at n=1e9 with a loose epsilon) cannot
        materialize a (near, L) float64 matrix of tens of GB.  ``piece_fn``
        maps a chunk of offsets to (kept_offsets, distances)."""
        if near.size <= cls.CONFIRM_CHUNK:
            return piece_fn(near)
        offs, dists = [], []
        for s in range(0, near.size, cls.CONFIRM_CHUNK):
            o, d = piece_fn(near[s: s + cls.CONFIRM_CHUNK])
            offs.append(o)
            dists.append(d)
        return np.concatenate(offs), np.concatenate(dists)

    def _cost_normalizer(self) -> float:
        """Total interval count of the w=100 index (or the closest enabled scale) —
        the denominator of the DP's log-selectivity (QueryEngine.java:409)."""
        scales = sorted(self.index)
        ref_w = 100 if 100 in self.index else scales[len(scales) // 2]
        sc = self.index[ref_w]
        return float(sc.cum_intervals[-1]) if sc.num_rows else 1.0

    # ------------------------------------------------------------------ plans
    def _plan(self, ctx: _Ctx) -> List[QuerySegment]:
        with span("kv.plan"):
            lo, hi, fn = self._plan_inputs(ctx)
            segments = determine_query_plan(ctx.length, lo, hi, fn,
                                            self.icfg, self.qcfg)
        if not segments:
            raise self._no_plan(ctx.length)
        return segments

    def _plan_batch(self, ctxs) -> list:
        """Plan a same-length query batch with the stacked DP (identical
        output to per-query _plan; the 30x5 transition ops amortize)."""
        with span("kv.plan"):
            parts = [self._plan_inputs(c) for c in ctxs]
            lo = np.stack([pt[0] for pt in parts])
            hi = np.stack([pt[1] for pt in parts])
            plans = determine_query_plans_batched(
                ctxs[0].length, lo, hi, [pt[2] for pt in parts],
                self.icfg, self.qcfg,
                cost_batch_multi=self._cost_batch_multi(ctxs))
        if not all(plans):
            raise self._no_plan(ctxs[0].length)
        return plans

    def _no_plan(self, length: int) -> ValueError:
        """The error of a query that no plan covers: its units outnumber
        ``QueryConfig.max_segments`` segments of the widest scale.  Phase 0
        runs on the host, so this comes before any device work.  (The JAX
        package goes on to phase 1 and raises IndexError there.)"""
        unit = self.icfg.unit
        widest = max(w for w, on in zip(self.icfg.wu_list,
                                        self.icfg.wu_enabled) if on)
        segs = self.qcfg.max_segments
        longest = (segs * (widest // unit) + 1) * unit - 1
        return ValueError(
            f"query length {length}: no plan of at most "
            f"QueryConfig.max_segments = {segs} segments of at most {widest} "
            f"points covers it (the longest such query has {longest} "
            f"points); raise max_segments")

    # Use the join when the candidate set is this many times smaller than the
    # segment's planned interval count (the join is O(|CS| log P) vs the
    # scan's O(P) view walk).
    JOIN_CS_RATIO = 16

    def _track_min_eps(self, cs: Dict[str, np.ndarray], ctx: _Ctx) -> None:
        if "eps" in cs and cs["eps"].size:
            ctx.last_min_eps = float(cs["eps"].min())

    def _candidate_intervals(self, cs: Dict[str, np.ndarray], last_segment: int,
                             length: int) -> Tuple[np.ndarray, np.ndarray]:
        """Translate the final CS to query-offset frame, clipped to valid starts."""
        if cs["left"].size == 0:
            e = np.empty(0, np.int64)
            return e, e
        base = (last_segment - 1) * self.icfg.unit
        left = np.maximum(cs["left"] - base, 0)
        right = np.minimum(cs["right"] - base, self.n - length)
        keep = left <= right
        return left[keep], right[keep]

    def _data_center(self) -> float:
        if not hasattr(self, "_center"):
            self._center = float(self.data.mean())
        return self._center

    REGION_M = 512
    # Gather-vs-region choice by DEVICE TRAFFIC: a region row reads M+L-1
    # points and serves up to M offsets (one FFT ~ the cost of 2-3 candidate
    # gathers — the fudge factor); the gather path reads L points per offset.
    # Intervals are gap-coalesced first (gap <= M), so dense-but-fragmented
    # candidate sets (millions of short intervals a few positions apart at
    # n=1e9) pack into shared regions instead of one region per interval.
    # The norm engines use a larger fudge: their scattered path prunes with an
    # exact host constraint prefilter before gathering.
    REGION_MIN_OFFSETS = 2048
    REGION_TRAFFIC_FUDGE = 2.0

    def _region_m(self, L: int, avg_run: float) -> int:
        """Region width.  The FFT length is next_pow2(M + L - 1), so for DENSE
        candidate runs M = next_pow2(L) costs the SAME transform as M = 512
        while serving up to 16x more offsets per region row (the N-point FFT
        is ~fully utilized: M + L - 1 = 2*next_pow2(L) - 1).  Short scattered
        runs keep the small M: an isolated hit then reads M + L - 1 points
        instead of ~2L."""
        base = self.REGION_M
        if avg_run >= 2 * base:
            return max(base, 1 << int(np.ceil(np.log2(max(L, 2)))))
        return base

    #: Above this series length the cumsum-based host prefilters (PAA,
    #: constraint) are skipped on the host verify route: the cached f64
    #: prefix sums cost 16 bytes/point (two 80 GB arrays at n=1e10) while the
    #: route only ever sees tiny candidate sets the exact kernel handles
    #: directly.
    PREFILTER_CUMSUM_MAX_N = 1 << 31

    def _host_verify_ok(self, cand_ivs, L: int) -> bool:
        """True when the batch's whole phase-2 load is small enough that the
        exact f64 host kernel undercuts even ONE device launch (the fixed
        dispatch floor) — see QueryConfig.host_verify_max_points.  Sound in
        both directions: the host kernel IS the exact confirmation step the
        device route ends with anyway."""
        cap = self.qcfg.host_verify_max_points
        if cap <= 0:
            return False
        total = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
        return total * L <= cap

    #: Staged-point budget for the host prefilter tier's run-local prefix
    #: sums (utils/sparse_prefix.py): 2.5e8 f64 points = 2 GB per array.
    HOST_PREFILTER_MAX_STAGED = 250_000_000

    def _host_prefilter_prefix(self, cand_ivs, L: int, want_sq: bool):
        """Run-local prefix views ``(c1, c2)`` for the host-only prefilter
        tier, or None when the load is outside the tier (too many offsets,
        or too much coverage to stage within the budget).  The tier lets a
        host-only engine answer mid-size candidate loads at any n — the
        full-series cumsums the regular prefilters use are unaffordable at
        n=1e10 (80 GB/array) — by staging only the candidate runs.  See
        QueryConfig.host_prefilter_max_offsets."""
        lim = self.qcfg.host_prefilter_max_offsets
        if lim <= 0:
            return None
        total = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
        if total == 0 or total > lim:
            return None
        alll = np.concatenate([l for l, r in cand_ivs if l.size])
        allr = np.concatenate([r for l, r in cand_ivs if l.size])
        c1, c2, _staged = sparse_prefixes(
            self.data, alll, allr, L, want_sq=want_sq,
            max_staged=self.HOST_PREFILTER_MAX_STAGED)
        if c1 is None:
            return None
        return c1, c2

    def _verify_intervals(self, left: np.ndarray, right: np.ndarray, ctx: _Ctx
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Phase 2 of one query: a batch of one through ``_verify_multi``."""
        return self._verify_multi([(left, right)], [ctx])[0]

    # --------------------------------------------------------- phase 2
    def _region_plan(self, cand_ivs, L: int):
        """Gather vs region decision of the JAX package's ``_region_plan``,
        on the port's region helpers; (starts, valid_from, valid_to, qids,
        M) or None for the gather path."""
        n_offsets = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
        if n_offsets < self.REGION_MIN_OFFSETS:
            return None
        merged = [coalesce_intervals(l, r, self.REGION_M) if l.size else (l, r)
                  for l, r in cand_ivs]
        n_runs = sum(l.size for l, _ in merged)
        run_len = sum(int(np.sum(r - l + 1)) for l, r in merged if l.size)
        if n_runs == 0:
            return None
        M = self._region_m(L, run_len / n_runs)
        if M > self.REGION_M:
            merged = [coalesce_intervals(l, r, M) if l.size else (l, r)
                      for l, r in merged]
        n_regions = sum(int(np.sum((r - l + 1 + M - 1) // M))
                        for l, r in merged if l.size)
        if (n_regions == 0
                or n_regions * (M + L - 1) * self.REGION_TRAFFIC_FUDGE
                    > n_offsets * L):
            return None
        starts, vfrom, vto, qids = [], [], [], []
        for qi, (l, r) in enumerate(merged):
            if l.size == 0:
                continue
            s, a, b = pack_regions(l, r, self.n, L, M)
            starts.append(s)
            vfrom.append(a)
            vto.append(b)
            qids.append(np.full(s.size, qi, np.int32))
        return (np.concatenate(starts), np.concatenate(vfrom),
                np.concatenate(vto), np.concatenate(qids), M)

    def _guarded_threshs(self, ctxs) -> np.ndarray:
        """Per-query eps^2 plus the f32 guard band of the device distances."""
        L = ctxs[0].length
        return np.array([c.eps2 + vf.guard_threshold(c.eps2, L,
                                                     self.qcfg.verify_guard)
                         for c in ctxs])

    def _verify_routed(self, cand_ivs, ctxs):
        """Device phase 2, routed as the JAX package routes a batch: its
        joint ``_region_plan`` sends every query to the region route
        (``_verify_regions``, FFT near-sets) when the candidates are
        clustered enough, else to the gather route (``_verify_gather``,
        kernel K2).  Both routes end in the exact f64 confirm."""
        L = ctxs[0].length
        with span("kv.verify.plan"):
            for (l, r), ctx in zip(cand_ivs, ctxs):
                ctx.stats.n_device_checked = \
                    int(np.sum(r - l + 1)) if l.size else 0
            region = self._region_plan(cand_ivs, L)
        if region is None:
            return self._verify_gather(cand_ivs, ctxs)
        return self._verify_regions(cand_ivs, ctxs, region)

    # ------------------------------------------------------- streamed phase 2
    #: Staged points per verification group: 1 GB of f32 on the device and
    #: 2 GB of f64 on the host.  Groups beyond it are verified one by one.
    STREAM_MAX_STAGE = 1 << 28

    def _verify_multi_streamed(self, cand_ivs, ctxs):
        """Phase 2 for a series larger than device memory
        (device_data="stream"); port of kvmatch_tpu/engine/base.py:
        _verify_multi_streamed.

        The candidate intervals of all queries are coalesced into runs; each
        run is staged with halos (rho for the DTW envelopes, a region-width
        tail for the packed-region route) into a compact host buffer, copied
        to the device once per group (a pinned f32 buffer, non_blocking on
        the current stream), and verified by a sub-engine of the same class
        on the parent's device, in local coordinates: the whole device
        cascade runs unchanged, because every read a valid candidate makes
        stays inside its own staged run.  Halos past the series' edges
        replicate the boundary point, which reproduces the clamped global
        envelope exactly.  Groups are cut under STREAM_MAX_STAGE staged
        points.  ``stream_counts`` holds the last call's groups, staged
        points and bytes; the spans ``kv.verify.stage`` and
        ``kv.verify.h2d`` time each group's host staging and copy."""
        L = ctxs[0].length
        if self.host_only:
            total = sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)
            raise RuntimeError(
                f"host-only engine: candidate load ({total} offsets x L={L}) "
                f"exceeds host_verify_max_points="
                f"{self.qcfg.host_verify_max_points} and the host prefilter "
                f"tier; phase 2 would need the device (device_data='stream')")
        rho = int(ctxs[0].params.get("rho", 0) or 0)
        halo = rho
        # Gap/tail >= any region width _region_plan can pick (next_pow2(L)),
        # so per-query region packing never crosses staged-run boundaries and
        # region-row tail reads stay inside the buffer (masked columns).
        G = 1 << int(np.ceil(np.log2(max(L, 2 * self.REGION_M))))
        tail = L - 1 + G + halo
        counts = dict(groups=0, staged_points=0, staged_bytes=0)
        self.stream_counts = counts
        nz = [(l, r) for l, r in cand_ivs if l.size]
        if not nz:
            return [_EMPTY for _ in ctxs]
        alll = np.concatenate([l for l, _ in nz])
        allr = np.concatenate([r for _, r in nz])
        order = np.argsort(alll, kind="stable")
        alll, allr = alll[order], np.maximum.accumulate(allr[order])
        new = np.empty(alll.size, bool)
        new[0] = True
        np.greater(alll[1:], allr[:-1] + G, out=new[1:])
        starts = np.flatnonzero(new)
        run_lo = alll[starts]
        run_hi = allr[np.concatenate((starts[1:] - 1, [alll.size - 1]))]
        stg_lo = run_lo - halo                      # virtual (may be < 0)
        ext = (run_hi - stg_lo + 1) + tail          # staged length per run

        # Split runs into groups under the staging budget (a single run wider
        # than the budget still forms its own group).
        bounds = [0]
        acc = 0
        for i, e in enumerate(ext):
            if acc and acc + e > self.STREAM_MAX_STAGE:
                bounds.append(i)
                acc = 0
            acc += int(e)
        bounds.append(ext.size)

        results = [[] for _ in ctxs]
        acc_dev = [0] * len(ctxs)
        acc_host = [0] * len(ctxs)
        acc_conf = [0] * len(ctxs)
        stages: dict = {}
        for g0, g1 in zip(bounds[:-1], bounds[1:]):
            g_stg_lo = stg_lo[g0:g1]
            g_ext = ext[g0:g1]
            loc0 = np.concatenate(([0], np.cumsum(g_ext)[:-1]))
            with span("kv.verify.stage"):
                buf = np.empty(int(g_ext.sum()), np.float64)
                for i in range(g_ext.size):
                    a = int(g_stg_lo[i])
                    b = a + int(g_ext[i])
                    dst = buf[int(loc0[i]): int(loc0[i]) + (b - a)]
                    s, e = max(a, 0), min(b, self.n)
                    dst[s - a: s - a + (e - s)] = self.data[s:e]
                    if s > a:
                        dst[: s - a] = self.data[0]
                    if b > e:
                        dst[e - a:] = self.data[self.n - 1]
                host32 = torch.empty(buf.size, dtype=torch.float32,
                                     pin_memory=self.device.type == "cuda")
                host32.numpy()[:] = buf
            with span("kv.verify.h2d"):
                dev32 = host32.to(self.device, non_blocking=True)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            sub = self._stream_sub(buf, dev32)
            lo_g, hi_g = int(run_lo[g0]), int(run_hi[g1 - 1])
            local_ivs = []
            for l, r in cand_ivs:
                sel = (l >= lo_g) & (l <= hi_g) if l.size else np.zeros(0, bool)
                li, ri = l[sel], r[sel]
                ridx = np.searchsorted(run_lo[g0:g1], li, side="right") - 1
                local_ivs.append((li - g_stg_lo[ridx] + loc0[ridx],
                                  ri - g_stg_lo[ridx] + loc0[ridx]))
            for c in ctxs:  # a group's route sets what it confirms
                c.stats.n_host_rechecked = c.stats.n_device_confirmed = 0
            sub_res = sub._verify_multi(local_ivs, ctxs)
            counts["groups"] += 1
            counts["staged_points"] += buf.size
            counts["staged_bytes"] += 4 * buf.size
            for k, v in getattr(sub, "stage_counts", {}).items():
                stages[k] = (stages.get(k, False) or v) if isinstance(v, bool) \
                    else stages.get(k, 0) + v
            for qi, (lo_offs, dists) in enumerate(sub_res):
                acc_dev[qi] += ctxs[qi].stats.n_device_checked
                acc_host[qi] += ctxs[qi].stats.n_host_rechecked
                acc_conf[qi] += ctxs[qi].stats.n_device_confirmed
                if lo_offs.size:
                    ridx = np.searchsorted(loc0, lo_offs, side="right") - 1
                    results[qi].append((lo_offs - loc0[ridx] + g_stg_lo[ridx],
                                        dists))
        if stages:
            self.stage_counts = stages
        out = []
        for qi, parts in enumerate(results):
            ctxs[qi].stats.n_device_checked = acc_dev[qi]
            ctxs[qi].stats.n_host_rechecked = acc_host[qi]
            ctxs[qi].stats.n_device_confirmed = acc_conf[qi]
            if parts:
                out.append((np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts])))
            else:
                out.append(_EMPTY)
        return out

    def _stream_sub(self, buf: np.ndarray, dev32: torch.Tensor):
        """An engine of this class over one staged group (host f64 ``buf``,
        its f32 copy ``dev32`` on the parent's device), built without
        ``__init__``: it holds every attribute the phase-2 routes read, and
        no index (phase 1 has run)."""
        sub = object.__new__(type(self))
        sub.icfg = self.icfg
        sub.qcfg = self.qcfg
        sub.host_only = False
        sub.device = self.device
        sub.data = buf
        sub.data_dev = dev32
        sub.n = buf.size
        sub.index = {}
        return sub

    # ------------------------------------------------------------------ phase 1
    def _phase1(self, segments: List[QuerySegment], ctx: _Ctx
                ) -> Tuple[Dict[str, np.ndarray], int]:
        unit = self.icfg.unit
        qcfg = self.qcfg
        t0 = time.perf_counter()
        cs: Optional[Dict[str, np.ndarray]] = None
        last_segment = segments[-1].order
        last_estimate = float("inf")
        cost_a = qcfg.phase2_cost_a_dtw if self.use_dtw_cost_model else qcfg.phase2_cost_a
        cost_b = qcfg.phase2_cost_b_dtw if self.use_dtw_cost_model else qcfg.phase2_cost_b
        if self.host_only:
            # The per-offset slopes are calibrated for the device verify;
            # the host-only route verifies through the sparse-prefix
            # prefilters and exact f64 kernels at roughly host_cost_scale
            # times the per-offset cost, so early termination probes
            # further before handing a flood to the slow route (phase 2 is
            # exact either way).
            cost_b *= qcfg.host_cost_scale
        est2_now = float("inf")  # phase-2 estimate of the CURRENT cs
        for i, seg in enumerate(segments):
            # Marginal-scan termination (see QueryConfig): the NEXT scan's
            # predicted cost already exceeds verifying the current cs exactly.
            if (qcfg.enable_early_termination and i >= 1
                    and seg.count * qcfg.phase1_scan_cost_ms_per_interval
                        > est2_now):
                last_segment = seg.order  # cs is framed at this segment
                ctx.stats.early_terminated = True
                break
            delta = 0 if i == len(segments) - 1 else \
                (segments[i + 1].order - seg.order) * unit
            ctx.processed_units += seg.w // unit
            fused = None  # (n_disjoint, n_offsets, min_eps) from the C step

            if i == 0:
                positions = self._scan(seg, ctx)
                ctx.stats.n_scans += 1
                # Only the first segment's set becomes the running CS and needs
                # sort+merge; later raw scans intersect against it unsorted.
                positions = iv.merge_intervals(positions)
                base = (seg.order - 1) * unit
                lo, hi = base, self.n - ctx.length + base  # valid window starts, 0-based
                left = np.maximum(positions["left"], lo)
                right = np.minimum(positions["right"], hi)
                keep = left <= right
                nxt = {k: v[keep] for k, v in positions.items()}
                nxt["left"], nxt["right"] = left[keep], right[keep]
            else:
                nxt = None
                # Join only when its O(|CS| log T) beats the per-row merge AND
                # the scale's position-sorted view is warranted (building it
                # costs O(T log R) once — POS_VIEW_MIN gates that, as in
                # _scan_fill/_gather_rows).
                if (cs["left"].size * self.JOIN_CS_RATIO < seg.count
                        and (self.index[seg.w].has_pos_sorted
                             or seg.count > self.POS_VIEW_MIN)):
                    nxt = self._scan_join(seg, cs, ctx)
                if nxt is not None:
                    ctx.stats.n_scans += 1
                else:
                    positions = self._scan(seg, ctx)
                    ctx.stats.n_scans += 1
                    nat = self._intersect_native(cs, positions, ctx, delta)
                    if nat is not None:
                        # The C kernel emitted the shifted, sorted-disjoint
                        # set AND its bookkeeping in one pass: no extra
                        # shift/merge/count/min-eps array passes.
                        nxt, n_off_c, emin_c = nat
                        fused = (nxt["left"].size, n_off_c, emin_c)
                    else:
                        pieces, ia, ib = iv.intersect_with_sorted(cs, positions)
                        nxt = self._combine(pieces, cs, positions, ia, ib, ctx)

            if fused is not None:
                if np.isfinite(fused[2]) and nxt["left"].size:
                    ctx.last_min_eps = fused[2]
                cs = nxt  # already in the next segment's frame
            else:
                self._track_min_eps(nxt, ctx)
                # NOTE: on the join path nxt's payload columns are ping-pong
                # scratch views (native._PING), and shift/merge_intervals may
                # return them UNCOPIED — cs can alias the pools until the next
                # native call flips the generation.  Sound only under the
                # shared-ping invariant documented at native._PING.
                cs = iv.merge_intervals(iv.shift(nxt, delta))
            ctx.stats.n_segments_used = i + 1
            if cs["left"].size:
                ctx.span = (int(cs["left"][0]), int(cs["right"][-1]))

            if cs["left"].size == 0:
                ctx.stats.t_phase1_ms = (time.perf_counter() - t0) * 1e3
                return cs, (segments[i + 1].order if i + 1 < len(segments) else seg.order)

            n_disjoint, n_offsets = fused[:2] if fused is not None \
                else iv.count_stats(cs)
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug("segment %d (order=%d w=%d): %d disjoint ranges, "
                             "%d offsets", i + 1, seg.order, seg.w,
                             n_disjoint, n_offsets)
            if qcfg.enable_early_termination:
                t1_ms = (time.perf_counter() - t0) * 1e3
                est2 = (cost_a * n_disjoint +
                        cost_b * n_offsets / 1e5 * ctx.length +
                        qcfg.phase2_cost_intercept)
                if (qcfg.phase2_cost_region is not None
                        and self.data_dev is not None
                        and not self.use_dtw_cost_model):
                    # Clustered candidates take the region route (see
                    # QueryConfig.phase2_cost_region): flat per-offset rate,
                    # ~L-independent.
                    est2 = min(est2, qcfg.phase2_cost_region * n_offsets
                               + qcfg.phase2_cost_intercept)
                est2_now = est2
                estimate = t1_ms + est2
                if logger.isEnabledFor(logging.DEBUG):
                    logger.debug("estimate after segment %d: t1=%.1fms "
                                 "est2=%.1fms", i + 1, t1_ms, est2)
                if (i >= qcfg.min_segments_before_termination
                        and estimate > last_estimate):
                    last_segment = (segments[i + 1].order if i + 1 < len(segments)
                                    else seg.order)
                    ctx.stats.early_terminated = True
                    break
                last_estimate = estimate
        else:
            last_segment = segments[-1].order

        ctx.stats.t_phase1_ms = (time.perf_counter() - t0) * 1e3
        return cs, last_segment

    # ------------------------------------------------ dense-on-device phase 1
    DENSE_PROBE_GROUP = 32  # dense queries probed per device pass

    def _dense_route(self, segments) -> bool:
        """True when phase 1 should run as the device dense probe: even the
        most selective plan segment is dense enough that host interval
        algebra would churn through 1e8-interval intermediates.  Never
        without a resident series (streamed and host-only modes): phase 1
        then stays on the host."""
        if self.data_dev is None:
            return False
        cutoff = self.qcfg.dense_probe_min_count
        return (cutoff is not None and bool(segments)
                and min(s.count for s in segments) > cutoff)

    def _dense_probe_retry(self, ctxs, seg_lists):
        """Flag-route dense phase 1 for a same-length query group: one pass
        of the resident probe, then each query's flags as intervals, a
        (left i64, right i64) pair a query.  Flag over-coverage is rejected
        by the exact phase 2."""
        L = ctxs[0].length
        norm = "alpha" in ctxs[0].params
        with span("kv.probe"):
            segs = pack_segments_batch(seg_lists, tuple(self.icfg.scales),
                                       self.device)
            eps2 = self._dev([c.eps2 for c in ctxs], torch.float32)
            cons = self._dev([[c.params["alpha"], c.params["beta"],
                               c.params["_mu_q"], c.params["_sd_q"]]
                              if norm else [0.0] * 4 for c in ctxs],
                             torch.float32)
            n_off, flags, blocks = self.probe.run(
                segs, eps2, cons, L, norm, self.CACHE_MEM_FRACTION)
            n_off, flags = fetch("kv.probe.wait", n_off, flags)
            m = self.n - L + 1
            with span("kv.probe.intervals"):
                for ctx, k in zip(ctxs, n_off.tolist()):
                    ctx.stats.n_probe_blocks = blocks
                    ctx.stats.n_candidates = k
                return [self._flags_to_intervals(f, m) for f in flags]

    def _probe_dense(self, ctxs, seg_lists):
        """Device phase 1 of queries with dense plans, DENSE_PROBE_GROUP a
        pass: each query's candidate intervals, in order.  A query's
        t_phase1_ms is its group's time over the group's size; n_scans and
        n_segments_used count its plan's segments."""
        out = []
        for g in range(0, len(ctxs), self.DENSE_PROBE_GROUP):
            grp = ctxs[g: g + self.DENSE_PROBE_GROUP]
            plans = seg_lists[g: g + self.DENSE_PROBE_GROUP]
            t0 = time.perf_counter()
            out += self._dense_probe_retry(grp, plans)
            dt = (time.perf_counter() - t0) * 1e3 / len(grp)
            for ctx, segs in zip(grp, plans):
                ctx.stats.t_phase1_ms = dt
                ctx.stats.n_scans = ctx.stats.n_segments_used = len(segs)
        return out

    @staticmethod
    def _flags_to_intervals(flags_row: np.ndarray, m: int):
        """Expand one query's flag bitmap (a flag per FLAG positions) into
        disjoint candidate intervals (adjacent flagged blocks coalesce;
        right edges clip to the last valid window start m-1)."""
        idx = np.flatnonzero(flags_row)
        if idx.size == 0:
            e = np.empty(0, np.int64)
            return e, e
        breaks = np.flatnonzero(np.diff(idx) > 1)
        left = idx[np.concatenate(([0], breaks + 1))].astype(np.int64) * FLAG
        right = np.minimum(
            (idx[np.concatenate((breaks, [idx.size - 1]))].astype(np.int64)
             + 1) * FLAG - 1, m - 1)
        return left, right

    def _phase1_routed(self, segments, ctx: _Ctx):
        """Host phase 1, or the device dense probe for dense plans.  Returns
        (c_left, c_right) candidate intervals in the global (query-start)
        frame."""
        if self._dense_route(segments):
            return self._probe_dense([ctx], [segments])[0]
        with span("kv.probe"):
            cs, last_segment = self._phase1(segments, ctx)
        return self._candidate_intervals(cs, last_segment, ctx.length)

    # ------------------------------------------------------------------ driver
    def query(self, query: np.ndarray, epsilon: float, **params) -> QueryResult:
        query = np.asarray(query, np.float64)
        if query.size < self.icfg.unit:
            raise ValueError(
                f"query length {query.size} is below the smallest index scale "
                f"({self.icfg.unit}); KV-match requires L >= {self.icfg.unit} "
                f"(QueryEngine.java:121-123)")
        if epsilon < 0:
            raise ValueError("epsilon must be >= 0")
        stats = QueryStats()
        ctx = _Ctx(query=query, length=query.size, epsilon=float(epsilon),
                   eps2=float(epsilon) ** 2, params=params, stats=stats)
        with request() as stats.trace:
            t0 = time.perf_counter()

            segments = self._plan(ctx)
            c_l, c_r = self._phase1_routed(segments, ctx)

            t2 = time.perf_counter()
            stats.n_candidates = int(np.sum(c_r - c_l + 1)) if c_l.size else 0
            stats.n_disjoint = int(c_l.size)
            if c_l.size:
                with span("kv.verify"):
                    ans_off, ans_dist = self._verify_intervals(c_l, c_r, ctx)
            else:
                ans_off, ans_dist = np.empty(0, np.int64), np.empty(0)
            stats.t_phase2_ms = (time.perf_counter() - t2) * 1e3

            order = np.argsort(ans_dist, kind="stable")
            ans_off, ans_dist = ans_off[order], ans_dist[order]
            stats.n_answers = int(ans_off.size)
            stats.t_total_ms = (time.perf_counter() - t0) * 1e3
        return QueryResult(offsets=ans_off, distances=ans_dist, stats=stats)

    # ------------------------------------------------------------ batched driver
    def query_batch(self, queries: np.ndarray, epsilon, **params) -> List[QueryResult]:
        """Throughput path: run phases 0/1 per query on the host, then verify ALL
        queries' candidates in shared device launches (one padded batch stream
        instead of one launch per query).  ``queries`` is (Q, L); ``epsilon`` may
        be a scalar or per-query array.  Returns one QueryResult per query.
        Dense plans run the device probe (``_dense_route``)."""
        return self._query_batch(queries, epsilon, params, all_dense=False)

    def query_batch_device(self, queries: np.ndarray, epsilon,
                           top_k: int = 4096, **params) -> List[QueryResult]:
        """``query_batch`` with phase 1 on the device for every query.
        ``top_k`` is kept for API compatibility.  ``stats.n_candidates`` is
        the probe's exact candidate count.  With no resident series to probe
        (streamed and host-only modes) this is ``query_batch``: host phase
        1, as the JAX package routes it."""
        if self.data_dev is None:
            return self.query_batch(queries, epsilon, **params)
        return self._query_batch(queries, epsilon, params, all_dense=True)

    def _query_batch(self, queries, epsilon, params: dict,
                     all_dense: bool) -> List[QueryResult]:
        """The body of ``query_batch`` and ``query_batch_device``: with
        ``all_dense`` every query takes the device probe and keeps its
        exact probe count as ``n_candidates``; otherwise the dense plans
        do and ``n_candidates`` is the candidate intervals' size."""
        queries = np.atleast_2d(np.asarray(queries, np.float64))
        nq = queries.shape[0]
        eps = np.broadcast_to(np.asarray(epsilon, np.float64), (nq,))
        with request() as trace:
            t0 = time.perf_counter()
            ctxs = [_Ctx(query=queries[qi], length=queries.shape[1],
                         epsilon=float(eps[qi]), eps2=float(eps[qi]) ** 2,
                         params=dict(params), stats=QueryStats())
                    for qi in range(nq)]
            seg_lists = self._plan_batch(ctxs)
            dense_q = [qi for qi in range(nq)
                       if all_dense or self._dense_route(seg_lists[qi])]
            dense_res = dict(zip(dense_q, self._probe_dense(
                [ctxs[qi] for qi in dense_q],
                [seg_lists[qi] for qi in dense_q])))
            cand_ivs: List[Tuple[np.ndarray, np.ndarray]] = []
            for qi, ctx in enumerate(ctxs):
                if qi in dense_res:
                    c_l, c_r = dense_res[qi]
                else:
                    with span("kv.probe"):
                        cs, last_segment = self._phase1(seg_lists[qi], ctx)
                    c_l, c_r = self._candidate_intervals(cs, last_segment,
                                                         ctx.length)
                if not all_dense:
                    ctx.stats.n_candidates = \
                        int(np.sum(c_r - c_l + 1)) if c_l.size else 0
                    ctx.stats.n_disjoint = int(c_l.size)
                cand_ivs.append((c_l, c_r))
            t_verify = time.perf_counter()
            with span("kv.verify"):
                per_query = self._verify_multi(cand_ivs, ctxs)
            t_end = time.perf_counter()
            results = []
            for qi, (ans_off, ans_dist) in enumerate(per_query):
                order = np.argsort(ans_dist, kind="stable")
                stats = ctxs[qi].stats
                stats.n_answers = int(ans_off.size)
                stats.t_phase2_ms = (t_end - t_verify) * 1e3 / nq
                stats.t_total_ms = (t_end - t0) * 1e3 / nq
                stats.trace = trace
                results.append(QueryResult(offsets=ans_off[order],
                                           distances=ans_dist[order],
                                           stats=stats))
        return results

    def query_at(self, offset: int, length: int, epsilon: float, **params) -> QueryResult:
        """Self-query convenience: extract Q = data[offset : offset+length] first
        (the reference's query(statistics, offset, length, ...) overload,
        QueryEngine.java:155-160).  ``offset`` is 0-based."""
        if not (0 <= offset and offset + length <= self.n):
            raise ValueError("query window out of range")
        return self.query(self.data[offset: offset + length], epsilon, **params)
