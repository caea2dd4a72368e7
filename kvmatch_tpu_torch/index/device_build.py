"""Device index builds in PyTorch (port of kvmatch_tpu/index/device_build.py).

Two builds, both on the tensor's device (the current CUDA device unless the
caller passes ``device="cpu"``):

* ``build_index_device_stats`` (serving mode) computes, per scale, the exact
  per-bucket offset and capped-interval histograms that the planner reads
  (IndexScale.counts_between_batch) -- one bucket pass, one cummax-RLE, one
  sort of a composite key and one searchsorted.  No intervals are
  materialized; the returned scales are ``stats_only`` and phase 1 must run
  as the device dense probe.
* ``build_index_device`` (the full index family) runs, per scale,

      bucket ids -> RLE with the 256-position cap -> bucket histogram ->
      row ids -> boundary-local merge policy -> segmented union + cap
      resplit -> per-row statistics

  with the variable-width row merge (IndexBuilder.java:308-346) as the
  reference's accumulating descending-key scan on the host, over row
  metadata only (``_merge_scan``), between two device stages
  (``_scale_pipeline_a``, ``_scale_pipeline_b``).  Because every window
  start has exactly one mean bucket, a scale's intervals tile the position
  axis: "group by bucket" is a histogram and "union adjacent rows" is run
  detection over the position-ordered stream, so no sort is needed.  The
  pieces stay on the device as the position-sorted view of each
  ``IndexScale`` (``dev_pos_view``) unless the build spills them (large n)
  or the caller asks for host copies.  Merges can differ from the host
  build's at boundaries (PARITY.md:104); answer sets cannot.

Both equal the JAX builds on the same input (tests/test_torch_device_build.py).
The JAX module's workarounds for a remote TPU compiler (stages padded to the
position count, shape-bucketed slices, no searchsorted over a computed
cumsum) are not semantics: the port compacts with boolean masks and
``repeat_interleave``.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import backend
from ..config import DEFAULT_INDEX_CONFIG, IndexConfig
from ..ops.sliding import bucketize_means, sliding_sums
from ..utils import rounding
from .structure import Index, IndexScale

logger = logging.getLogger("kvmatch_tpu_torch")

#: Histogram capacity (distinct mean buckets), as in the JAX build.
NB = 1 << 20

_SENT = 1 << 30  # bucket sentinel for padded tail positions

#: Most rows a scale may have before the host merge (as in the JAX build).
GMAX = 1 << 17

#: Max bucket distance between the rows of a position-adjacent interval pair
#: counted by the join histogram.  Pairs further apart are dropped (union
#: sizes get over-estimated, merges get rarer -- conservative).
DMAX = 8

#: Above this n the full build spills each scale's pieces to the host before
#: the next scale starts, bounding peak device memory to one scale's
#: working set.
SPILL_N = 40_000_000

#: Positions are int32 on the device, as in the JAX build.
MAX_POSITIONS = (1 << 31) - 1


def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _bucket_prog(data: torch.Tensor, w: int, u: int, pos_of_d: int
                 ) -> torch.Tensor:
    """Single-scale bucket ids, padded with the sentinel to n - u + 1."""
    s = sliding_sums(data, (u, w) if w != u else (u,))[w]
    b = bucketize_means(s, w, pos_of_d)
    pad = w - u
    if pad:
        b = torch.cat([b, torch.full((pad,), _SENT, dtype=torch.int32,
                                     device=b.device)])
    return b


def _bucket_range(data: np.ndarray, cfg: IndexConfig):
    """(bucket_lo, bucket_hi) bounding every mean bucket of the series, from
    the host data range; raises when it passes the histogram capacity NB."""
    s = 10.0 ** (cfg.pos_of_d - 1)
    bucket_lo = int(2 * np.floor(float(data.min()) * s)) - 2
    bucket_hi = int(2 * np.floor(float(data.max()) * s)) + 3
    if bucket_hi - bucket_lo >= NB:
        raise ValueError(
            f"mean-bucket range {bucket_hi - bucket_lo} exceeds the device "
            f"histogram capacity {NB}; build this data's index with "
            f"kvmatch_tpu_torch.index.build.build_index_host")
    return bucket_lo, bucket_hi


def _scale_pipeline_a(b: torch.Tensor, bucket_lo: int, cap: int):
    """Stage A: RLE with the cap, bucket histogram and adjacency-join
    histogram of one scale's bucket ids ``b`` (int32, one per window start).

    Returns the interval arrays, which stay on the device for stage B,
    (il, ir, r_iv): left and right positions (int32) and row id of each
    interval, in position order; and the row metadata for the host merge,
    (row_bucket, counts, offs, joins): each row's bucket, interval count and
    offset total, and joins[r, d - 1], the position-adjacent interval pairs
    between rows r and r + d (d <= DMAX)."""
    m = b.shape[0]
    dev = b.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    change = torch.ones(m, dtype=torch.bool, device=dev)
    change[1:] = b[1:] != b[:-1]
    run_start = _prefix_max(torch.where(change, pos, -1))
    start = change | ((pos - run_start) % cap == 0)
    del run_start, change
    il = pos[start]
    del pos, start
    ir = torch.empty_like(il)
    ir[:-1] = il[1:] - 1
    ir[-1:] = m - 1
    # Rows are the buckets present, in ascending order.
    hb = torch.clamp(b[il] - bucket_lo, 0, NB - 1)
    hist = torch.bincount(hb, minlength=NB)
    present = hist > 0
    row_of_bucket = torch.cumsum(present, 0) - 1
    r_iv = row_of_bucket[hb]
    row_bucket = torch.nonzero(present).flatten() + bucket_lo
    counts = hist[present]
    n_rows = int(row_bucket.shape[0])
    offs = torch.zeros(n_rows, dtype=torch.int64, device=dev).index_add_(
        0, r_iv, (ir - il + 1).long())
    # The buckets tile the position axis, so consecutive intervals are
    # position-adjacent; a pair whose rows differ by delta in [1, DMAX] is a
    # union join charged to (lower row, delta).
    delta = (r_iv[1:] - r_iv[:-1]).abs()
    ok = (delta >= 1) & (delta <= DMAX)
    jdst = torch.minimum(r_iv[1:], r_iv[:-1])[ok] * DMAX + delta[ok] - 1
    joins = torch.bincount(jdst, minlength=n_rows * DMAX)
    meta = tuple(t.cpu().numpy() for t in (row_bucket, counts, offs, joins))
    return (il, ir, r_iv), meta[:3] + (meta[3].reshape(n_rows, DMAX),)


def _merge_scan(counts: np.ndarray, offs: np.ndarray, joins: np.ndarray,
                count_factor: float, shrink_factor: float, cap: int):
    """The reference's accumulating row merge (IndexBuilder.java:308-346) on
    row metadata: descending-key scan; row idx merges into the RUNNING group
    when its interval count < count_factor*avg and the estimated union size
    shrinks below shrink_factor*(parts sum).  ``joins[r, d-1]`` counts
    position-adjacent interval pairs between rows r and r+d; ``offs[r]`` is
    row r's total offsets (sum of piece lengths).

    The union estimate is  max(parts - joins, ceil(group_offsets / cap)).
    The join term alone collapses key-range tails: there, nearly every piece
    is position-adjacent to a piece of a nearby row (joins ~= counts), so the
    estimate stays flat while the true union — long coalesced runs RE-SPLIT
    at the 256-offset cap (IndexNodeUtils.mergeIndexNode) — keeps growing
    with the group.  ceil(group_offsets/cap) is a hard lower bound on the
    capped union (disjoint runs: sum of ceils >= ceil of sum), tight exactly
    in that coalesced-tail regime, and inert in the key-range center where
    runs are far shorter than the cap.

    Returns (grp_of_row i64[R], n_groups); group ids ascend with key order
    and each group's key is its first row's bucket."""
    R = int(counts.size)
    if R == 0:
        return np.zeros(0, np.int64), 0
    thresh = count_factor * float(counts.mean())
    shrink = float(shrink_factor)
    merge_up = np.zeros(R, bool)        # row idx joins the group of row idx+1
    joins_f = joins.astype(np.float64, copy=False)
    counts_f = counts.astype(np.float64, copy=False)
    offs_f = offs.astype(np.float64, copy=False)
    top = R - 1
    acc = counts_f[R - 1]
    acc_off = offs_f[R - 1]
    for idx in range(R - 2, -1, -1):
        c = counts_f[idx]
        if c < thresh:
            d = top - idx
            j = joins_f[idx, :d].sum() if d < DMAX else joins_f[idx].sum()
            floor = np.ceil((acc_off + offs_f[idx]) / cap)
            union = max(acc + c - j, floor)
            if union < shrink * (acc + c):
                acc = union
                acc_off += offs_f[idx]
                merge_up[idx] = True
                continue
        top = idx
        acc = c
        acc_off = offs_f[idx]
    grp = np.zeros(R, np.int64)
    np.cumsum(~merge_up[:-1], out=grp[1:])
    return grp, int(grp[-1]) + 1


def _scale_pipeline_b(il: torch.Tensor, ir: torch.Tensor, r_iv: torch.Tensor,
                      grp_of_row: torch.Tensor, n_groups: int, cap: int):
    """Stage B: apply the host grouping, then the segmented union with the
    cap resplit and the per-group statistics.  Adjacent intervals of one
    group join into a run; a run splits into pieces of at most ``cap``
    offsets.  Returns (p_left, p_right, p_row) int32 in position order and
    (g_n_iv, g_n_off) int64[n_groups]."""
    dev = il.device
    g_iv = grp_of_row[r_iv]
    ustart = torch.ones(il.shape[0], dtype=torch.bool, device=dev)
    ustart[1:] = (g_iv[1:] != g_iv[:-1]) | (il[1:] != ir[:-1] + 1)
    first = torch.nonzero(ustart).flatten()
    run_l = il[first]
    run_g = g_iv[first]
    last = torch.empty_like(first)
    last[:-1] = first[1:] - 1
    last[-1:] = il.shape[0] - 1
    run_r = ir[last]
    del first, last, ustart, g_iv
    pieces = (run_r - run_l + cap) // cap
    total = int(pieces.sum())
    rep = torch.repeat_interleave(
        torch.arange(run_l.shape[0], device=dev), pieces, output_size=total)
    before = torch.cumsum(pieces, 0) - pieces  # pieces of the earlier runs
    within = (torch.arange(total, device=dev) - before[rep]) * cap
    p_left = (run_l[rep] + within).to(torch.int32)
    p_right = torch.minimum(p_left + (cap - 1), run_r[rep])
    p_row = run_g[rep].to(torch.int32)
    g_n_iv = torch.bincount(p_row, minlength=n_groups)
    g_n_off = torch.zeros(n_groups, dtype=torch.int64, device=dev).index_add_(
        0, p_row, (p_right - p_left + 1).long())
    return (p_left, p_right, p_row), (g_n_iv, g_n_off)


def _numpy_twin_scale(b: np.ndarray, cap: int, count_factor: float,
                      shrink_factor: float):
    """Host mirror of stage A + _merge_scan + stage B (the semantics
    reference for tests).  Takes the raw bucket array (no padding); returns
    (p_left, p_right, p_row, grp_bucket, g_n_iv, g_n_off)."""
    m = b.size
    pos = np.arange(m)
    change = np.concatenate(([True], b[1:] != b[:-1]))
    run_start = np.maximum.accumulate(np.where(change, pos, -1))
    start = change | ((pos - run_start) % cap == 0)
    il = pos[start]
    ir = np.concatenate([il[1:] - 1, [m - 1]])
    ib = b[il]
    ub, r_iv, counts = np.unique(ib, return_inverse=True, return_counts=True)
    R = ub.size
    joins = np.zeros((R, DMAX), np.int64)
    dj = np.abs(np.diff(r_iv))
    lo = np.minimum(r_iv[:-1], r_iv[1:])
    ok = (dj >= 1) & (dj <= DMAX)
    np.add.at(joins, (lo[ok], dj[ok] - 1), 1)
    offs = np.zeros(R, np.int64)
    np.add.at(offs, r_iv, ir - il + 1)
    grp, _ = _merge_scan(counts, offs, joins, count_factor, shrink_factor,
                         cap)
    gfirst = np.concatenate(([True], grp[1:] != grp[:-1]))
    grp_bucket = ub[gfirst]
    g_iv = grp[r_iv]
    ustart = np.concatenate(
        ([True], (g_iv[1:] != g_iv[:-1]) | (il[1:] != ir[:-1] + 1)))
    runL = il[ustart]
    uidx = np.flatnonzero(ustart)
    ends = np.concatenate([uidx[1:] - 1, [il.size - 1]])
    runR = ir[ends]
    rung = g_iv[ustart]
    run_len = runR - runL + 1
    pieces = (run_len + cap - 1) // cap
    rep = np.repeat(np.arange(runL.size), pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(int(pieces.sum())) - np.repeat(offs, pieces)) * cap
    p_left = runL[rep] + within
    p_right = np.minimum(p_left + cap - 1, runR[rep])
    p_row = rung[rep]
    NG = int(grp.max()) + 1 if R else 0
    g_n_iv = np.zeros(NG, np.int64)
    np.add.at(g_n_iv, p_row, 1)
    g_n_off = np.zeros(NG, np.int64)
    np.add.at(g_n_off, p_row, p_right - p_left + 1)
    return p_left, p_right, p_row, grp_bucket, g_n_iv, g_n_off


def _scale_pipeline_stats(b: torch.Tensor, bucket_lo: int, n_valid: int,
                          cap: int, nbs: int):
    """Exact per-bucket (offset, capped-interval) histograms by sort-based
    counting; returns (hist_off i64[nbs], hist_iv i64[nbs]) indexed by
    bucket - bucket_lo."""
    M = b.shape[0]
    dev = b.device
    pos = torch.arange(M, dtype=torch.int32, device=dev)
    valid = pos < n_valid
    change = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        b[1:] != b[:-1]])
    run_start = _prefix_max(torch.where(change, pos, -1))
    start = (change | ((pos - run_start) % cap == 0)) & valid
    comp = torch.where(valid,
                       torch.clamp(b - bucket_lo, 0, nbs - 1) * 2
                       + start.to(torch.int32),
                       2 * nbs)
    del pos, change, run_start, start
    sc = torch.sort(comp).values
    edges = torch.arange(2 * nbs + 1, dtype=torch.int32, device=dev)
    cnt = torch.searchsorted(sc, edges, side="left")
    per = (cnt[1:] - cnt[:-1]).reshape(nbs, 2)
    return per[:, 0] + per[:, 1], per[:, 1]


def build_index_device_stats(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                             stats: Optional[dict] = None,
                             data_dev: Optional[torch.Tensor] = None,
                             device=None) -> Index:
    """Planner statistics of every scale, built on ``data_dev``'s device, or
    on ``device`` (the current CUDA device unless ``device="cpu"``) after one
    upload of ``data``.  ``stats`` receives the build seconds and Mpts/s."""
    data = np.asarray(data)
    n = data.size
    scales = tuple(cfg.scales)
    u = min(scales)
    cap = cfg.maximum_diff - 1
    bucket_lo, bucket_hi = _bucket_range(data, cfg)
    t0 = time.perf_counter()
    if data_dev is None:
        data_dev = torch.as_tensor(data, dtype=torch.float32,
                                   device=backend.resolve_device(device))
    if data_dev.device.type == "cuda":
        torch.cuda.synchronize(data_dev.device)
    t_h2d = time.perf_counter() - t0

    nbs = 1 << max(bucket_hi - bucket_lo + 2, 2).bit_length()
    t0 = time.perf_counter()
    hists = {}
    for w in scales:
        b = _bucket_prog(data_dev, w, u, cfg.pos_of_d)
        h_off, h_iv = _scale_pipeline_stats(b, bucket_lo, n - w + 1, cap, nbs)
        del b
        hists[w] = (h_off.cpu().numpy(), h_iv.cpu().numpy())
    t_dev = time.perf_counter() - t0

    t0 = time.perf_counter()
    index: Index = {}
    for w in scales:
        hist_off, hist_iv = (a.astype(np.int64) for a in hists[w])
        present = np.flatnonzero(hist_off)
        buckets = present + bucket_lo
        g_n_off = hist_off[present]
        g_n_iv = hist_iv[present]
        keys = rounding.bucket_to_key(buckets, cfg.pos_of_d)
        row_ptr = np.zeros(present.size + 1, np.int64)
        np.cumsum(g_n_iv, out=row_ptr[1:])
        upper = float(rounding.bucket_to_key(int(buckets[-1]) + 1,
                                             cfg.pos_of_d)) \
            if present.size else float("inf")
        index[w] = IndexScale(
            w=w, n=n, keys=keys, row_ptr=row_ptr, left=None, right=None,
            cum_intervals=np.cumsum(g_n_iv), cum_offsets=np.cumsum(g_n_off),
            mean_upper_bound=upper, stats_only=True)
    t_host = time.perf_counter() - t0
    if stats is not None:
        total = t_h2d + t_dev + t_host
        stats.update(build_seconds=total,
                     mpts_per_second=n * len(scales) / max(total, 1e-9) / 1e6,
                     h2d_seconds=t_h2d, device_seconds=t_dev,
                     host_group_seconds=t_host)
    return index


def build_index_device(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                       stats: Optional[dict] = None,
                       keep_device: bool = True,
                       data_dev: Optional[torch.Tensor] = None,
                       device=None) -> Index:
    """The full index family built on ``data_dev``'s device, or on
    ``device`` (the current CUDA device unless ``device="cpu"``) after one
    upload of ``data``; the host receives row metadata only (port of
    kvmatch_tpu/index/device_build.py:build_index_device).

    ``keep_device=True`` leaves each scale's pieces on the device as its
    position-sorted view (``IndexScale.dev_pos_view``; host copies are made
    at first host access); False copies them to the host at once.  Above
    ``SPILL_N`` points the build runs scale by scale and copies each
    scale's pieces to the host before the next scale starts, bounding peak
    device memory to one scale's working set.  ``stats`` receives the build
    seconds, Mpts/s and the device, host-merge and device-to-host seconds.
    Positions are int32: a series of more than 2^31 - 1 points raises."""
    data = np.asarray(data)
    n = data.size
    if n > MAX_POSITIONS:
        raise ValueError(f"build_index_device: {n} points exceed the int32 "
                         f"position limit {MAX_POSITIONS}")
    scales = tuple(cfg.scales)
    u = min(scales)
    cap = cfg.maximum_diff - 1
    bucket_lo, _ = _bucket_range(data, cfg)
    spill = n > SPILL_N
    t0 = time.perf_counter()
    if data_dev is None:
        data_dev = torch.as_tensor(data, dtype=torch.float32,
                                   device=backend.resolve_device(device))
    dev = data_dev.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t_h2d = time.perf_counter() - t0
    t_dev = t_host = t_d2h = 0.0
    index: Index = {}
    for w in scales:
        t1 = time.perf_counter()
        s = sliding_sums(data_dev, (u, w) if w != u else (u,))[w]
        b = bucketize_means(s, w, cfg.pos_of_d)
        del s
        ivs, (row_bucket, counts, offs, joins) = _scale_pipeline_a(
            b, bucket_lo, cap)
        del b
        n_rows = row_bucket.size
        if n_rows > GMAX:
            raise ValueError(f"scale w={w}: {n_rows} rows exceed GMAX={GMAX}")
        t2 = time.perf_counter()
        grp, n_groups = _merge_scan(counts, offs, joins,
                                    cfg.merge_count_factor,
                                    cfg.merge_shrink_factor, cap)
        grp_bucket = row_bucket[np.concatenate(([True], grp[1:] != grp[:-1]))
                                if n_rows else np.zeros(0, bool)]
        t3 = time.perf_counter()
        pieces, (g_n_iv, g_n_off) = _scale_pipeline_b(
            *ivs, torch.as_tensor(grp, device=dev), n_groups, cap)
        del ivs
        g_n_iv = g_n_iv.cpu().numpy().astype(np.int64)
        g_n_off = g_n_off.cpu().numpy().astype(np.int64)
        np_pieces = int(pieces[0].shape[0])
        t4 = time.perf_counter()
        t_dev += (t2 - t1) + (t4 - t3)
        t_host += t3 - t2
        keys = rounding.bucket_to_key(grp_bucket, cfg.pos_of_d)
        row_ptr = np.zeros(n_groups + 1, np.int64)
        np.cumsum(g_n_iv, out=row_ptr[1:])
        upper = float(rounding.bucket_to_key(int(row_bucket[-1]) + 1,
                                             cfg.pos_of_d)) \
            if n_groups else float("inf")
        sc = IndexScale(
            w=w, n=n, keys=keys, row_ptr=row_ptr, left=None, right=None,
            cum_intervals=np.cumsum(g_n_iv), cum_offsets=np.cumsum(g_n_off),
            mean_upper_bound=upper,
            dev_pos_view=None if spill else (*pieces, np_pieces))
        if spill:
            t5 = time.perf_counter()
            host = [t.cpu().numpy() for t in pieces]
            del pieces
            t6 = time.perf_counter()
            sc.set_pos_arrays(*host)
            t_d2h += t6 - t5
            t_host += time.perf_counter() - t6
        elif not keep_device:
            t5 = time.perf_counter()
            sc.materialize_host()
            t_d2h += time.perf_counter() - t5
        index[w] = sc
        logger.debug("device build w=%d: %d pieces, %d rows", w, np_pieces,
                     n_groups)
    if stats is not None:
        total = time.perf_counter() - t0
        stats.update(build_seconds=total,
                     mpts_per_second=n * len(scales) / max(total, 1e-9) / 1e6,
                     h2d_seconds=t_h2d, device_seconds=t_dev,
                     host_group_seconds=t_host, d2h_seconds=t_d2h,
                     spilled=spill)
    return index
