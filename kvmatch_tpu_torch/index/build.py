"""KV-index construction: a bucket pass, then vectorized host grouping.

A copy of kvmatch_tpu/index/build.py, the reference's IndexBuilder
(IndexBuilder.java:47-350) redesigned: one pass gives the mean-bucket ids of
every scale, and run-length encoding, row grouping and the variable-width
merge policy are O(n) passes in C with NumPy fallbacks.  The bucket pass runs
on the host in float64 (``compute_buckets_host``, ``build_index_host``) or
on the device in f32 (``compute_buckets_device``,
``build_index_device_buckets``: the JAX package's ``compute_buckets_tpu`` and
``build_index_tpu``, and the engines' default index).  The merge policy
(IndexBuilder.java:308-346) and the 256-offset interval cap (IndexNode.java:31,
IndexBuilder.java:268) are reproduced, so each index equals the JAX
package's from the same pass.  Positions are 0-based window starts (the
reference stores 1-based `loc`, IndexBuilder.java:259).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..backend import resolve_device
from ..config import DEFAULT_INDEX_CONFIG, IndexConfig
from ..utils import rounding
from .structure import Index, IndexScale


logger = logging.getLogger("kvmatch_tpu_torch")


def _rle_cap(buckets: np.ndarray, cap: int):
    """Run-length encode equal-bucket runs, splitting runs longer than ``cap``
    positions (the MAXIMUM_DIFF discipline, IndexBuilder.java:268).

    Returns (bucket_per_interval, left, right) with 0-based inclusive positions.
    Uses the single-stream C kernel when available (the NumPy fallback below is
    the semantics reference; identical output, ~10x slower at n=1e8).
    """
    from .. import native

    if buckets.size and np.issubdtype(buckets.dtype, np.integer) \
            and buckets.min() >= np.iinfo(np.int32).min \
            and buckets.max() <= np.iinfo(np.int32).max:
        out = native.rle_cap(buckets, cap)
        if out is not None:
            return out[0].astype(buckets.dtype, copy=False), out[1], out[2]
    m = buckets.size
    if m == 0:
        e = np.empty(0, np.int64)
        return e.astype(np.int32), e, e
    change = np.empty(m, bool)
    change[0] = True
    np.not_equal(buckets[1:], buckets[:-1], out=change[1:])
    run_starts = np.flatnonzero(change).astype(np.int64)
    run_ends = np.empty_like(run_starts)
    run_ends[:-1] = run_starts[1:] - 1
    run_ends[-1] = m - 1
    run_len = run_ends - run_starts + 1
    # Split runs into ceil(len/cap) intervals of at most cap positions.
    pieces = (run_len + cap - 1) // cap
    total = int(pieces.sum())
    rep_start = np.repeat(run_starts, pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(total) - np.repeat(offs, pieces)) * cap
    left = rep_start + within
    right = np.minimum(left + cap - 1, np.repeat(run_ends, pieces))
    ivl_bucket = np.repeat(buckets[run_starts], pieces)
    return ivl_bucket, left, right


def _union_resplit(l1, r1, l2, r2, cap: int):
    """Sorted union of two disjoint interval lists, merging overlapping/adjacent and
    re-splitting pieces wider than ``cap`` (IndexNodeUtils.mergeIndexNode,
    IndexNodeUtils.java:30-90)."""
    left = np.concatenate([l1, l2])
    right = np.concatenate([r1, r2])
    order = np.argsort(left, kind="stable")
    left, right = left[order], right[order]
    cummax = np.maximum.accumulate(right)
    starts = np.empty(left.size, bool)
    starts[0] = True
    starts[1:] = left[1:] - 1 > cummax[:-1]
    first = np.flatnonzero(starts)
    g_left = left[first]
    g_right = np.maximum.reduceat(right, first)
    # Re-split at cap.
    length = g_right - g_left + 1
    pieces = (length + cap - 1) // cap
    total = int(pieces.sum())
    rep = np.repeat(g_left, pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(total) - np.repeat(offs, pieces)) * cap
    out_l = rep + within
    out_r = np.minimum(out_l + cap - 1, np.repeat(g_right, pieces))
    return out_l, out_r


def _group_and_merge(ivl_bucket, left, right, cfg: IndexConfig, w: int, n: int) -> IndexScale:
    """Group intervals by bucket into rows, then apply the variable-width row merge
    (IndexBuilder.java:308-346): scan keys descending, merge a row into the running
    group when its interval count < 1.2*avg and the merged list shrinks below
    0.8*(sum of parts); a merged row keeps the group's smallest key."""
    from .. import native

    # Grouping: counting-sort C kernel (no argsort/unique — the bucket range is
    # a few thousand distinct mean grids; this host has ONE core, so the serial
    # constant factor IS the build time) with the argsort path as fallback and
    # semantics reference.
    grp = native.group_rows(ivl_bucket, left, right) if ivl_bucket.size else None
    if grp is not None:
        ubuckets, row_ptr0, l_sorted, r_sorted = grp
        row_start = row_ptr0[:-1]
        row_end = row_ptr0[1:]
    else:
        order = np.argsort(ivl_bucket, kind="stable")  # stable keeps left ascending per row
        b_sorted = ivl_bucket[order]
        l_sorted = left[order]
        r_sorted = right[order]
        ubuckets, row_start = np.unique(b_sorted, return_index=True)
        ubuckets = ubuckets.astype(np.int64)
        row_end = np.empty_like(row_start)
        row_end[:-1] = row_start[1:]
        row_end[-1] = b_sorted.size
    counts = row_end - row_start
    avg = counts.mean() if counts.size else 0.0
    cap = cfg.maximum_diff
    merge_thresh = cfg.merge_count_factor * avg

    nat = native.group_merge(row_start, row_end, ubuckets, l_sorted, r_sorted,
                             merge_thresh, cfg.merge_shrink_factor, cap) \
        if ubuckets.size else None
    if nat is not None:
        keys_a, counts_a, flat_l, flat_r = nat
        keys = rounding.bucket_to_key(keys_a, cfg.pos_of_d)
        row_ptr = np.zeros(keys_a.size + 1, np.int64)
        np.cumsum(counts_a, out=row_ptr[1:])
        n_iv = np.diff(row_ptr)
        n_off = np.add.reduceat(flat_r - flat_l + 1, row_ptr[:-1]) if flat_l.size \
            else np.zeros(keys_a.size, np.int64)
        n_off = np.where(n_iv == 0, 0, n_off)
        upper = float(rounding.bucket_to_key(int(ubuckets[-1]) + 1, cfg.pos_of_d)) \
            if ubuckets.size else float("inf")
        return IndexScale(
            w=w, n=n, keys=keys, row_ptr=row_ptr,
            left=flat_l.astype(np.int64), right=flat_r.astype(np.int64),
            cum_intervals=np.cumsum(n_iv), cum_offsets=np.cumsum(n_off),
            mean_upper_bound=upper,
        )

    # Descending-key scan with chained merging (NumPy fallback = the
    # semantics reference for the C kernel above).
    out_keys = []      # smallest bucket of each final row
    out_lists = []     # (left, right) arrays per final row
    R = ubuckets.size
    cur_l = cur_r = None
    cur_key = None
    for idx in range(R - 1, -1, -1):
        l_i = l_sorted[row_start[idx]:row_end[idx]]
        r_i = r_sorted[row_start[idx]:row_end[idx]]
        if cur_l is None:
            cur_l, cur_r, cur_key = l_i, r_i, ubuckets[idx]
            continue
        merged = False
        if counts[idx] < merge_thresh:
            ml, mr = _union_resplit(cur_l, cur_r, l_i, r_i, cap)
            if ml.size < cfg.merge_shrink_factor * (cur_l.size + l_i.size):
                cur_l, cur_r = ml, mr
                cur_key = ubuckets[idx]
                merged = True
        if not merged:
            out_keys.append(cur_key)
            out_lists.append((cur_l, cur_r))
            cur_l, cur_r, cur_key = l_i, r_i, ubuckets[idx]
    if cur_l is not None:
        out_keys.append(cur_key)
        out_lists.append((cur_l, cur_r))

    # Reverse to ascending key order.
    out_keys = out_keys[::-1]
    out_lists = out_lists[::-1]
    keys = rounding.bucket_to_key(np.asarray(out_keys, np.int64), cfg.pos_of_d)
    row_ptr = np.zeros(len(out_lists) + 1, np.int64)
    for i, (l_i, _) in enumerate(out_lists):
        row_ptr[i + 1] = row_ptr[i] + l_i.size
    if out_lists:
        flat_l = np.concatenate([l for l, _ in out_lists])
        flat_r = np.concatenate([r for _, r in out_lists])
    else:
        flat_l = flat_r = np.empty(0, np.int64)
    n_iv = np.diff(row_ptr)
    n_off = np.add.reduceat(flat_r - flat_l + 1, row_ptr[:-1]) if flat_l.size else \
        np.zeros(len(out_lists), np.int64)
    n_off = np.where(n_iv == 0, 0, n_off)
    upper = float(rounding.bucket_to_key(int(ubuckets[-1]) + 1, cfg.pos_of_d)) \
        if ubuckets.size else float("inf")
    return IndexScale(
        w=w, n=n, keys=keys, row_ptr=row_ptr,
        left=flat_l.astype(np.int64), right=flat_r.astype(np.int64),
        cum_intervals=np.cumsum(n_iv), cum_offsets=np.cumsum(n_off),
        mean_upper_bound=upper,
    )


def build_index_from_buckets(buckets: Dict[int, np.ndarray], n: int,
                             cfg: IndexConfig = DEFAULT_INDEX_CONFIG) -> Index:
    cap = cfg.maximum_diff - 1  # builder-side cap: a run breaks after 255 offsets
    index: Index = {}
    for w, b in buckets.items():
        ivl_bucket, left, right = _rle_cap(np.asarray(b), cap)
        index[w] = _group_and_merge(ivl_bucket, left, right, cfg, w, n)
        logger.debug("scale w=%d: %d intervals -> %d rows", w,
                     ivl_bucket.size, index[w].num_rows)
    return index


def compute_buckets_host(data: np.ndarray,
                         cfg: IndexConfig = DEFAULT_INDEX_CONFIG
                         ) -> Dict[int, np.ndarray]:
    """Host float64 bucket pass: prefix sums + fused mean->bucket C kernel
    (native.bucket_pass), with the vectorized NumPy math as the fallback and
    the semantics reference.  Bit-identical to the NumPy path (tests assert it);
    ~15x faster because the C stream has no temporaries.
    """
    from .. import native

    data = np.asarray(data, np.float64)
    c1 = np.concatenate(([0.0], np.cumsum(data)))
    buckets: Dict[int, np.ndarray] = {}
    for w in cfg.scales:
        b = native.bucket_pass(c1, w, cfg.pos_of_d)
        if b is None:
            means = (c1[w:] - c1[:-w]) / w
            b = rounding.bucket_id(means, cfg.pos_of_d).astype(np.int32)
        buckets[w] = b
    return buckets


def build_index_host(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                     stats: Optional[dict] = None) -> Index:
    """Host builder: the C bucket pass + host grouping.  ``stats`` receives
    the build seconds and Mpts/s."""
    data = np.asarray(data)
    n = data.size
    t0 = time.perf_counter()
    index = build_index_from_buckets(compute_buckets_host(data, cfg), n, cfg)
    if stats is not None:
        total = time.perf_counter() - t0
        stats.update(build_seconds=total,
                     mpts_per_second=n * len(cfg.scales) / max(total, 1e-9) / 1e6)
    return index


def compute_buckets_device(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                           chunk: Optional[int] = None,
                           stats: Optional[dict] = None,
                           device=None) -> Dict[int, np.ndarray]:
    """Device doubling-kernel bucket pass (ops/sliding.build_buckets, f32 on
    ``device``, the current CUDA device unless ``device="cpu"``), chunked
    with w_max - 1 right halos; port of
    kvmatch_tpu/index/build.py:compute_buckets_tpu.

    The halo discipline mirrors the MapReduce mapper's region-left extension
    (BuildIndexMapReduce.java:215-226): chunk c covers window starts
    [c*chunk, (c+1)*chunk) and reads w_max-1 extra points on the right.
    Bucket ids equal the JAX pass's bit for bit.  ``stats`` gets the
    seconds of the upload, the device pass and the copy back."""
    from ..ops.sliding import build_buckets

    data = np.asarray(data)
    n = data.size
    scales = tuple(cfg.scales)
    w_max = max(scales)
    chunk = chunk or cfg.build_chunk
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    upload_s = exec_s = d2h_s = 0.0
    parts: Dict[int, list] = {w: [] for w in scales}
    for start in range(0, max(n - w_max + 1, 1), chunk):
        stop = min(start + chunk + w_max - 1, n)
        t0 = time.perf_counter()
        piece = torch.as_tensor(data[start:stop], dtype=torch.float32,
                                device=dev)
        sync()
        t1 = time.perf_counter()
        out = build_buckets(piece, scales, cfg.pos_of_d)
        sync()
        t2 = time.perf_counter()
        out = {w: v.cpu().numpy() for w, v in out.items()}
        t3 = time.perf_counter()
        upload_s += t1 - t0
        exec_s += t2 - t1
        d2h_s += t3 - t2
        for w in scales:
            # Window starts owned by this chunk: [start, min(start+chunk, n-w+1)).
            owned = min(start + chunk, n - w + 1) - start
            if owned > 0:
                parts[w].append(out[w][:owned])
        if stop == n:
            break
    if stats is not None:
        stats["device_seconds"] = stats.get("device_seconds", 0.0) + exec_s
        stats["upload_seconds"] = upload_s
        stats["d2h_seconds"] = d2h_s
    return {w: (np.concatenate(v) if len(v) > 1 else v[0])
            for w, v in parts.items()}


def build_index_device_buckets(data, cfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                               chunk: Optional[int] = None,
                               stats: Optional[dict] = None,
                               device=None) -> Index:
    """Device bucket pass + host grouping; port of
    kvmatch_tpu/index/build.py:build_index_tpu.

    Runs ``compute_buckets_device`` on ``device`` (the current CUDA device
    unless ``device="cpu"``); ``build_index_host`` is the same index from
    the fused C pass on the CPU.  ``stats`` receives the build seconds and
    Mpts/s, and the pass's seconds."""
    data = np.asarray(data)
    n = data.size
    t0 = time.perf_counter()
    buckets = compute_buckets_device(data, cfg, chunk, stats, device)
    index = build_index_from_buckets(buckets, n, cfg)
    if stats is not None:
        total = time.perf_counter() - t0
        stats.update(build_seconds=total,
                     mpts_per_second=n * len(cfg.scales) / max(total, 1e-9) / 1e6)
    return index
