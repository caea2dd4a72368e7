"""Incremental (append) index maintenance — a capability beyond the reference.

A copy of kvmatch_tpu/index/streaming.py over the port's host build
(index/build.py ``_group_and_merge``, the C ``bucket_pass`` with its NumPy
fallback); host code, as in the JAX package.  ``build()`` equals
``build_index_host`` over the concatenated series bit for bit.

The reference's IndexBuilder is build-once (IndexBuilder.java:47-350: one pass
over a closed series; growing the series means rebuilding).  Time series are
append-only in production, so this module maintains the KV-index under appends:

* Bucket values depend only on the window's points, so appending ``m`` points
  creates exactly ``m`` new windows per scale and NEVER changes existing bucket
  values.  The builder keeps the last ``w_max - 1`` points and computes buckets
  for just the new windows (C ``bucket_pass`` on the overlap + chunk).
* New equal-bucket runs are joined to the cached tail run per scale; the
  MAXIMUM_DIFF cap split (IndexBuilder.java:268) is applied at ``build()`` time
  so piece boundaries keep the same phase as a from-scratch RLE.
* The variable-width row-merge policy (IndexBuilder.java:308-346) is GLOBAL —
  which rows coalesce depends on the full count distribution — so the merge is
  re-run from the cached runs on each ``build()`` refresh.  ``append`` is
  O(chunk); ``build`` is O(total intervals) but skips re-bucketing the old
  points (chip_smoke.py's ``append`` phase times both beside the host
  build).  Absorb a stream with many cheap ``append``
  calls and refresh at query-visibility boundaries.

Usage::

    b = StreamingIndexBuilder(cfg)
    b.append(first_chunk)
    b.append(more_points)
    index = b.build()          # == build_index_host(np.concatenate(chunks))
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import IndexConfig, DEFAULT_INDEX_CONFIG
from ..utils import rounding
from .build import _group_and_merge
from .structure import Index


def _runs(b: np.ndarray):
    """Uncapped RLE: (bucket, left, right) per equal-bucket run, 0-based."""
    m = b.size
    change = np.empty(m, bool)
    change[0] = True
    np.not_equal(b[1:], b[:-1], out=change[1:])
    starts = np.flatnonzero(change).astype(np.int64)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = m - 1
    return b[starts].astype(np.int64), starts, ends


def _cap_split(ib: np.ndarray, l: np.ndarray, r: np.ndarray, cap: int):
    """Split runs wider than ``cap`` positions, phase-anchored at each run's own
    start (the vectorized body of build._rle_cap)."""
    run_len = r - l + 1
    pieces = (run_len + cap - 1) // cap
    total = int(pieces.sum())
    rep_start = np.repeat(l, pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(total) - np.repeat(offs, pieces)) * cap
    out_l = rep_start + within
    out_r = np.minimum(out_l + cap - 1, np.repeat(r, pieces))
    return np.repeat(ib, pieces), out_l, out_r


class StreamingIndexBuilder:

    def __init__(self, cfg: IndexConfig = DEFAULT_INDEX_CONFIG):
        self.cfg = cfg
        self.scales = tuple(cfg.scales)
        self.w_max = max(self.scales)
        self.n = 0                              # total points appended
        self._tail = np.empty(0, np.float64)    # last w_max - 1 points (owned copy)
        self._c_prefix = 0.0                    # global cumsum value at tail[0]
        # Persistent append scratch: [prefix, tail, chunk] and its cumsum.
        # Fresh multi-GB allocations fault at tens of MB/s on slow hosts, so
        # reusing these buffers is worth ~5x on append throughput.
        self._buf = np.empty(0, np.float64)
        self._cbuf = np.empty(0, np.float64)
        # Cached per-scale UNCAPPED run lists (the merge input after cap split).
        self._ib: Dict[int, List[np.ndarray]] = {w: [] for w in self.scales}
        self._l: Dict[int, List[np.ndarray]] = {w: [] for w in self.scales}
        self._r: Dict[int, List[np.ndarray]] = {w: [] for w in self.scales}

    # ------------------------------------------------------------------ append
    def append(self, chunk: np.ndarray) -> None:
        """Ingest new points; O(len(chunk)) bucket work per scale."""
        from .. import native

        chunk = np.asarray(chunk, np.float64)
        if chunk.size == 0:
            return
        n_old = self.n
        t_len = self._tail.size
        ext_len = t_len + chunk.size
        base = n_old - t_len                    # global position of ext[0]
        # Continue the GLOBAL sequential cumsum fold: seeding np.cumsum with the
        # carried prefix value reproduces cumsum(full_series)[base:] bit-for-bit
        # (np.cumsum is a sequential left fold), so bucket ids are identical to
        # a from-scratch build — not merely close.  The [prefix, tail, chunk]
        # staging buffer and the cumsum output live in reused scratch.
        need = ext_len + 1
        if self._buf.size < need:
            self._buf = np.empty(need, np.float64)
            self._cbuf = np.empty(need, np.float64)
        buf = self._buf[:need]
        buf[0] = self._c_prefix
        buf[1:1 + t_len] = self._tail
        buf[1 + t_len:need] = chunk
        c1 = self._cbuf[:need]
        np.cumsum(buf, out=c1)
        for w in self.scales:
            if ext_len < w:
                continue
            first_new = max(n_old - w + 1, 0)   # global start of first new window
            lo_ext = first_new - base           # its index into ext
            m = ext_len - w + 1 - lo_ext        # number of new windows
            if m <= 0:
                continue
            sub = np.ascontiguousarray(c1[lo_ext:])
            b = native.bucket_pass(sub, w, self.cfg.pos_of_d)
            if b is None:
                means = (sub[w:] - sub[:-w]) / w
                b = rounding.bucket_id(means, self.cfg.pos_of_d).astype(np.int32)
            ib, l, r = _runs(b[:m])
            l = l + first_new
            r = r + first_new
            # Join with the cached tail run (same bucket + adjacent): RLE over a
            # split stream must equal RLE over the whole stream.
            if self._ib[w] and ib.size:
                pib, pl, pr = self._ib[w][-1], self._l[w][-1], self._r[w][-1]
                if pib[-1] == ib[0] and pr[-1] + 1 == l[0]:
                    pr[-1] = r[0]
                    ib, l, r = ib[1:], l[1:], r[1:]
            if ib.size:
                self._ib[w].append(ib)
                self._l[w].append(l)
                self._r[w].append(r)
        self.n = n_old + chunk.size
        keep = self.w_max - 1
        # Copy the tail out of the scratch (a view would alias the next append
        # AND would pin the whole chunk-sized buffer alive).
        if ext_len >= keep:
            self._tail = buf[need - keep:need].copy()
            self._c_prefix = float(c1[ext_len - keep])
        else:
            self._tail = buf[1:need].copy()

    # ------------------------------------------------------------------ build
    def build(self) -> Index:
        """Materialize the index for everything appended so far — identical to a
        from-scratch build over the concatenated series (tested)."""
        cap = self.cfg.maximum_diff - 1
        index: Index = {}
        for w in self.scales:
            if not self._ib[w]:
                continue
            ib = np.concatenate(self._ib[w])
            l = np.concatenate(self._l[w])
            r = np.concatenate(self._r[w])
            # Keep caches compact (single arrays) for the next refresh.
            self._ib[w], self._l[w], self._r[w] = [ib], [l], [r]
            sib, sl, sr = _cap_split(ib, l, r, cap)
            index[w] = _group_and_merge(sib, sl, sr, self.cfg, w, self.n)
        return index
