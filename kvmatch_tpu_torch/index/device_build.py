"""Serving-mode device index build in PyTorch (port of the stats-only path of
kvmatch_tpu/index/device_build.py).

``build_index_device_stats`` computes, per scale, the exact per-bucket offset
and capped-interval histograms that the planner reads
(IndexScale.counts_between_batch) -- one bucket pass, one cummax-RLE, one
sort of a composite key and one searchsorted, all on the tensor's device.  No
intervals are materialized; the returned scales are ``stats_only`` and phase 1
must run as the device dense probe.  Histograms equal the JAX build's
(tests/test_torch_device_build.py).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import backend
from ..config import DEFAULT_INDEX_CONFIG, IndexConfig
from ..ops.sliding import bucketize_means, sliding_sums
from ..utils import rounding
from .structure import Index, IndexScale

#: Histogram capacity (distinct mean buckets), as in the JAX build.
NB = 1 << 20

_SENT = 1 << 30  # bucket sentinel for padded tail positions


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
    s = 10.0 ** (cfg.pos_of_d - 1)
    bucket_lo = int(2 * np.floor(float(data.min()) * s)) - 2
    bucket_hi = int(2 * np.floor(float(data.max()) * s)) + 3
    if bucket_hi - bucket_lo >= NB:
        raise ValueError(
            f"mean-bucket range {bucket_hi - bucket_lo} exceeds the device "
            f"histogram capacity {NB}; build this data's index with "
            f"kvmatch_tpu_torch.index.build.build_index_host")
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
