"""Engine base of the PyTorch port.

``BaseEngine`` subclasses the JAX package's host engine skeleton
(kvmatch_tpu/engine/base.py), which imports jax only inside its device
methods: host phase 1, planning, ``_flags_to_intervals`` and the chunked
exact confirms are reused as they are.  Every method that reaches jax is
overridden here with tensors on an explicit device:

* ``__init__``: f64 host shadow + f32 device tensor of the series; an index
  built with the host backend when none is given.
* ``data_envelope_dev``: the series' Sakoe-Chiba envelope for the DTW
  cascade, cached per band radius (``_run_chunked`` drives that cascade's
  stages over unpadded chunks).
* ``_fly_padded_dev``, ``_fly_cons_stats``, ``_fly_bucket_stack``: the
  per-series caches of the dense probe, gated on the device's free memory.
* ``_dense_probe_retry``, ``_device_dense_phase1_flags``: phase 1 always
  takes the flag route (K1 + the constraint AND) at granularity 128, on any
  device; the JAX package's run-emission ladder is a TPU workaround and is
  not ported.
* ``_region_plan``: the same decision, on the port's region helpers.
* ``_verify_routed``: device phase 2, the batch routed to the region route
  or the gather route (kernel K2) by its joint plan.
* ``query_batch_device``: batched querying with the device probe for every
  query, with phase timings.

Streamed and host-only modes (``device_data='stream'|'host'``) are not
ported yet.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from kvmatch_tpu import verify as vf
from kvmatch_tpu.config import (DEFAULT_INDEX_CONFIG, DEFAULT_QUERY_CONFIG,
                                IndexConfig, QueryConfig)
from kvmatch_tpu.engine.base import BaseEngine as _HostEngine
from kvmatch_tpu.engine.base import QueryResult, QueryStats, _Ctx
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu.index.structure import Index

from .. import backend
from ..ops.probe import FLAG
from ..ops.sliding import sliding_min_max
from ..parallel.query import (FLY_FILL, dense_probe_flags, fly_pad_for,
                              make_bucket_stack, make_cons_stats,
                              pack_segments_batch)
from ..state import series_to_device

__all__ = ["BaseEngine", "QueryResult", "QueryStats", "_Ctx"]

NEAR_K = 16384  # near-set capacity of one region launch
_EMPTY = (np.empty(0, np.int64), np.empty(0))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class BaseEngine(_HostEngine):
    """Series (f64 on host + f32 on ``device``) and the index."""

    FLAG_BLOCK = FLAG
    #: Share of free device memory one cached probe stack may take.
    CACHE_MEM_FRACTION = 0.2

    def __init__(self, data: np.ndarray, index: Index | None = None,
                 icfg: IndexConfig = DEFAULT_INDEX_CONFIG,
                 qcfg: QueryConfig = DEFAULT_QUERY_CONFIG,
                 device_data: torch.Tensor | None = None, device=None):
        if isinstance(device_data, str):
            raise ValueError(f"device_data={device_data!r}: streamed and "
                             f"host-only modes are not ported")
        if device_data is not None:
            device = device_data.device
        self.device = backend.resolve_device(device)
        self.host_only = False  # read by the inherited host phase 1
        if device_data is None:
            self.data, device_data = series_to_device(data, self.device)
        else:
            self.data = np.ascontiguousarray(np.asarray(data, np.float64))
            if (device_data.dtype != torch.float32
                    or tuple(device_data.shape) != (self.data.size,)
                    or not device_data.is_contiguous()):
                raise ValueError("device_data must be a contiguous float32 "
                                 "tensor of the series' length")
        self.data_dev = device_data
        self.n = self.data.size
        self.icfg = icfg
        self.qcfg = qcfg
        self.index = index if index is not None else \
            build_index_tpu(self.data, icfg, backend="host")

    # ------------------------------------------------------------ helpers
    def _dev(self, a, dtype) -> torch.Tensor:
        """numpy -> tensor on the engine's device."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _cache_fits(self, nbytes: int) -> bool:
        return nbytes <= self.CACHE_MEM_FRACTION * \
            backend.device_mem_bytes(self.device)

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

    # --------------------------------------------------------- phase 1
    def _fly_padded_dev(self, length: int) -> torch.Tensor:
        """Cached series copy right-padded with FLY_FILL for the probe."""
        pad = fly_pad_for(length, max(self.icfg.scales))
        cur = getattr(self, "_fly_data", None)
        if cur is None or cur[0] < pad:
            fill = torch.full((pad,), float(FLY_FILL), dtype=torch.float32,
                              device=self.device)
            self._fly_data = (pad, torch.cat([self.data_dev, fill]))
        return self._fly_data[1]

    def _fly_cons_stats(self, length: int):
        """Cached f32 (3, npad) width-L window stats for the constraint AND,
        or None when 12 bytes/point would not fit the memory budget."""
        data_p = self._fly_padded_dev(length)
        cache = self.__dict__.setdefault("_cons_stats_cache", {})
        if length not in cache:
            if not self._cache_fits(int(data_p.shape[0]) * 12):
                return None
            cache[length] = make_cons_stats(data_p, length)
        return cache[length]

    def _fly_bucket_stack(self, length: int):
        """Cached int32 (S, npad) bucket stack, or None when 4*S bytes/point
        would not fit the memory budget."""
        data_p = self._fly_padded_dev(length)
        cache = self.__dict__.setdefault("_bucket_stack_cache", {})
        if length not in cache:
            nbytes = int(data_p.shape[0]) * 4 * len(self.icfg.scales)
            if not self._cache_fits(nbytes):
                return None
            cache[length] = make_bucket_stack(data_p, self.icfg)
        return cache[length]

    def _device_dense_phase1_flags(self, ctxs, seg_lists):
        """One probe pass for a same-length query group: (n_off i32[Q],
        flags bool[Q, NF], flag granularity)."""
        L = ctxs[0].length
        norm = "alpha" in ctxs[0].params
        bstack = self._fly_bucket_stack(L)
        stats3 = self._fly_cons_stats(L) if norm else None
        data_p = self._fly_padded_dev(L)
        segs = pack_segments_batch(seg_lists, tuple(self.icfg.scales),
                                   self.device)
        eps2 = self._dev([c.eps2 for c in ctxs], torch.float32)
        if norm:
            cons = self._dev([[c.params["alpha"], c.params["beta"],
                               c.params["_mu_q"], c.params["_sd_q"]]
                              for c in ctxs], torch.float32)
        else:
            cons = torch.zeros((len(ctxs), 4), dtype=torch.float32,
                               device=self.device)
        n_off, flags = dense_probe_flags(data_p, segs, eps2, cons, self.n,
                                         self.icfg, L, norm, bstack=bstack,
                                         stats3=stats3)
        return n_off.cpu().numpy(), flags.cpu().numpy(), FLAG

    def _dense_probe_retry(self, ctxs, seg_lists):
        """Flag-route dense phase 1 for every query of the group: returns
        {query_index_in_group: (left i64, right i64)}.  Flag over-coverage
        is rejected by the exact phase 2."""
        n_off, flags, fgran = self._device_dense_phase1_flags(ctxs, seg_lists)
        m = self.n - ctxs[0].length + 1
        out = {}
        for qi, ctx in enumerate(ctxs):
            ctx.stats.n_candidates = int(n_off[qi])
            out[qi] = self._flags_to_intervals(flags[qi], m, fgran)
        return out

    # --------------------------------------------------------- phase 2
    def _region_plan(self, cand_ivs, L: int):
        """Gather vs region decision of the JAX package's ``_region_plan``,
        on the port's region helpers; (starts, valid_from, valid_to, qids,
        M) or None for the gather path."""
        from ..ops.regions import coalesce_intervals, pack_regions
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
        for (l, r), ctx in zip(cand_ivs, ctxs):
            ctx.stats.n_device_checked = int(np.sum(r - l + 1)) if l.size else 0
        region = self._region_plan(cand_ivs, L)
        if region is None:
            return self._verify_gather(cand_ivs, ctxs)
        return self._verify_regions(cand_ivs, ctxs, region)

    # ------------------------------------------------ device-probe batch
    def query_batch_device(self, queries: np.ndarray, epsilon,
                           top_k: int = 4096, **params) -> List[QueryResult]:
        """Batched querying with phase 1 on the device for every query (the
        flag probe, DENSE_PROBE_GROUP queries per pass), then the engine's
        batched verification.  ``top_k`` is kept for API compatibility.
        ``stats.n_candidates`` is the probe's exact candidate count."""
        queries = np.atleast_2d(np.asarray(queries, np.float64))
        nq, L = queries.shape
        eps = np.broadcast_to(np.asarray(epsilon, np.float64), (nq,))
        t0 = time.perf_counter()
        ctxs = [_Ctx(query=queries[qi], length=L, epsilon=float(eps[qi]),
                     eps2=float(eps[qi]) ** 2, params=dict(params),
                     stats=QueryStats()) for qi in range(nq)]
        seg_lists = self._plan_batch(ctxs)
        cand_ivs = []
        for g in range(0, nq, self.DENSE_PROBE_GROUP):
            grp = list(range(g, min(g + self.DENSE_PROBE_GROUP, nq)))
            t1 = time.perf_counter()
            res = self._dense_probe_retry([ctxs[qi] for qi in grp],
                                          [seg_lists[qi] for qi in grp])
            dt = (time.perf_counter() - t1) * 1e3 / len(grp)
            for j, qi in enumerate(grp):
                ctxs[qi].stats.t_phase1_ms = dt
                ctxs[qi].stats.n_scans = len(seg_lists[qi])
                ctxs[qi].stats.n_segments_used = len(seg_lists[qi])
                cand_ivs.append(res[j])
        t_verify = time.perf_counter()
        per_query = self._verify_multi(cand_ivs, ctxs)
        t_end = time.perf_counter()
        results = []
        for qi, (ans_off, ans_dist) in enumerate(per_query):
            order = np.argsort(ans_dist, kind="stable")
            stats = ctxs[qi].stats
            stats.n_answers = int(ans_off.size)
            stats.t_phase2_ms = (t_end - t_verify) * 1e3 / nq
            stats.t_total_ms = (t_end - t0) * 1e3 / nq
            results.append(QueryResult(offsets=ans_off[order],
                                       distances=ans_dist[order], stats=stats))
        return results
