"""Index-free full-scan baselines — the UCR-suite executors, on the card.

Port of kvmatch_tpu/baselines.py onto the port's ops.  Equivalents of the
reference's baseline executors (experiments/ucr/UcrEdQueryExecutor.java:29-184,
UcrDtwQueryExecutor.java:31-315, PaaUcrEdQueryExecutor.java:29-257,
PaaUcrDtwQueryExecutor.java:30-448): scan EVERY window of the series with no
index, used to measure what the KV-index buys.  The reference streams windows
through scalar early-abandon loops; here the scan is the region machinery of
ops/regions.py (the ``_multi`` forms, one query: ``qids`` all 0) over
regions covering the whole series — sliding FFT correlation and sliding sums
on the device, an exact float64 confirmation of near-threshold offsets on
the host, and (for DTW) the LB_Kim/LB_Keogh cascade (ops/dtw.lb_stage_multi)
and the f32 banded DP (kernel K3, ops/dtw.dtw_stage_multi) on the window
prefilter's survivors.

What differs from the JAX package: the near-threshold test runs on the
device and only the near offsets come back to the host; the z-normalized
scan adds the region function's f32 error bound to its guard (a larger near
set, the same confirmed answers); the f64 confirms run in chunks.

``paa_prefilter`` adds the PAA lower bound of the Paa* executors
(PaaUcrEdQueryExecutor.java:104-120): with PAA segment width c, per-window
lb = c * sum_k max(|paa_T[k] - paa_Q[k]| , 0)^2 <= ED^2 — computed on the
host from float64 prefix sums, it prunes windows before any device work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import backend
from . import verify as vf
from .config import QueryConfig
from .state import host_series, series_to_device


@dataclasses.dataclass
class ScanStats:
    n_windows: int = 0
    n_after_paa: int = 0
    n_near: int = 0
    n_answers: int = 0


_EMPTY = (np.empty(0, np.int64), np.empty(0))


class UcrScanner:
    """Full-scan matcher over a series held on a device (and float64 on the
    host).  ``device_data`` is the series' f32 tensor when the caller holds
    it already (e.g. ``storage.memory.HbmStore.device``); otherwise the
    series is uploaded to ``device``, the current CUDA device unless the
    caller passes ``device="cpu"``."""

    REGION_M = 4096
    #: Region rows per device launch (the JAX scan's bucket cap).
    REGION_BATCH = 512
    #: Window rows per chunk of the exact f64 confirms.
    CONFIRM_ROWS = 1 << 14

    def __init__(self, data: np.ndarray, device_data=None,
                 qcfg: QueryConfig = QueryConfig(), device=None):
        if device_data is None:
            self.data, device_data = series_to_device(
                data, backend.resolve_device(device))
        else:
            self.data = host_series(data)
            if (device_data.dtype != torch.float32
                    or tuple(device_data.shape) != (self.data.size,)):
                raise ValueError("device_data must be a float32 tensor of "
                                 "the series' length")
        self.data_dev = device_data
        self.device = device_data.device
        self.n = self.data.size
        self.qcfg = qcfg
        self._center = float(self.data.mean())

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    # --------------------------------------------------------------- regions
    def _near_scan(self, L: int, region_fn) -> np.ndarray:
        """Offsets whose region row ``region_fn`` marks near, ascending.
        Region b covers window starts [starts[b], starts[b] + M), its start
        clamped to the series' end (``starts_c``); a clamped row keeps only
        the columns of its own starts.  ``region_fn(starts, qids, M)``
        returns a (B, M) bool tensor on the device."""
        m = self.n - L + 1
        M = min(self.REGION_M, m)
        starts = np.arange(0, m, M, dtype=np.int64)
        starts_c = np.minimum(starts, self.n - (M + L - 1))
        first = starts - starts_c
        stop = np.minimum(starts + M, m) - starts_c
        cols = torch.arange(M, device=self.device)[None, :]
        step = vf.bucket_size(starts.size, lo=8, hi=self.REGION_BATCH,
                              width=M + L - 1)
        near = []
        for s in range(0, starts.size, step):
            sc = self._dev(starts_c[s:s + step], torch.int64)
            qids = torch.zeros(sc.shape, dtype=torch.int32, device=self.device)
            mask = region_fn(sc, qids, M)
            mask &= cols >= self._dev(first[s:s + step], torch.int64)[:, None]
            mask &= cols < self._dev(stop[s:s + step], torch.int64)[:, None]
            row, col = torch.nonzero(mask, as_tuple=True)
            near.append((sc[row] + col).cpu().numpy())
        return np.concatenate(near) if near else np.empty(0, np.int64)

    # ------------------------------------------------------------------ ED
    def scan_ed(self, query: np.ndarray, epsilon: float,
                stats: Optional[ScanStats] = None) -> Tuple[np.ndarray, np.ndarray]:
        """RSM-ED over every window (UcrEdQueryExecutor equivalent)."""
        from .ops.regions import region_ed_distances_multi
        query = np.asarray(query, np.float64)
        L = query.size
        q32 = self._dev((query - self._center)[None, :], torch.float32)
        c = float(np.float32(self._center))
        eps2 = float(epsilon) ** 2
        thresh = eps2 + vf.guard_threshold(eps2, L, self.qcfg.verify_guard)

        def region_fn(starts, qids, M):
            d2, err = region_ed_distances_multi(self.data_dev, q32, starts,
                                                qids, L, M, c)
            return d2 <= thresh + err
        near = self._near_scan(L, region_fn)
        if stats is not None:
            stats.n_windows = self.n - L + 1
            stats.n_near = int(near.size)
        return self._confirm_ed(near, query, eps2, stats)

    def scan_nsm_ed(self, query: np.ndarray, epsilon: float,
                    alpha: Optional[float] = None, beta: Optional[float] = None,
                    stats: Optional[ScanStats] = None):
        """NSM/cNSM-ED over every window (UcrEdQueryExecutor with the constraint
        test, UcrEdQueryExecutor.java:161)."""
        from .ops.regions import region_znorm_distances_multi
        query = np.asarray(query, np.float64)
        L = query.size
        mu_q = query.mean()
        sd_q = float(np.sqrt(max(np.mean(query * query) - mu_q * mu_q, 0.0)))
        qh = (query - mu_q) / sd_q
        q32 = self._dev(qh[None, :], torch.float32)
        eps2 = float(epsilon) ** 2
        thresh = eps2 + vf.guard_threshold(eps2, L, self.qcfg.verify_guard)
        cg = 1e-3 * (1.0 + abs(mu_q) + sd_q)
        mass_err = 1e-3 * (1.0 + eps2)

        def region_fn(starts, qids, M):
            d2, mu, sd, err = region_znorm_distances_multi(
                self.data_dev, q32, starts, qids, L, M)
            ok = sd > 0
            if alpha is not None:
                ratio = sd / sd_q
                ok &= (torch.abs(mu - mu_q) <= beta + cg) & \
                    (ratio <= alpha + cg) & (ratio >= 1.0 / alpha - cg)
            return ok & (d2 <= thresh + mass_err + err)
        near = self._near_scan(L, region_fn)
        if stats is not None:
            stats.n_windows = self.n - L + 1
            stats.n_near = int(near.size)
        return self._confirm_znorm(near, query, qh, mu_q, sd_q, eps2,
                                   alpha, beta, stats)

    # ------------------------------------------------------------------ DTW
    def scan_dtw(self, query: np.ndarray, epsilon: float, rho: int,
                 paa_prefilter: bool = True,
                 stats: Optional[ScanStats] = None):
        """RSM-DTW over every window (UcrDtwQueryExecutor equivalent):
        PAA + LB_Keogh/LB_Kim prefilters, banded DP on survivors."""
        from .ops.dtw import (dtw_banded_batch_f64, dtw_stage_multi,
                              lb_stage_multi)
        from .ops.sliding import sliding_min_max
        from .plan import envelope
        query = np.asarray(query, np.float64)
        L = query.size
        m = self.n - L + 1
        eps2 = float(epsilon) ** 2
        thresh = eps2 + vf.guard_threshold(eps2, L, self.qcfg.verify_guard)

        cand = np.arange(m, dtype=np.int64)
        if paa_prefilter:
            cand = cand[self._lb_paa_dtw(query, eps2, rho) <= thresh]
        if stats is not None:
            stats.n_windows = m
            stats.n_after_paa = int(cand.size)
        if cand.size == 0:
            return _EMPTY

        env_lo, env_hi = envelope(query, rho)
        qm = self._dev(query[None, :], torch.float32)
        lo_m = self._dev(env_lo[None, :], torch.float32)
        hi_m = self._dev(env_hi[None, :], torch.float32)
        data_dev = self.data_dev
        d_lo, d_hi = sliding_min_max(data_dev, rho)

        def on_dev(fn):
            def run(o):
                offs = self._dev(o, torch.int64)
                qids = torch.zeros(offs.shape, dtype=torch.int32,
                                   device=self.device)
                return fn(offs, qids).cpu().numpy()
            return run

        lb = vf.run_bucketed(
            on_dev(lambda o, z: lb_stage_multi(data_dev, d_lo, d_hi, qm, lo_m,
                                               hi_m, o, z, L)),
            cand.size, cand, lo=1024)
        surv = cand[lb <= thresh]
        if surv.size == 0:
            return _EMPTY

        d2 = vf.run_bucketed(
            on_dev(lambda o, z: dtw_stage_multi(data_dev, qm, o, z, L, rho)),
            surv.size, surv, lo=1024)
        near = surv[d2 <= thresh]
        if stats is not None:
            stats.n_near = int(near.size)
        if near.size == 0:
            return _EMPTY
        d2h = self._chunked(near, L,
                            lambda x: dtw_banded_batch_f64(x, query, rho))
        return self._answers(near, d2h, d2h <= eps2, stats)

    # ------------------------------------------------------------------ PAA
    def _paa_sums(self) -> np.ndarray:
        """Float64 prefix sums of the series (cached)."""
        if not hasattr(self, "_c1"):
            self._c1 = np.concatenate(([0.0], np.cumsum(self.data)))
        return self._c1

    def _lb_paa_dtw(self, query: np.ndarray, eps2: float, rho: int,
                    segments: int = 16) -> np.ndarray:
        """PAA-domain lower bound for banded DTW over every window
        (PaaUcrDtwQueryExecutor.lbPaaDTW idea, PaaUcrDtwQueryExecutor.java:413):
        per PAA block, distance from the window's block mean to the query's
        *enveloped* block mean range, times the block width.  On the host
        in float64, as in the JAX package and with its operations, but as
        in-place torch CPU operations over window-sized buffers (they run
        on all the host's cores; each element's result is the same)."""
        from .plan import envelope
        L = query.size
        m = self.n - L + 1
        c = max(L // segments, 1)
        k = L // c  # whole blocks only
        c1 = torch.from_numpy(self._paa_sums())
        env_lo, env_hi = envelope(query, rho)
        lb = torch.zeros(m, dtype=torch.float64)
        t = torch.empty(m, dtype=torch.float64)
        d = torch.empty(m, dtype=torch.float64)
        for blk in range(k):
            s = blk * c
            q_lo = float(env_lo[s:s + c].mean())
            q_hi = float(env_hi[s:s + c].mean())
            torch.sub(c1[s + c:s + c + m], c1[s:s + m], out=t)
            t.div_(c)                               # block mean
            torch.neg(t, out=d)
            d.add_(q_lo)                            # q_lo - mean
            t.sub_(q_hi)                            # mean - q_hi
            torch.maximum(t, d, out=t)
            t.clamp_(min=0.0)                       # delta
            torch.mul(t, c, out=d)
            d.mul_(t)                               # c * delta * delta
            lb.add_(d)
        return lb.numpy()

    # ------------------------------------------------------------------ exact
    def _chunked(self, near: np.ndarray, L: int, fn) -> np.ndarray:
        """``fn(windows)`` over the f64 windows at ``near``, in chunks of at
        most CONFIRM_ROWS rows and 2^24 points, concatenated."""
        rows = max(1, min(self.CONFIRM_ROWS, (1 << 24) // L))
        span = np.arange(L)[None, :]
        return np.concatenate([fn(self.data[near[s:s + rows, None] + span])
                               for s in range(0, near.size, rows)])

    def _answers(self, near, d2h, keep, stats):
        if stats is not None:
            stats.n_answers = int(keep.sum())
        order = np.argsort(d2h[keep])
        return near[keep][order], np.sqrt(d2h[keep][order])

    def _confirm_ed(self, near, query, eps2, stats):
        if near.size == 0:
            return _EMPTY

        def d2(x):
            diff = x - query[None, :]
            return np.einsum("ij,ij->i", diff, diff)
        d2h = self._chunked(near, query.size, d2)
        return self._answers(near, d2h, d2h <= eps2, stats)

    def _confirm_znorm(self, near, query, qh, mu_q, sd_q, eps2, alpha, beta, stats):
        if near.size == 0:
            return _EMPTY

        def d2(x):
            mu_h = x.mean(axis=1)
            var_h = np.maximum(np.mean(x * x, axis=1) - mu_h * mu_h, 0.0)
            sd_h = np.sqrt(var_h)
            ok = sd_h > 0
            if alpha is not None:
                ratio = sd_h / sd_q
                ok &= (np.abs(mu_h - mu_q) <= beta) & (ratio <= alpha) & \
                      (ratio >= 1.0 / alpha)
            z = (x - mu_h[:, None]) / np.where(sd_h > 0, sd_h, 1.0)[:, None]
            diff = z - qh[None, :]
            # a window that fails the constraint is never an answer
            return np.where(ok, np.einsum("ij,ij->i", diff, diff), np.inf)
        d2h = self._chunked(near, query.size, d2)
        return self._answers(near, d2h, d2h <= eps2, stats)
