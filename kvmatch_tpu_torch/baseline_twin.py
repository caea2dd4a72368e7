"""Measured reference baseline: the engines with the reference's SCALAR phase 2.

A copy of kvmatch_tpu/baseline_twin.py whose twins subclass the port's
engines and call the port's copy of the scalar library
(native.get_baseline_lib).  The Java reference needs a JVM; these twin
engines stand in for it: phase 0/1 run the same host planner and
interval machinery as the real engines (identical candidate sets — the
reference's phase 1 does the same index work, in Java), and phase 2 runs the
reference's per-offset single-thread scalar loops compiled from C
(native/baseline_scalar.c):

  - ED:       early-abandon Euclidean loop        (QueryEngine.java:343-363)
  - cNSM-ED:  rolling Ex/Ex2 + constraint check +
              reordered early-abandon z-ED        (NormQueryEngine.java:454-527)
  - RSM-DTW:  lbKim -> lbKeogh(query env) -> lbKeogh(data env) ->
              merged cb -> early-abandon banded DP (QueryEngineDtw.java:385-452)
  - cNSM-DTW: the union of the two                 (NormQueryEngineDtw.java)

C is faster than the Java it stands in for (no boxed Lists, no JIT warmup), so
speedups measured against these twins are CONSERVATIVE estimates of the real
reference's single-node latency.  Answer sets are exact (float64 end-to-end),
which the tests assert against the oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .engine.base import _Ctx
from .engine.norm_dtw import NormQueryEngineDtw
from .engine.norm_ed import NormQueryEngine
from .engine.rsm_dtw import QueryEngineDtw
from .engine.rsm_ed import QueryEngine
from .native import get_baseline_lib
from .plan import envelope


def _outbufs(left: np.ndarray, right: np.ndarray):
    cap = int(np.sum(right - left + 1))
    return (np.ascontiguousarray(left, np.int64),
            np.ascontiguousarray(right, np.int64),
            np.empty(cap, np.int64), np.empty(cap, np.float64))


def _sort_desc_abs(x: np.ndarray) -> np.ndarray:
    """Positions of x by descending |x| (the reference's reordered abandoning)."""
    return np.argsort(-np.abs(x), kind="stable").astype(np.int64)


class ScalarTwinEd(QueryEngine):
    """RSM-ED with the reference's scalar phase 2."""

    def _verify_intervals(self, left, right, ctx: _Ctx
                          ) -> Tuple[np.ndarray, np.ndarray]:
        lib = get_baseline_lib()
        if lib is None:
            raise RuntimeError("baseline twin requires the native toolchain")
        l, r, offs, d2 = _outbufs(left, right)
        q = np.ascontiguousarray(ctx.query, np.float64)
        k = lib.base_ed_scan(self.data, self.n, l, r, l.size, q, ctx.length,
                             ctx.eps2, offs, d2)
        return offs[:k].copy(), np.sqrt(d2[:k])


class ScalarTwinNormEd(NormQueryEngine):
    """cNSM-ED with the reference's scalar phase 2."""

    def _verify_intervals(self, left, right, ctx: _Ctx
                          ) -> Tuple[np.ndarray, np.ndarray]:
        lib = get_baseline_lib()
        if lib is None:
            raise RuntimeError("baseline twin requires the native toolchain")
        l, r, offs, d2 = _outbufs(left, right)
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        zq = (np.asarray(ctx.query, np.float64) - mu_q) / sd_q
        order = _sort_desc_abs(zq)
        zq_sorted = np.ascontiguousarray(zq[order])
        k = lib.base_nsm_scan(self.data, self.n, l, r, l.size,
                              zq_sorted, order, ctx.length, ctx.eps2,
                              ctx.params["alpha"], ctx.params["beta"],
                              mu_q, sd_q, offs, d2)
        return offs[:k].copy(), np.sqrt(d2[:k])


class ScalarTwinDtw(QueryEngineDtw):
    """RSM-DTW with the reference's scalar UCR cascade phase 2."""

    def _verify_intervals(self, left, right, ctx: _Ctx
                          ) -> Tuple[np.ndarray, np.ndarray]:
        lib = get_baseline_lib()
        if lib is None:
            raise RuntimeError("baseline twin requires the native toolchain")
        l, r, offs, d2 = _outbufs(left, right)
        rho = int(ctx.params["rho"])
        q = np.ascontiguousarray(ctx.query, np.float64)
        q_lo, q_hi = envelope(q, rho)
        order = _sort_desc_abs(q - q.mean())
        k = lib.base_dtw_scan(self.data, self.n, l, r, l.size,
                              q, np.ascontiguousarray(q_lo),
                              np.ascontiguousarray(q_hi), order,
                              ctx.length, rho, ctx.eps2, offs, d2)
        return offs[:k].copy(), np.sqrt(d2[:k])


class ScalarTwinNormDtw(NormQueryEngineDtw):
    """cNSM-DTW with the reference's scalar z-normalized UCR cascade phase 2."""

    def _verify_intervals(self, left, right, ctx: _Ctx
                          ) -> Tuple[np.ndarray, np.ndarray]:
        lib = get_baseline_lib()
        if lib is None:
            raise RuntimeError("baseline twin requires the native toolchain")
        l, r, offs, d2 = _outbufs(left, right)
        rho = int(ctx.params["rho"])
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        zq = (np.asarray(ctx.query, np.float64) - mu_q) / sd_q
        zq_lo, zq_hi = envelope(zq, rho)
        order = _sort_desc_abs(zq)
        k = lib.base_nsm_dtw_scan(self.data, self.n, l, r, l.size,
                                  np.ascontiguousarray(zq),
                                  np.ascontiguousarray(zq_lo),
                                  np.ascontiguousarray(zq_hi), order,
                                  ctx.length, rho, ctx.eps2,
                                  ctx.params["alpha"], ctx.params["beta"],
                                  mu_q, sd_q, offs, d2)
        return offs[:k].copy(), np.sqrt(d2[:k])


TWINS = {
    "rsm-ed": ScalarTwinEd,
    "cnsm-ed": ScalarTwinNormEd,
    "rsm-dtw": ScalarTwinDtw,
    "cnsm-dtw": ScalarTwinNormDtw,
}
