"""RSM-DTW engine of the PyTorch port (kvmatch_tpu/engine/rsm_dtw.py).

Raw-subsequence matching under banded DTW.  Phases 0 and 1 are RSM-ED's with
the query's Sakoe-Chiba envelope as the per-segment mean range; phase 2 runs
the cascade on the port's tensors:

    PAA envelope prefilter (host, prefix sums)
    -> LB stage (LB_Kim + both LB_Keogh directions), skipped for a candidate
       set of at most ``QueryConfig.dtw_skip_lb_max`` offsets
    -> f32 banded DP (K3, or K4 when selected in ops/dtw.DTW_STATE)
    -> double-single DP of the near set
    -> host f64 DP of the candidates inside the ``verify.ds_guard`` border.

The helpers below (``paa_env_blocks``, ``lb_dp_near``, ``assemble``) are
shared with the cNSM-DTW engine.  Host-only and streamed modes are not
ported (``BaseEngine.__init__`` raises on them).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kvmatch_tpu import verify as vf
from kvmatch_tpu.plan import QuerySegment, envelope, unit_sums
from kvmatch_tpu.utils import intervals as iv

from ..ops.dtw import (ds_value, dtw_banded_batch_f64, dtw_stage_ds_multi,
                       dtw_stage_multi, lb_stage_multi)
from .base import _EMPTY, _Ctx
from .rsm_ed import QueryEngine

PAA_BLOCKS = 16


def paa_env_blocks(lo: np.ndarray, hi: np.ndarray, L: int):
    """Block means (lo_blk, hi_blk) of an envelope for the PAA envelope
    prefilter, or None when the blocks would be narrower than 4 points."""
    cw = L // PAA_BLOCKS
    if cw < 4:
        return None
    nblk = L // cw
    return (lo[: nblk * cw].reshape(nblk, cw).mean(axis=1),
            hi[: nblk * cw].reshape(nblk, cw).mean(axis=1))


def lb_dp_near(eng, cand_offs, ctxs, threshs, lb_fn, dp_fn):
    """The device half of the cascade for a batch: LB stage (unless the set
    is tiny), then the f32 DP of its survivors.  ``lb_fn`` and ``dp_fn``
    take (offsets i64, qids i32) on the device.  Returns the near set
    (offsets, qids) whose f32 DTW is within the guarded threshold, and
    records the batch's stage counts in ``eng.stage_counts``."""
    L = ctxs[0].length
    counts = [o.size for o in cand_offs]
    total = int(sum(counts))
    for c, cnt in zip(ctxs, counts):
        c.stats.n_device_checked = cnt
    offsets = np.concatenate(cand_offs).astype(np.int64)
    qids = np.repeat(np.arange(len(ctxs), dtype=np.int32), counts)
    skip_lb = total <= eng.qcfg.dtw_skip_lb_max
    if total and not skip_lb:
        lb = eng._run_chunked(lb_fn, total, offsets, qids, width=L)
        surv = lb <= threshs[qids]
        offsets, qids = offsets[surv], qids[surv]
    dp_rows = int(offsets.size)
    if dp_rows:
        d2 = eng._run_chunked(dp_fn, dp_rows, offsets, qids, width=L)
        near = d2 <= threshs[qids]
        offsets, qids = offsets[near], qids[near]
    eng.stage_counts.update(prefiltered=total, lb_skipped=skip_lb,
                            dp_rows=dp_rows, near=int(offsets.size),
                            rechecks=0)
    return offsets, qids


def assemble(eng, ctxs, n_off, n_qid, d2ds, acc_m, bor_m, confirm):
    """Per-query answers: the DS-accepted offsets with their DS distances,
    plus the exact ``confirm(border, ctx)`` of the border set."""
    per_q = []
    for qi, ctx in enumerate(ctxs):
        mine = n_qid == qi
        if not mine.any():
            ctx.stats.n_host_rechecked = 0
            per_q.append(_EMPTY)
            continue
        acc = n_off[mine & acc_m]
        border = n_off[mine & bor_m]
        ctx.stats.n_host_rechecked = int(border.size)
        eng.stage_counts["rechecks"] += int(border.size)
        parts = [(acc, np.sqrt(np.maximum(d2ds[mine & acc_m], 0.0)))]
        if border.size:
            parts.append(confirm(border, ctx))
        offs_q = np.concatenate([p[0] for p in parts])
        dist_q = np.concatenate([p[1] for p in parts])
        order = np.argsort(offs_q)
        per_q.append((offs_q[order], dist_q[order]))
    return per_q


def candidate_count(cand_ivs) -> int:
    return sum(int(np.sum(r - l + 1)) for l, r in cand_ivs if l.size)


class QueryEngineDtw(QueryEngine):
    """RSM-DTW; ``query(..., rho=r)`` with the Sakoe-Chiba radius r.
    ``stage_counts`` holds the last phase-2 batch's counts: candidates,
    prefiltered, lb_skipped, dp_rows, near (the DS rows) and rechecks."""
    use_dtw_cost_model = True

    # ---------------------------------------------------------------- phase 0
    def _plan_inputs(self, ctx: _Ctx):
        env_lo, env_hi = envelope(ctx.query, ctx.params["rho"])
        return (unit_sums(env_lo, self.icfg.unit),
                unit_sums(env_hi, self.icfg.unit), self._cost_batch(ctx))

    # ---------------------------------------------------------------- phase 1
    def _probe_rows_eps(self, seg: QuerySegment, ctx: _Ctx):
        # Reset guard: a stale minimum epsilon above the budget would produce
        # a negative range (QueryEngineDtw.java:210).
        if ctx.last_min_eps > ctx.eps2:
            ctx.last_min_eps = 0.0
        return super()._probe_rows_eps(seg, ctx)

    # ---------------------------------------------------------------- phase 2
    def _confirm_dtw(self, border: np.ndarray, ctx: _Ctx):
        """Exact f64 banded DTW of the border set on the host (chunked)."""
        cols = np.arange(ctx.length)
        rho = ctx.params["rho"]

        def piece(p):
            d2h = dtw_banded_batch_f64(
                self.data[p[:, None] + cols[None, :]].astype(
                    np.float64, copy=False), ctx.query, rho, ub=ctx.eps2)
            keep = d2h <= ctx.eps2
            return p[keep], np.sqrt(d2h[keep])

        return self._chunked_confirm(border, piece)

    def _verify_multi(self, cand_ivs, ctxs):
        """Fused multi-query DTW verification: one cascade for the batch,
        with a query row per candidate."""
        L = ctxs[0].length
        rho = ctxs[0].params["rho"]
        threshs = self._guarded_threshs(ctxs)
        self.stage_counts = dict(candidates=candidate_count(cand_ivs))
        envs = [envelope(c.query, rho) for c in ctxs]
        cand_offs = []
        for (l, r), c, th, env in zip(cand_ivs, ctxs, threshs, envs):
            offs = iv.expand_offsets({"left": l, "right": r})
            blk = paa_env_blocks(*env, L)
            if blk is not None:
                offs = self._paa_prefilter(offs, c, float(th), env=blk)
            cand_offs.append(offs)
        qm = self._dev(np.stack([c.query for c in ctxs]), torch.float32)
        lo_m = self._dev(np.stack([e[0] for e in envs]), torch.float32)
        hi_m = self._dev(np.stack([e[1] for e in envs]), torch.float32)
        data_dev = self.data_dev

        def lb_fn(o, q):
            env_lo, env_hi = self.data_envelope_dev(rho)
            return lb_stage_multi(data_dev, env_lo, env_hi, qm, lo_m, hi_m,
                                  o, q, L)

        n_off, n_qid = lb_dp_near(
            self, cand_offs, ctxs, threshs, lb_fn,
            lambda o, q: dtw_stage_multi(data_dev, qm, o, q, L, rho))
        if n_off.size == 0:
            for c in ctxs:
                c.stats.n_host_rechecked = 0
            return [_EMPTY for _ in ctxs]
        # Double-single device confirm of the near set; only candidates
        # inside the +-ds_guard band around eps^2 go to the host f64 DP.
        hi, lo, amax = self._run_chunked(
            lambda o, q: dtw_stage_ds_multi(data_dev, qm, o, q, L, rho),
            n_off.size, n_off, n_qid, width=2 * L)
        d2ds = ds_value(hi, lo)
        qmax = np.array([float(np.abs(c.query).max()) for c in ctxs])
        g = vf.ds_guard(d2ds, L, amax.astype(np.float64) + qmax[n_qid] + 1.0)
        eps2s = np.array([c.eps2 for c in ctxs])[n_qid]
        acc_m = d2ds <= eps2s - g
        bor_m = ~acc_m & (d2ds <= eps2s + g)
        return assemble(self, ctxs, n_off, n_qid, d2ds, acc_m, bor_m,
                        self._confirm_dtw)

    def _verify(self, offsets: np.ndarray, ctx: _Ctx
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Single query = a batch of one through the fused stages."""
        if offsets.size == 0:
            return _EMPTY
        runs = np.flatnonzero(np.diff(offsets) > 1)
        left = offsets[np.concatenate(([0], runs + 1))]
        right = offsets[np.concatenate((runs, [offsets.size - 1]))]
        return self._verify_multi([(left, right)], [ctx])[0]
