"""cNSM-DTW engine of the PyTorch port (kvmatch_tpu/engine/norm_dtw.py).

Constrained normalized matching under banded DTW: the cNSM machinery of
engine/norm_ed.py (alpha/beta probe bounds, the constraint AND of the dense
probe, the constraint prefilter) with the DTW cascade of engine/rsm_dtw.py
on z-normalized windows:

    constraint prefilter + PAA z-envelope prefilter (host, prefix sums)
    -> z-LB stage with the guarded constraint rows (unless the set is tiny)
    -> f32 banded z-DP (K3, or K4 when selected)
    -> double-single z-DP of the near set, on windows normalized with
       host-exact f64 window stats
    -> the exact f64 pipeline (``_confirm_dtw``) for candidates inside the
       DS guard band or near a constraint boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import verify as vf
from ..ops.dtw import (ds_value, dtw_banded_batch_f64, dtw_stage_znorm_ds_multi,
                       dtw_stage_znorm_multi, lb_stage_znorm_multi)
from ..plan import envelope, unit_sums
from ..utils import intervals as iv
from .base import _EMPTY, _Ctx
from .norm_ed import NormQueryEngine
from .rsm_dtw import assemble, candidate_count, lb_dp_near, paa_env_blocks


class NormQueryEngineDtw(NormQueryEngine):
    """cNSM-DTW; ``query(..., rho=r, alpha=a, beta=b)``.  ``stage_counts``
    holds the last phase-2 batch's counts, as in ``QueryEngineDtw``."""

    # ---------------------------------------------------------------- phase 0
    def _plan_inputs(self, ctx: _Ctx):
        q = ctx.query
        mu_q = float(q.mean())
        sd_q = float(np.sqrt(max(np.mean(q * q) - mu_q * mu_q, 0.0)))
        if sd_q == 0.0:
            raise ValueError(
                "query has zero standard deviation: z-normalized matching is "
                "undefined for a constant pattern")
        ctx.params["_mu_q"], ctx.params["_sd_q"] = mu_q, sd_q
        env_lo, env_hi = envelope(q, ctx.params["rho"])
        return (unit_sums(env_lo, self.icfg.unit),
                unit_sums(env_hi, self.icfg.unit), self._cost_batch(ctx))

    # ---------------------------------------------------------------- phase 2
    def _host_zdtw_prefilter_tier(self, cand_ivs, ctxs):
        """Host-only mid-size loads: the run-local constraint prefilter and
        the z-space PAA envelope bound prune the load to what the exact f64
        pipeline can verify; None when the load is outside the tier or too
        many candidates survive (kvmatch_tpu/engine/norm_dtw.py:200)."""
        L = ctxs[0].length
        pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=True)
        if pre is None:
            return None
        surv = []
        for (l, r), c in zip(cand_ivs, ctxs):
            offs = iv.expand_offsets({"left": l, "right": r})
            c.stats.n_host_checked = int(offs.size)
            offs = self._constraint_prefilter(offs, c, prefix=pre)
            zq = (c.query - c.params["_mu_q"]) / c.params["_sd_q"]
            blk = paa_env_blocks(*envelope(zq, c.params["rho"]), L)
            if blk is not None and offs.size:
                offs = self._paa_z_prefilter(offs, c, c.eps2, env=blk,
                                             prefix=pre)
            surv.append(offs)
        if sum(o.size for o in surv) * L > self.qcfg.host_confirm_max_points:
            return None
        return [self._host_confirm_sorted(o, c) for o, c in zip(surv, ctxs)]

    def _host_confirm_sorted(self, offs: np.ndarray, ctx: _Ctx):
        """The exact pipeline ``_confirm_dtw`` (window stats, constraints,
        the early-abandoning f64 z-DP) of a host-only engine, by offset."""
        o, d = self._confirm_dtw(offs, ctx)
        order = np.argsort(o)
        return o[order], d[order]

    def _verify_multi(self, cand_ivs, ctxs):
        """Fused multi-query cNSM-DTW: exact host constraint prefilter, then
        the z-normalized cascade with a query row per candidate.  A
        host-only engine takes the exact host pipeline (a tiny load) or the
        host prefilter tier; with no resident series the batch is
        streamed."""
        L = ctxs[0].length
        if self.host_only:
            if self._host_verify_ok(cand_ivs, L):
                out = []
                for (l, r), c in zip(cand_ivs, ctxs):
                    offs = iv.expand_offsets({"left": l, "right": r})
                    c.stats.n_host_checked = int(offs.size)
                    out.append(self._host_confirm_sorted(offs, c))
                return out
            tier = self._host_zdtw_prefilter_tier(cand_ivs, ctxs)
            if tier is not None:
                return tier
        if self.data_dev is None:
            return self._verify_multi_streamed(cand_ivs, ctxs)
        rho = ctxs[0].params["rho"]
        threshs = self._guarded_threshs(ctxs)
        self.stage_counts = dict(candidates=candidate_count(cand_ivs))
        zqs = np.stack([(c.query - c.params["_mu_q"]) / c.params["_sd_q"]
                        for c in ctxs])
        envs = [envelope(z, rho) for z in zqs]
        cand_offs = []
        for (l, r), c, th, env in zip(cand_ivs, ctxs, threshs, envs):
            offs = self._constraint_prefilter(
                iv.expand_offsets({"left": l, "right": r}), c)
            blk = paa_env_blocks(*env, L)
            if blk is not None:
                offs = self._paa_z_prefilter(offs, c, float(th), env=blk)
            cand_offs.append(offs)
        zq_m = self._dev(zqs, torch.float32)
        lo_m = self._dev(np.stack([e[0] for e in envs]), torch.float32)
        hi_m = self._dev(np.stack([e[1] for e in envs]), torch.float32)
        cons = self._dev(np.stack(
            [[c.params["alpha"], c.params["beta"], c.params["_mu_q"],
              c.params["_sd_q"],
              1e-3 * (1.0 + abs(c.params["_mu_q"]) + c.params["_sd_q"])]
             for c in ctxs]), torch.float32)
        data_dev = self.data_dev

        def lb_fn(o, q):
            env_lo, env_hi = self.data_envelope_dev(rho)
            return lb_stage_znorm_multi(data_dev, env_lo, env_hi, zq_m, lo_m,
                                        hi_m, cons, o, q, L)

        n_off, n_qid = lb_dp_near(
            self, cand_offs, ctxs, threshs, lb_fn,
            lambda o, q: dtw_stage_znorm_multi(data_dev, zq_m, o, q, L, rho))
        if n_off.size == 0:
            for c in ctxs:
                c.stats.n_host_rechecked = 0
            return [_EMPTY for _ in ctxs]
        # Double-single device confirm on windows normalized with host-exact
        # f64 stats; a candidate is accepted without the exact host pass only
        # when it clears eps^2 by the DS guard AND every constraint by more
        # than the prefix sums' rounding margin.
        c1, c2 = self._cumsums()
        mu64 = (c1[n_off + L] - c1[n_off]) / L
        sd64 = np.sqrt(np.maximum((c2[n_off + L] - c2[n_off]) / L
                                  - mu64 * mu64, 0.0))
        safe64 = np.where(sd64 > 0, sd64, 1.0)
        hi, lo, amp = self._run_chunked(
            lambda o, q, m, s: dtw_stage_znorm_ds_multi(
                data_dev, zq_m, o, q, m, s, L, rho),
            n_off.size, n_off, n_qid, mu64.astype(np.float32),
            safe64.astype(np.float32), width=2 * L)
        d2ds = ds_value(hi, lo)
        zqmax = np.abs(zqs).max(axis=1)
        g = vf.ds_guard(d2ds, L, amp.astype(np.float64) + zqmax[n_qid] + 1.0)

        def per(key):
            return np.array([c.params[key] for c in ctxs])[n_qid]

        eps2s = np.array([c.eps2 for c in ctxs])[n_qid]
        alphas, betas = per("alpha"), per("beta")
        mu_qs, sd_qs = per("_mu_q"), per("_sd_q")
        # constraint clearance: the margins cover the prefix-sum rounding
        # (|err| <= ~4 eps64 |c1[o+L]| / L on the mean, likewise on the
        # variance), so a clear pass here implies the exact window-recomputed
        # stats pass too
        eps64 = np.finfo(np.float64).eps
        m_mu = 8.0 * eps64 * np.abs(c1[n_off + L]) / L + 1e-12
        m_sd = 8.0 * eps64 * np.abs(c2[n_off + L]) / L / (2.0 * safe64) + 1e-12
        cons_clear = ((np.abs(mu64 - mu_qs) <= betas - m_mu)
                      & (sd64 <= alphas * sd_qs - m_sd)
                      & (sd64 >= sd_qs / alphas + m_sd) & (sd64 > 0))
        cons_border = (~cons_clear
                       & (np.abs(mu64 - mu_qs) <= betas + m_mu)
                       & (sd64 <= alphas * sd_qs + m_sd)
                       & (sd64 >= sd_qs / alphas - m_sd) & (sd64 > 0))
        d_acc = d2ds <= eps2s - g
        d_bor = ~d_acc & (d2ds <= eps2s + g)
        acc_m = cons_clear & d_acc
        bor_m = (cons_border & (d_acc | d_bor)) | (cons_clear & d_bor)
        return assemble(self, ctxs, n_off, n_qid, d2ds, acc_m, bor_m,
                        self._confirm_dtw)

    def _confirm_dtw(self, near: np.ndarray, ctx: _Ctx):
        """Exact float64 confirmation: constraints + banded DTW on z-normed
        windows, the stats recomputed per window (chunked)."""
        rho = ctx.params["rho"]
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        zq = (ctx.query - mu_q) / sd_q
        cols = np.arange(ctx.length)

        def piece(p):
            x = self.data[p[:, None] + cols[None, :]].astype(
                np.float64, copy=False)
            mu_h = x.mean(axis=1)
            var_h = np.maximum(np.mean(x * x, axis=1) - mu_h * mu_h, 0.0)
            sd_h = np.sqrt(var_h)
            ratio_h = sd_h / sd_q
            ok_h = (np.abs(mu_h - mu_q) <= beta) & (ratio_h <= alpha) & \
                   (ratio_h >= 1.0 / alpha) & (sd_h > 0)
            z = (x - mu_h[:, None]) / np.where(sd_h > 0, sd_h, 1.0)[:, None]
            d2h = dtw_banded_batch_f64(z, zq, rho, ub=ctx.eps2)
            keep = ok_h & (d2h <= ctx.eps2)
            return p[keep], np.sqrt(d2h[keep])

        return self._chunked_confirm(near, piece)
