"""cNSM-ED engine of the PyTorch port (kvmatch_tpu/engine/norm_ed.py).

Z-normalized Euclidean distance under the constraints
|mu_T - mu_Q| <= beta and 1/alpha <= sigma_T/sigma_Q <= alpha.  The host
methods (plan inputs and costs, probe rows, scan/combine, the std filter, the
constraint and PAA prefilters, the exact f64 confirms) are carried over from
the JAX package's module; ``_verify_multi`` runs phase 2 on the port's
tensors: the FFT
region near-set for clustered candidates and kernel K2 (ops/ed.py) for
scattered ones, then the exact f64 confirmation: on the device by K2's f64
form when the device's f32 series holds the host shadow's values exactly
(``confirm_on_device``), else on the host.
"""

from __future__ import annotations

import functools
import math
import types
from typing import Dict

import numpy as np
import torch

from .. import native
from .. import verify as vf
from ..ops.ed import window_ed_f64, znorm_ed_distances_multi
from ..ops.regions import (region_znorm_distances_multi,
                           region_znorm_near_multi)
from ..plan import QuerySegment, unit_sums
from ..utils import intervals as iv
from ..utils import rounding
from ..utils.profiling import fetch, span
from .base import _EMPTY, NEAR_K, BaseEngine, _Ctx

#: Region rows of a near-set launch are a multiple of this (the chunk's
#: padding rows cut to it), so the transforms take few distinct shapes.
NEAR_ROWS_STEP = 256


def host_znorm_stats(data: np.ndarray, offsets: np.ndarray,
                     q_hat: np.ndarray):
    """(d2, mean, std) in f64 on the host of the windows
    ``data[o : o + L]`` against the z-normalized query ``q_hat`` (L,): the
    host confirm's arithmetic (one-pass variance E[x^2] - mean^2)."""
    x = data[offsets[:, None] + np.arange(q_hat.size)[None, :]].astype(
        np.float64, copy=False)
    mu = x.mean(axis=1)
    sd = np.sqrt(np.maximum(np.mean(x * x, axis=1) - mu * mu, 0.0))
    diff = (x - mu[:, None]) / np.where(sd > 0, sd, 1.0)[:, None] \
        - q_hat[None, :]
    return np.einsum("ij,ij->i", diff, diff), mu, sd


class NormQueryEngine(BaseEngine):
    payloads = ("eps", "ex_lo", "ex2_lo", "ex_up", "ex2_up", "beta")
    # The host constraint prefilter makes the scattered path much cheaper than
    # raw traffic suggests; demand a bigger region advantage before switching.
    REGION_TRAFFIC_FUDGE = 8.0
    use_dtw_cost_model = True  # reference uses the DTW-fit coefficients here
    #: Points a step of ``confirm_on_device``'s comparison.
    SHADOW_CHUNK = 1 << 24

    @functools.cached_property
    def confirm_on_device(self) -> bool:
        """Whether the exact f64 confirm runs on the device
        (``window_ed_f64``): the f32 series phase 2 reads there (resident,
        or staged from the shadow when streamed), promoted to f64, equals
        the host shadow ``self.data`` point for point, so the device reads
        the values the host confirm would read.  An f32 shadow (a streamed
        f32 series) holds by construction; a resident series is compared
        with its shadow chunk by chunk on its device, a streamed f64 one with
        its own f32 rounding.  False for a host-only engine.  Decided at the
        first confirm that asks."""
        if self.host_only:
            return False
        if self.data.dtype == np.float32:
            return True
        for s in range(0, self.n, self.SHADOW_CHUNK):
            host = torch.from_numpy(self.data[s:s + self.SHADOW_CHUNK])
            if self.data_dev is None:
                held = host.to(torch.float32)
            else:
                host = host.to(self.data_dev.device)
                held = self.data_dev[s:s + self.SHADOW_CHUNK]
            if not torch.equal(held.to(torch.float64), host):
                return False
        return True

    # ---------------------------------------------------------------- bounds
    def _probe_bounds(self, mean_lo, mean_hi, w: int, ctx: _Ctx):
        """alpha/beta dual probe bounds (NormQueryEngine.java:225-231), with
        the range shrunk by the accumulated z-space lower bound."""
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        eps_eff = np.sqrt(np.maximum(ctx.eps2 - ctx.last_min_eps, 0.0))
        r = eps_eff * sd_q / math.sqrt(w)
        lo = np.minimum(
            (1.0 / alpha) * mean_lo + (1 - 1.0 / alpha) * mu_q - beta - r / alpha,
            alpha * mean_lo + (1 - alpha) * mu_q - beta - alpha * r)
        hi = np.maximum(
            alpha * mean_hi + (1 - alpha) * mu_q + beta + alpha * r,
            (1.0 / alpha) * mean_hi + (1 - 1.0 / alpha) * mu_q + beta + r / alpha)
        return lo, hi

    def _beta_partitions(self, mean_lo, mean_hi, w: int, ctx: _Ctx):
        """Per-partition key ranges (NormQueryEngine.java:241-255); partition
        count clamped to [1, 64]."""
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        num = 1
        if self.qcfg.enable_beta_partition:
            num = min(max(int(2.0 * beta / self.qcfg.beta_partition_width), 1), 64)
        width = 2.0 * beta / num
        eps_eff = math.sqrt(max(ctx.eps2 - ctx.last_min_eps, 0.0))
        r = eps_eff * sd_q / math.sqrt(w)
        k = np.arange(num)
        b_lo = -beta + width * k
        b_hi = -beta + width * (k + 1)
        begin = np.minimum(
            (1.0 / alpha) * mean_lo + (1 - 1.0 / alpha) * mu_q + b_lo - r / alpha,
            alpha * mean_lo + (1 - alpha) * mu_q + b_lo - alpha * r)
        end = np.maximum(
            alpha * mean_hi + (1 - alpha) * mu_q + b_hi + alpha * r,
            (1.0 / alpha) * mean_hi + (1 - 1.0 / alpha) * mu_q + b_hi + r / alpha)
        return begin, end

    # ---------------------------------------------------------------- phase 0
    def _cost_batch(self, ctx: _Ctx):
        norm = self._cost_normalizer()
        pos_of_d = self.icfg.pos_of_d

        def cost_batch(w, mean_lo, mean_hi):
            sc = self.index[w]
            b, e = self._probe_bounds(mean_lo, mean_hi, w, ctx)
            b = rounding.to_round(b, pos_of_d)
            e = rounding.to_round(e, pos_of_d)
            cnt_i, _ = sc.counts_between_batch(np.atleast_1d(b), np.atleast_1d(e))
            with np.errstate(divide="ignore"):
                log_cost = np.log(cnt_i / norm)
            return log_cost, cnt_i

        return cost_batch

    def _cost_batch_multi(self, ctxs):
        """Whole-batch DP cost: _probe_bounds broadcast over (Q, 1) columns."""
        norm = self._cost_normalizer()
        pos_of_d = self.icfg.pos_of_d

        def col(vals):
            return np.asarray(vals, np.float64)[:, None]

        bctx = types.SimpleNamespace(
            params={"alpha": col([c.params["alpha"] for c in ctxs]),
                    "beta": col([c.params["beta"] for c in ctxs]),
                    "_mu_q": col([c.params["_mu_q"] for c in ctxs]),
                    "_sd_q": col([c.params["_sd_q"] for c in ctxs])},
            eps2=col([c.eps2 for c in ctxs]),
            last_min_eps=col([c.last_min_eps for c in ctxs]))

        def cost_batch_multi(w, mean_lo, mean_hi):
            sc = self.index[w]
            b, e = self._probe_bounds(mean_lo, mean_hi, w, bctx)
            b = rounding.to_round(b, pos_of_d)
            e = rounding.to_round(e, pos_of_d)
            cnt_i, _ = sc.counts_between_batch(b, e)
            with np.errstate(divide="ignore"):
                log_cost = np.log(cnt_i / norm)
            return log_cost, cnt_i

        return cost_batch_multi

    def _plan_inputs(self, ctx: _Ctx):
        if "alpha" not in ctx.params or "beta" not in ctx.params:
            raise ValueError(
                "NormQueryEngine requires alpha= and beta= (cNSM constraints); "
                "for unconstrained NSM use "
                "the JAX package's baselines.UcrScanner.scan_nsm_ed")
        q = ctx.query
        mu_q = float(q.mean())
        sd_q = float(np.sqrt(max(np.mean(q * q) - mu_q * mu_q, 0.0)))
        if sd_q == 0.0:
            raise ValueError(
                "query has zero standard deviation: z-normalized matching is "
                "undefined for a constant pattern")
        ctx.params["_mu_q"], ctx.params["_sd_q"] = mu_q, sd_q
        sums = unit_sums(q, self.icfg.unit)
        return sums, sums, self._cost_batch(ctx)

    # ---------------------------------------------------------------- phase 1
    def _probe_rows_payloads(self, seg: QuerySegment, ctx: _Ctx):
        """Probed row range + the six per-row payload columns (z-space eps
        bound, Ex/Ex2 tracks, beta bitmask)."""
        sc = self.index[seg.w]
        guard = self.icfg.probe_guard
        b, e = self._probe_bounds(seg.mean_lo, seg.mean_hi, seg.w, ctx)
        begin = float(rounding.snap_down(b - guard, sc.keys, self.icfg.pos_of_d))
        end = float(rounding.to_round(e + guard, self.icfg.pos_of_d))
        rows = sc.probe_rows(begin, end)
        if rows.size == 0:
            return sc, rows, None
        lo, hi = self._row_bounds(sc, rows)
        k_units = seg.w // self.icfg.unit
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        n_lo = lo - (mu_q + beta)
        n_hi = hi - (mu_q - beta)
        s_small, s_big = sd_q / alpha, alpha * sd_q
        z_lo = np.where(n_lo >= 0, n_lo / s_big, n_lo / s_small)
        z_hi = np.where(n_hi >= 0, n_hi / s_small, n_hi / s_big)
        zq_lo = (seg.mean_lo - mu_q) / sd_q
        zq_hi = (seg.mean_hi - mu_q) / sd_q
        zdelta = np.maximum(np.maximum(z_lo - zq_hi, zq_lo - z_hi), 0.0)
        eps_row = seg.w * zdelta * zdelta
        ex_lo = lo * k_units
        ex_up = hi * k_units
        ex2_lo = np.where(lo > 0, lo * lo, np.where(hi < 0, hi * hi, 0.0)) * k_units
        ex2_up = np.maximum(lo * lo, hi * hi) * k_units
        pb, pe = self._beta_partitions(seg.mean_lo, seg.mean_hi, seg.w, ctx)
        pb = rounding.snap_down(pb - guard, sc.keys, self.icfg.pos_of_d)
        pe = rounding.to_round(pe + guard, self.icfg.pos_of_d)
        key = sc.keys[rows]
        inside = (pb[None, :] <= key[:, None]) & (key[:, None] <= pe[None, :])
        bits = (inside.astype(np.uint64) << np.arange(pb.size, dtype=np.uint64)[None, :]).sum(
            axis=1, dtype=np.uint64)
        return sc, rows, {
            "eps": eps_row, "ex_lo": ex_lo, "ex2_lo": ex2_lo,
            "ex_up": ex_up, "ex2_up": ex2_up, "beta": bits}

    def _scan(self, seg: QuerySegment, ctx: _Ctx) -> Dict[str, np.ndarray]:
        sc, rows, payloads = self._probe_rows_payloads(seg, ctx)
        if rows.size == 0:
            return iv.empty_set(("ex_lo", "ex2_lo", "ex_up", "ex2_up", "beta"))
        return self._scan_fill(sc, rows, ctx, payloads)

    def _scan_join(self, seg: QuerySegment, cs, ctx: _Ctx):
        """Fused cNSM scan+intersect via the position-sorted view."""
        sc, rows, payloads = self._probe_rows_payloads(seg, ctx)
        if rows.size == 0:
            return iv.empty_set(("ex_lo", "ex2_lo", "ex_up", "ex2_up", "beta"))
        p_left, p_right, p_row = sc.pos_sorted()
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        return native.join_norm(
            cs, p_left, p_right, p_row, i0, i1,
            payloads, ctx.eps2,
            row_total=int(sc.row_ptr[i1] - sc.row_ptr[i0]),
            use_beta=self.qcfg.enable_beta_partition,
            use_std=self.qcfg.enable_std_filter,
            unit=self.icfg.unit, qlen=ctx.length, p_units=ctx.processed_units,
            alpha=ctx.params["alpha"], beta=ctx.params["beta"],
            mu_q=ctx.params["_mu_q"], sd_q=ctx.params["_sd_q"],
            max_diff=self.icfg.maximum_diff)

    def _combine(self, pieces, a, b, ia, ib, ctx: _Ctx) -> Dict[str, np.ndarray]:
        eps_sum = a["eps"][ia] + b["eps"][ib]
        keep = eps_sum <= ctx.eps2
        bits = a["beta"][ia] & b["beta"][ib]
        if self.qcfg.enable_beta_partition:
            keep &= bits != 0
        ex_lo = a["ex_lo"][ia] + b["ex_lo"][ib]
        ex2_lo = a["ex2_lo"][ia] + b["ex2_lo"][ib]
        ex_up = a["ex_up"][ia] + b["ex_up"][ib]
        ex2_up = a["ex2_up"][ia] + b["ex2_up"][ib]
        if self.qcfg.enable_std_filter:
            keep &= self._std_filter(ex_lo, ex2_lo, ex_up, ex2_up, ctx)
        out = {k: v[keep] for k, v in pieces.items()}
        out.update(eps=eps_sum[keep], ex_lo=ex_lo[keep], ex2_lo=ex2_lo[keep],
                   ex_up=ex_up[keep], ex2_up=ex2_up[keep], beta=bits[keep])
        return out

    def _intersect_native(self, cs, positions, ctx: _Ctx, delta: int = 0):
        return native.intersect_norm(
            cs, positions, ctx.eps2,
            use_beta=self.qcfg.enable_beta_partition,
            use_std=self.qcfg.enable_std_filter,
            unit=self.icfg.unit, qlen=ctx.length, p_units=ctx.processed_units,
            alpha=ctx.params["alpha"], beta=ctx.params["beta"],
            mu_q=ctx.params["_mu_q"], sd_q=ctx.params["_sd_q"], delta=delta)

    def _std_filter(self, ex_lo, ex2_lo, ex_up, ex2_up, ctx: _Ctx) -> np.ndarray:
        """Derived-sigma lower-bound filter (NormQueryEngine.java:354-382)."""
        unit = self.icfg.unit
        L = ctx.length
        p = ctx.processed_units
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        rest = L - p * unit
        limit = alpha * alpha * sd_q * sd_q
        if rest <= 0:
            mean_lo = ex_lo / p
            mean_up = ex_up / p
            var_lb = np.where(mean_up < mu_q - beta, (mu_q - beta - mean_up) ** 2,
                              np.where(mean_lo > mu_q + beta,
                                       (mean_lo - mu_q - beta) ** 2, 0.0))
            return var_lb <= limit + 1e-12
        keep = np.ones(ex_lo.shape, bool)
        mean_lo = ex_lo / p
        over = mean_lo > mu_q + beta
        if over.any():
            new_val = mu_q + beta - (mean_lo - mu_q - beta) * p * unit / rest
            var2 = (ex2_lo * unit + rest * new_val * new_val) / L - (mu_q + beta) ** 2
            keep &= ~over | (var2 <= limit + 1e-12)
        mean_up = ex_up / p
        under = mean_up < mu_q - beta
        if under.any():
            new_val = mu_q - beta + (mu_q - beta - mean_up) * p * unit / rest
            var2 = (ex2_lo * unit + rest * new_val * new_val) / L - (mu_q - beta) ** 2
            keep &= ~under | (var2 <= limit + 1e-12)
        return keep

    # ---------------------------------------------------------------- phase 2
    def _cumsums(self):
        """Cached f64 prefix sums of data and data^2 (in f64 also for a
        streamed engine's f32 series)."""
        if not hasattr(self, "_c1"):
            x = self.data.astype(np.float64, copy=False)
            self._c1 = np.concatenate(([0.0], np.cumsum(x)))
            self._c2 = np.concatenate(([0.0], np.cumsum(x * x)))
        return self._c1, self._c2

    def _paa_z_prefilter(self, offsets: np.ndarray, ctx: _Ctx,
                         thresh: float, blocks: int = 16, env=None,
                         prefix=None) -> np.ndarray:
        """PAA lower bound in z-space from prefix sums (no window gather).
        With ``env=(lo_blk, hi_blk)`` (block means of the z-query's
        Sakoe-Chiba envelope) the per-block distance is the envelope form,
        which lower-bounds banded z-DTW
        (kvmatch_tpu/engine/norm_ed.py:354-406)."""
        L = ctx.length
        c = L // blocks
        if offsets.size == 0 or c < 4:
            return offsets
        nblk = L // c
        c1, c2 = prefix if prefix is not None else self._cumsums()
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        zq = ctx.params.get("_zq_blk")
        if zq is None or zq.size != nblk:
            qz = (ctx.query - mu_q) / sd_q
            zq = qz[: nblk * c].reshape(nblk, c).mean(axis=1)
            ctx.params["_zq_blk"] = zq
        CHUNK = 1 << 20
        cols = np.arange(nblk) * c
        lb = np.empty(offsets.size)
        for s in range(0, offsets.size, CHUNK):
            off_c = offsets[s: s + CHUNK]
            s1 = c1[off_c + L] - c1[off_c]
            mean = s1 / L
            var = np.maximum((c2[off_c + L] - c2[off_c]) / L - mean * mean,
                             0.0)
            std = np.sqrt(var)
            std = np.where(std > 0, std, 1.0)
            o = off_c[:, None] + cols[None, :]
            blk = (c1[o + c] - c1[o]) / c
            zb = (blk - mean[:, None]) / std[:, None]
            if env is not None:
                d = np.maximum(np.maximum(zb - env[1][None, :],
                                          env[0][None, :] - zb), 0.0)
            else:
                d = zb - zq[None, :]
            lb[s: s + CHUNK] = c * np.einsum("ij,ij->i", d, d)
        # f64 prefix-sum rounding guard (relative; the bound is exact math)
        return offsets[lb <= thresh * (1.0 + 1e-9) + 1e-9]

    def _constraint_prefilter(self, offsets: np.ndarray, ctx: _Ctx,
                              prefix=None) -> np.ndarray:
        """Drop candidates violating the mean/std constraints before any
        window gather (two prefix-sum lookups per offset, ~1e-9 slack)."""
        if offsets.size == 0:
            return offsets
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        L = ctx.length
        c1, c2 = prefix if prefix is not None else self._cumsums()
        s1 = c1[offsets + L] - c1[offsets]
        mean = s1 / L
        var = np.maximum((c2[offsets + L] - c2[offsets]) / L - mean * mean, 0.0)
        std = np.sqrt(var)
        g = 1e-9 * (1.0 + np.abs(mu_q) + sd_q) + 1e-12 * np.abs(mean)
        keep = (np.abs(mean - mu_q) <= beta + g) & \
               (std <= alpha * sd_q * (1 + 1e-9) + g) & \
               (std >= sd_q / alpha * (1 - 1e-9) - g) & (std > 0)
        return offsets[keep]

    def _host_znorm_prefilter_tier(self, cand_ivs, ctxs):
        """Host-only mid-size loads: the run-local constraint and z-PAA
        prefilters prune the load to what the exact f64 z-norm kernel can
        verify; None when the load is outside the tier or too many
        candidates survive (kvmatch_tpu/engine/norm_ed.py:435)."""
        L = ctxs[0].length
        with span("kv.verify.plan"):
            pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=True)
            if pre is None:
                return None
            surv = []
            for (l, r), c in zip(cand_ivs, ctxs):
                offs = iv.expand_offsets({"left": l, "right": r})
                c.stats.n_host_checked = int(offs.size)
                offs = self._constraint_prefilter(offs, c, prefix=pre)
                surv.append(self._paa_z_prefilter(offs, c, c.eps2,
                                                  prefix=pre))
        if sum(o.size for o in surv) * L > self.qcfg.host_confirm_max_points:
            return None
        return [self._confirm_znorm_exact(o, c) for o, c in zip(surv, ctxs)]

    def _verify_multi(self, cand_ivs, ctxs):
        """Multi-query z-norm verification: the exact f64 host kernel for a
        tiny load; on a host-only engine the host prefilter tier; with no
        resident series the streamed route; else the device routes of
        BaseEngine._verify_routed."""
        L = ctxs[0].length
        if self._host_verify_ok(cand_ivs, L):
            # Tiny load: prefilters from prefix sums + the exact f64 host
            # kernel, no device launch.
            with span("kv.verify.plan"):
                prefix = None
                if self.n > self.PREFILTER_CUMSUM_MAX_N:
                    prefix = self._host_prefilter_prefix(cand_ivs, L,
                                                         want_sq=True)
                pre_ok = (prefix is not None
                          or self.n <= self.PREFILTER_CUMSUM_MAX_N)
                surv = []
                for (l, r), c in zip(cand_ivs, ctxs):
                    offs = iv.expand_offsets({"left": l, "right": r})
                    c.stats.n_host_checked = int(offs.size)
                    if pre_ok:
                        offs = self._paa_z_prefilter(
                            self._constraint_prefilter(offs, c,
                                                       prefix=prefix),
                            c, c.eps2, prefix=prefix)
                    surv.append(offs)
            return [self._confirm_znorm_exact(o, c)
                    for o, c in zip(surv, ctxs)]
        if self.host_only:
            tier = self._host_znorm_prefilter_tier(cand_ivs, ctxs)
            if tier is not None:
                return tier
        if self.data_dev is None:
            return self._verify_multi_streamed(cand_ivs, ctxs)
        return self._verify_routed(cand_ivs, ctxs)

    @staticmethod
    def _qhat(ctx: _Ctx) -> np.ndarray:
        """The z-normalized query in f64."""
        return (ctx.query - ctx.params["_mu_q"]) / ctx.params["_sd_q"]

    def _qhats(self, ctxs, dtype=torch.float32) -> torch.Tensor:
        return self._dev(np.stack([self._qhat(c) for c in ctxs]), dtype)

    def _stream_sub(self, buf: np.ndarray, dev32: torch.Tensor):
        """The parent's ``confirm_on_device`` holds for its staged groups:
        ``dev32`` is cast from ``buf``, a copy of the parent's shadow."""
        sub = super()._stream_sub(buf, dev32)
        sub.confirm_on_device = self.confirm_on_device
        return sub

    def _verify_regions(self, cand_ivs, ctxs, region):
        """Region route: z-norm FFT distances with the guarded constraint,
        near-set selection on the device (``region_znorm_near_multi``, one
        read-back a chunk), exact f64 confirm of the set.  Each query's
        ``n_region_rows`` gains its rows; ``n_near_overflows`` counts the
        batch's passes that overflowed ``NEAR_K`` into the full-matrix
        fallback."""
        L = ctxs[0].length
        starts, vfrom, vto, qids, M = region
        for c, k in zip(ctxs, np.bincount(qids, minlength=len(ctxs))):
            c.stats.n_region_rows += int(k)
        qm = self._qhats(ctxs)
        data_dev = self.data_dev
        threshs = self._guarded_threshs(ctxs)
        cons = np.stack([[c.params["alpha"], c.params["beta"],
                          c.params["_mu_q"], c.params["_sd_q"],
                          1e-3 * (1.0 + abs(c.params["_mu_q"])
                                  + c.params["_sd_q"])] for c in ctxs])
        cons_dev = self._dev(cons, torch.float32)
        th_dev = self._dev(threshs, torch.float32)

        with span("kv.verify.near") as sp:
            def near_fn(s_, q_, vf_, vt_):
                # A chunk's padding rows (vto = vfrom) follow its rows (at
                # least one): the launch stops at the first multiple of
                # NEAR_ROWS_STEP past the last row, so the transforms skip
                # most of them.
                last = int(np.flatnonzero(vt_ > vf_)[-1])
                keep = (last // NEAR_ROWS_STEP + 1) * NEAR_ROWS_STEP
                args = (self._dev(s_[:keep], torch.int64),
                        self._dev(q_[:keep], torch.int32),
                        self._dev(vf_[:keep], torch.int64),
                        self._dev(vt_[:keep], torch.int64))
                with sp.device(self.device):
                    cnt, rows, cols = region_znorm_near_multi(
                        data_dev, qm, *args, th_dev, cons_dev, L, M, NEAR_K)
                return fetch("kv.verify.wait", torch.as_tensor(cnt), rows,
                             cols)

            near = vf.run_region_near(near_fn, starts, vfrom, vto, qids,
                                      NEAR_K, width=M + L - 1)
        if near is None:
            for c in ctxs:
                c.stats.n_near_overflows += 1
            # Overflowed the near-set capacity: full-matrix fallback with the
            # same guarded constraint and distance test on the host.
            with span("kv.verify.near") as sp:
                def dist_fn(s_, q_):
                    args = (self._dev(s_, torch.int64),
                            self._dev(q_, torch.int32))
                    with sp.device(self.device):
                        out = region_znorm_distances_multi(data_dev, qm,
                                                           *args, L, M)
                    return fetch("kv.verify.wait", *out)

                d2, mu, sd, derr = vf.run_bucketed(
                    dist_fn, starts.size, starts, qids, lo=32, hi=2048,
                    width=M + L - 1)
            with span("kv.verify.plan"):
                a_r, b_r, mq_r, sq_r, cg_r = (cons[qids, k][:, None]
                                              for k in range(5))
                ratio = sd / sq_r
                ok = ((np.abs(mu - mq_r) <= b_r + cg_r)
                      & (ratio <= a_r + cg_r)
                      & (ratio >= 1.0 / a_r - cg_r) & (sd > 0))
                col = np.arange(M)[None, :]
                nearm = (ok & (col >= vfrom[:, None]) & (col < vto[:, None])
                         & (d2 <= threshs[qids][:, None] + derr))
                rows, cols = np.nonzero(nearm)
                near = (starts[rows] + cols, qids[rows])
        near_off, near_qid = near
        return self._confirm_exact([np.sort(near_off[near_qid == qi])
                                    for qi in range(len(ctxs))], ctxs)

    def _verify_gather(self, cand_ivs, ctxs):
        """Scattered route: exact host constraint prefilter + PAA z-bound,
        then K2 on the survivors (int64 offsets end to end)."""
        L = ctxs[0].length
        threshs = self._guarded_threshs(ctxs)
        with span("kv.verify.plan"):
            cand_offs = [self._paa_z_prefilter(
                self._constraint_prefilter(
                    iv.expand_offsets({"left": l, "right": r}), c),
                c, float(th))
                for (l, r), c, th in zip(cand_ivs, ctxs, threshs)]
            counts = [o.size for o in cand_offs]
            total = int(sum(counts))
        if total == 0:
            return [_EMPTY for _ in ctxs]
        offsets = np.concatenate(cand_offs).astype(np.int64)
        qids = np.repeat(np.arange(len(ctxs), dtype=np.int32), counts)
        qm = self._qhats(ctxs)
        with span("kv.verify.near") as sp:
            def k2(o, q):
                args = (self._dev(o, torch.int64), self._dev(q, torch.int32))
                with sp.device(self.device):
                    out = znorm_ed_distances_multi(self.data_dev, qm, *args,
                                                   L)
                return fetch("kv.verify.wait", *out)

            d2, mu, sd = vf.run_bucketed(k2, total, offsets, qids,
                                         lo=self.qcfg.verify_batch, width=L)
        nears = []
        start = 0
        for qi, ctx in enumerate(ctxs):
            sl = slice(start, start + counts[qi])
            start += counts[qi]
            nears.append(self._guarded_near(
                cand_offs[qi], d2[sl], mu[sl], sd[sl], ctx))
        return self._confirm_exact(nears, ctxs)

    @staticmethod
    def _exact_keep(d2, mu, sd, ctx: _Ctx) -> np.ndarray:
        """The exact f64 test of a window: the constraints on its mean and
        std, std > 0 and d2 <= eps^2."""
        alpha = ctx.params["alpha"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        ratio = sd / sd_q
        return ((np.abs(mu - mu_q) <= ctx.params["beta"]) & (ratio <= alpha)
                & (ratio >= 1.0 / alpha) & (sd > 0) & (d2 <= ctx.eps2))

    def _confirm_exact(self, nears, ctxs):
        """Exact f64 confirm of each query's near offsets: on the device
        when it holds the shadow's values, else on the host."""
        if self.confirm_on_device:
            return self._confirm_znorm_device(nears, ctxs)
        return [self._confirm_znorm_exact(o, c) for o, c in zip(nears, ctxs)]

    def _confirm_znorm_device(self, nears, ctxs):
        """Exact f64 confirm of a batch on the device: the f64 z-normalized
        queries, the near offsets of every query and their query ids copied
        to the device, one launch of K2's f64 form (``window_ed_f64``) over
        the resident series, one read-back of (d2, mean, std), then
        ``_exact_keep`` on the host for the rows within eps.  Returns what
        ``_confirm_znorm_exact`` returns, query by query."""
        counts = [o.size for o in nears]
        for n_q, ctx in zip(counts, ctxs):
            ctx.stats.n_device_confirmed = int(n_q)
        if sum(counts) == 0:
            return [_EMPTY for _ in ctxs]
        with span("kv.verify.confirm") as sp:
            q_hat = self._qhats(ctxs, torch.float64)
            offsets = self._dev(np.concatenate(nears), torch.int64)
            qids = self._dev(np.repeat(np.arange(len(ctxs), dtype=np.int32),
                                       counts), torch.int32)
            with sp.device(self.device):
                out = window_ed_f64(self.data_dev, q_hat, offsets, qids,
                                    ctxs[0].length)
            (d2, mu, sd), = fetch("kv.verify.wait", out)
            results = []
            start = 0
            for o, ctx in zip(nears, ctxs):
                near = start + np.flatnonzero(d2[start:start + o.size]
                                              <= ctx.eps2)
                start += o.size
                keep = near[self._exact_keep(d2[near], mu[near], sd[near],
                                             ctx)]
                results.append((o[keep - (start - o.size)],
                                np.sqrt(d2[keep])))
        return results

    def _confirm_znorm_exact(self, near: np.ndarray, ctx: _Ctx):
        """Exact f64 confirmation on the host (chunked)."""
        ctx.stats.n_host_rechecked = int(near.size)
        if near.size == 0:
            return _EMPTY
        q_hat = self._qhat(ctx)

        def piece(p):
            d2h, mu_h, sd_h = host_znorm_stats(self.data, p, q_hat)
            keep = self._exact_keep(d2h, mu_h, sd_h, ctx)
            return p[keep], np.sqrt(d2h[keep])

        with span("kv.verify.confirm"):
            return self._chunked_confirm(near, piece)

    def _guarded_near(self, offsets, d2, mu, sd, ctx: _Ctx) -> np.ndarray:
        """The gather route's guarded pre-filter of K2's f32 (d2, mean,
        std): the offsets the exact confirm takes."""
        if offsets.size == 0:
            return offsets
        alpha = ctx.params["alpha"]
        beta = ctx.params["beta"]
        mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
        L = ctx.length
        ctx.stats.n_device_checked = int(offsets.size)
        cg = 1e-3 * (1.0 + np.abs(mu_q) + sd_q)
        ratio = sd / sd_q
        ok = (np.abs(mu - mu_q) <= beta + cg) & (ratio <= alpha + cg) & \
             (ratio >= 1.0 / alpha - cg) & (sd > 0)
        thresh = ctx.eps2 + vf.guard_threshold(ctx.eps2, L, self.qcfg.verify_guard)
        return offsets[ok & (d2 <= thresh)]
