"""RSM-ED engine of the PyTorch port (kvmatch_tpu/engine/rsm_ed.py).

Raw-subsequence matching under Euclidean distance.  The host methods (plan
inputs and costs, probe rows, scan/combine, the PAA prefilter, the exact f64
confirm) are carried over from the JAX package's module, which imports jax
at the top and so cannot be imported here; ``_verify_multi`` runs phase 2 on
the port's tensors: the FFT region near-set for clustered candidates and
kernel K2 (ops/ed.py) for scattered ones, then the exact f64 confirmation on
the host.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from kvmatch_tpu import native
from kvmatch_tpu import verify as vf
from kvmatch_tpu.plan import QuerySegment, unit_sums
from kvmatch_tpu.utils import intervals as iv
from kvmatch_tpu.utils import rounding

from ..ops.ed import ed_distances_multi
from ..ops.regions import region_ed_distances_multi, region_ed_near_multi
from .base import _EMPTY, NEAR_K, BaseEngine, _Ctx, _np


class QueryEngine(BaseEngine):
    payloads = ("eps",)

    # ---------------------------------------------------------------- phase 0
    def _cost_batch(self, ctx: _Ctx):
        """DP cost: index intervals with key in the segment's plain probe
        range (QueryEngine.java:382-422)."""
        norm = self._cost_normalizer()
        pos_of_d = self.icfg.pos_of_d

        def cost_batch(w, mean_lo, mean_hi):
            sc = self.index[w]
            rng = ctx.epsilon / math.sqrt(w)
            b = rounding.to_round(mean_lo - rng, pos_of_d)
            e = rounding.to_round(mean_hi + rng, pos_of_d)
            cnt_i, _ = sc.counts_between_batch(b, e)
            with np.errstate(divide="ignore"):
                log_cost = np.log(cnt_i / norm)
            return log_cost, cnt_i

        return cost_batch

    def _cost_batch_multi(self, ctxs):
        """Whole-batch DP cost: one (Q, S) searchsorted pass per scale."""
        norm = self._cost_normalizer()
        pos_of_d = self.icfg.pos_of_d
        eps = np.asarray([c.epsilon for c in ctxs], np.float64)[:, None]

        def cost_batch_multi(w, mean_lo, mean_hi):
            sc = self.index[w]
            rng = eps / math.sqrt(w)
            b = rounding.to_round(mean_lo - rng, pos_of_d)
            e = rounding.to_round(mean_hi + rng, pos_of_d)
            cnt_i, _ = sc.counts_between_batch(b, e)
            with np.errstate(divide="ignore"):
                log_cost = np.log(cnt_i / norm)
            return log_cost, cnt_i

        return cost_batch_multi

    def _plan_inputs(self, ctx: _Ctx):
        sums = unit_sums(ctx.query, self.icfg.unit)
        return sums, sums, self._cost_batch(ctx)

    # ---------------------------------------------------------------- phase 1
    def _probe_rows_eps(self, seg: QuerySegment, ctx: _Ctx):
        """Probed row range + per-row distance lower bound for a segment
        (QueryEngine.java:199-202, 578-591)."""
        sc = self.index[seg.w]
        budget = max(ctx.eps2 - ctx.last_min_eps, 0.0)
        rng = math.sqrt(budget / seg.w) + self.icfg.probe_guard
        begin = float(rounding.snap_down(seg.mean_lo - rng, sc.keys,
                                         self.icfg.pos_of_d))
        end = float(rounding.to_round(seg.mean_hi + rng, self.icfg.pos_of_d))
        rows = sc.probe_rows(begin, end)
        if rows.size == 0:
            return sc, rows, None
        lo, hi = self._row_bounds(sc, rows)
        delta = np.maximum(np.maximum(lo - seg.mean_hi, seg.mean_lo - hi), 0.0)
        return sc, rows, seg.w * delta * delta

    def _scan(self, seg: QuerySegment, ctx: _Ctx) -> Dict[str, np.ndarray]:
        sc, rows, eps_row = self._probe_rows_eps(seg, ctx)
        if rows.size == 0:
            return iv.empty_set(("eps",))
        return self._scan_fill(sc, rows, ctx, {"eps": eps_row})

    def _scan_join(self, seg: QuerySegment, cs, ctx: _Ctx):
        """Fused scan+intersect via the position-sorted view."""
        sc, rows, eps_row = self._probe_rows_eps(seg, ctx)
        if rows.size == 0:
            return iv.empty_set(("eps",))
        p_left, p_right, p_row = sc.pos_sorted()
        i0, i1 = int(rows[0]), int(rows[-1]) + 1
        return native.join_ed(cs, p_left, p_right, p_row, i0, i1, eps_row,
                              ctx.eps2, self.icfg.maximum_diff,
                              row_total=int(sc.row_ptr[i1] - sc.row_ptr[i0]))

    def _combine(self, pieces, a, b, ia, ib, ctx: _Ctx) -> Dict[str, np.ndarray]:
        eps_sum = a["eps"][ia] + b["eps"][ib]
        keep = eps_sum <= ctx.eps2
        return {"left": pieces["left"][keep], "right": pieces["right"][keep],
                "eps": eps_sum[keep]}

    def _intersect_native(self, cs, positions, ctx: _Ctx, delta: int = 0):
        return native.intersect_ed(cs, positions, ctx.eps2, delta)

    # ---------------------------------------------------------------- phase 2
    def _confirm_ed(self, near: np.ndarray, ctx: _Ctx):
        """Exact f64 confirmation on the host (chunked)."""
        ctx.stats.n_host_rechecked = int(near.size)
        if near.size == 0:
            return _EMPTY
        cols = np.arange(ctx.length)

        def piece(p):
            diff = self.data[p[:, None] + cols[None, :]].astype(
                np.float64, copy=False) - ctx.query[None, :]
            d2h = np.einsum("ij,ij->i", diff, diff)
            keep = d2h <= ctx.eps2
            return p[keep], np.sqrt(d2h[keep])

        return self._chunked_confirm(near, piece)

    def _verify_intervals(self, left, right, ctx):
        return self._verify_multi([(left, right)], [ctx])[0]

    def _paa_prefilter(self, offsets: np.ndarray, ctx: _Ctx, thresh: float,
                       blocks: int = 16, env=None, prefix=None) -> np.ndarray:
        """Raw-space PAA lower bound from prefix sums (no window gather).
        With ``env=(lo_blk, hi_blk)`` (block means of the Sakoe-Chiba
        envelope) the per-block distance is the envelope form, which
        lower-bounds banded DTW (kvmatch_tpu/engine/rsm_ed.py:147-189)."""
        L = ctx.length
        c = L // blocks
        if offsets.size == 0 or c < 4:
            return offsets
        nblk = L // c
        if prefix is not None:
            c1 = prefix
        else:
            if not hasattr(self, "_c1_paa"):
                self._c1_paa = np.concatenate(([0.0], np.cumsum(self.data)))
            c1 = self._c1_paa
        if env is None:
            qb = ctx.params.get("_q_blk")
            if qb is None or qb.size != nblk:
                qb = ctx.query[: nblk * c].reshape(nblk, c).mean(axis=1)
                ctx.params["_q_blk"] = qb
        CHUNK = 1 << 20
        cols = np.arange(nblk) * c
        lb = np.empty(offsets.size)
        for s in range(0, offsets.size, CHUNK):
            o = offsets[s: s + CHUNK, None] + cols[None, :]
            blk = (c1[o + c] - c1[o]) / c
            if env is not None:
                d = np.maximum(np.maximum(blk - env[1][None, :],
                                          env[0][None, :] - blk), 0.0)
            else:
                d = blk - qb[None, :]
            lb[s: s + CHUNK] = c * np.einsum("ij,ij->i", d, d)
        return offsets[lb <= thresh * (1.0 + 1e-9) + 1e-9]

    def _verify_multi(self, cand_ivs, ctxs):
        """Multi-query verification: the exact f64 host kernel for a tiny
        load, else the device routes of BaseEngine._verify_routed."""
        L = ctxs[0].length
        if self._host_verify_ok(cand_ivs, L):
            # Tiny load: PAA prefilter + the exact f64 host kernel, no device
            # launch.
            prefix = None
            if self.n > self.PREFILTER_CUMSUM_MAX_N:
                pre = self._host_prefilter_prefix(cand_ivs, L, want_sq=False)
                prefix = pre[0] if pre is not None else None
            paa_ok = prefix is not None or self.n <= self.PREFILTER_CUMSUM_MAX_N
            out = []
            for (l, r), c in zip(cand_ivs, ctxs):
                offs = iv.expand_offsets({"left": l, "right": r})
                c.stats.n_host_checked = int(offs.size)
                if paa_ok:
                    offs = self._paa_prefilter(offs, c, c.eps2, prefix=prefix)
                out.append(self._confirm_ed(offs, c))
            return out
        return self._verify_routed(cand_ivs, ctxs)

    def _verify_regions(self, cand_ivs, ctxs, region):
        """Region route: raw FFT distances on centred data, near-set
        selection on the device, exact f64 confirm of the set."""
        L = ctxs[0].length
        starts, vfrom, vto, qids, M = region
        data_dev = self.data_dev
        threshs = self._guarded_threshs(ctxs)
        center = float(np.float32(self._data_center()))
        qm = self._dev(np.stack([c.query for c in ctxs]) - center,
                       torch.float32)
        th_dev = self._dev(threshs, torch.float32)

        def near_fn(s_, q_, vf_, vt_):
            cnt, rows, cols = region_ed_near_multi(
                data_dev, qm, self._dev(s_, torch.int64),
                self._dev(q_, torch.int32), self._dev(vf_, torch.int64),
                self._dev(vt_, torch.int64), th_dev, L, M, NEAR_K, center)
            return cnt, _np(rows), _np(cols)

        near = vf.run_region_near(near_fn, starts, vfrom, vto, qids, NEAR_K,
                                  width=M + L - 1)
        if near is None:
            # Overflowed the near-set capacity: full-matrix fallback.
            d2, err = vf.run_bucketed(
                lambda s_, q_: tuple(_np(a) for a in region_ed_distances_multi(
                    data_dev, qm, self._dev(s_, torch.int64),
                    self._dev(q_, torch.int32), L, M, center)),
                starts.size, starts, qids, lo=32, hi=2048, width=M + L - 1)
            col = np.arange(M)[None, :]
            nearm = ((col >= vfrom[:, None]) & (col < vto[:, None])
                     & (d2 <= threshs[qids][:, None] + err))
            rows, cols = np.nonzero(nearm)
            near = (starts[rows] + cols, qids[rows])
        near_off, near_qid = near
        return [self._confirm_ed(np.sort(near_off[near_qid == qi]), ctx)
                for qi, ctx in enumerate(ctxs)]

    def _verify_gather(self, cand_ivs, ctxs):
        """Scattered route: PAA prefilter (no gather), then K2 on the
        survivors (int64 offsets end to end)."""
        L = ctxs[0].length
        threshs = self._guarded_threshs(ctxs)
        cand_offs = [self._paa_prefilter(
            iv.expand_offsets({"left": l, "right": r}), c, float(th))
            for (l, r), c, th in zip(cand_ivs, ctxs, threshs)]
        counts = [o.size for o in cand_offs]
        total = int(sum(counts))
        if total == 0:
            return [_EMPTY for _ in ctxs]
        offsets = np.concatenate(cand_offs).astype(np.int64)
        qids = np.repeat(np.arange(len(ctxs), dtype=np.int32), counts)
        qm = self._dev(np.stack([c.query for c in ctxs]), torch.float32)
        d2 = vf.run_bucketed(
            lambda o, q: _np(ed_distances_multi(
                self.data_dev, qm, self._dev(o, torch.int64),
                self._dev(q, torch.int32), L)),
            total, offsets, qids, lo=self.qcfg.verify_batch, width=L)
        results = []
        start = 0
        for qi, ctx in enumerate(ctxs):
            d2_q = d2[start:start + counts[qi]]
            start += counts[qi]
            results.append(self._confirm_ed(cand_offs[qi][d2_q <= threshs[qi]],
                                            ctx))
        return results
