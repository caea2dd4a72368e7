"""Plain reference of cNSM-ED: every window of the series whose
z-normalised Euclidean distance to the query is within eps, under the
constraint |mu - mu_q| <= beta and 1/alpha <= sd / sd_q <= alpha.

Means and standard deviations are the population ones, sqrt(max(mean(x^2)
- mean(x)^2, 0)), of the window's values; a window with sd = 0 is never an
answer.  The FFT profile of ``common.Rows`` picks every window that could
be within eps (its error bound and a relative slack added), and each of
those is recomputed from its own values, in the rows' dtype: float64 for
the reference, float32 for its control.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .common import SLACK, Rows, constraint, gather, window_stats

#: Windows past the k-th that a calibration recomputes exactly, so that
#: the profile's rounding cannot reorder the ranks it reads.
TOPK_MARGIN = 8


def exact(rows: Rows, offs: torch.Tensor, qh, mu_q, sd_q, alpha: float,
          beta: float) -> torch.Tensor:
    """Squared distances of the windows at ``offs`` from their own values,
    +inf where the constraint fails."""
    L = rows.L
    out = torch.empty(offs.numel(), dtype=rows.dtype, device=offs.device)
    step = max(1, (1 << 24) // L)
    for s in range(0, offs.numel(), step):
        x = gather(rows.x, offs[s:s + step], L)
        mu, sd = window_stats(x)
        ok = constraint(mu, sd, mu_q, sd_q, alpha, beta)
        safe = torch.where(sd > 0, sd, torch.ones_like(sd))
        z = (x - mu[:, None]) / safe[:, None]
        d2 = (z - qh[None, :]).square().sum(dim=1)
        out[s:s + step] = torch.where(ok, d2, torch.inf)
    return out


def answers(rows: Rows, q: torch.Tensor, eps: float, alpha: float,
            beta: float, **_) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets ascending, distances) of every answer to ``q`` within
    ``eps``."""
    qh, qspec, mu_q, sd_q = rows.znormed(q.to(rows.dtype))
    eps2 = float(eps) ** 2
    near = []
    for g0, g1 in rows.chunks():
        d2, err = rows.profile(g0, g1, qspec)
        ok = rows.valid[g0:g1] & constraint(
            rows.mu[g0:g1], rows.sd[g0:g1], mu_q, sd_q, alpha, beta, SLACK)
        near.append(rows.offsets(g0, ok & (d2 <= eps2 + err)))
    offs = torch.cat(near)
    d2 = exact(rows, offs, qh, mu_q, sd_q, alpha, beta)
    keep = d2 <= eps2
    offs, d2 = offs[keep], d2[keep]
    order = torch.argsort(offs)
    return (offs[order].cpu().numpy().astype(np.int64),
            torch.sqrt(d2[order]).double().cpu().numpy())


def topk(rows: Rows, q: torch.Tensor, k: int, alpha: float,
         beta: float) -> np.ndarray:
    """The k + TOPK_MARGIN smallest squared distances of admissible windows
    to ``q``, ascending, each recomputed from the window's values (+inf
    where fewer windows are admissible)."""
    qh, qspec, mu_q, sd_q = rows.znormed(q.to(rows.dtype))
    kk = k + TOPK_MARGIN
    vals, offs = [], []
    for g0, g1 in rows.chunks():
        d2, _ = rows.profile(g0, g1, qspec)
        ok = rows.valid[g0:g1] & constraint(
            rows.mu[g0:g1], rows.sd[g0:g1], mu_q, sd_q, alpha, beta)
        d2 = torch.where(ok, d2, torch.inf).reshape(-1)
        v, i = torch.topk(d2, min(kk, d2.numel()), largest=False)
        vals.append(v)
        offs.append(g0 * rows.M + i)
    v, i = torch.topk(torch.cat(vals), kk, largest=False)
    best = torch.cat(offs)[i][torch.isfinite(v)]
    d2 = exact(rows, best, qh, mu_q, sd_q, alpha, beta)
    out = torch.full((kk,), torch.inf, dtype=torch.float64)
    out[:d2.numel()] = torch.sort(d2).values.double().cpu()
    return out.numpy()
