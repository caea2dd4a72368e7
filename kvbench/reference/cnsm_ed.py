"""Plain reference of cNSM-ED: every window of the series whose
z-normalised Euclidean distance to the query is within eps, under the
constraint |mu - mu_q| <= beta and 1/alpha <= sd / sd_q <= alpha.

Means and standard deviations are the population ones, sqrt(max(mean(x^2)
- mean(x)^2, 0)), of the window's values; a window with sd = 0 is never an
answer.  The FFT profile of each ``common.Chunk`` picks every window that
could be within eps (its error bound and a relative slack added), and each
of those is recomputed from its own values, in the rows' dtype: float64 for
the reference, float32 for its control.  ``topk`` and ``answers`` take
every query at once and walk the rows once: the chunk is the outer loop and
the query the inner one, and a chunk in which no window can pass a query's
constraint (``Chunk.may_admit``) is left out of that query's walk.  Imports
nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def answers(rows: Rows, qs: Sequence[torch.Tensor], eps: Sequence[float],
            alpha: float, beta: float,
            **_) -> List[Tuple[np.ndarray, np.ndarray]]:
    """For each query of ``qs`` (1-D tensors), the (offsets ascending,
    distances) of every answer within its ``eps``."""
    zs = _znormed(rows, qs)
    eps2 = [float(e) ** 2 for e in eps]
    near: List[list] = [[] for _ in zs]
    for ch in rows.chunks():
        err = ch.error()
        for j, (_, qspec, mu_q, sd_q, host) in enumerate(zs):
            if ch.may_admit(*host, alpha, beta, SLACK):
                ok = ch.admitted(mu_q, sd_q, alpha, beta, SLACK)
                near[j].append(ch.offsets(
                    ok & (ch.distances(qspec) <= eps2[j] + err)))
        del ch, err
    out = []
    for j, (qh, _, mu_q, sd_q, _) in enumerate(zs):
        offs = (torch.cat(near[j]) if near[j] else
                torch.zeros(0, dtype=torch.long, device=rows.x.device))
        d2 = exact(rows, offs, qh, mu_q, sd_q, alpha, beta)
        keep = d2 <= eps2[j]
        offs, d2 = offs[keep], d2[keep]
        order = torch.argsort(offs)
        out.append((offs[order].cpu().numpy().astype(np.int64),
                    torch.sqrt(d2[order]).double().cpu().numpy()))
    return out


def smallest(d2: torch.Tensor, kk: int):
    """The kk smallest entries of ``d2`` (rows, M), ascending, and their
    flat indices, as ``torch.topk`` of the flattened ``d2`` gives them but
    for the order of equal values.  They lie in the kk rows of least
    minimum: a row outside those has kk entries at or below its least in
    the others.  So one pass takes the rows' minima, and the rest reads kk
    rows."""
    M = d2.shape[1]
    r = torch.topk(d2.amin(dim=1), min(kk, d2.shape[0]), largest=False)[1]
    v, c = torch.topk(d2[r].reshape(-1), min(kk, r.numel() * M),
                      largest=False)
    return v, r[c // M] * M + c % M


def topk(rows: Rows, qs: Sequence[torch.Tensor], k: int, alpha: float,
         beta: float) -> np.ndarray:
    """For each query of ``qs`` (1-D tensors), a row of the k + TOPK_MARGIN
    smallest squared distances of admissible windows, ascending, each
    recomputed from the window's values (+inf where fewer windows are
    admissible)."""
    zs = _znormed(rows, qs)
    kk = k + TOPK_MARGIN
    vals: List[list] = [[] for _ in zs]
    offs: List[list] = [[] for _ in zs]
    for ch in rows.chunks():
        for j, (_, qspec, mu_q, sd_q, host) in enumerate(zs):
            if not ch.may_admit(*host, alpha, beta):
                continue
            ok = ch.admitted(mu_q, sd_q, alpha, beta)
            v, i = smallest(torch.where(ok, ch.distances(qspec), torch.inf),
                            kk)
            vals[j].append(v)
            offs[j].append(ch.g0 * rows.M + i)
        del ch
    out = np.full((len(zs), kk), np.inf)
    for j, (qh, _, mu_q, sd_q, _) in enumerate(zs):
        if not vals[j]:
            continue
        v = torch.cat(vals[j])
        v, i = torch.topk(v, min(kk, v.numel()), largest=False)
        best = torch.cat(offs[j])[i][torch.isfinite(v)]
        d2 = exact(rows, best, qh, mu_q, sd_q, alpha, beta)
        out[j, :d2.numel()] = torch.sort(d2).values.double().cpu().numpy()
    return out


def _znormed(rows: Rows, qs: Sequence[torch.Tensor]) -> list:
    """Per query ``Rows.znormed`` and its (mean, sd) on the host."""
    out = []
    for q in qs:
        qh, qspec, mu_q, sd_q = rows.znormed(q.to(rows.dtype))
        out.append((qh, qspec, mu_q, sd_q, (mu_q.item(), sd_q.item())))
    return out
