"""The reference as it stood before its one pass: ``Rows`` keeps every
window's mean and standard deviation and every row's spectrum for the whole
series, and ``topk`` and ``answers`` walk the rows once per query.  The
tests hold the one-pass reference (``kvbench/reference``) to it bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

#: Most elements of one temporary, so that a chunk of rows stays within a
#: few hundred MB on the card.
CHUNK_ELEMS = 1 << 24
#: Relative slack of the constraint and distance prefilters in front of the
#: exact statistics: a window within it of a boundary is recomputed.
SLACK = 1e-6


def unit_roundoff(dtype) -> float:
    return float(torch.finfo(dtype).eps) / 2


def fft_size(L: int) -> int:
    """Points of a row: the power of two at or above 2 L, at least 4096."""
    return max(4096, 1 << (2 * L - 1).bit_length())


def query_stats(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Population mean and standard deviation of a query, as the semantics
    define them: sqrt(max(mean(q^2) - mean(q)^2, 0))."""
    mu = q.mean()
    return mu, torch.sqrt(torch.clamp((q * q).mean() - mu * mu, min=0.0))


def window_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row population mean and standard deviation of windows ``x``
    (rows, L), by the semantics' formula."""
    mu = x.mean(dim=1)
    var = torch.clamp((x * x).mean(dim=1) - mu * mu, min=0.0)
    return mu, torch.sqrt(var)


def constraint(mu, sd, mu_q, sd_q, alpha: float, beta: float,
               slack: float = 0.0) -> torch.Tensor:
    """cNSM's constraint |mu - mu_q| <= beta, 1/alpha <= sd/sd_q <= alpha
    (and sd > 0), loosened by the relative ``slack``."""
    ratio = sd / sd_q
    return ((torch.abs(mu - mu_q) <= beta * (1 + slack)
             + slack * (1 + torch.abs(mu)))
            & (ratio <= alpha * (1 + slack))
            & (ratio >= (1 - slack) / alpha) & (sd > 0))


def gather(x: torch.Tensor, offs: torch.Tensor, L: int) -> torch.Tensor:
    """The windows of ``x`` at ``offs``, (len(offs), L)."""
    return x[offs[:, None] + torch.arange(L, device=x.device)[None, :]]


class Rows:
    """The series ``x`` (a 1-D tensor, cast to ``dtype`` on its device) in
    rows of M windows of length L: per window its mean and standard
    deviation, per row its norm after the shift and its real FFT of P
    points."""

    def __init__(self, x: torch.Tensor, L: int, dtype=torch.float64):
        self.dtype, self.L = dtype, L
        self.x = x.to(dtype)
        self.n = int(self.x.numel())
        self.m = self.n - L + 1
        self.P = fft_size(L)
        self.M = self.P - L + 1
        self.R = -(-self.m // self.M)
        self.chunk = max(1, CHUNK_ELEMS // self.P)
        dev = self.x.device
        tail = self.R * self.M + L - 1 - self.n
        xp = torch.cat([self.x, self.x[-1:].expand(max(tail, 0))])
        view = xp.as_strided((self.R, self.P), (self.M, 1))
        self.mu = torch.empty((self.R, self.M), dtype=dtype, device=dev)
        self.sd = torch.empty_like(self.mu)
        self.norm = torch.empty(self.R, dtype=dtype, device=dev)
        self.spec = torch.empty((self.R, self.P // 2 + 1),
                                dtype=torch.complex128
                                if dtype == torch.float64
                                else torch.complex64, device=dev)
        for g0, g1 in self.chunks():
            seg = view[g0:g1]
            shift = seg.mean(dim=1, keepdim=True)
            y = seg - shift
            s1, s2 = self._sums(y)
            mu_y = s1 / L
            self.mu[g0:g1] = mu_y + shift
            self.sd[g0:g1] = torch.sqrt(torch.clamp(s2 / L - mu_y * mu_y,
                                                    min=0.0))
            self.norm[g0:g1] = torch.linalg.vector_norm(y, dim=1)
            self.spec[g0:g1] = torch.fft.rfft(y, n=self.P, dim=1)
        col = torch.arange(self.M, device=dev)
        self.valid = (torch.arange(self.R, device=dev)[:, None] * self.M
                      + col[None, :]) < self.m

    def chunks(self):
        for g0 in range(0, self.R, self.chunk):
            yield g0, min(g0 + self.chunk, self.R)

    def _sums(self, y: torch.Tensor):
        """Sums of the values and of their squares over each window of the
        rows ``y``, from prefix sums with a leading 0."""
        L, M = self.L, self.M
        c1, c2 = (torch.nn.functional.pad(torch.cumsum(v, dim=1), (1, 0))
                  for v in (y, y * y))
        return c1[:, L:L + M] - c1[:, :M], c2[:, L:L + M] - c2[:, :M]

    def offsets(self, g0: int, mask: torch.Tensor) -> torch.Tensor:
        """Window offsets of the True entries of ``mask`` (rows g0 ..)."""
        r, c = torch.nonzero(mask, as_tuple=True)
        return (r + g0) * self.M + c

    def znormed(self, q: torch.Tensor):
        """The z-normalised query (L,) and its zero-mean correlation
        spectrum (P // 2 + 1,)."""
        mu_q, sd_q = query_stats(q)
        qh = (q - mu_q) / sd_q
        qc = qh - qh.mean()
        return qh, torch.fft.rfft(qc.flip(0), n=self.P), mu_q, sd_q

    def profile(self, g0: int, g1: int, qspec: torch.Tensor):
        """Approximate squared z-normalised distances of rows g0 .. g1 - 1
        to the query, and a bound on their error: 2 L - 2 c / sd, with c
        the FFT correlation of the shifted rows and the zero-mean query.
        The bound covers the FFT's normwise error (50 u log2 P |row| |q|),
        a relative ``SLACK`` of 2 L and the rounding of each window's
        variance (4 u (mu / sd)^2 of it)."""
        L, M = self.L, self.M
        c = torch.fft.irfft(self.spec[g0:g1] * qspec, n=self.P,
                            dim=1)[:, L - 1:L - 1 + M]
        sd, mu = self.sd[g0:g1], self.mu[g0:g1]
        safe = torch.where(sd > 0, sd, torch.ones_like(sd))
        d2 = 2 * L - 2 * c / safe
        u = unit_roundoff(self.dtype)
        gamma = 50 * u * math.log2(self.P)
        rel = torch.clamp(torch.abs(mu) / safe,
                          max=float(torch.finfo(self.dtype).max) ** 0.25)
        err = (2 * gamma * math.sqrt(L) * self.norm[g0:g1, None] / safe
               + 2 * L * (SLACK + 4 * u * rel * rel))
        return d2, err

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
