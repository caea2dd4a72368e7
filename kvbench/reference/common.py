"""Plain PyTorch pieces of the references: the series laid out in rows of
windows, walked one chunk of rows at a time; each chunk's window means and
standard deviations and its rows' spectra; the FFT correlation of a
z-normalised query with every window of a chunk; and the exact statistics
of a few windows.

Imports nothing of the program.  Everything runs in the ``dtype`` it is
given: float64 for the reference, float32 for its control.

Row g holds the P = M + L - 1 points from g M on, so its circular
correlation with a query of L points gives the M windows g M .. g M + M - 1
without wrap-around.  Each row is shifted by its own mean before the
prefix sums and the FFT: a window's statistics and its correlation with a
zero-mean query do not change under a common shift, and the shifted values
are small, so their rounding is too.

Only the series stays on the device for the whole walk.  A chunk's
statistics and spectrum are made once, serve every query of the walk, and
are dropped before the next chunk's are made, so device memory is the
series and one chunk's buffers.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

#: Most elements of one temporary, so that a chunk of rows stays within a
#: few hundred MB on the card.
CHUNK_ELEMS = 1 << 24
#: Relative slack of the constraint and distance prefilters in front of the
#: exact statistics: a window within it of a boundary is recomputed.
SLACK = 1e-6
#: Relative margin of a chunk's skip (``Chunk.may_admit``), in unit
#: roundoffs of the rows' dtype: far above the rounding of the constraint's
#: arithmetic.
SKIP_ROUNDINGS = 1e4


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


def mean_limit(mu, beta: float, slack: float = 0.0):
    """The bound of |mu - mu_q| in ``constraint``, loosened by ``slack``."""
    return beta * (1 + slack) + slack * (1 + torch.abs(mu))


def constraint(mu, sd, mu_q, sd_q, alpha: float, beta: float,
               slack: float = 0.0, limit=None) -> torch.Tensor:
    """cNSM's constraint |mu - mu_q| <= beta, 1/alpha <= sd/sd_q <= alpha
    (and sd > 0), loosened by the relative ``slack``; ``limit`` is
    ``mean_limit(mu, beta, slack)`` where the caller has it."""
    if limit is None:
        limit = mean_limit(mu, beta, slack)
    ratio = sd / sd_q
    return ((torch.abs(mu - mu_q) <= limit)
            & (ratio <= alpha * (1 + slack))
            & (ratio >= (1 - slack) / alpha) & (sd > 0))


def gather(x: torch.Tensor, offs: torch.Tensor, L: int) -> torch.Tensor:
    """The windows of ``x`` at ``offs``, (len(offs), L)."""
    return x[offs[:, None] + torch.arange(L, device=x.device)[None, :]]


class Rows:
    """The series ``x`` (a 1-D tensor, cast to ``dtype`` on its device) in
    rows of M windows of length L, padded with its last value to whole
    rows.  ``chunks()`` walks it one ``Chunk`` of rows at a time."""

    def __init__(self, x: torch.Tensor, L: int, dtype=torch.float64):
        self.dtype, self.L = dtype, L
        self.n = int(x.numel())
        self.m = self.n - L + 1
        self.P = fft_size(L)
        self.M = self.P - L + 1
        self.R = -(-self.m // self.M)
        self.chunk = max(1, CHUNK_ELEMS // self.P)
        xp = torch.empty(self.R * self.M + L - 1, dtype=dtype,
                         device=x.device)
        xp[:self.n] = x
        xp[self.n:] = xp[self.n - 1]
        self.x = xp[:self.n]
        self.view = xp.as_strided((self.R, self.P), (self.M, 1))

    def chunks(self):
        """The chunks of rows in order, each made as the walk reaches it."""
        for g0 in range(0, self.R, self.chunk):
            yield Chunk(self, g0, min(g0 + self.chunk, self.R))

    def znormed(self, q: torch.Tensor):
        """The z-normalised query (L,), its zero-mean correlation spectrum
        (P // 2 + 1,), its mean and its standard deviation."""
        mu_q, sd_q = query_stats(q)
        qh = (q - mu_q) / sd_q
        qc = qh - qh.mean()
        return qh, torch.fft.rfft(qc.flip(0), n=self.P), mu_q, sd_q


class Chunk:
    """Rows g0 .. g1 - 1 of ``rows``: per window its mean and standard
    deviation and whether it lies in the series, per row its norm after the
    shift and its real FFT of P points."""

    def __init__(self, rows: Rows, g0: int, g1: int):
        L, M = rows.L, rows.M
        self.rows, self.g0 = rows, g0
        seg = rows.view[g0:g1]
        shift = seg.mean(dim=1, keepdim=True)
        y = seg - shift
        c1, c2 = (torch.nn.functional.pad(torch.cumsum(v, dim=1), (1, 0))
                  for v in (y, y * y))
        s1, s2 = c1[:, L:L + M] - c1[:, :M], c2[:, L:L + M] - c2[:, :M]
        del c1, c2
        mu_y = s1 / L
        self.mu = mu_y + shift
        self.sd = torch.sqrt(torch.clamp(s2 / L - mu_y * mu_y, min=0.0))
        self.norm = torch.linalg.vector_norm(y, dim=1)
        self.spec = torch.fft.rfft(y, n=rows.P, dim=1)
        dev = self.mu.device
        self.valid = (torch.arange(g0, g1, device=dev)[:, None] * M
                      + torch.arange(M, device=dev)[None, :]) < rows.m
        self.safe = torch.where(self.sd > 0, self.sd,
                                torch.ones_like(self.sd))
        self.ranges = torch.stack([self.mu.min(), self.mu.max(),
                                   self.sd.min(), self.sd.max()]).tolist()
        self._limits = {}

    def may_admit(self, mu_q: float, sd_q: float, alpha: float, beta: float,
                  slack: float = 0.0) -> bool:
        """False only where no window of the chunk can pass ``constraint``:
        the chunk's means or standard deviations all lie farther from the
        query's than the constraint allows, by a relative margin of
        ``SKIP_ROUNDINGS`` unit roundoffs.  Rounding moves |mu - mu_q| and
        sd / sd_q monotonically and by far less, so a skipped chunk's
        windows would all be +inf, and the walk leaves it out."""
        lo_mu, hi_mu, lo_sd, hi_sd = self.ranges
        margin = SKIP_ROUNDINGS * unit_roundoff(self.rows.dtype)
        limit = beta * (1 + slack) + slack * (1 + max(abs(lo_mu),
                                                      abs(hi_mu)))
        if max(lo_mu - mu_q, mu_q - hi_mu) > limit * (1 + margin):
            return False
        if not 0 < sd_q < math.inf:
            return True
        return (lo_sd / sd_q <= alpha * (1 + slack) * (1 + margin)
                and hi_sd / sd_q >= (1 - slack) / alpha * (1 - margin))

    def admitted(self, mu_q, sd_q, alpha: float, beta: float,
                 slack: float = 0.0) -> torch.Tensor:
        """The windows in the series that pass ``constraint``."""
        key = (beta, slack)
        if key not in self._limits:
            self._limits[key] = mean_limit(self.mu, beta, slack)
        return self.valid & constraint(self.mu, self.sd, mu_q, sd_q, alpha,
                                      beta, slack, self._limits[key])

    def distances(self, qspec: torch.Tensor) -> torch.Tensor:
        """Approximate squared z-normalised distances of the windows to the
        query: 2 L - 2 c / sd, with c the FFT correlation of the shifted
        rows and the zero-mean query."""
        L, M, P = self.rows.L, self.rows.M, self.rows.P
        c = torch.fft.irfft(self.spec * qspec, n=P, dim=1)[:, L - 1:L - 1 + M]
        # 2 L + (-2) (c / sd): the bits of 2 L - (2 c) / sd, as scaling by 2
        # is exact, in one pass
        return torch.addcdiv(c.new_full((), 2.0 * L), c, self.safe, value=-2)

    def error(self) -> torch.Tensor:
        """A bound on the error of ``distances``, the same for every query:
        the FFT's normwise error (50 u log2 P |row| |q|), a relative
        ``SLACK`` of 2 L and the rounding of each window's variance
        (4 u (mu / sd)^2 of it)."""
        L, dtype = self.rows.L, self.rows.dtype
        u = unit_roundoff(dtype)
        gamma = 50 * u * math.log2(self.rows.P)
        rel = torch.clamp(torch.abs(self.mu) / self.safe,
                          max=float(torch.finfo(dtype).max) ** 0.25)
        return (2 * gamma * math.sqrt(L) * self.norm[:, None] / self.safe
                + 2 * L * (SLACK + 4 * u * rel * rel))

    def offsets(self, mask: torch.Tensor) -> torch.Tensor:
        """Window offsets of the True entries of ``mask``."""
        r, c = torch.nonzero(mask, as_tuple=True)
        return (r + self.g0) * self.rows.M + c
