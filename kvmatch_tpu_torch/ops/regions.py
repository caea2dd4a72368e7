"""Region phase 2 in PyTorch (port of kvmatch_tpu/ops/regions.py).

Clustered candidates leave phase 1 as intervals of window offsets; each
interval's region (M + L - 1 points) is gathered once and all M offsets are
evaluated with one batched rfft/irfft cross-correlation (``torch.fft``):

    corr[i] = sum_j x[i+j] * q[j]
    raw ED:   d2[i] = S2[i] - 2*corr[i] + ||q||^2
    z-norm:   d2[i] = 2L - 2*corr_hat[i] / sigma[i]      (MASS form)

with a per-offset f32 error bound that the caller adds to its guard band
before the exact f64 host confirmation.  ``FFT_ERR_C`` was fit on TPU FFTs;
chip_smoke.py re-measures the cuFFT error against f64 before relying on it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .ed import _gather, _one_query

# f32 round-off amplification constant of the error bounds.
ERR_C = 64.0 * float(np.finfo(np.float32).eps)
# Rounding constant of the f64 window sums of the z-norm region distances.
SUM_ERR_C = 4.0 * float(np.finfo(np.float64).eps)
# FFT correlation error coefficient: |corr_f32 - corr| <= FFT_ERR_C *
# ||x||_2 * ||q||_2 is what the guards assume, x the window (raw ED) or the
# whole region row (z-norm).
FFT_ERR_C = 1e-5


def _sliding_sum_rows(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding sums of width w along dim 1 by doubling; (B, R) -> (B, R-w+1)."""
    n = x.shape[1]
    pow_sums = {1: x}
    width = 1
    while width * 2 <= w:
        s = pow_sums[width]
        pow_sums[width * 2] = s[:, : n - 2 * width + 1] + s[:, width: n - width + 1]
        width *= 2
    out_len = n - w + 1
    acc = None
    offset, rem = 0, w
    for p in sorted(pow_sums, reverse=True):
        if rem >= p:
            piece = pow_sums[p][:, offset: offset + out_len]
            acc = piece if acc is None else acc + piece
            offset += p
            rem -= p
    return acc


def _correlate_grouped(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """corr[b, i] = sum_j x[b, i+j] qs[b, j] by batched f32 FFT."""
    R = x.shape[1]
    L = qs.shape[1]
    N = 1 << max(int(np.ceil(np.log2(R))), 1)
    X = torch.fft.rfft(x, n=N, dim=1)
    Qf = torch.fft.rfft(torch.flip(qs, dims=(1,)), n=N, dim=1)
    full = torch.fft.irfft(X * Qf, n=N, dim=1)
    return full[:, L - 1: R]


def region_ed_distances_multi(data, queries_centered, starts, qids,
                              length: int, m_per_region: int,
                              center: float = 0.0):
    """Raw squared ED for offsets starts[b] + [0, M); one query per region
    row.  Returns (d2 (B, M), err (B, M))."""
    r_len = m_per_region + length - 1
    x = _gather(data, starts, r_len) - center
    qs = queries_centered[qids.long()]
    corr = _correlate_grouped(x, qs)
    s2 = _sliding_sum_rows(x * x, length)
    q2 = torch.sum(qs * qs, dim=1)[:, None]
    d2 = torch.clamp_min(s2 - 2.0 * corr + q2, 0.0)
    err = ERR_C * (s2 + 2.0 * torch.abs(corr) + q2) + \
        2.0 * FFT_ERR_C * torch.sqrt(torch.clamp_min(s2 * q2, 0.0))
    return d2, err


def _window_sums(x: torch.Tensor, w: int) -> torch.Tensor:
    """Width-w sliding sums along dim 1 as differences of prefix sums, in
    ``x``'s dtype; (B, R) -> (B, R-w+1)."""
    c = torch.nn.functional.pad(torch.cumsum(x, dim=1), (1, 0))
    return c[:, w:] - c[:, :-w]


def region_znorm_distances_multi(data, queries_hat, starts, qids,
                                 length: int, m_per_region: int):
    """Z-normalized squared ED (MASS form) with window mean/std and the
    error bound; each (B, M).

    Each region row is shifted by its first value c, in f64, before the
    correlation and the window sums, as z-normalization ignores a shift:
    with x' = x - c (exact in f64) and s1', s2' the width-L sums of x' and
    x'^2, taken in f64 as differences of the row's prefix sums,
    mean = s1'/L + c and var = s2'/L - (s1'/L)^2, both in f64 before they
    are rounded to f32.  The correlation reads x' rounded to f32.  So a
    window's variance does not cancel at a level far above its std (f32
    sums of the raw values cancel at std/|mean| of 4e-3 at L = 4096, and to
    0 at 1e-4 at L = 256), nor across a jump of level inside the row.

    The bound ``err`` of |d2 - d2_exact|, with sigma the window's std, R
    the row's points (M + L - 1), P = ||x'_row||^2 and u32, u64 the unit
    roundoffs.  d2 = 2L - 2 C / sigma, C the correlation of the centred
    window with the query, |C| <= L sigma:

    * the correlation: the FFT's error is at most FFT_ERR_C ||x'_row||
      ||q||, ||q|| = sqrt(L), over the whole row that the transform reads
      (it bounds every window's norm); rounding x' and the query to f32
      adds 2 u32 sqrt(P L), inside FFT_ERR_C's margin.  Divided by sigma
      and doubled: 2 FFT_ERR_C sqrt(L) ||x'_row|| / sigma;
    * the variance: the squares of f32 values are exact in f64, and a
      prefix sum over R terms and the difference of two leave
      |var - var_exact| <= 2 R u64 P / L; as |C| <= L sigma,
      2 |C| |1/sigma - 1/sigma_exact| <= 2 L |var - var_exact| / sigma^2
      <= SUM_ERR_C R P / sigma^2;
    * rounding sigma to f32 (relative u32), 2 C / sigma and 2L minus it:
      a few u32 of 2L, under ERR_C 2L.
    """
    r_len = m_per_region + length - 1
    x = _gather(data, starts, r_len)
    c = x[:, :1].double()
    x = x.double() - c
    corr = _correlate_grouped(x.float(), queries_hat[qids.long()])
    xx = x * x
    mean = _window_sums(x, length) / length
    var = torch.clamp_min(_window_sums(xx, length) / length - mean * mean,
                          0.0)
    std = torch.sqrt(var).float()
    mean = (mean + c).float()
    safe = torch.where(std > 0, std, 1.0)
    two_l = float(np.float32(2.0 * length))
    d2 = torch.clamp_min(two_l - 2.0 * corr / safe, 0.0)
    d2 = torch.where(std > 0, d2, torch.inf)
    row_sq = torch.sum(xx, dim=1, keepdim=True).float()
    err = ((2.0 * FFT_ERR_C * float(np.sqrt(length))) * torch.sqrt(row_sq)
           + (SUM_ERR_C * r_len) * row_sq / safe) / safe + ERR_C * two_l
    return d2, mean, std, err


def region_ed_distances(data, query_centered, starts, length: int,
                        m_per_region: int, center: float = 0.0):
    """``region_ed_distances_multi`` with one query (L,) for every region:
    (d2 (B, M), err (B, M)).  ``center`` is subtracted from the gathered
    data; pass the constant that centred ``query_centered``."""
    return region_ed_distances_multi(data, query_centered[None], starts,
                                     _one_query(starts), length,
                                     m_per_region, center)


def region_znorm_distances(data, query_hat, starts, length: int,
                           m_per_region: int):
    """``region_znorm_distances_multi`` with one z-normalized query (L,) for
    every region: (d2, mean, std), each (B, M)."""
    d2, mean, std, _ = region_znorm_distances_multi(
        data, query_hat[None], starts, _one_query(starts), length,
        m_per_region)
    return d2, mean, std


def _near_compact(near: torch.Tensor, near_k: int):
    """(count, rows, cols) of the True cells of a 2-D mask in ascending
    row-major order, at most ``near_k`` of them; callers read [:count] and
    fall back when count > near_k (the contract of the JAX _near_compact).
    ``nonzero`` waits for the mask: a read-back of its count."""
    with span("kv.verify.wait"):
        idx = torch.nonzero(near)
    count = int(idx.shape[0])
    idx = idx[:near_k]
    return count, idx[:, 0].to(torch.int32), idx[:, 1].to(torch.int32)


def _in_window(vfrom, vto, m_per_region: int, device):
    col = torch.arange(m_per_region, device=device)[None, :]
    return (col >= vfrom[:, None]) & (col < vto[:, None])


def region_ed_near_multi(data, queries_centered, starts, qids, vfrom, vto,
                         threshs, length: int, m_per_region: int, near_k: int,
                         center: float = 0.0):
    """Region ED with near-set selection: (count, rows, cols) of the offsets
    whose guarded d2 is under the per-query threshold."""
    d2, err = region_ed_distances_multi(data, queries_centered, starts, qids,
                                        length, m_per_region, center)
    near = (_in_window(vfrom, vto, m_per_region, d2.device)
            & (d2 <= threshs[qids.long()][:, None] + err))
    return _near_compact(near, near_k)


def region_znorm_near_multi(data, queries_hat, starts, qids, vfrom, vto,
                            threshs, cons, length: int, m_per_region: int,
                            near_k: int):
    """Z-norm region distances with the guarded constraint and near-set
    selection; ``cons`` rows are (alpha, beta, mu_q, sd_q, cg) per query."""
    d2, mean, std, err = region_znorm_distances_multi(
        data, queries_hat, starts, qids, length, m_per_region)
    c = cons[qids.long()]
    a, b, mq, sq, cg = (c[:, k:k + 1] for k in range(5))
    ratio = std / sq
    ok = ((torch.abs(mean - mq) <= b + cg) & (ratio <= a + cg)
          & (ratio >= 1.0 / a - cg) & (std > 0))
    near = (ok & _in_window(vfrom, vto, m_per_region, d2.device)
            & (d2 <= threshs[qids.long()][:, None] + err))
    return _near_compact(near, near_k)


def coalesce_intervals(left: np.ndarray, right: np.ndarray, gap: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge sorted disjoint intervals whose gaps are <= ``gap`` (gap offsets
    were pruned by a sound phase-1 bound, so they can only add guard-band
    rechecks, never answers)."""
    if left.size <= 1:
        return left, right
    starts = np.empty(left.size, bool)
    starts[0] = True
    starts[1:] = left[1:] - right[:-1] - 1 > gap
    first = np.flatnonzero(starts)
    return left[first], np.maximum.reduceat(right, first)


def pack_regions(left: np.ndarray, right: np.ndarray, n: int, length: int,
                 m_per_region: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split candidate intervals into fixed-M region rows: region b covers
    window offsets starts[b] + [valid_from[b], valid_to[b]); starts are
    clamped so [start, start + M + L - 1) stays inside the data."""
    m = m_per_region
    sizes = right - left + 1
    pieces = (sizes + m - 1) // m
    total = int(pieces.sum())
    rep_left = np.repeat(left, pieces)
    rep_right = np.repeat(right, pieces)
    offs = np.concatenate(([0], np.cumsum(pieces)[:-1]))
    within = (np.arange(total) - np.repeat(offs, pieces)) * m
    starts = rep_left + within
    ends = np.minimum(starts + m - 1, rep_right)  # inclusive last offset
    r_len = m + length - 1
    clamped = np.minimum(starts, n - r_len)
    clamped = np.maximum(clamped, 0)
    valid_from = starts - clamped
    valid_to = ends - clamped + 1
    return clamped.astype(np.int64), valid_from.astype(np.int64), valid_to.astype(np.int64)
