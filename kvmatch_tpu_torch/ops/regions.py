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

from .ed import _gather

# f32 round-off amplification constant of the error bounds.
ERR_C = 64.0 * float(np.finfo(np.float32).eps)
# FFT correlation error coefficient: |corr_f32 - corr| <= FFT_ERR_C *
# ||x_window||_2 * ||q||_2 is what the guards assume.
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


def region_znorm_distances_multi(data, queries_hat, starts, qids,
                                 length: int, m_per_region: int):
    """Z-normalized squared ED (MASS form) with window mean/std and the
    error bound; each (B, M)."""
    r_len = m_per_region + length - 1
    x = _gather(data, starts, r_len)
    corr = _correlate_grouped(x, queries_hat[qids.long()])
    inv_l = float(np.float32(1.0 / length))
    s1 = _sliding_sum_rows(x, length)
    s2 = _sliding_sum_rows(x * x, length)
    mean = s1 * inv_l
    var = torch.clamp_min(s2 * inv_l - mean * mean, 0.0)
    std = torch.sqrt(var)
    safe = torch.where(std > 0, std, 1.0)
    two_l = float(np.float32(2.0 * length))
    d2 = torch.clamp_min(two_l - 2.0 * corr / safe, 0.0)
    d2 = torch.where(std > 0, d2, torch.inf)
    err = (2.0 * FFT_ERR_C * torch.sqrt(torch.clamp_min(s2, 0.0) * length)
           + ERR_C * two_l) / safe
    return d2, mean, std, err


def _near_compact(near: torch.Tensor, near_k: int):
    """(count, rows, cols) of the True cells of a 2-D mask in ascending
    row-major order, at most ``near_k`` of them; callers read [:count] and
    fall back when count > near_k (the contract of the JAX _near_compact)."""
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
