"""Brute-force float64 oracles of RSM-ED and cNSM-ED, in PyTorch.

The same semantics as ``kvmatch_tpu/oracle.py`` (``rsm_ed``, ``nsm_ed``):
an offset is an answer iff its distance^2 <= epsilon^2; window mean/std come
from float64 prefix sums; distances are returned square-rooted.  The O(n L)
distance work runs in float64 on ``device`` over chunks of the series'
window view, so a card checks n=1e6, L=8192 in about a second.  It shares
no code with the engines it checks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import backend


def sliding_mean_std(data: np.ndarray, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Population mean/std of every length-w window, float64 cumsum based."""
    c1 = np.concatenate(([0.0], np.cumsum(data, dtype=np.float64)))
    c2 = np.concatenate(([0.0], np.cumsum(data.astype(np.float64) ** 2)))
    mean = (c1[w:] - c1[:-w]) / w
    var = np.maximum((c2[w:] - c2[:-w]) / w - mean * mean, 0.0)
    return mean, np.sqrt(var)


def _chunk_rows(device: torch.device, L: int) -> int:
    # 512 MB of f64 per temporary on a card, 32 MB on the CPU.
    return max(1, (1 << (26 if device.type == "cuda" else 22)) // L)


def _d2(data: np.ndarray, ref: np.ndarray, rows: np.ndarray, device,
        mean: np.ndarray | None = None, std: np.ndarray | None = None
        ) -> np.ndarray:
    """Squared ED of ``ref`` against the windows at ``rows``; z-normalized
    windows when ``mean``/``std`` (per row) are given."""
    device = backend.resolve_device(device)
    L = ref.size
    win = torch.as_tensor(data, dtype=torch.float64,
                          device=device).unfold(0, L, 1)
    q = torch.as_tensor(ref, dtype=torch.float64, device=device)
    out = np.empty(rows.size)
    step = _chunk_rows(device, L)
    for s in range(0, rows.size, step):
        idx = torch.as_tensor(rows[s:s + step], device=device)
        x = win[idx]
        if mean is not None:
            mu = torch.as_tensor(mean[s:s + step], device=device)[:, None]
            sd = torch.as_tensor(std[s:s + step], device=device)[:, None]
            x = (x - mu) / sd
        out[s:s + step] = (x - q).square().sum(dim=1).cpu().numpy()
    return out


def rsm_ed(data: np.ndarray, query: np.ndarray, epsilon: float, device=None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """RSM-ED: every offset with raw Euclidean distance <= epsilon."""
    data = np.asarray(data, np.float64)
    query = np.asarray(query, np.float64)
    d2 = _d2(data, query, np.arange(data.size - query.size + 1), device)
    offs = np.flatnonzero(d2 <= epsilon * epsilon)
    return offs, np.sqrt(d2[offs])


def nsm_ed(data: np.ndarray, query: np.ndarray, epsilon: float,
           alpha: float | None = None, beta: float | None = None,
           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """NSM/cNSM-ED: z-normalized Euclidean distance, with the cNSM
    constraints |mu_T - mu_Q| <= beta and 1/alpha <= sigma_T/sigma_Q <= alpha
    when ``alpha`` is given."""
    data = np.asarray(data, np.float64)
    query = np.asarray(query, np.float64)
    mean_q = query.mean()
    std_q = np.sqrt(np.maximum((query * query).mean() - mean_q * mean_q, 0.0))
    zq = (query - mean_q) / std_q
    mean_t, std_t = sliding_mean_std(data, query.size)
    ok = std_t > 0
    if alpha is not None:
        ratio = std_t / std_q
        ok &= (np.abs(mean_t - mean_q) <= beta) & (ratio <= alpha) & \
              (ratio >= 1.0 / alpha)
    cand = np.flatnonzero(ok)
    d2 = _d2(data, zq, cand, device, mean_t[cand], std_t[cand])
    keep = d2 <= epsilon * epsilon
    return cand[keep], np.sqrt(d2[keep])


def _dtw_chunk_rows(device: torch.device, L: int, lanes: int) -> int:
    # On a card: 2 GB of f64 windows and 256 MB per carry; 32 MB on the CPU.
    if device.type == "cuda":
        return max(1, min((1 << 28) // L, (1 << 25) // lanes))
    return max(1, (1 << 22) // (L + lanes))


def _anti_diagonal_dtw(x: torch.Tensor, q: torch.Tensor, r: int
                       ) -> torch.Tensor:
    """Banded DTW d^2 of each row of ``x`` (c, L) against ``q`` (L,), by the
    anti-diagonal recurrence D_s[k] = d + min(D_{s-1}[k-1], D_{s-1}[k+1],
    D_{s-2}[k]) over band lanes k = j - i + r.  Diagonal s holds cells only
    on lanes with s + r - k even, and those read only lanes of their own
    class, so each parity class is one carry: even lanes k = 2m in ``ev``
    (r + 1), odd lanes k = 2m + 1 in ``od`` (r, kept with an inf lane on
    each side).  Dead cells hold inf."""
    c, L = x.shape
    inf = float("inf")
    ev = torch.full((c, r + 1), inf, dtype=x.dtype, device=x.device)
    od = torch.full((c, r + 2), inf, dtype=x.dtype, device=x.device)
    if r % 2 == 0:              # D_{-2}: lane r seeds cell (0, 0)
        ev[:, r // 2] = 0.0
    else:
        od[:, 1 + r // 2] = 0.0
    pad = r + 2
    # xr[:, pad + L - 1 - i] = x[:, i]; qp[:, pad + j] = q[j]
    xr = torch.nn.functional.pad(x.flip(1), (pad, pad))
    qp = torch.nn.functional.pad(q, (pad, pad))
    for s in range(2 * L - 1):
        p = (s + r) % 2
        n = r + 1 - p                  # lanes of this class
        h = (s + r - p) // 2           # i of its lane m = 0: i = h - m
        a = xr[:, pad + L - 1 - h: pad + L - 1 - h + n]
        b = qp[pad + s - h: pad + s - h + n]
        d = (a - b).square_()
        if p == 0:
            m = torch.minimum(od[:, :-1], od[:, 1:])
            torch.minimum(m, ev, out=m)
        else:
            m = torch.minimum(ev[:, :-1], ev[:, 1:])
            torch.minimum(m, od[:, 1:-1], out=m)
        d.add_(m)
        # lanes whose cell lies outside the matrix: 0 <= i, j < L
        lo = max(0, h - L + 1, h - s)
        hi = min(n - 1, h, L - 1 - s + h)
        if lo > 0:
            d[:, :lo] = inf
        if hi < n - 1:
            d[:, hi + 1:] = inf
        if p == 0:
            ev = d
        else:
            od[:, 1:-1] = d
    return (ev[:, r // 2] if r % 2 == 0 else od[:, 1 + r // 2])


def _dtw_d2(data: np.ndarray, ref: np.ndarray, rows: np.ndarray, rho: int,
            device, mean: np.ndarray | None = None,
            std: np.ndarray | None = None) -> np.ndarray:
    """Banded DTW d^2 of ``ref`` against the windows at ``rows`` in float64;
    z-normalized windows when ``mean``/``std`` (per row) are given."""
    device = backend.resolve_device(device)
    L = ref.size
    r = min(rho, L - 1)
    win = torch.as_tensor(data, dtype=torch.float64,
                          device=device).unfold(0, L, 1)
    q = torch.as_tensor(ref, dtype=torch.float64, device=device)
    out = np.empty(rows.size)
    step = _dtw_chunk_rows(device, L, r + 1)
    for s in range(0, rows.size, step):
        x = win[torch.as_tensor(rows[s:s + step], device=device)]
        if mean is not None:
            mu = torch.as_tensor(mean[s:s + step], device=device)[:, None]
            sd = torch.as_tensor(std[s:s + step], device=device)[:, None]
            x = (x - mu) / sd
        out[s:s + step] = _anti_diagonal_dtw(x, q, r).cpu().numpy()
    return out


def rsm_dtw(data: np.ndarray, query: np.ndarray, epsilon: float, rho: int,
            device=None) -> Tuple[np.ndarray, np.ndarray]:
    """RSM-DTW: every offset whose banded DTW (Sakoe-Chiba radius ``rho``)
    on raw values is within epsilon."""
    data = np.asarray(data, np.float64)
    query = np.asarray(query, np.float64)
    d2 = _dtw_d2(data, query, np.arange(data.size - query.size + 1), rho,
                 device)
    offs = np.flatnonzero(d2 <= epsilon * epsilon)
    return offs, np.sqrt(d2[offs])


def cnsm_dtw(data: np.ndarray, query: np.ndarray, epsilon: float, rho: int,
             alpha: float, beta: float, device=None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """cNSM-DTW: the cNSM constraints on window mean/std, banded DTW on
    z-normalized values."""
    data = np.asarray(data, np.float64)
    query = np.asarray(query, np.float64)
    mean_q = query.mean()
    std_q = np.sqrt(np.maximum((query * query).mean() - mean_q * mean_q, 0.0))
    zq = (query - mean_q) / std_q
    mean_t, std_t = sliding_mean_std(data, query.size)
    ratio = std_t / std_q
    ok = ((std_t > 0) & (np.abs(mean_t - mean_q) <= beta)
          & (ratio <= alpha) & (ratio >= 1.0 / alpha))
    cand = np.flatnonzero(ok)
    d2 = _dtw_d2(data, zq, cand, rho, device, mean_t[cand], std_t[cand])
    keep = d2 <= epsilon * epsilon
    return cand[keep], np.sqrt(d2[keep])
