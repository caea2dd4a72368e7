"""Sliding-window primitives in PyTorch (port of kvmatch_tpu/ops/sliding.py).

Same log-depth doubling as the JAX package: power-of-two window sums, each one
shifted add of the previous, then the binary decomposition of the width summed
from the largest piece down.  Every output element is produced by exactly the
same f32 additions in the same order as in JAX, so bucket ids are
bit-identical between the two packages (tests/test_torch_sliding.py).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _unit_sliding_sum(x: torch.Tensor, u: int) -> torch.Tensor:
    """S[i] = sum(x[i:i+u]) for i in [0, n-u]; length n-u+1."""
    n = x.shape[0]
    pow_sums = {1: x}
    width = 1
    while width * 2 <= u:
        s = pow_sums[width]
        pow_sums[width * 2] = s[: n - 2 * width + 1] + s[width: n - width + 1]
        width *= 2
    out_len = n - u + 1
    acc = None
    offset, rem = 0, u
    for w in sorted(pow_sums, reverse=True):
        if rem >= w:
            piece = pow_sums[w][offset: offset + out_len]
            acc = piece if acc is None else acc + piece
            offset += w
            rem -= w
    return acc


def sliding_sums(data: torch.Tensor, scales: Sequence[int]
                 ) -> Dict[int, torch.Tensor]:
    """Window sums for every scale from one base pass; scales must be
    multiples of the smallest.  out[w][i] = sum(data[i:i+w]), length n-w+1."""
    scales = sorted(scales)
    u = scales[0]
    n = data.shape[0]
    base = _unit_sliding_sum(data, u)
    pow_sums = {1: base}
    max_k = scales[-1] // u
    k = 1
    while k * 2 <= max_k:
        s = pow_sums[k]
        step = k * u
        m = n - 2 * k * u + 1
        pow_sums[k * 2] = s[:m] + s[step: step + m]
        k *= 2
    out = {}
    for w in scales:
        kk = w // u
        out_len = n - w + 1
        acc = None
        offset, rem = 0, kk
        for p in sorted(pow_sums, reverse=True):
            if rem >= p:
                piece = pow_sums[p][offset: offset + out_len]
                acc = piece if acc is None else acc + piece
                offset += p * u
                rem -= p
        out[w] = acc
    return out


def bucketize_means(window_sums: torch.Tensor, w: int, pos_of_d: int
                    ) -> torch.Tensor:
    """int32 mean-bucket ids: 2*floor(mean*s) + (frac >= 0.5), with the same
    f32 constant scale/w as the JAX package."""
    c = float(np.float32(10.0 ** (pos_of_d - 1)) / np.float32(w))
    v = window_sums * c
    fl = torch.floor(v)
    half = (v - fl >= 0.5).to(torch.int32)
    return 2 * fl.to(torch.int32) + half


def build_buckets(data: torch.Tensor, scales: Tuple[int, ...], pos_of_d: int
                  ) -> Dict[int, torch.Tensor]:
    """data -> per-scale int32 bucket ids for every window start."""
    sums = sliding_sums(data, scales)
    return {w: bucketize_means(s, w, pos_of_d) for w, s in sums.items()}


def _forward_extreme(x: torch.Tensor, L: int, op) -> torch.Tensor:
    """out[i] = op-reduce(x[i:i+L]) by doubling; two overlapping power-of-two
    windows cover [0, L) at the end (min/max are idempotent)."""
    n = x.shape[0]
    pow_ = {1: x}
    w = 1
    while w * 2 <= L:
        s = pow_[w]
        pow_[w * 2] = op(s[: n - 2 * w + 1], s[w: n - w + 1])
        w *= 2
    out_len = n - L + 1
    s = pow_[w]
    return op(s[:out_len], s[L - w: L - w + out_len])


def sliding_window_stats_fwd(x: torch.Tensor, L: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Width-L window (sum, sum of squares, min, max), each length n-L+1."""
    s1 = _unit_sliding_sum(x, L)
    s2 = _unit_sliding_sum(x * x, L)
    lo = _forward_extreme(x, L, torch.minimum)
    hi = _forward_extreme(x, L, torch.maximum)
    return s1, s2, lo, hi


def sliding_min_max(data: torch.Tensor, radius: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-clamped Lemire envelope of the series: lo[i] = min(data[i-r :
    i+r+1]), hi[i] = max(...), the window cut at both ends (the XLA
    ``reduce_window`` of kvmatch_tpu/ops/sliding.py:147-157).  Min and max
    are exact, so the result is bit-identical to JAX's; max pooling pads
    with -inf, which never wins, and the minimum is the pooled maximum of
    the negated series."""
    if radius <= 0:
        return data.clone(), data.clone()
    k = 2 * radius + 1
    x = data[None, None, :]
    hi = torch.nn.functional.max_pool1d(x, k, stride=1, padding=radius)
    lo = torch.nn.functional.max_pool1d(-x, k, stride=1, padding=radius)
    return (-lo)[0, 0], hi[0, 0]
