"""Carry serving state across packages: indexes and the resident series.

``index_from_arrays`` builds the port's own ``IndexScale``s from any object
that maps window widths to scales with the fields of the JAX package's index
(kvmatch_tpu/index/structure.py: ``w, n, keys, row_ptr, left, right,
cum_intervals, cum_offsets, mean_upper_bound, stats_only``), read as numpy
arrays, so one index built by either package drives the other.
``series_to_device`` makes the port's pair of series copies: the f64 host
shadow used by the exact confirms and the f32 device tensor used by the
probe and phase 2 (the split of kvmatch_tpu/engine/base.py:119-145).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .index.structure import Index, IndexScale


def index_from_arrays(index) -> Index:
    """The port's index holding numpy copies of ``index``'s scales."""
    out: Index = {}
    for w, sc in index.items():
        stats_only = bool(sc.stats_only)
        out[int(w)] = IndexScale(
            w=int(sc.w), n=int(sc.n), keys=np.asarray(sc.keys),
            row_ptr=np.asarray(sc.row_ptr),
            left=None if stats_only else np.asarray(sc.left),
            right=None if stats_only else np.asarray(sc.right),
            cum_intervals=np.asarray(sc.cum_intervals),
            cum_offsets=np.asarray(sc.cum_offsets),
            mean_upper_bound=float(sc.mean_upper_bound),
            stats_only=stats_only)
    return out


def series_to_device(data, device) -> Tuple[np.ndarray, torch.Tensor]:
    """(f64 host shadow, f32 tensor on ``device``) of a 1-D series."""
    host = np.ascontiguousarray(np.asarray(data, np.float64))
    if host.ndim != 1:
        raise ValueError(f"series must be 1-D, got shape {host.shape}")
    dev = torch.as_tensor(host.astype(np.float32), device=device)
    return host, dev
