"""Carry serving state across packages: indexes and the resident series.

``index_from_jax`` turns an index built by the JAX package (whose scales may
hold a device-resident interval view, kvmatch_tpu/index/structure.py:46-82)
into one that holds only numpy arrays, so the same index can drive both
packages.  ``series_to_device`` makes the port's pair of series copies: the
f64 host shadow used by the exact confirms and the f32 device tensor used by
the probe and phase 2 (the split of kvmatch_tpu/engine/base.py:119-145).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kvmatch_tpu.index.structure import Index, IndexScale


def index_from_jax(index: Index) -> Index:
    """Numpy-only copy of ``index`` (device interval views materialized)."""
    out: Index = {}
    for w, sc in index.items():
        if sc.dev_pos_view is not None:
            sc.materialize_host()
        left = None if sc.stats_only else np.asarray(sc.left)
        right = None if sc.stats_only else np.asarray(sc.right)
        out[w] = IndexScale(
            w=sc.w, n=sc.n, keys=np.asarray(sc.keys),
            row_ptr=np.asarray(sc.row_ptr), left=left, right=right,
            cum_intervals=np.asarray(sc.cum_intervals),
            cum_offsets=np.asarray(sc.cum_offsets),
            mean_upper_bound=float(sc.mean_upper_bound),
            stats_only=sc.stats_only)
    return out


def series_to_device(data, device) -> Tuple[np.ndarray, torch.Tensor]:
    """(f64 host shadow, f32 tensor on ``device``) of a 1-D series."""
    host = np.ascontiguousarray(np.asarray(data, np.float64))
    if host.ndim != 1:
        raise ValueError(f"series must be 1-D, got shape {host.shape}")
    dev = torch.as_tensor(host.astype(np.float32), device=device)
    return host, dev
