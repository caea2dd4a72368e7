"""Carry serving state across packages: indexes and the resident series.

``index_from_arrays`` builds the port's own ``IndexScale``s from any object
that maps window widths to scales with the fields of the JAX package's index
(kvmatch_tpu/index/structure.py: ``w, n, keys, row_ptr, left, right,
cum_intervals, cum_offsets, mean_upper_bound, stats_only``), read as numpy
arrays, so one index built by either package drives the other.
``series_to_device`` makes the port's pair of series copies: the f64 host
shadow used by the exact confirms and the f32 device tensor used by the
probe and phase 2 (the split of kvmatch_tpu/engine/base.py:119-145);
``host_series`` the host copy alone, which a streamed engine keeps in f32
when it is given f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .index.structure import Index, IndexScale


def index_from_arrays(index) -> Index:
    """The port's index holding numpy copies of ``index``'s scales.  A scale
    whose intervals live on its device (the JAX package's full device build)
    is read through its lazy ``left``/``right`` fields, which copy them to
    the host; its position-sorted view comes along when that copy made one."""
    out: Index = {}
    for w, sc in index.items():
        stats_only = bool(sc.stats_only)
        left = None if stats_only else np.asarray(sc.left)
        right = None if stats_only else np.asarray(sc.right)
        pos = getattr(sc, "_pos_sorted", None)
        out[int(w)] = IndexScale(
            w=int(sc.w), n=int(sc.n), keys=np.asarray(sc.keys),
            row_ptr=np.asarray(sc.row_ptr), left=left, right=right,
            cum_intervals=np.asarray(sc.cum_intervals),
            cum_offsets=np.asarray(sc.cum_offsets),
            mean_upper_bound=float(sc.mean_upper_bound),
            stats_only=stats_only,
            _pos_sorted=None if pos is None
            else tuple(np.asarray(a) for a in pos))
    return out


def host_series(data, keep_f32: bool = False) -> np.ndarray:
    """The host copy of a 1-D series: contiguous float64, or, with
    ``keep_f32``, an f32 series as it is (a streamed series larger than
    device memory keeps no f64 shadow; the exact confirms promote its values
    per window, as kvmatch_tpu/engine/base.py:119-127)."""
    data = np.asarray(data)
    if data.ndim != 1:
        raise ValueError(f"series must be 1-D, got shape {data.shape}")
    if keep_f32 and data.dtype == np.float32:
        return np.ascontiguousarray(data)
    return np.ascontiguousarray(data, dtype=np.float64)


def series_to_device(data, device) -> Tuple[np.ndarray, torch.Tensor]:
    """(f64 host shadow, f32 tensor on ``device``) of a 1-D series."""
    host = host_series(data)
    dev = torch.as_tensor(host.astype(np.float32), device=device)
    return host, dev
