"""Mean-bucket rounding -- the "row key" arithmetic of the KV-index.

A copy of the functions of kvmatch_tpu/utils/rounding.py that the port calls
(the reference's key semantics, MeanIntervalUtils.java:51-114):

* ``to_round(x)``        floors a mean onto the d-grid (d = 0.5 * 10^(1-pos_of_d)):
                         1.9 -> 1.5, 1.4 -> 1.0, -1.9 -> -2.0 for d=0.5.
* ``snap_down(x, keys)`` stats-aware round: the largest existing index key <= round(x)
                         (MeanIntervalUtils.java:70-80; returns round-10000 below all keys).
* ``bucket_id``, ``bucket_to_key``: the integer bucket of a mean and back.

All functions are NumPy-vectorized and work on scalars or arrays.
"""

from __future__ import annotations

import numpy as np

_OUT_OF_RANGE = 10000.0


def to_round(value, pos_of_d: int = 2):
    """Floor onto the d-grid, matching MeanIntervalUtils.toRound exactly."""
    scale = 10.0 ** (pos_of_d - 1)
    v = np.asarray(value, dtype=np.float64) * scale
    iv = np.floor(v)
    ret = np.where(v - iv >= 0.5, iv + 0.5, iv)
    return ret / scale


def snap_down(value, keys: np.ndarray, pos_of_d: int = 2):
    """Largest existing key <= to_round(value); value-10000 if below all keys.

    ``keys`` must be sorted ascending (the index's row keys).
    """
    rounded = np.asarray(to_round(value, pos_of_d))
    if keys.size == 0:
        return rounded - _OUT_OF_RANGE
    # searchsorted 'right' - 1 gives the last key <= rounded.
    idx = np.searchsorted(keys, rounded, side="right") - 1
    out = np.where(idx >= 0, keys[np.maximum(idx, 0)], rounded - _OUT_OF_RANGE)
    return out


def bucket_id(value, pos_of_d: int = 2):
    """Integer bucket id = round(value) / d, suitable as an int32 device-side key.

    bucket_id * d == to_round(value) exactly for the grid widths used here.
    """
    scale = 10.0 ** (pos_of_d - 1)
    v = np.asarray(value, dtype=np.float64) * scale
    iv = np.floor(v)
    half = (v - iv >= 0.5).astype(np.int64)
    return (2 * iv.astype(np.int64) + half)  # in units of d = 1/(2*scale)


def bucket_to_key(bucket, pos_of_d: int = 2):
    """Inverse of bucket_id: lower edge of the bucket as float64."""
    scale = 10.0 ** (pos_of_d - 1)
    return np.asarray(bucket, dtype=np.float64) * 0.5 / scale
