"""Frozen copy of the eps rule of ``kvmatch_tpu_torch/selectivity.py:
calibrate``: a query's eps for ``target`` answers is the square root of
the middle of the gap between the target-th and the next smallest squared
distance of its profile, or a flat 2% past the last finite one when fewer
windows are admissible.  ``kvbench/tests/test_kvbench_frozen.py`` holds it
equal to its source.
"""

from __future__ import annotations

import numpy as np


def eps_for_target(ds: np.ndarray, target: int) -> float:
    """eps for ``target`` answers from ``ds``, a query's smallest squared
    distances in ascending order (non-finite where inadmissible)."""
    fin = ds[np.isfinite(ds)]
    kk = min(target, fin.size)
    lo = fin[kk - 1]
    hi = fin[kk] if kk < fin.size else lo * 1.02 + 1e-3
    return float(np.sqrt((lo + hi) / 2.0))
