"""Frozen copy of the device-busy union of ``chip_smoke.py:profile_batch``:
the length of the union of device activity intervals, each clipped to the
window [b0, b1].  The idle share is 1 - busy / (b1 - b0).
``kvbench/tests/test_kvbench_frozen.py`` holds it equal to its source.
"""

from __future__ import annotations


def busy_union(intervals, b0, b1):
    """Length of the union of ``intervals`` ((start, end) pairs) inside
    [b0, b1], in their unit."""
    busy, end = 0.0, b0
    for lo, hi in sorted((max(lo, b0), min(hi, b1)) for lo, hi in intervals):
        if hi > max(lo, end):
            busy += hi - max(lo, end)
            end = hi
    return busy
