"""The program's own span records in a traced window.

While a profiler records, each request of the program keeps a list of span
records and attaches it to every ``QueryStats`` of the request as
``trace``: dicts with ``name``, ``parent`` (-1 for the root ``kv.query``),
``start_ns`` and ``end_ns`` (``time.time_ns()``, the device trace's clock),
``device_ms`` (the elapsed time between the CUDA events of the span's
device legs, idle between their launches included, or None).  The readers
of the ``kv.*`` metrics read each window request's list once, through
``per_query``.  A program that keeps no records gives
them nothing to read, and they return None.
"""

from __future__ import annotations


def records(run) -> list:
    """Each window request's list of span records (those that have one)."""
    out = []
    for r in run.requests:
        rec = getattr(r["res"][0].stats, "trace", None) if r["res"] else None
        if rec:
            out.append(rec)
    return out


def per_query(run, value):
    """The sum over the window's requests of ``value(records)``, divided by
    the window's queries (a request's time split over its queries); None
    when no request has records or every ``value`` is None."""
    vals = [value(rec) for rec in records(run)]
    vals = [v for v in vals if v is not None]
    if not vals or not run.n_queries:
        return None
    return sum(vals) / run.n_queries


def host_ms(rec: list, name: str) -> float:
    """Summed host milliseconds of the spans ``name``."""
    return sum(s["end_ns"] - s["start_ns"] for s in rec
               if s["name"] == name) / 1e6


def device_ms(rec: list, name: str):
    """Summed device milliseconds of the spans ``name``, or None when none
    has any (on the CPU)."""
    vals = [s["device_ms"] for s in rec
            if s["name"] == name and s["device_ms"] is not None]
    return sum(vals) if vals else None


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint pairs."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        elif hi > lo:
            out.append([lo, hi])
    return out


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
