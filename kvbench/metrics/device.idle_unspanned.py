"""device.idle_unspanned (%, layer device): the share of the window's device
idle time (the gaps in the union of the device's activity inside the
window) that no span of the program other than the root ``kv.query``
covers: idle that the program's spans cannot name."""

from kvbench import spans


def read(run):
    if not run.device_events:
        return None
    recs = spans.records(run)
    if not recs:
        return None
    b0, b1 = run.window_ns
    busy = spans.union((max(s, b0), min(t, b1))
                       for _, s, t in run.device_events if t > b0 and s < b1)
    gaps, end = [], b0
    for lo, hi in busy:
        if lo > end:
            gaps.append([end, lo])
        end = max(end, hi)
    if b1 > end:
        gaps.append([end, b1])
    idle = sum(hi - lo for lo, hi in gaps)
    if idle <= 0:
        return None
    named = spans.union((s["start_ns"], s["end_ns"]) for rec in recs
                        for s in rec if s["parent"] != -1)
    return 100.0 * (idle - spans.overlap(gaps, named)) / idle
