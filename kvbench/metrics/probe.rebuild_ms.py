"""probe.rebuild_ms (ms/query, layer probe): the device elapsed time of the
dense probe's per-block rebuilds, between the CUDA events of the
program's ``kv.probe.rebuild`` spans (parallel/query.py:
dense_probe_flags: each PROBE_BLOCK's bucket windows and window
statistics, made again for every query group when the cached tables do
not fit the device's memory budget), per query.  A program without the
span gives nothing to read."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: spans.device_ms(
        rec, "kv.probe.rebuild"))
