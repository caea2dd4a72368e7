"""probe.cons_ms (ms/query, layer probe): the device elapsed time of the
alpha/beta constraint AND of the dense probe, between the two CUDA events
of the program's ``kv.probe.cons`` span (parallel/query.py:
dense_probe_flags), per query.  It counts the card's idle between the
AND's launches too: on an H100 in the cnsm_ed cells, 1-4% above the busy
time of the kernels the span launches."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: spans.device_ms(rec,
                                                            "kv.probe.cons"))
