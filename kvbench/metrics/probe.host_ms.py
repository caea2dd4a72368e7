"""probe.host_ms (ms/query, layer probe): phase 1's host time, the program's
``kv.probe`` spans less the ``kv.probe.wait`` read-backs inside them, per
query."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: spans.host_ms(rec, "kv.probe")
                           - spans.host_ms(rec, "kv.probe.wait"))
