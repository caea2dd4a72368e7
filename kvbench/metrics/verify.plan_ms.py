"""verify.plan_ms (ms/query, layer verify): phase 2's routing and packing on
the host (interval sums, coalescing, region packing, the gather route's
prefilters), the program's ``kv.verify.plan`` spans, per query."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: spans.host_ms(rec,
                                                          "kv.verify.plan"))
