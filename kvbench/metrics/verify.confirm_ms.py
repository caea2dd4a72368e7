"""verify.confirm_ms (ms/query, layer verify): the exact f64 recheck on the
host, the program's ``kv.verify.confirm`` spans, per query."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: spans.host_ms(
        rec, "kv.verify.confirm"))
