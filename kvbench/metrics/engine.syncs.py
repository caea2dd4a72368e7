"""engine.syncs (read-backs/query, layer engine): the blocking read-backs
from the device, the program's ``kv.*.wait`` spans, per query."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: sum(
        s["name"].startswith("kv.") and s["name"].endswith(".wait")
        for s in rec))
