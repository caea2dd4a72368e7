"""probe.ms (ms/query, layer probe): the mean of the program's
QueryStats.t_phase1_ms over the window's queries (a batch's phase 1 split
over its queries)."""


def read(run):
    if not run.stats:
        return None
    return sum(s.t_phase1_ms for s in run.stats) / len(run.stats)
