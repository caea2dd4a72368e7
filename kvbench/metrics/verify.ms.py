"""verify.ms (ms/query, layer verify): the mean of the program's
QueryStats.t_phase2_ms over the window's queries (a batch's phase 2 split
over its queries)."""


def read(run):
    if not run.stats:
        return None
    return sum(s.t_phase2_ms for s in run.stats) / len(run.stats)
