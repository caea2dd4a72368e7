"""engine.other_ms (ms/query, layer engine): the mean over the window's
queries of t_total_ms - t_phase1_ms - t_phase2_ms of the program's
QueryStats: planning, candidate assembly and the ordering of results."""


def read(run):
    if not run.stats:
        return None
    return sum(s.t_total_ms - s.t_phase1_ms - s.t_phase2_ms
               for s in run.stats) / len(run.stats)
