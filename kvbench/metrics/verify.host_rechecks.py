"""verify.host_rechecks (rows/query, layer verify): the mean of the
program's QueryStats.n_host_rechecked, the windows confirmed in f64 on the
host, over the window's queries."""


def read(run):
    if not run.stats:
        return None
    return sum(s.n_host_rechecked for s in run.stats) / len(run.stats)
