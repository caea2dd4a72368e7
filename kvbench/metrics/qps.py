"""qps (queries/s): every query answered in the window over the window's
time, from its start to the end of its last request."""


def read(run):
    return run.n_queries / run.window_s
