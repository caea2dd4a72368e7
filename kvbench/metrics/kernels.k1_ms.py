"""kernels.k1_ms (ms/query, layer kernels): the device time of K1, the
dense probe (csrc/probe.cu: probe_flags_kernel), in the traced window,
divided by the window's queries."""

K1 = "probe_flags_kernel"


def read(run):
    if not run.device_events or not run.n_queries:
        return None
    t = run.device_time_s(lambda name: K1 in name)
    if t <= 0:
        return None
    return t * 1e3 / run.n_queries
