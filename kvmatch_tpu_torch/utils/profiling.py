"""Observability: per-query stats export, cost-model fitting, device tracing.

A copy of kvmatch_tpu/utils/profiling.py, its ``trace`` on torch.profiler.
Covers the reference's cross-cutting subsystems (SURVEY.md section 5):

* ``StatsWriter`` — CSV appender for QueryStats rows, the structured replacement
  for the static StatisticWriter (statistic/StatisticWriter.java:28-70).
* ``fit_cost_model`` — re-fits the phase-2 time model t2 = a*#windows +
  b*#offsets/1e5*L on THIS hardware.  The reference ships coefficients fitted on
  its lab machine (QueryEngine.java:55-57) and says to re-fit by hand; here it is
  one function over a sample workload, returning an updated QueryConfig.  It
  times each query alone (``engine.query``), where the JAX package's times a
  batch: the port's ``query_batch`` shares one phase-2 time among the batch.
* ``trace`` — context manager around torch.profiler for device-level traces
  (``QueryConfig.h100_tuned`` holds the constants ``fit_cost_model`` fitted on
  the card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from pathlib import Path

import numpy as np

from ..config import QueryConfig


class StatsWriter:
    """Append QueryStats rows to a CSV (one header, flushed per write)."""

    FIELDS = ("t_total_ms", "t_phase1_ms", "t_phase2_ms", "n_candidates", "n_disjoint",
              "n_answers", "n_scans", "n_segments_used", "n_device_checked",
              "n_host_rechecked", "early_terminated")

    def __init__(self, path):
        self.path = Path(path)
        if not self.path.exists():
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(",".join(("label",) + self.FIELDS) + "\n")

    def write(self, label: str, stats) -> None:
        row = [str(label)] + [str(getattr(stats, f)) for f in self.FIELDS]
        with open(self.path, "a") as f:
            f.write(",".join(row) + "\n")
            f.flush()


def fit_cost_model(engine, queries: np.ndarray, epsilon, repeats: int = 1,
                   **params) -> QueryConfig:
    """Measure phase-2 time against (#disjoint windows, #offsets*L) on real
    hardware and return a QueryConfig with re-fitted coefficients.

    Least squares on t2 ~= a * n_windows + b * n_offsets/1e5 * L + c,
    mirroring the reference's fitted model shape (QueryEngine.java:316-327).
    Each query runs alone through ``engine.query``: ``query_batch`` times
    phase 2 once for the whole batch and gives every query the same share,
    which leaves the slopes nothing to fit.  Give it at least as many
    queries as unknowns (three), with candidate counts that differ."""
    rows = []
    t2s = []
    for _ in range(repeats):
        for q in queries:
            s = engine.query(q, epsilon, **params).stats
            # n_candidates counts offsets.
            rows.append([max(s.n_disjoint, 1),
                         s.n_candidates / 1e5 * queries.shape[1],
                         1.0])
            t2s.append(s.t_phase2_ms)
    A = np.asarray(rows)
    t = np.asarray(t2s)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    a, b = float(max(coef[0], 0.0)), float(max(coef[1], 0.0))
    c = float(max(coef[2], 0.0))
    # On a device the per-offset cost is tiny and a fixed launch cost dominates —
    # the intercept keeps the early-termination comparison honest
    # (QueryEngine.java:316-327 has no intercept because serial Java has no
    # launch floor).
    if getattr(engine, "use_dtw_cost_model", False):
        return dataclasses.replace(engine.qcfg, phase2_cost_a_dtw=a,
                                   phase2_cost_b_dtw=b, phase2_cost_intercept=c)
    return dataclasses.replace(engine.qcfg, phase2_cost_a=a, phase2_cost_b=b,
                               phase2_cost_intercept=c)


#: Where ``trace`` writes when no directory is given: build/trace at the
#: repository root (gitignored).
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


@contextlib.contextmanager
def trace(log_dir=None):
    """Device-level profiling around a block::

        with trace() as prof:
            engine.query(...)

    Yields the ``torch.profiler.profile`` (CPU activity, and CUDA when a
    card is present), whose ``events()`` the caller may read after the
    block; on exit writes its Chrome trace (chrome://tracing, Perfetto) to
    ``prof.trace_file`` under ``log_dir`` (default ``TRACE_DIR``) — the deep
    replacement for the reference's wall-clock phase timers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir) if log_dir is not None else TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.trace_file = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_file))
