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
* ``span``, ``request``, ``fetch`` — the engines' own spans, the port's with
  no JAX counterpart.  They record only while a torch profiler records (in
  ``trace`` or any other ``torch.profiler.profile``); otherwise each is one
  ``torch.autograd._profiler_enabled()`` check.  A span enters
  ``record_function(name)``, so it nests over its kernels in the profiler's
  trace, and appends a record to the current request's: a dict of ``name``,
  ``parent`` (the index of the enclosing span's record, -1 for the root),
  ``start_ns`` and ``end_ns`` (``time.time_ns()``, the clock of the
  profiler's trace) and ``device_ms`` (None on the CPU).  A span's device
  legs bracket its launches with two CUDA events each; ``device_ms`` sums
  their elapsed times, which count any idle of the card between the
  launches of a leg.  ``request`` opens the root ``kv.query`` and yields
  the request's list of records, which the engines attach to every
  ``QueryStats`` of the request as ``trace``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

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


# ------------------------------------------------------------------- spans
_enabled = torch.autograd._profiler_enabled
_REQUEST = contextvars.ContextVar("kvmatch_tpu_torch_request", default=None)


class _Request:
    """The records of one request, its open spans and its device legs
    (record index, start event, end event) to resolve at its end."""

    __slots__ = ("spans", "stack", "legs")

    def __init__(self):
        self.spans, self.stack, self.legs = [], [], []

    def open(self, name: str) -> int:
        self.spans.append(dict(name=name,
                               parent=self.stack[-1] if self.stack else -1,
                               start_ns=time.time_ns(), end_ns=None,
                               device_ms=None))
        self.stack.append(len(self.spans) - 1)
        return self.stack[-1]

    def close(self) -> None:
        self.spans[self.stack.pop()]["end_ns"] = time.time_ns()

    def resolve(self) -> None:
        """Each leg's elapsed time into its record's ``device_ms``.  The
        request's read-backs have already waited for every leg, so the
        end events are complete and this waits for nothing."""
        for i, e0, e1 in self.legs:
            e1.synchronize()
            rec = self.spans[i]
            rec["device_ms"] = (rec["device_ms"] or 0.0) + e0.elapsed_time(e1)
        self.legs.clear()


class _Off:
    """The span while no profiler records: every method does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def device(self, dev):
        return _NULL


_OFF = _Off()
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_rf", "_req", "_idx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._req = _REQUEST.get()
        if self._req is not None:
            self._idx = self._req.open(self.name)
        return self

    def __exit__(self, *exc):
        if self._req is not None:
            self._req.close()
        self._rf.__exit__(*exc)
        return False

    def device(self, dev):
        """A device leg: the launches inside it, bracketed by two CUDA
        events on ``dev``'s current stream, add to ``device_ms``.  Nothing
        on the CPU."""
        if self._req is None or dev is None or dev.type != "cuda":
            return _NULL
        return _Leg(self._req, self._idx, dev)


class _Leg:
    __slots__ = ("req", "idx", "stream", "e0")

    def __init__(self, req: _Request, idx: int, dev):
        self.req, self.idx = req, idx
        self.stream = torch.cuda.current_stream(dev)

    def __enter__(self):
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record(self.stream)

    def __exit__(self, *exc):
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(self.stream)
        self.req.legs.append((self.idx, self.e0, e1))
        return False


def span(name: str):
    """A span of the current request (see the module docstring); a no-op
    unless a profiler records."""
    return _Span(name) if _enabled() else _OFF


class _Root(_Span):
    __slots__ = ("_token",)

    def __enter__(self):
        self._token = None
        if _REQUEST.get() is None:
            self._token = _REQUEST.set(_Request())
        super().__enter__()
        return self._req.spans

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._token is not None:
            _REQUEST.reset(self._token)
            self._req.resolve()
        return False


def request():
    """The root span ``kv.query`` of one request: yields the request's list
    of records (None unless a profiler records).  Inside another request it
    is a span of that one."""
    return _Root("kv.query") if _enabled() else _NULL


def fetch(name: str, *tensors):
    """Read ``tensors`` back as numpy arrays: one blocking read-back, a
    ``name`` span while a profiler records."""
    with span(name):
        return tuple(t.cpu().numpy() for t in tensors)
