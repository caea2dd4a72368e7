"""The benchmark of ``kvmatch_tpu_torch``, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its file holds the
series' size, the engine class, the query length and parameters, the
reference's semantics and the limits of the check) and a traffic mix (``traffic/<name>.json``: the entry,
the batch size, the answers a query is calibrated to, the pool of queries,
the queries checked besides the window's, the warm-up).  A per-layer metric is
``metrics/<name>.py``, whose ``read(run)`` returns a number or None; so is
an end-to-end metric (``qps``, ``p95_ms``, ``setup_s``).  So a
new cell, configuration or metric is new files and new entries, never an
edit here.

One run of a cell:

1. set-up (``setup_s`` from process start): the series (the frozen
   generator, the configuration's ``series_seed``), the pool of
   self-queries (the traffic's ``pool_seed``) cut into fixed batches, the
   queries checked besides them (drawn from ``--seed``), each query's eps
   (the frozen calibration over the reference's own FFT profile), then the
   program's state: the series on the card, ``build_index_device_stats``
   (``index.build_s``), the engine, and warm requests;
2. the window: one closed-loop client sends the pool's batches, each cycle
   through them in an order drawn from ``--seed``, until ``seconds`` have
   passed, and waits for the last one; with ``trace`` the window runs under
   ``torch.profiler``; then the client sends the seed's own queries through
   the same entry, in batches of the same size, outside the window;
3. the device's peak memory is read, the program's state freed, and the
   reference recomputes the answers of every query served from the series
   alone; every response is compared with them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .frozen import calibrate, idle
from .frozen.generators import generate_series
from .reference.common import Rows

HERE = Path(__file__).resolve().parent
#: Host spans of the traced window: the engine methods the harness wraps,
#: by the layer they belong to.
SPANS = (("_plan_batch", "engine.plan"), ("_plan", "engine.plan"),
         ("_dense_probe_retry", "probe"), ("_verify_multi", "verify"))
REQUEST_SPAN = "request"
#: Entries of each list of the breakdown, and the characters kept of a
#: device operation's name (templated kernel names run to hundreds).
TOP = 10
NAME_CHARS = 160


class CellError(Exception):
    """A cell, configuration, traffic or metric that the files do not
    define."""


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: Path, name: str) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic, end-to-end metrics and per-layer metrics (each with its
    reader), found by name."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json", "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"workload {name!r}: no config {cell['config']!r}")
    config = _load_json(root / configs[cell["config"]]["file"], "config")
    traffic = _load_json(root / HERE.name / "traffic"
                         / f"{cell['traffic']}.json", "traffic")
    e2e = [dict(m, read=_reader(root, m["name"]))
           for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [dict(m, read=_reader(root, m["name"]))
                 for m in bench["per_layer"] if _applies(m, name, names)]
    return dict(name=name, chips=cell["chips"], config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def _reader(root: Path, name: str) -> Callable:
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.is_file():
        raise CellError(f"metric {name!r}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"kvbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reference(semantics: str):
    path = HERE / "reference" / f"{semantics}.py"
    if not path.is_file():
        raise CellError(f"no reference {path}")
    return importlib.import_module(f"{__package__}.reference.{semantics}")


# ------------------------------------------------------------------ inputs
def seed_ints(seed: int) -> List[int]:
    """The seed as non-negative words for numpy's generators."""
    s = int(seed) & ((1 << 64) - 1)
    return [s & 0xFFFFFFFF, s >> 32]


def make_inputs(spec: dict, seed: int, device) -> dict:
    """The series (the configuration's ``series_seed``), the queries and
    their eps, and the order in which the window sends them.  The pool the
    window cycles through is drawn from the traffic's ``pool_seed``, so
    that every seed does the same work in the window; the order of its
    batches and the ``check_queries`` self-queries sent after the window
    (indices ``pool`` on) are drawn from ``seed``.  Each set of offsets
    takes one in each of as many equal strata of the series."""
    cfg, tr = spec["config"], spec["traffic"]
    n, L = int(cfg["n"]), int(cfg["L"])
    t0 = time.perf_counter()
    series = generate_series(n, seed=int(cfg["series_seed"]),
                             dtype=np.float32)
    gen_s = time.perf_counter() - t0
    pool, b = int(tr["pool"]), int(tr["batch"])
    fixed = np.random.default_rng(int(tr["pool_seed"]))
    rng = np.random.default_rng(seed_ints(seed))
    offs = np.concatenate([_strata(fixed, n - L + 1, pool),
                           _strata(rng, n - L + 1, int(tr["check_queries"]))])
    batches = fixed.permutation(pool)[:pool // b * b].reshape(-1, b)
    cal = _reference(cfg["calibration"])
    x = torch.as_tensor(series, device=device)
    rows = Rows(x, L, torch.float64)
    del x
    params = cfg["params"]
    eps = np.empty(offs.size)
    t0 = time.perf_counter()
    for j, o in enumerate(offs):
        q = rows.x[o:o + L]
        ds = cal.topk(rows, q, int(tr["answers"]), params["alpha"],
                      params["beta"])
        eps[j] = calibrate.eps_for_target(ds, int(tr["answers"]))
    cal_s = time.perf_counter() - t0
    del rows
    _free(device)
    queries = np.stack([series[o:o + L] for o in offs]).astype(np.float64)
    return dict(series=series, offs=offs, batches=batches, eps=eps,
                queries=queries, calibration_s=cal_s, generate_s=gen_s,
                rng=rng, cycles=[], extra=np.arange(pool, offs.size))


def _strata(rng: np.random.Generator, m: int, k: int) -> np.ndarray:
    """k offsets below m, one drawn in each of k equal strata."""
    edges = np.linspace(0, m, k + 1).astype(np.int64)
    return edges[:-1] + (rng.random(k) * np.diff(edges)).astype(np.int64)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------- program
def build_program(spec: dict, inputs: dict, device) -> dict:
    """The program's serving state: the series on ``device``, the
    stats-only index, the engine.  A stats-only index is probed on the
    device alone, so the engine takes ``dense_probe_min_count=0`` and the
    port's defaults otherwise."""
    import kvmatch_tpu_torch as kt
    from kvmatch_tpu_torch.index.device_build import build_index_device_stats
    from kvmatch_tpu_torch.state import series_to_device
    cfg = spec["config"]
    icfg = kt.IndexConfig()
    data, dev = series_to_device(inputs["series"], device)
    _sync(device)
    t0 = time.perf_counter()
    index = build_index_device_stats(data, icfg, data_dev=dev)
    _sync(device)
    build_s = time.perf_counter() - t0
    eng = getattr(kt, cfg["engine"])(
        data, index=index, icfg=icfg,
        qcfg=kt.QueryConfig(dense_probe_min_count=0), device_data=dev)
    return dict(engine=eng, index_build_s=build_s)


def request_plan(inputs: dict, count: int, start: int = 0) -> np.ndarray:
    """Pool indices (count, batch) of requests start .. start + count - 1:
    the pool's fixed batches, each cycle through them in an order drawn
    from the seed."""
    batches, cycles = inputs["batches"], inputs["cycles"]
    nb = batches.shape[0]
    out = []
    for k in range(start, start + count):
        while len(cycles) <= k // nb:
            cycles.append(inputs["rng"].permutation(nb))
        out.append(batches[cycles[k // nb][k % nb]])
    return np.stack(out)


def send(spec: dict, eng, inputs: dict, idx: np.ndarray):
    """One request of the pool queries ``idx``: a list of QueryResult."""
    tr, params = spec["traffic"], spec["config"]["params"]
    q, eps = inputs["queries"][idx], inputs["eps"][idx]
    if tr["entry"] == "query":
        return [eng.query(q[0], float(eps[0]), **params)]
    return getattr(eng, tr["entry"])(q, eps, **params)


def serve(spec: dict, state: dict, inputs: dict, seconds: float,
          trace: bool, device) -> dict:
    """Warm-up, the window, then the seed's own queries; responses and
    timings."""
    eng = state["engine"]
    warm = int(spec["traffic"]["warmup"])
    t0 = time.perf_counter()
    for idx in request_plan(inputs, warm):
        send(spec, eng, inputs, idx)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    prof = _Tracer(eng, device) if trace else None
    reqs = []
    k = warm
    with (prof or nullcontext()):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            (idx,) = request_plan(inputs, 1, k)
            k += 1
            with (prof.span(REQUEST_SPAN) if prof else nullcontext()):
                reqs.append(_request(spec, eng, inputs, idx))
        t1 = time.perf_counter()
    b = int(spec["traffic"]["batch"])
    ex = inputs["extra"]
    extra = [_request(spec, eng, inputs, ex[i:i + b])
             for i in range(0, ex.size, b)]
    out = dict(requests=reqs, extra=extra, window_s=t1 - t0,
               t_window_start=t0, warmup_s=warmup_s)
    if prof:
        out["trace"] = prof.reduce()
    return out


def _request(spec: dict, eng, inputs: dict, idx: np.ndarray) -> dict:
    """One timed request; a request that raises is counted as failed."""
    ts = time.perf_counter()
    try:
        res, err = send(spec, eng, inputs, idx), None
    except Exception as e:
        res, err = None, f"{type(e).__name__}: {e}"
    return dict(idx=idx, res=res, error=err,
                latency_s=time.perf_counter() - ts)


class _Tracer:
    """``torch.profiler`` over the window, the engine's layer calls wrapped
    in ``record_function`` spans named by ``SPANS``."""

    def __init__(self, eng, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.eng, self.device = eng, device
        self.prof = profile(activities=acts)
        self.labels = {REQUEST_SPAN, "window"}
        self._patched = []

    def span(self, label: str):
        from torch.profiler import record_function
        return record_function(label)

    def __enter__(self):
        for meth, label in SPANS:
            if hasattr(self.eng, meth):
                self._wrap(meth, label)
        self.prof.__enter__()
        self._window = self.span("window")
        self._window.__enter__()
        return self

    def _wrap(self, meth: str, label: str):
        orig = getattr(self.eng, meth)
        self.labels.add(label)

        def wrapped(*a, _orig=orig, _label=label, **kw):
            with self.span(_label):
                return _orig(*a, **kw)
        setattr(self.eng, meth, wrapped)
        self._patched.append(meth)

    def __exit__(self, *a):
        _sync(self.device)
        self._window.__exit__(None, None, None)
        self.prof.__exit__(*a)
        for meth in self._patched:
            delattr(self.eng, meth)
        return False

    def reduce(self) -> dict:
        """Device activities and host spans of the window, on one clock
        (ns)."""
        try:
            events = self.prof.profiler.kineto_results.events()
            rows = [(e.name(), e.device_type(), e.start_ns(),
                     e.start_ns() + e.duration_ns(),
                     bool(e.is_user_annotation())) for e in events]
        except AttributeError:  # an older profiler: its FunctionEvents
            rows = [(e.name, e.device_type, e.time_range.start * 1000,
                     e.time_range.end * 1000, False)
                    for e in self.prof.events()]
        from torch.autograd import DeviceType
        spans = [(n, s, t) for n, d, s, t, _ in rows
                 if d == DeviceType.CPU and n in self.labels]
        win = [(s, t) for n, s, t in spans if n == "window"]
        b0, b1 = win[0] if win else (0, 0)
        dev = [(n, s, t) for n, d, s, t, ua in rows
               if d != DeviceType.CPU and not ua and n not in self.labels]
        return dict(window_ns=(b0, b1), device=dev,
                    spans=[x for x in spans if x[0] != "window"])


# ------------------------------------------------------------------- check
def check(spec: dict, inputs: dict, reqs: List[dict], device,
          dtype=torch.float64) -> dict:
    """The reference's answers of every query served, computed in
    ``dtype`` from the series alone, against every response in ``reqs``.
    Returns the compared numbers and counts."""
    cfg = spec["config"]
    L, params = int(cfg["L"]), cfg["params"]
    served: Dict[int, list] = {}
    for r in reqs:
        if r["res"] is None:
            continue
        for qi, res in zip(r["idx"], r["res"]):
            served.setdefault(int(qi), []).append(res)
    chosen = sorted(served)
    ref = _reference(cfg["semantics"])
    t0 = time.perf_counter()
    rows = Rows(torch.as_tensor(inputs["series"], device=device), L, dtype)
    missing = extra = compared = answers = 0
    gap = 0.0
    counts, examples = [], []
    for qi in chosen:
        o = int(inputs["offs"][qi])
        r_off, r_d = ref.answers(rows, rows.x[o:o + L],
                                 float(inputs["eps"][qi]), **params)
        counts.append(int(r_off.size))
        want = dict(zip(r_off.tolist(), r_d.tolist()))
        for res in served[qi]:
            got = dict(zip(np.asarray(res.offsets).tolist(),
                           np.asarray(res.distances).tolist()))
            miss, more = want.keys() - got.keys(), got.keys() - want.keys()
            missing += len(miss)
            extra += len(more)
            if (miss or more) and len(examples) < 5:
                q = inputs["queries"][qi]
                examples.append(dict(offset=o, mu_q=float(q.mean()),
                                     sd_q=float(q.std()),
                                     eps=float(inputs["eps"][qi]),
                                     missing=sorted(miss)[:5],
                                     extra=sorted(more)[:5]))
            for off in want.keys() & got.keys():
                gap = max(gap, abs(got[off] - want[off])
                          / max(want[off], 1.0))
            compared += 1
            answers += len(got)
    del rows
    _free(device)
    return dict(missing=missing, extra=extra, dist_gap=gap,
                checked_queries=len(chosen), compared_responses=compared,
                compared_answers=answers, mismatches=examples,
                reference_answers_mean=(statistics.fmean(counts)
                                        if counts else 0.0),
                reference_s=time.perf_counter() - t0)


# ----------------------------------------------------------------- metrics
class Run:
    """What a metric's reader reads: the window's length and every
    request's latency, the set-up's seconds and timings, the answered
    requests (each with its pool indices and QueryResults) and their
    QueryStats, the trace reduced to device activities and host spans (ns,
    one clock), the cell's configuration and traffic."""

    def __init__(self, spec: dict, served: dict, setup: dict):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.window_s = served["window_s"]
        self.latencies_s = [r["latency_s"] for r in served["requests"]]
        self.requests = [r for r in served["requests"] if r["res"]]
        self.stats = [x.stats for r in self.requests for x in r["res"]]
        self.n_queries = len(self.stats)
        self.setup = setup
        tr = served.get("trace")
        self.window_ns = tr["window_ns"] if tr else None
        self.device_events = tr["device"] if tr else None
        self.spans = tr["spans"] if tr else None

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        """Summed seconds of the device activities whose name matches."""
        return sum(t - s for n, s, t in self.device_events if match(n)) / 1e9

    def busy_window(self):
        """(busy_s, window_s) of the traced window."""
        b0, b1 = self.window_ns
        busy = idle.busy_union([(s, t) for _, s, t in self.device_events],
                               b0, b1)
        return busy / 1e9, (b1 - b0) / 1e9


def breakdown(run: Run) -> dict:
    """The device operations that took most time, and the device's idle
    time by the innermost host span it fell under."""
    by_name: Dict[str, float] = {}
    for n, s, t in run.device_events:
        key = n[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    b0, b1 = run.window_ns
    ivs = sorted((max(s, b0), min(t, b1)) for _, s, t in run.device_events
                 if t > b0 and s < b1)
    gaps, end = [], b0
    for lo, hi in ivs:
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if b1 > end:
        gaps.append((end, b1))
    spans = sorted(run.spans, key=lambda x: x[2] - x[1])
    by_label: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        label = next((n for n, s, t in spans if s <= mid <= t), "client")
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e9
    gaps_top = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(device_ops=[[k, v] for k, v in ops],
                idle_gaps=[[k, v] for k, v in gaps_top])


# --------------------------------------------------------------------- run
def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, card: Optional[dict] = None,
             build: Callable = build_program) -> Tuple[dict, dict]:
    """One run of a cell: the result object of the last line, and what
    else the run learned (``info``, for standard error).  ``build(spec,
    inputs, device)`` makes the serving state; the default is the
    program's."""
    device = torch.device(device)
    inputs = make_inputs(spec, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = build(spec, inputs, device)
    served = serve(spec, state, inputs, seconds, trace, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    setup = dict(setup_s=served["t_window_start"] - t_start,
                 index_build_s=state["index_build_s"],
                 calibration_s=inputs["calibration_s"],
                 generate_s=inputs["generate_s"],
                 warmup_s=served["warmup_s"])
    run = Run(spec, served, setup)
    del state
    _free(device)
    every = served["requests"] + served["extra"]
    checks = check(spec, inputs, every, device)
    failed = sum(len(r["idx"]) for r in every if r["res"] is None)
    attempted = sum(len(r["idx"]) for r in every)
    limits = spec["config"]["limits"]
    numbers = dict(failed=failed, missing=checks["missing"],
                   extra=checks["extra"], dist_gap=checks["dist_gap"])
    correct = (checks["compared_responses"] > 0
               and all(numbers[k] <= limits[k] for k in numbers))
    out = dict(correct=bool(correct), attempted=attempted, failed=failed,
               metrics={})
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = m["read"](run)
        if v is not None:
            out["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
    out["device"] = dict(card or {}, memory_peak_bytes=int(peak))
    if trace and run.device_events is not None:
        busy, window = run.busy_window()
        out["device"].update(busy_s=busy, window_s=window)
        out["breakdown"] = breakdown(run)
    info = dict(seed=int(seed), requests=len(served["requests"]),
                extra_requests=len(served["extra"]),
                window_s=served["window_s"], **setup,
                **{k: v for k, v in checks.items() if k not in numbers})
    out["checks"] = {k: dict(value=v, limit=limits[k])
                     for k, v in numbers.items()}
    return out, info
