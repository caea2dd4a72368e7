"""The port's bench: one JSON line with the headline metric (port of the
repository's bench.py).

Headline: the reference's only published number, the README demo query
(RSM-ED, synthetic n=1e6, self-query at offset 123456, L=8192, eps=10 ->
176 ms on the authors' machine).  ``value`` is the median total latency of
the same query here; ``vs_baseline`` is 176 / value.  ``extras`` holds the
index build, batched RSM-ED and cNSM-ED throughput (host and device phase
1), RSM-DTW latency, the scalar-C twins of the reference's phase 2 on the
same queries, cNSM-DTW at the north-star shape, the kernels' efficiency
(utils/kernel_bench.py) and the n=1e8 cNSM-ED north star.  The sections,
their sizes, seeds and repetitions are the JAX bench's; its query config
``tpu_tuned`` becomes ``QueryConfig.h100_tuned``.

  python -m kvmatch_tpu_torch.bench [--n N] [--batch B] [--quick]
      [--[no-]northstar] [--deadline S] [--log-dir D] [--device cuda|cpu]

Each section runs in turn.  One that raises is recorded in
``extras["section_errors"]`` with its traceback on stderr, the later
sections still run, the line still prints, and the process exits 1.  The
``--deadline`` (seconds from the start) is checked before each section; a
section past it does not run and is listed in ``extras["sections_skipped"]``
(not an error).  ``--quick`` runs the first nine sections at 64 and 32
queries (``--batch`` below 64 lowers both).  There is no fallback: without
a card and without ``--device cpu`` the command exits 2.  The full JSON of
each run also goes to ``<log-dir>/bench_torch_run{k}.json`` (default
``build/bench/`` at the repository root), a new file every run.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

BASELINE_DEMO_MS = 176.0
SERIES_SEED = 20260816
DEMO_OFF, DEMO_L, DEMO_EPS = 123_455, 8192, 10.0  # 0-based: the demo's 123456
DTW_L, DTW_RHO, DTW_EPS = 1024, 51, 6.0
ALPHA, BETA, CNSM_EPS = 1.2, 5.0, 4.0
TOP_K = 32768
NORTHSTAR_N, NORTHSTAR_SEED = 100_000_000, 20260817
LOG_DIR = Path(__file__).resolve().parents[1] / "build" / "bench"
# The reference's fitted phase-2 models (QueryEngine.java:55-57 and
# NormQueryEngine's), per disjoint interval and per 1e5 candidate points.
REF_RSM = (4.0707589132278, 0.269833135638498)
REF_CNSM = (9.72276547123376, 0.0106737255022236)


@dataclasses.dataclass
class _State:
    """What the sections share: the n-point series, its host-built index,
    the RSM-ED engine over it, the batch's queries, and what the sections
    report (``res``: measurements, ``correctness``, ``answers``: each
    query's answer count)."""
    args: argparse.Namespace
    qcfg: object
    data: np.ndarray
    index: dict
    icfg: object
    engine: object
    offs: np.ndarray
    queries: np.ndarray
    nq: int
    nq2: int
    res: dict = dataclasses.field(default_factory=dict)
    correctness: dict = dataclasses.field(default_factory=dict)
    answers: dict = dataclasses.field(default_factory=dict)
    neng: object = None


def _setup(args, qcfg, device) -> _State:
    from .config import IndexConfig
    from .data.generators import generate_series
    from .engine.rsm_ed import QueryEngine
    from .index.build import build_index_host
    from .index.structure import total_memory_bytes
    n = args.n
    data = generate_series(n, seed=SERIES_SEED)
    icfg = IndexConfig()
    stats: dict = {}
    index = build_index_host(data, icfg, stats=stats)
    engine = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                         device=device)
    nq = min(args.batch, 64) if args.quick else args.batch
    nq2 = min(nq, 32 if args.quick else 128)
    offs = np.random.default_rng(1).integers(0, n - DEMO_L, nq)
    queries = np.stack([data[o:o + DEMO_L] for o in offs])
    st = _State(args=args, qcfg=qcfg, data=data, index=index, icfg=icfg,
                engine=engine, offs=offs, queries=queries, nq=nq, nq2=nq2)
    st.res.update(index_build_mpts_per_s=stats["mpts_per_second"],
                  index_memory_mb=total_memory_bytes(index) / 1e6)
    return st


def _found(offs, results) -> int:
    return sum(1 for o, r in zip(offs, results)
               if int(o) in r.offsets.tolist())


def _counts(results) -> list:
    return [int(r.stats.n_answers) for r in results]


def _timed_batches(fn, nq: int, reps: int) -> tuple:
    """(results of the last, q/s of each) over ``reps`` calls of ``fn``."""
    qps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        qps.append(nq / (time.perf_counter() - t0))
    return out, qps


def _ref_qps(results, coeffs, L: int) -> float:
    """Queries per second of the reference's fitted phase-2 model applied to
    the measured candidate loads."""
    a, b = coeffs
    ms = [a * r.stats.n_disjoint + b * r.stats.n_candidates / 1e5 * L
          for r in results]
    return 1000.0 / max(float(np.mean(ms)), 1e-9)


# ---------------------------------------------------------------- sections
def demo(st: _State) -> None:
    eng = st.engine
    res = eng.query_at(DEMO_OFF, DEMO_L, DEMO_EPS)  # warm
    ok = bool(res.found and int(res.offsets[0]) == DEMO_OFF
              and res.distances[0] == 0.0)
    lat = []
    for _ in range(3 if st.args.quick else 7):
        r = eng.query_at(DEMO_OFF, DEMO_L, DEMO_EPS)
        lat.append(r.stats.t_total_ms)
    st.res.update(demo_ms=statistics.median(lat), demo_ms_reps=lat)
    st.answers["demo"] = [int(r.stats.n_answers)]
    st.correctness["demo_exact"] = ok


def rsm_batch(st: _State) -> None:
    eng, q, nq = st.engine, st.queries, st.nq
    eng.query_batch(q, DEMO_EPS)  # warm
    res, reps = _timed_batches(lambda: eng.query_batch(q, DEMO_EPS), nq, 2)
    st.res.update(
        rsm_ed_batch_qps=max(reps), rsm_ed_batch_qps_reps=reps,
        ref_costmodel_rsm_qps_est=_ref_qps(res, REF_RSM, DEMO_L),
        rsm_batch_p1_ms=float(np.mean([r.stats.t_phase1_ms for r in res])),
        rsm_batch_p2_ms=float(np.mean([r.stats.t_phase2_ms for r in res])),
        rsm_batch_candidates=int(np.sum([r.stats.n_candidates for r in res])),
        rsm_batch_host_rechecked=int(np.sum([r.stats.n_host_rechecked
                                             for r in res])))
    st.answers["rsm_batch"] = _counts(res)
    st.correctness["rsm_batch_self_found"] = f"{_found(st.offs, res)}/{nq}"


def cnsm_batch(st: _State) -> None:
    from .engine.norm_ed import NormQueryEngine
    nq2, q2 = st.nq2, st.queries[:st.nq2]
    st.neng = neng = NormQueryEngine(st.data, index=st.index, icfg=st.icfg,
                                     qcfg=st.qcfg,
                                     device_data=st.engine.data_dev)
    kw = dict(alpha=ALPHA, beta=BETA)
    neng.query_batch(q2, CNSM_EPS, **kw)  # warm
    res, reps = _timed_batches(lambda: neng.query_batch(q2, CNSM_EPS, **kw),
                               nq2, 2)
    st.res.update(cnsm_ed_batch_qps=max(reps), cnsm_ed_batch_qps_reps=reps,
                  ref_costmodel_cnsm_qps_est=_ref_qps(res, REF_CNSM, DEMO_L))
    st.answers["cnsm_batch"] = _counts(res)
    st.correctness["cnsm_batch_self_found"] = \
        f"{_found(st.offs[:nq2], res)}/{nq2}"


def rsm_device_batch(st: _State) -> None:
    eng, q, nq = st.engine, st.queries, st.nq
    eng.query_batch_device(q, DEMO_EPS, top_k=TOP_K)  # warm
    res, reps = _timed_batches(
        lambda: eng.query_batch_device(q, DEMO_EPS, top_k=TOP_K), nq, 2)
    st.res["rsm_ed_device_batch_qps"] = max(reps)
    st.answers["rsm_device_batch"] = _counts(res)
    st.correctness["rsm_device_self_found"] = f"{_found(st.offs, res)}/{nq}"


def cnsm_device_batch(st: _State) -> None:
    if st.neng is None:
        raise RuntimeError("cnsm_batch section failed; no engine")
    neng, nq2, q2 = st.neng, st.nq2, st.queries[:st.nq2]
    kw = dict(top_k=TOP_K, alpha=ALPHA, beta=BETA)
    neng.query_batch_device(q2, CNSM_EPS, **kw)  # warm
    res, reps = _timed_batches(
        lambda: neng.query_batch_device(q2, CNSM_EPS, **kw), nq2, 2)
    st.res["cnsm_ed_device_batch_qps"] = max(reps)
    st.answers["cnsm_device_batch"] = _counts(res)
    st.correctness["cnsm_device_self_found"] = \
        f"{_found(st.offs[:nq2], res)}/{nq2}"


def rsm_dtw(st: _State) -> None:
    from .engine.rsm_dtw import QueryEngineDtw
    deng = QueryEngineDtw(st.data, index=st.index, icfg=st.icfg,
                          qcfg=st.qcfg, device_data=st.engine.data_dev)
    deng.query_at(DEMO_OFF, DTW_L, DTW_EPS, rho=DTW_RHO)  # warm
    ms = []
    for _ in range(3):
        r = deng.query_at(DEMO_OFF, DTW_L, DTW_EPS, rho=DTW_RHO)
        ms.append(r.stats.t_total_ms)
    st.res["rsm_dtw_query_ms"] = statistics.median(ms)
    st.answers["rsm_dtw"] = [int(r.stats.n_answers)]
    st.correctness["dtw_self_found"] = bool(
        r.found and int(r.offsets[0]) == DEMO_OFF)


def _twin(st: _State, cls):
    """A scalar-C twin of the reference's phase 2 over the same index and
    resident series, with the reference's cost-model coefficients (its
    phase-1 termination)."""
    from .config import QueryConfig
    return cls(st.data, index=st.index, icfg=st.icfg, qcfg=QueryConfig(),
               device_data=st.engine.data_dev)


def _ms_per_query(fn, rows) -> float:
    t0 = time.perf_counter()
    for q in rows:
        fn(q)
    return (time.perf_counter() - t0) * 1e3 / len(rows)


def twin_ed(st: _State) -> None:
    from .baseline_twin import ScalarTwinEd
    twin = _twin(st, ScalarTwinEd)
    st.res["twin_demo_ms_measured"] = statistics.median(
        twin.query_at(DEMO_OFF, DEMO_L, DEMO_EPS).stats.t_total_ms
        for _ in range(3))
    st.res["twin_rsm_ms_per_query_measured"] = _ms_per_query(
        lambda q: twin.query(q, DEMO_EPS), st.queries[:min(16, st.nq)])


def twin_cnsm(st: _State) -> None:
    from .baseline_twin import ScalarTwinNormEd
    twin = _twin(st, ScalarTwinNormEd)
    st.res["twin_cnsm_ms_per_query_measured"] = _ms_per_query(
        lambda q: twin.query(q, CNSM_EPS, alpha=ALPHA, beta=BETA),
        st.queries[:min(8, st.nq2)])


def twin_dtw(st: _State) -> None:
    from .baseline_twin import ScalarTwinDtw
    twin = _twin(st, ScalarTwinDtw)
    st.res["twin_rsm_dtw_ms_measured"] = statistics.median(
        twin.query_at(DEMO_OFF, DTW_L, DTW_EPS, rho=DTW_RHO).stats.t_total_ms
        for _ in range(3))


def cnsm_dtw(st: _State) -> None:
    """cNSM-DTW at the north-star shape (L=8192, rho=0.05 L) on the n-point
    series: 16 queries a batch, the median of 3 batches after a warm one,
    against the scalar-C twin on 2 of them."""
    from .baseline_twin import ScalarTwinNormDtw
    from .engine.norm_dtw import NormQueryEngineDtw
    eng = NormQueryEngineDtw(st.data, index=st.index, icfg=st.icfg,
                             qcfg=st.qcfg, device_data=st.engine.data_dev)
    nq_cd = min(16, st.nq)
    q_cd = st.queries[:nq_cd]
    kw = dict(rho=int(0.05 * DEMO_L), alpha=ALPHA, beta=BETA)
    eng.query_batch(q_cd[:2], CNSM_EPS, **kw)  # warm
    res, reps = _timed_batches(lambda: eng.query_batch(q_cd, CNSM_EPS, **kw),
                               nq_cd, 3)
    twin = _twin(st, ScalarTwinNormDtw)
    st.res.update(
        cnsm_dtw_batch_qps=statistics.median(reps),
        cnsm_dtw_batch_qps_reps=reps,
        cnsm_dtw_host_rechecked=int(np.sum([r.stats.n_host_rechecked
                                            for r in res])),
        twin_cnsm_dtw_ms_measured=_ms_per_query(
            lambda q: twin.query(q, CNSM_EPS, **kw), q_cd[:2]))
    st.answers["cnsm_dtw"] = _counts(res)
    st.correctness["cnsm_dtw_batch_self_found"] = \
        f"{_found(st.offs[:nq_cd], res)}/{nq_cd}"


def kernel_efficiency(st: _State) -> None:
    from .utils.kernel_bench import measure_kernel_efficiency
    st.res["kernel_efficiency"] = measure_kernel_efficiency(
        st.engine.data_dev, reps=8)


def northstar(st: _State) -> None:
    """cNSM-ED at n=1e8, L=8192 (the north star): the stats-only device
    build (cold, warm), 8 self-queries a batch over the resident series with
    every query on the device probe, the probe pass alone, and one query of
    the scalar-C twin over a host-built index."""
    from .baseline_twin import ScalarTwinNormEd
    from .config import QueryConfig
    from .data.generators import generate_series
    from .engine.base import QueryStats, _Ctx
    from .engine.norm_ed import NormQueryEngine
    from .index.build import build_index_host
    from .index.device_build import build_index_device_stats
    ns: dict = {}
    st.res["northstar"] = ns
    device = st.engine.device
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    n8, L = NORTHSTAR_N, DEMO_L
    data8 = generate_series(n8, seed=NORTHSTAR_SEED)
    t0 = time.perf_counter()
    dev8 = torch.as_tensor(data8.astype(np.float32), device=device)
    sync()
    ns["series_h2d_s"] = time.perf_counter() - t0
    for key in ("device_build_mpts_per_s_1e8_cold",
                "device_build_mpts_per_s_1e8"):
        bst: dict = {}
        index8 = build_index_device_stats(data8, st.icfg, stats=bst,
                                          data_dev=dev8)
        ns[key] = bst["mpts_per_second"]
    for k in ("build_seconds", "h2d_seconds", "device_seconds",
              "host_group_seconds"):
        ns[k] = bst[k]
    offs8 = np.random.default_rng(2).integers(0, n8 - L, 8)
    q8 = np.stack([data8[o:o + L] for o in offs8])
    eng8 = NormQueryEngine(data8, index=index8, icfg=st.icfg,
                           qcfg=dataclasses.replace(st.qcfg,
                                                    dense_probe_min_count=0),
                           device_data=dev8)
    kw = dict(alpha=ALPHA, beta=BETA)
    eng8.query_batch(q8, CNSM_EPS, **kw)  # warm, with the full batch
    r8, reps = _timed_batches(lambda: eng8.query_batch(q8, CNSM_EPS, **kw),
                              8, 3)
    ns.update(
        cnsm_ed_1e8_qps=statistics.median(reps), cnsm_ed_1e8_qps_reps=reps,
        cnsm_ed_1e8_self_found=_found(offs8, r8),
        cnsm_ed_1e8_answers=_counts(r8),
        cnsm_ed_1e8_cands_per_query=float(np.mean(
            [r.stats.n_candidates for r in r8])),
        cnsm_ed_1e8_p1_ms=float(np.mean([r.stats.t_phase1_ms for r in r8])),
        cnsm_ed_1e8_p2_ms=float(np.mean([r.stats.t_phase2_ms for r in r8])))
    ctxs = [_Ctx(query=q, length=L, epsilon=CNSM_EPS,
                 eps2=CNSM_EPS * CNSM_EPS, params=dict(kw),
                 stats=QueryStats()) for q in q8]
    plans = eng8._plan_batch(ctxs)
    sync()
    t0 = time.perf_counter()
    eng8._dense_probe_retry(ctxs, plans)
    sync()
    ns["probe_pass_s_q8"] = time.perf_counter() - t0
    # The twin's phase 1 reads host intervals, which the serving index
    # lacks: one host build at the same n, one query.
    t0 = time.perf_counter()
    index8h = build_index_host(data8, st.icfg)
    ns["host_build_s_for_twin"] = time.perf_counter() - t0
    twin8 = ScalarTwinNormEd(data8, index=index8h, icfg=st.icfg,
                             qcfg=QueryConfig(), device_data=dev8)
    ns["twin_cnsm_1e8_ms"] = _ms_per_query(
        lambda q: twin8.query(q, CNSM_EPS, **kw), q8[:1])
    ns["cnsm_1e8_speedup_vs_twin_measured"] = \
        ns["twin_cnsm_1e8_ms"] * ns["cnsm_ed_1e8_qps"] / 1000.0
    del twin8, eng8, index8, index8h, data8, dev8
    gc.collect()


#: The sections in the JAX bench's order; ``run`` looks each up here.
SECTIONS = {f.__name__: f for f in (
    demo, rsm_batch, cnsm_batch, rsm_device_batch, cnsm_device_batch,
    rsm_dtw, twin_ed, twin_cnsm, twin_dtw, cnsm_dtw, kernel_efficiency,
    northstar)}
QUICK_SECTIONS = tuple(SECTIONS)[:9]


# -------------------------------------------------------------- the line
def _num(x):
    """A finite float, or None."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def _ratio(a, b):
    a, b = _num(a), _num(b)
    return None if a is None or not b else a / b


def _ms_each(qps):
    """Milliseconds a query at ``qps`` queries a second, or None."""
    return _ratio(1000.0, qps)


def _line(st: _State | None, n: int, device, card, floor_ms: float,
          errors: dict, ran: list, skipped: list) -> dict:
    r = st.res if st is not None else {}
    g = r.get
    demo_ms = g("demo_ms")
    rsm_qps, cnsm_qps = g("rsm_ed_batch_qps"), g("cnsm_ed_batch_qps")
    return {
        "metric": "RSM-ED demo query latency (n=1e6, L=8192, eps=10, "
                  "self-query)",
        "value": _num(demo_ms),
        "unit": "ms",
        "vs_baseline": _ratio(BASELINE_DEMO_MS, demo_ms),
        "extras": {
            "baseline_ms": BASELINE_DEMO_MS,
            "index_build_mpts_per_s": _num(g("index_build_mpts_per_s")),
            "index_memory_mb": _num(g("index_memory_mb")),
            "rsm_ed_batch_qps": _num(rsm_qps),
            "cnsm_ed_batch_qps": _num(cnsm_qps),
            "demo_ms_reps": g("demo_ms_reps", []),
            "rsm_ed_batch_qps_reps": g("rsm_ed_batch_qps_reps", []),
            "cnsm_ed_batch_qps_reps": g("cnsm_ed_batch_qps_reps", []),
            "cnsm_dtw_batch_qps_reps": g("cnsm_dtw_batch_qps_reps", []),
            "rsm_ed_batch_speedup_vs_ref_demo_rate": _ratio(
                rsm_qps, 1000.0 / BASELINE_DEMO_MS),
            "ref_costmodel_rsm_qps_est": _num(g("ref_costmodel_rsm_qps_est")),
            "ref_costmodel_cnsm_qps_est": _num(
                g("ref_costmodel_cnsm_qps_est")),
            "rsm_speedup_vs_ref_costmodel": _ratio(
                rsm_qps, g("ref_costmodel_rsm_qps_est")),
            "cnsm_speedup_vs_ref_costmodel": _ratio(
                cnsm_qps, g("ref_costmodel_cnsm_qps_est")),
            "twin_note": "twin shares our phase 0/1",
            "twin_demo_ms_measured": _num(g("twin_demo_ms_measured")),
            "twin_rsm_ms_per_query_measured": _num(
                g("twin_rsm_ms_per_query_measured")),
            "twin_cnsm_ms_per_query_measured": _num(
                g("twin_cnsm_ms_per_query_measured")),
            "twin_rsm_dtw_ms_measured": _num(g("twin_rsm_dtw_ms_measured")),
            "demo_speedup_vs_twin_measured": _ratio(
                g("twin_demo_ms_measured"), demo_ms),
            "rsm_batch_speedup_vs_twin_measured": _ratio(
                g("twin_rsm_ms_per_query_measured"), _ms_each(rsm_qps)),
            "cnsm_batch_speedup_vs_twin_measured": _ratio(
                g("twin_cnsm_ms_per_query_measured"), _ms_each(cnsm_qps)),
            "rsm_dtw_speedup_vs_twin_measured": _ratio(
                g("twin_rsm_dtw_ms_measured"), g("rsm_dtw_query_ms")),
            "rsm_dtw_query_ms": _num(g("rsm_dtw_query_ms")),
            "launch_floor_ms": floor_ms,
            "cnsm_dtw_batch_qps": _num(g("cnsm_dtw_batch_qps")),
            "twin_cnsm_dtw_ms_measured": _num(
                g("twin_cnsm_dtw_ms_measured")),
            "cnsm_dtw_speedup_vs_twin_measured": _ratio(
                g("twin_cnsm_dtw_ms_measured"),
                _ms_each(g("cnsm_dtw_batch_qps"))),
            "cnsm_dtw_host_rechecked": g("cnsm_dtw_host_rechecked"),
            "northstar": g("northstar", {}),
            "rsm_ed_device_batch_qps": _num(g("rsm_ed_device_batch_qps")),
            "cnsm_ed_device_batch_qps": _num(g("cnsm_ed_device_batch_qps")),
            "rsm_batch_p1_ms": _num(g("rsm_batch_p1_ms")),
            "rsm_batch_p2_ms": _num(g("rsm_batch_p2_ms")),
            "rsm_batch_candidates": g("rsm_batch_candidates"),
            "rsm_batch_host_rechecked": g("rsm_batch_host_rechecked"),
            "n": n,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "card": card,
            "kernel_efficiency": g("kernel_efficiency", {}),
            "section_errors": errors,
            "sections_run": ran,
            "sections_skipped": skipped,
            # Only for sections that ran to their end: a skipped section's
            # "0/16" would read as 16 false dismissals.
            "correctness": dict(st.correctness) if st is not None else {},
            "answer_counts": dict(st.answers) if st is not None else {},
        },
    }


def _launch_floor_ms(device) -> float:
    """Median host milliseconds of 5 tiny launches, each followed by a
    synchronize (after a warm one): the fixed cost a single query pays per
    launch it waits for."""
    x = torch.zeros(1, device=device)

    def once() -> float:
        t0 = time.perf_counter()
        x.add(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3

    once()
    return statistics.median(once() for _ in range(5))


def _write_log(out: dict, log_dir: Path) -> None:
    """``out`` as ``log_dir/bench_torch_run{k}.json``, k the first free,
    its name in ``out["extras"]["log_file"]``."""
    log_dir.mkdir(parents=True, exist_ok=True)
    k = 1
    while True:
        path = log_dir / f"bench_torch_run{k}.json"
        try:
            fh = open(path, "x")
        except FileExistsError:
            k += 1
            continue
        with fh:
            out["extras"]["log_file"] = path.name
            json.dump(out, fh, indent=1)
        return


def run(args: argparse.Namespace, qcfg=None) -> dict:
    """Run the sections ``args`` asks for and return the bench's line;
    the full line also goes to a new file under ``args.log_dir``.
    ``qcfg`` defaults to ``QueryConfig.h100_tuned()``."""
    from .backend import resolve_device
    from .config import QueryConfig
    from .utils.kernel_bench import card_line
    t_start = time.perf_counter()
    device = resolve_device(args.device)
    qcfg = QueryConfig.h100_tuned() if qcfg is None else qcfg
    card = card_line() if device.type == "cuda" else None
    floor_ms = _launch_floor_ms(device)
    plan = list(QUICK_SECTIONS if args.quick else SECTIONS)
    if not args.northstar and "northstar" in plan:
        plan.remove("northstar")
    st, errors, ran, skipped, secs = None, {}, [], [], {}
    for name in plan:
        t0 = time.perf_counter()
        if t0 - t_start > args.deadline:
            skipped.append(name)
            continue
        ran.append(name)
        try:
            if st is None:
                st = _setup(args, qcfg, device)
                secs["setup"] = time.perf_counter() - t0
                t0 = time.perf_counter()
            SECTIONS[name](st)
        except Exception as exc:  # noqa: BLE001 -- recorded, exit 1
            errors[name] = f"{type(exc).__name__}: {exc}"[:200]
            print(f"[bench] section '{name}' failed: {errors[name]}",
                  file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
        secs[name] = time.perf_counter() - t0
    out = _line(st, args.n, device, card, floor_ms, errors, ran, skipped)
    out["extras"]["section_s"] = secs
    _write_log(out, Path(args.log_dir))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m kvmatch_tpu_torch.bench",
        description="The port's bench: one JSON line with the headline "
                    "metric.")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--quick", action="store_true",
                    help="the first nine sections, at 64 and 32 queries")
    ap.add_argument("--northstar", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the n=1e8 cNSM-ED north star (build, engine "
                         "batches, one measured twin query)")
    ap.add_argument("--deadline", type=float, default=1200.0,
                    help="seconds from the start after which no section "
                         "starts")
    ap.add_argument("--log-dir", default=str(LOG_DIR))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.n < DEMO_OFF + DEMO_L:
        ap.error(f"--n must be at least {DEMO_OFF + DEMO_L} (the demo query)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device or "cuda").type == "cuda" \
            and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    out = run(args)
    log = Path(args.log_dir) / out["extras"]["log_file"]
    print(f"[bench] full line in {log}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 1 if out["extras"]["section_errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
