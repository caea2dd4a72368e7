"""Observability and experiments of the PyTorch port against the JAX
package's: the ``StatsWriter`` CSV, ``fit_cost_model``'s routing by engine
family, ``trace`` on torch.profiler (a Chrome trace on the CPU), the
selectivity workloads of experiments.py, and ``QueryConfig.h100_tuned``
(opt-in: the defaults are unchanged and its answer sets equal theirs).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kvmatch_tpu import experiments as jexp
from kvmatch_tpu.config import IndexConfig as JIndexConfig
from kvmatch_tpu.engine.norm_ed import NormQueryEngine as JNormQueryEngine
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JQueryEngine
from kvmatch_tpu.index.build import build_index_numpy
from kvmatch_tpu.utils import profiling as jprof
from kvmatch_tpu_torch import (NormQueryEngine, NormQueryEngineDtw,
                               QueryEngine, QueryEngineDtw, experiments)
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.index.build import build_index_host
from kvmatch_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    data = generate_series(25_000, seed=31)
    return data, build_index_host(data, IndexConfig()), \
        build_index_numpy(data, JIndexConfig())


def test_stats_writer_csv_equals_jax(setup, tmp_path):
    data, index, _ = setup
    res = QueryEngine(data, index=index, device="cpu").query_at(500, 256, 4.0)
    for writer, name in ((profiling.StatsWriter, "t.csv"),
                         (jprof.StatsWriter, "j.csv")):
        w = writer(tmp_path / name)
        w.write("q1", res.stats)
        w.write("q2", res.stats)
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    lines = text.strip().splitlines()
    assert lines[0].startswith("label,t_total_ms") and len(lines) == 3
    assert profiling.StatsWriter.FIELDS == jprof.StatsWriter.FIELDS


FAMILIES = {  # engine, its params, whether it reads the _dtw coefficients
    "rsm_ed": (QueryEngine, {}, False),
    "cnsm_ed": (NormQueryEngine, {"alpha": 1.3, "beta": 8.0}, True),
    "rsm_dtw": (QueryEngineDtw, {"rho": 12}, True),
    "cnsm_dtw": (NormQueryEngineDtw, {"rho": 12, "alpha": 1.3, "beta": 8.0},
                 True),
}


# A known phase-2 time model, t2 = a * n_windows + b * n_offsets/1e5 * L + c,
# with every coefficient positive and unlike the defaults.
KNOWN_FIT = (0.375, 0.0625, 2.5)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_fit_cost_model_routes_by_engine_family(setup, name, monkeypatch):
    """ED engines re-fit (a, b, intercept); the others the _dtw
    coefficients and the intercept (the reference fits the two families
    separately, QueryEngine.java:55-57 against QueryEngineDtw.java:53-55),
    as the JAX package's fit routes them.  With phase-2 times given by a
    known linear function of the real queries' counts, the fit recovers it
    and exactly the family's fields move; one timed fit per family keeps
    every coefficient >= 0 and moves no field outside the family."""
    data, index, _ = setup
    cls, kw, dtw = FAMILIES[name]
    eng = cls(data, index=index, device="cpu")
    assert eng.use_dtw_cost_model == dtw
    L = 256
    offs = np.random.default_rng(0).integers(0, data.size - L, 6)
    queries = np.stack([data[o:o + L] for o in offs])
    base = dataclasses.asdict(eng.qcfg)
    fitted = ({"phase2_cost_a_dtw", "phase2_cost_b_dtw"} if dtw else
              {"phase2_cost_a", "phase2_cost_b"}) | {"phase2_cost_intercept"}

    def moved(qc):
        return {k for k, v in dataclasses.asdict(qc).items() if v != base[k]}

    timed = profiling.fit_cost_model(eng, queries, 4.0, **kw)
    assert moved(timed) <= fitted
    assert all(getattr(timed, k) >= 0 for k in fitted)

    a, b, c = KNOWN_FIT
    real_query, rows = eng.query, []

    def query(q, epsilon, **params):
        res = real_query(q, epsilon, **params)
        s = res.stats
        row = (max(s.n_disjoint, 1), s.n_candidates / 1e5 * L)
        rows.append(row)
        s.t_phase2_ms = a * row[0] + b * row[1] + c
        return res

    monkeypatch.setattr(eng, "query", query)
    qc = profiling.fit_cost_model(eng, queries, 4.0, **kw)
    design = np.column_stack([np.asarray(rows), np.ones(len(rows))])
    assert np.linalg.matrix_rank(design) == 3, "counts do not pin the fit"
    assert moved(qc) == fitted
    names = (["phase2_cost_a_dtw", "phase2_cost_b_dtw"] if dtw else
             ["phase2_cost_a", "phase2_cost_b"]) + ["phase2_cost_intercept"]
    for k, want in zip(names, KNOWN_FIT):
        assert getattr(qc, k) == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_trace_writes_a_chrome_trace_on_the_cpu(setup, tmp_path):
    data, index, _ = setup
    from torch.profiler import record_function
    eng = QueryEngine(data, index=index, device="cpu",
                      qcfg=QueryConfig(host_verify_max_points=0))
    with profiling.trace(tmp_path / "tr") as prof:
        with record_function("one_query"):
            eng.query_at(500, 256, 4.0)
    assert prof.trace_file.parent == tmp_path / "tr"
    events = json.loads(prof.trace_file.read_text())["traceEvents"]
    assert "one_query" in {e.get("name") for e in events}
    assert any(e.name == "one_query" for e in prof.events())
    assert len(prof.events()) > 1  # the query's torch operations
    assert profiling.TRACE_DIR.parts[-2:] == ("build", "trace")


@pytest.mark.parametrize("engine", ["rsm_ed", "cnsm_ed"])
def test_workloads_equal_jax_and_round_trip(setup, tmp_path, engine):
    """generate_workload over the port's engine finds the JAX engine's
    workload entry for entry; either package loads the other's file; the
    replay misses no query's own offset."""
    data, index, jindex = setup
    if engine == "rsm_ed":
        eng = QueryEngine(data, index=index, device="cpu")
        jeng = JQueryEngine(data, index=jindex)
        kw = dict(lengths=[128, 256], epsilons=[2.0, 6.0], seed=1)
    else:
        eng = NormQueryEngine(data, index=index, device="cpu")
        jeng = JNormQueryEngine(data, index=jindex)
        kw = dict(lengths=[128], epsilons=[3.0], seed=2,
                  param_grid=[{"alpha": 1.3, "beta": 10.0}])
    wl = experiments.generate_workload(eng, queries_per_cell=2, **kw)
    jwl = jexp.generate_workload(jeng, queries_per_cell=2, **kw)
    assert wl and [dataclasses.asdict(e) for e in wl] == \
        [dataclasses.asdict(e) for e in jwl]
    experiments.save_workload(wl, tmp_path / "t.json")
    jexp.save_workload(jwl, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = experiments.load_workload(tmp_path / "j.json")
    assert [dataclasses.asdict(e) for e in back] == \
        [dataclasses.asdict(e) for e in jexp.load_workload(tmp_path /
                                                           "t.json")]
    reports = experiments.run_workload(eng, back)
    assert reports and sum(r.false_dismissals for r in reports) == 0
    assert all(r.mean_answers >= 1 for r in reports)
    assert [r.bin_label for r in reports] == \
        [r.bin_label for r in jexp.run_workload(jeng, jwl)]


def test_h100_tuned_is_opt_in_and_answers_equal(setup):
    """h100_tuned changes only the cost-model constants; the default
    QueryConfig stays the reference's, and answer sets under the tuned
    constants equal the default's (they steer early termination only)."""
    data, index, _ = setup
    default, tuned = QueryConfig(), QueryConfig.h100_tuned()
    diff = {k for k, v in dataclasses.asdict(tuned).items()
            if v != getattr(default, k)}
    assert diff and all(k.startswith("phase2_cost") for k in diff)
    assert QueryConfig.h100_tuned(max_segments=12).max_segments == 12
    offs = (300, 5000, 11_000, 19_000)
    qs = np.stack([data[o:o + 512] for o in offs])
    for cls, kw in ((QueryEngine, {}),
                    (NormQueryEngine, {"alpha": 1.5, "beta": 10.0})):
        got = cls(data, index=index, qcfg=tuned,
                  device="cpu").query_batch(qs, 5.0, **kw)
        want = cls(data, index=index, device="cpu").query_batch(qs, 5.0, **kw)
        for o, g, w in zip(offs, got, want):
            assert set(g.offsets.tolist()) == set(w.offsets.tolist())
            assert o in g.offsets.tolist()
