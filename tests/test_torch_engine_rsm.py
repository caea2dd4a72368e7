"""RSM-ED engine end to end: the PyTorch port against the oracle and JAX.

The port's ``QueryEngine`` runs the serving route -- dense flag probe,
device phase 2, exact f64 confirm -- through ``query_batch_device``,
``query_batch`` and ``query`` on the parameter rows of tests/test_rsm_ed.py,
with the index the JAX package built (``state.index_from_arrays``).  Answer
sets and distances must EQUAL the float64 oracle and the JAX engine;
``stats.n_candidates`` is compared on ``query_batch_device``, where both
packages report the exact probe count (see tests/test_torch_engine.py).
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.base import QueryStats as JStats, _Ctx as JCtx
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JaxRaw
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu_torch import QueryEngine
from kvmatch_tpu_torch.engine import rsm_ed as port_raw
from kvmatch_tpu_torch import config as tconfig
from kvmatch_tpu_torch.engine.base import QueryStats, _Ctx
from kvmatch_tpu_torch.state import index_from_arrays

torch.set_num_threads(2)

N = 60_000
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
RAW_ROWS = [  # tests/test_rsm_ed.py
    (123, 400, 5.0),
    (1234, 1600, 10.0),
    (30000, 4096, 20.0),
    (7777, 800, 1.0),
    (50, 25, 0.5),
]


@pytest.fixture(scope="module")
def setup():
    data = generate_series(N, seed=7)
    icfg = IndexConfig()
    jindex = build_index_tpu(data, icfg)
    return dict(data=data, index=index_from_arrays(jindex),
                jraw=JaxRaw(data, index=jindex, icfg=icfg, qcfg=SERVE),
                raw=QueryEngine(data, index=index_from_arrays(jindex),
                                icfg=tconfig.IndexConfig(),
                                qcfg=tconfig.QueryConfig(
                                    dense_probe_min_count=0,
                                    host_verify_max_points=0),
                                device="cpu"))


def _same(res, offs, dists, what):
    got = dict(zip(res.offsets.tolist(), res.distances.tolist()))
    want = dict(zip(offs.tolist(), dists.tolist()))
    assert set(got) == set(want), (
        f"{what}: missing={sorted(set(want) - set(got))[:5]} "
        f"extra={sorted(set(got) - set(want))[:5]}")
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9)


@pytest.mark.parametrize("offset,length,eps", RAW_ROWS)
def test_raw_engine_equals_oracle_and_jax(setup, offset, length, eps):
    data = setup["data"]
    q = data[offset:offset + length]
    oo, od = oracle.rsm_ed(data, q, eps)
    assert offset in oo.tolist()
    (jres,) = setup["jraw"].query_batch_device(q[None], eps)
    _same(jres, oo, od, "jax query_batch_device")
    eng = setup["raw"]
    (res,) = eng.query_batch_device(q[None], eps)
    _same(res, oo, od, "query_batch_device")
    assert res.stats.n_candidates == jres.stats.n_candidates
    (res,) = eng.query_batch(q[None], eps)
    _same(res, oo, od, "query_batch")
    _same(eng.query(q, eps), oo, od, "query")


@pytest.mark.parametrize("offs,length,eps,routes", [
    ((7777, 20_000, 41_234), 256, (30.0, 15.0, 60.0), (3, 0)),
    ((20_000,), 256, (15.0,), (1, 0)),
    ((7777, 20_000, 41_234), 800, (8.0, 4.0, 16.0), (0, 3)),
])
def test_batch_takes_one_route(setup, monkeypatch, offs, length, eps,
                                 routes):
    """Phase 2 routes a batch by its joint plan, as the JAX package does:
    every query takes the region near-set route when the batch's candidates
    are clustered enough (a selective query beside floods too), else K2's
    gather route.  Every query's answers stay exact."""
    eng = setup["raw"]
    seen = {"_verify_regions": 0, "_verify_gather": 0}
    for name in seen:
        fn = getattr(eng, name)

        def wrapped(ivs, ctxs, *a, _fn=fn, _name=name):
            seen[_name] += len(ctxs)
            return _fn(ivs, ctxs, *a)
        monkeypatch.setattr(eng, name, wrapped)
    data = setup["data"]
    qs = np.stack([data[o:o + length] for o in offs])
    results = eng.query_batch_device(qs, list(eps))
    for res, q, e, o in zip(results, qs, eps, offs):
        oo, od = oracle.rsm_ed(data, q, e)
        _same(res, oo, od, "batch")
        assert o in res.offsets.tolist()
    assert (seen["_verify_regions"], seen["_verify_gather"]) == routes


def test_region_near_overflow_falls_back(setup, monkeypatch):
    """A near set beyond its capacity takes the full-matrix fallback with
    the same exact answers."""
    monkeypatch.setattr(port_raw, "NEAR_K", 1)
    data = setup["data"]
    offs, L, eps = (7777, 20_000, 41_234), 256, [30.0, 15.0, 60.0]
    qs = np.stack([data[o:o + L] for o in offs])
    for res, q, e in zip(setup["raw"].query_batch_device(qs, eps), qs, eps):
        oo, od = oracle.rsm_ed(data, q, e)
        _same(res, oo, od, "overflow fallback")


# The longest query a plan covers with the default config: 30 segments
# (QueryConfig.max_segments) of at most 16 units of 25 points, and a tail of
# fewer than 25 points that no segment needs.
LONGEST = 30 * 16 * 25 + 24


def _never(*args, **kwargs):
    raise AssertionError("phase 1 ran on a query with no plan")


@pytest.mark.parametrize("entry", ["query", "query_batch",
                                   "query_batch_device", "stream"])
def test_query_past_the_longest_plan_raises(setup, monkeypatch, entry):
    """A query of L = 12,100 > 12,024 has no plan: every entry point raises
    ValueError naming max_segments in phase 0, before phase 1 or any device
    work (the JAX package raises IndexError in phase 1 instead:
    test_longest_plan_equals_jax)."""
    data = setup["data"]
    q = data[100:100 + 12_100]
    eng = setup["raw"]
    if entry == "stream":
        eng = QueryEngine(data, index=setup["index"], device_data="stream",
                          device="cpu")
    for name in ("_phase1", "_phase1_routed", "_dense_probe_retry"):
        monkeypatch.setattr(eng, name, _never)
    call = {"query": lambda: eng.query(q, 5.0),
            "query_batch": lambda: eng.query_batch(q[None], 5.0),
            "query_batch_device": lambda: eng.query_batch_device(q[None], 5.0),
            "stream": lambda: eng.query_batch_device(q[None], 5.0)}[entry]
    with pytest.raises(ValueError, match="max_segments = 30") as err:
        call()
    assert "query length 12100" in str(err.value)
    assert f"the longest such query has {LONGEST} points" in str(err.value)


def test_longest_plan_equals_jax(setup):
    """At L = 12,024 the port plans what the JAX package plans (30
    segments); one point more, the JAX package's plan is empty and its
    query raises IndexError in phase 1, where the port raises ValueError in
    phase 0."""
    data, eng, jeng = setup["data"], setup["raw"], setup["jraw"]
    q = data[300:300 + LONGEST]
    want = jeng._plan(JCtx(query=q, length=q.size, epsilon=5.0, eps2=25.0,
                           params={}, stats=JStats()))
    got = eng._plan(_Ctx(query=q, length=q.size, epsilon=5.0, eps2=25.0,
                         params={}, stats=QueryStats()))
    assert len(want) == 30
    assert [vars(s) for s in got] == [vars(s) for s in want]
    q = data[300:300 + LONGEST + 1]
    assert jeng._plan(JCtx(query=q, length=q.size, epsilon=5.0, eps2=25.0,
                           params={}, stats=JStats())) == []
    with pytest.raises(IndexError):
        jeng.query(q, 5.0)
    with pytest.raises(ValueError, match="max_segments"):
        eng.query(q, 5.0)
