"""RSM-ED engine end to end: the PyTorch port against the oracle and JAX.

The port's ``QueryEngine`` runs the serving route -- dense flag probe,
device phase 2, exact f64 confirm -- through ``query_batch_device``,
``query_batch`` and ``query`` on the parameter rows of tests/test_rsm_ed.py,
with the index the JAX package built (``state.index_from_jax``).  Answer
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
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JaxRaw
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu_torch import QueryEngine
from kvmatch_tpu_torch.engine import rsm_ed as port_raw
from kvmatch_tpu_torch.state import index_from_jax

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
    return dict(data=data,
                jraw=JaxRaw(data, index=jindex, icfg=icfg, qcfg=SERVE),
                raw=QueryEngine(data, index=index_from_jax(jindex), icfg=icfg,
                                qcfg=SERVE))


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
