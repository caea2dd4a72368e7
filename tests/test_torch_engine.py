"""cNSM-ED engine end to end: the PyTorch port against the oracle and JAX.

The port's ``NormQueryEngine`` runs the serving route -- dense flag probe
with the constraint AND, device phase 2, exact f64 confirm -- through
``query_batch_device``, ``query_batch`` and ``query`` on the parameter rows
of tests/test_norm_ed.py (RSM-ED: tests/test_torch_engine_rsm.py).  The same
index drives both packages (``state.index_from_jax``).  Answer sets must
EQUAL the float64 oracle and the JAX engine.  ``stats.n_candidates`` is
compared on ``query_batch_device`` only, where it is the exact probe count
in both packages; ``query_batch`` replaces it with interval coverage, which
depends on the flag granularity (128 in the port, 256 for JAX on the CPU).
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.norm_ed import NormQueryEngine as JaxNorm
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu_torch import NormQueryEngine
from kvmatch_tpu_torch import backend
from kvmatch_tpu_torch.engine import norm_ed as port_norm
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
from kvmatch_tpu_torch.state import index_from_jax, series_to_device

torch.set_num_threads(2)

N = 60_000
# Device routes everywhere: the dense probe for every plan, and no tiny-load
# host shortcut in phase 2.
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
NORM_ROWS = [  # tests/test_norm_ed.py
    (123, 400, 2.0, 1.5, 20.0),
    (1234, 1600, 5.0, 1.1, 8.0),
    (30000, 4096, 8.0, 2.0, 30.0),
    (7777, 800, 1.0, 1.2, 5.0),
    (2048, 256, 4.0, 1.5, 50.0),
]


@pytest.fixture(scope="module")
def setup():
    data = generate_series(N, seed=7)
    icfg = IndexConfig()
    jindex = build_index_tpu(data, icfg)
    index = index_from_jax(jindex)
    return dict(
        data=data, icfg=icfg, index=index,
        jnorm=JaxNorm(data, index=jindex, icfg=icfg, qcfg=SERVE),
        norm=NormQueryEngine(data, index=index, icfg=icfg, qcfg=SERVE))


def _same(res, offs, dists, what):
    got = dict(zip(res.offsets.tolist(), res.distances.tolist()))
    want = dict(zip(offs.tolist(), dists.tolist()))
    assert set(got) == set(want), (
        f"{what}: missing={sorted(set(want) - set(got))[:5]} "
        f"extra={sorted(set(got) - set(want))[:5]}")
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9)


@pytest.mark.parametrize("offset,length,eps,alpha,beta", NORM_ROWS)
def test_norm_engine_equals_oracle_and_jax(setup, offset, length, eps, alpha,
                                           beta):
    data = setup["data"]
    q = data[offset:offset + length]
    kw = dict(alpha=alpha, beta=beta)
    oo, od = oracle.nsm_ed(data, q, eps, **kw)
    assert offset in oo.tolist()
    (jres,) = setup["jnorm"].query_batch_device(q[None], eps, **kw)
    _same(jres, oo, od, "jax query_batch_device")
    eng = setup["norm"]
    (res,) = eng.query_batch_device(q[None], eps, **kw)
    _same(res, oo, od, "query_batch_device")
    assert res.stats.n_candidates == jres.stats.n_candidates
    (res,) = eng.query_batch(q[None], eps, **kw)
    _same(res, oo, od, "query_batch")
    _same(eng.query(q, eps, **kw), oo, od, "query")


@pytest.mark.parametrize("offs,length,eps,routes", [
    ((7777, 20_000, 41_234), 800, (1.0, 3.0, 6.0), (3, 0)),
    ((7777, 20_000), 256, (1.0, 8.0), (2, 0)),
    ((7777, 41_234), 2048, (1.0, 1.5), (0, 2)),
])
def test_batch_takes_one_route(setup, monkeypatch, offs, length, eps,
                                 routes):
    """Phase 2 routes a batch by its joint plan, as the JAX package does:
    every query takes the region near-set route when the batch's candidates
    are clustered enough (a selective query beside floods too), else K2's
    gather route.  Every query's answers stay exact."""
    eng = setup["norm"]
    seen = {"_verify_regions": 0, "_verify_gather": 0}
    for name in seen:
        fn = getattr(eng, name)

        def wrapped(ivs, ctxs, *a, _fn=fn, _name=name):
            seen[_name] += len(ctxs)
            return _fn(ivs, ctxs, *a)
        monkeypatch.setattr(eng, name, wrapped)
    data = setup["data"]
    kw = dict(alpha=1.2, beta=5.0)
    qs = np.stack([data[o:o + length] for o in offs])
    results = eng.query_batch_device(qs, list(eps), **kw)
    for res, q, e, o in zip(results, qs, eps, offs):
        oo, od = oracle.nsm_ed(data, q, e, **kw)
        _same(res, oo, od, "batch")
        assert o in res.offsets.tolist()
    assert (seen["_verify_regions"], seen["_verify_gather"]) == routes


def test_region_near_overflow_falls_back(setup, monkeypatch):
    """A near set beyond its capacity takes the full-matrix fallback with
    the same exact answers."""
    monkeypatch.setattr(port_norm, "NEAR_K", 1)
    data = setup["data"]
    offs, L, eps, kw = (7777, 20_000), 800, [3.0, 6.0], dict(alpha=1.2,
                                                             beta=5.0)
    qs = np.stack([data[o:o + L] for o in offs])
    for res, q, e in zip(setup["norm"].query_batch_device(qs, eps, **kw), qs,
                         eps):
        oo, od = oracle.nsm_ed(data, q, e, **kw)
        _same(res, oo, od, "overflow fallback")


def test_serving_index_and_host_phase1(setup):
    """The stats-only index of the port's device build serves the dense
    route; the host-built interval index serves host phase 1 (the default
    QueryConfig).  Both give the oracle's answers."""
    data, icfg = setup["data"], setup["icfg"]
    host, dev = series_to_device(data, "cpu")
    serving = build_index_device_stats(host, icfg, data_dev=dev)
    eng = NormQueryEngine(host, index=serving, icfg=icfg,
                          qcfg=QueryConfig(dense_probe_min_count=0),
                          device_data=dev)
    plain = NormQueryEngine(data, index=setup["index"], icfg=icfg)
    for off, L, eps, a, b in NORM_ROWS[:2]:
        q = data[off:off + L]
        oo, od = oracle.nsm_ed(data, q, eps, alpha=a, beta=b)
        (res,) = eng.query_batch(q[None], eps, alpha=a, beta=b)
        _same(res, oo, od, "serving index")
        _same(plain.query(q, eps, alpha=a, beta=b), oo, od, "host phase 1")


def test_backend_device_rules():
    assert backend.resolve_device(None) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        backend.resolve_device("meta")
    with pytest.raises(ValueError, match="no kernel route"):
        backend.route(torch.empty(1, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            backend.resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
