"""RSM-DTW and cNSM-DTW end to end: the PyTorch port against the float64
oracle and the JAX engines.

The cases are tests/test_dtw_engines.py's (N=20,000, seed 9).  The port's
engines run with the host phase 1 (the default QueryConfig, as the JAX test)
and on the serving route (dense probe, every phase 2 on the device) through
``query``, ``query_batch`` and ``query_batch_device``.  Answer sets must
EQUAL ``kvmatch_tpu.oracle``'s and the JAX engine's.  An answer the DS stage
accepts carries the double-single distance, whose square is within
``verify.ds_guard`` of the f64 one: squared distances are compared within
1e-4 (d^2 + 1), far inside that guard at these shapes.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw as JaxNormDtw
from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw as JaxDtw
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu_torch import NormQueryEngineDtw, QueryEngine, QueryEngineDtw
from kvmatch_tpu_torch.state import index_from_jax

torch.set_num_threads(2)

N = 20_000
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
RSM_ROWS = [(500, 128, 2.0, 0.05), (3000, 256, 6.0, 0.05),
            (12000, 512, 10.0, 0.1)]
CNSM_ROWS = [(700, 128, 2.0, 0.05, 1.5, 10.0), (5000, 256, 5.0, 0.05, 1.2, 6.0),
             (11000, 512, 8.0, 0.1, 2.0, 25.0)]


@pytest.fixture(scope="module")
def setup():
    data = generate_series(N, seed=9)
    icfg = IndexConfig()
    jindex = build_index_tpu(data, icfg)
    index = index_from_jax(jindex)
    return dict(data=data, icfg=icfg, index=index, jindex=jindex)


def _engine(setup, cls, qcfg=None):
    return cls(setup["data"], index=setup["index"], icfg=setup["icfg"],
               **({} if qcfg is None else {"qcfg": qcfg}))


def _same(res, offs, dists, what):
    got = dict(zip(res.offsets.tolist(), res.distances.tolist()))
    want = dict(zip(offs.tolist(), dists.tolist()))
    assert set(got) == set(want), (
        f"{what}: missing={sorted(set(want) - set(got))[:5]} "
        f"extra={sorted(set(got) - set(want))[:5]}")
    for k, v in want.items():
        assert abs(got[k] ** 2 - v * v) <= 1e-4 * (v * v + 1.0), (what, k)


@pytest.mark.parametrize("offset,length,eps,rho_frac", RSM_ROWS)
def test_rsm_dtw_equals_oracle_and_jax(setup, offset, length, eps, rho_frac):
    data = setup["data"]
    rho = int(rho_frac * length)
    q = data[offset:offset + length]
    oo, od = oracle.rsm_dtw(data, q, eps, rho)
    assert offset in oo.tolist()
    jres = JaxDtw(data, index=setup["jindex"], icfg=setup["icfg"]).query_at(
        offset, length, eps, rho=rho)
    _same(jres, oo, od, "jax")
    _same(_engine(setup, QueryEngineDtw).query_at(offset, length, eps,
                                                 rho=rho), oo, od, "query")
    serve = _engine(setup, QueryEngineDtw, SERVE)
    (res,) = serve.query_batch_device(q[None], eps, rho=rho)
    _same(res, oo, od, "query_batch_device")
    assert serve.stage_counts["near"] >= oo.size
    (res,) = serve.query_batch(q[None], eps, rho=rho)
    _same(res, oo, od, "query_batch")


@pytest.mark.parametrize("offset,length,eps,rho_frac,alpha,beta", CNSM_ROWS)
def test_cnsm_dtw_equals_oracle_and_jax(setup, offset, length, eps, rho_frac,
                                        alpha, beta):
    data = setup["data"]
    rho = int(rho_frac * length)
    q = data[offset:offset + length]
    kw = dict(rho=rho, alpha=alpha, beta=beta)
    oo, od = oracle.cnsm_dtw(data, q, eps, rho, alpha, beta)
    assert offset in oo.tolist()
    jres = JaxNormDtw(data, index=setup["jindex"],
                      icfg=setup["icfg"]).query_at(offset, length, eps, **kw)
    _same(jres, oo, od, "jax")
    _same(_engine(setup, NormQueryEngineDtw).query_at(offset, length, eps,
                                                     **kw), oo, od, "query")
    serve = _engine(setup, NormQueryEngineDtw, SERVE)
    (res,) = serve.query_batch_device(q[None], eps, **kw)
    _same(res, oo, od, "query_batch_device")
    (res,) = serve.query_batch(q[None], eps, **kw)
    _same(res, oo, od, "query_batch")


def test_batches_of_queries_equal_oracle(setup):
    """Several queries share one cascade (a query row per candidate)."""
    data = setup["data"]
    offs, L, rho = (300, 4100, 9000, 15500), 256, 12
    qs = np.stack([data[o:o + L] for o in offs])
    eps = [4.0, 6.0, 3.0, 8.0]
    raw = _engine(setup, QueryEngineDtw, SERVE).query_batch(qs, eps, rho=rho)
    norm = _engine(setup, NormQueryEngineDtw, SERVE).query_batch_device(
        qs, eps, rho=rho, alpha=1.5, beta=10.0)
    for o, q, e, r1, r2 in zip(offs, qs, eps, raw, norm):
        _same(r1, *oracle.rsm_dtw(data, q, e, rho), "rsm batch")
        _same(r2, *oracle.cnsm_dtw(data, q, e, rho, 1.5, 10.0), "cnsm batch")
        assert o in r1.offsets.tolist() and o in r2.offsets.tolist()


def test_rsm_dtw_rho_zero_equals_ed(setup):
    """rho=0 DTW reduces to plain Euclidean matching."""
    dtw = _engine(setup, QueryEngineDtw, SERVE)
    ed = _engine(setup, QueryEngine, SERVE)
    r1 = dtw.query_at(2500, 200, 5.0, rho=0)
    r2 = ed.query_at(2500, 200, 5.0)
    assert set(r1.offsets.tolist()) == set(r2.offsets.tolist())
    assert r1.found


@pytest.mark.parametrize("cls,kw", [
    (QueryEngineDtw, {}), (NormQueryEngineDtw, {"alpha": 1.4, "beta": 8.0})])
def test_skip_lb_route_matches_cascade_route(setup, cls, kw):
    """dtw_skip_lb_max sends tiny candidate sets straight to the DP; the
    answers equal the LB-cascade route's (the cascade only prefilters)."""
    skip = _engine(setup, cls, QueryConfig(dtw_skip_lb_max=1 << 30))
    casc = _engine(setup, cls, QueryConfig(dtw_skip_lb_max=0))
    data = setup["data"]
    for off, L, eps in [(4000, 512, 5.0), (15000, 256, 4.0)]:
        q = data[off:off + L]
        rs = skip.query(q, eps, rho=int(0.05 * L), **kw)
        assert skip.stage_counts["lb_skipped"]
        rc = casc.query(q, eps, rho=int(0.05 * L), **kw)
        assert not casc.stage_counts["lb_skipped"]
        assert rs.offsets.tolist() == rc.offsets.tolist()
        np.testing.assert_allclose(rs.distances, rc.distances)
        assert off in rs.offsets.tolist()


def test_engines_refuse_streamed_modes(setup):
    with pytest.raises(ValueError, match="not ported"):
        QueryEngineDtw(setup["data"], index=setup["index"],
                       device_data="stream")


def test_stage_chunks_change_no_answer(setup, monkeypatch):
    """The cascade's stages run over unpadded chunks (BaseEngine.
    _run_chunked); 7-row chunks give the same answers and distances."""
    from kvmatch_tpu import verify as vf
    data = setup["data"]
    qs = np.stack([data[o:o + 256] for o in (3000, 9000)])
    kw = dict(rho=12, alpha=1.5, beta=10.0)
    eng = _engine(setup, NormQueryEngineDtw, QueryConfig(dtw_skip_lb_max=0))
    want = eng.query_batch(qs, 5.0, **kw)
    monkeypatch.setattr(vf, "bucket_size", lambda m, lo, width: 7)
    got = eng.query_batch(qs, 5.0, **kw)
    assert eng.stage_counts["near"] > 7
    for g, w in zip(got, want):
        assert g.offsets.tolist() == w.offsets.tolist()
        np.testing.assert_array_equal(g.distances, w.distances)
