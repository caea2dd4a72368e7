"""What a resident series of about 1.4e9 points asks of the cNSM-ED engine,
at small sizes on the CPU.

* The per-block probe path: when neither the bucket stack nor the window
  statistics fit the device's memory budget, ``dense_probe_flags`` makes
  them again for every ``PROBE_BLOCK`` of positions.  An engine with
  ``CACHE_MEM_FRACTION = 0`` on the instance takes that path; with
  ``PROBE_BLOCK`` cut small a series of a few hundred thousand points
  spans many blocks.  Its answers and distances equal the cached path's
  and the plain f64 reference's (``kvbench/reference/cnsm_ed.py``).
* Windows at a level far above their std: the region route's window
  variance (``ops/regions.py:region_znorm_distances_multi``) once came
  from f32 sliding sums of the raw values, which cancel there, so the
  near-set lost self-matches.  A segment series lifted by 2341 (the level
  of the n = 1.4e9 series' random walks, std/|mean| near 1e-3 to 5e-3)
  and the low-std repro of ``generate_series(200_000, seed=3471459838)``
  (std/|mean| 1.4e-4) hold the route to the reference and the oracle.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kvbench.frozen import segments  # noqa: E402
from kvbench.frozen.calibrate import eps_for_target  # noqa: E402
from kvbench.reference import cnsm_ed as reference  # noqa: E402
from kvbench.reference.common import Rows  # noqa: E402
from kvmatch_tpu_torch import NormQueryEngine, oracle  # noqa: E402
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig  # noqa: E402
from kvmatch_tpu_torch.data.generators import generate_series  # noqa: E402
from kvmatch_tpu_torch.index.device_build import \
    build_index_device_stats  # noqa: E402
from kvmatch_tpu_torch.ops import regions  # noqa: E402
from kvmatch_tpu_torch.parallel import query as tq  # noqa: E402
from kvmatch_tpu_torch.state import series_to_device  # noqa: E402

torch.set_num_threads(2)

L, ALPHA, BETA = 4096, 1.5, 282.65
#: The level added to the segment series, as the n = 1.4e9 series' random
#: walks reach it.
LEVEL = 2341.0
#: The tiny-load host route off, so phase 2 runs on the device's routes.
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)


def _engine(x, qcfg=SERVE):
    host, dev = series_to_device(x, "cpu")
    index = build_index_device_stats(host, IndexConfig(), data_dev=dev)
    return NormQueryEngine(host, index=index, qcfg=qcfg, device_data=dev)


def _workload(n, seed, level, k=3, count=8):
    """A segment series (plus ``level``), ``count`` self-queries, each
    query's eps for ``k`` answers and the reference's answers."""
    x = (segments.generate(n, seed, threads=2) + np.float32(level)).astype(
        np.float32)
    offs = np.sort(np.random.default_rng(seed).integers(0, n - L + 1, count))
    rows = Rows(torch.as_tensor(x), L, torch.float64)
    qs = [rows.x[o:o + L] for o in offs]
    eps = np.array([eps_for_target(d, k) for d in
                    reference.topk(rows, qs, k, ALPHA, BETA)])
    want = reference.answers(rows, qs, list(eps), ALPHA, BETA)
    queries = np.stack([x[o:o + L] for o in offs]).astype(np.float64)
    return x, offs, queries, eps, want


def _routes(eng, monkeypatch):
    taken = []
    for route, meth in (("region", "_verify_regions"),
                        ("gather", "_verify_gather")):
        def spy(*a, _orig=getattr(eng, meth), _route=route, **kw):
            taken.append(_route)
            return _orig(*a, **kw)
        monkeypatch.setattr(eng, meth, spy)
    return taken


def _assert_equal_reference(res, want):
    """Equal answer sets, and each distance within 1e-8 of the
    reference's, relative to max(d, 1) (the benchmark's ``dist_gap``)."""
    for r, (w_off, w_d) in zip(res, want):
        order = np.argsort(r.offsets)
        np.testing.assert_array_equal(r.offsets[order], w_off)
        gap = np.abs(r.distances[order] - w_d) / np.maximum(w_d, 1.0)
        assert np.all(gap <= 1e-8), gap.max()


@pytest.fixture(scope="module")
def level_case():
    """n = 300,000 at LEVEL: seed 1's batch, on whose query at 151,450 the
    f32 sums of the raw values dropped the self-match."""
    return _workload(300_000, 1, LEVEL)


def test_per_block_path_equals_cached_path_and_reference(level_case,
                                                         monkeypatch):
    x, offs, queries, eps, want = level_case
    cached = _engine(x)
    got_cached = cached.query_batch(queries, eps, alpha=ALPHA, beta=BETA)
    assert cached._fly_bucket_stack(L) is not None
    assert all(r.stats.n_probe_blocks == 0 for r in got_cached)

    monkeypatch.setattr(tq, "PROBE_BLOCK", 1 << 15)
    blocked = _engine(x)
    blocked.CACHE_MEM_FRACTION = 0
    calls = []

    def spy(*a, _orig=tq.make_bucket_stack, **kw):
        calls.append(a[0].shape[0])
        return _orig(*a, **kw)
    monkeypatch.setattr(tq, "make_bucket_stack", spy)
    got = blocked.query_batch(queries, eps, alpha=ALPHA, beta=BETA)
    assert blocked._fly_bucket_stack(L) is None
    assert blocked._fly_cons_stats(L) is None
    npos = -(-(x.size - L + 1) // tq.FLAG) * tq.FLAG
    blocks = -(-npos // (1 << 15))
    assert len(calls) == blocks > 8
    assert all(r.stats.n_probe_blocks == 2 * blocks for r in got)
    for a, b in zip(got, got_cached):
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.distances, b.distances)
        assert a.stats.n_candidates == b.stats.n_candidates
    _assert_equal_reference(got, want)


def test_region_route_keeps_self_matches_at_a_large_level(level_case,
                                                          monkeypatch):
    x, offs, queries, eps, want = level_case
    eng = _engine(x)
    taken = _routes(eng, monkeypatch)
    res = eng.query_batch(queries, eps, alpha=ALPHA, beta=BETA)
    assert taken == ["region"]
    assert 151_450 in offs
    sd_mu = [queries[i].std() / abs(queries[i].mean())
             for i in range(len(offs))]
    assert max(sd_mu) < 1e-2
    for o, r in zip(offs, res):
        assert o in r.offsets
    _assert_equal_reference(res, want)
    single = eng.query(queries[list(offs).index(151_450)],
                       float(eps[list(offs).index(151_450)]), alpha=ALPHA,
                       beta=BETA)
    assert 151_450 in single.offsets


@pytest.mark.parametrize("level", [0.0, LEVEL, 1e5])
def test_region_znorm_distances_within_their_bound(level):
    """d2 within ``err`` of the windows' f64 distances, and the mean and
    std near their f64 values, at a level of 0, LEVEL and 1e5, over rows
    that cross segments of other levels and kinds."""
    Lq, M, B = 1024, 1024, 24
    x = (segments.generate(60_000, 4, threads=2) + np.float32(level)).astype(
        np.float32)
    rng = np.random.default_rng(5)
    starts = rng.integers(0, x.size - (M + Lq - 1) + 1, B).astype(np.int64)
    q = x[20_000:20_000 + Lq].astype(np.float64)
    qh = ((q - q.mean()) / q.std()).astype(np.float32)
    out = regions.region_znorm_distances_multi(
        torch.as_tensor(x), torch.as_tensor(qh)[None],
        torch.as_tensor(starts), torch.zeros(B, dtype=torch.int32), Lq, M)
    d2, mean, std, err = (t.numpy() for t in out)
    w = x.astype(np.float64)[(starts[:, None] + np.arange(M))[..., None]
                             + np.arange(Lq)]
    mu, sd = w.mean(axis=2), w.std(axis=2)
    z = (w - mu[..., None]) / sd[..., None]
    exact = ((z - qh.astype(np.float64)) ** 2).sum(axis=2)
    assert np.all(std > 0)
    assert np.all(np.abs(d2 - exact) <= err)
    np.testing.assert_allclose(std, sd, rtol=1e-6)
    assert np.all(np.abs(mean - mu) <= 1e-6 * np.abs(mu) + 1e-6)


def test_low_std_batch_equals_oracle(monkeypatch):
    """The low-std repro: a batch of the self-queries at 91,580 and 109,512
    of ``generate_series(200_000, seed=3471459838)`` at L 256, alpha 1.2,
    beta 5.  Its first query's window has std/|mean| 1.4e-4; the region
    route found none of its answers while its variance cancelled to 0."""
    x = generate_series(200_000, seed=3471459838, dtype=np.float32)
    eng = _engine(x, QueryConfig(dense_probe_min_count=0))
    taken = _routes(eng, monkeypatch)
    n = 256
    qs = np.stack([eng.data[91_580:91_580 + n], eng.data[109_512:109_512 + n]])
    eps = [20.750362236997496, 2.6919782969087005]
    res = eng.query_batch(qs, eps, alpha=1.2, beta=5.0)
    assert taken == ["region"]
    assert sorted(res[0].offsets.tolist()) == [91_131, 91_580, 91_677]
    for r, q, e in zip(res, qs, eps):
        want, _ = oracle.nsm_ed(eng.data, q, e, alpha=1.2, beta=5.0,
                                device="cpu")
        assert sorted(r.offsets.tolist()) == sorted(want.tolist())
