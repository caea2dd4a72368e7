"""The region near-set of cNSM-ED (``ops/regions.py:region_znorm_near_multi``)
on the CPU, where it runs its plain chain (``region_znorm_near_plain``).

* The near-set is a superset of the answers: over a short random walk at a
  high level (std/|mean| near 1e-3), every window that a brute-force f64
  scan finds within eps under the alpha/beta constraint is in the set.
* ``_verify_regions`` answers the same whether ``run_region_near``
  overflows the near-set capacity (``NEAR_K``: the full-matrix fallback)
  or not, and sets ``QueryStats.n_region_rows`` and ``n_near_overflows``.
* ``near_sums_within_err``: the card's window sums are covered by ``err``
  at every (L, M) the engines plan, and refused where they are not.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu_torch import NormQueryEngine
from kvmatch_tpu_torch import verify as vf
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.engine import norm_ed
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
from kvmatch_tpu_torch.ops import regions as trg
from kvmatch_tpu_torch.state import series_to_device

torch.set_num_threads(2)

N, L = 200_000, 512
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
#: A self-query that takes the region route on the series below, and a
#: batch around it (offset, eps); alpha 1.05, beta 0.2.
REGION = (161_000, 0.5)
BATCH = ((161_000, 0.5), (46_000, 0.5), (92_000, 0.5))


def _brute(x, q, eps, alpha, beta):
    """Offsets of the windows of ``x`` within ``eps`` of ``q`` in f64
    z-normalised ED whose mean and std pass the alpha/beta constraint."""
    w = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), q.size)
    mu, sd = w.mean(1), w.std(1)
    qh = (q - q.mean()) / q.std()
    ok = ((np.abs(mu - q.mean()) <= beta) & (sd / q.std() <= alpha)
          & (sd / q.std() >= 1 / alpha) & (sd > 0))
    d2 = np.full(mu.size, np.inf)
    idx = np.flatnonzero(ok)
    d2[idx] = np.sum(((w[idx] - mu[idx, None]) / sd[idx, None] - qh) ** 2, 1)
    return np.flatnonzero(d2 <= eps * eps)


@pytest.mark.parametrize("length,m", [(128, 512), (300, 512)])
def test_plain_near_set_holds_brute_force_answers(length, m):
    rng = np.random.default_rng(length)
    n = 30_000
    x = (2341.0 + np.cumsum(rng.normal(0, 0.05, n))).astype(np.float32)
    offs = rng.integers(0, n - length, 2)
    qs = np.stack([x[o:o + length] for o in offs]).astype(np.float64)
    alpha, beta, eps = 1.5, 0.5, 0.75 * np.sqrt(length)
    left = np.array([0], np.int64)
    right = np.array([n - length], np.int64)
    starts, vfrom, vto = trg.pack_regions(left, right, n, length, m)
    B = starts.size
    starts, vfrom, vto = (np.tile(a, 2) for a in (starts, vfrom, vto))
    qids = np.repeat(np.arange(2, dtype=np.int32), B)
    mu, sd = qs.mean(1), qs.std(1)
    qhat = ((qs - mu[:, None]) / sd[:, None]).astype(np.float32)
    eps2 = eps * eps
    th = np.full(2, eps2 + vf.guard_threshold(eps2, length, 1e-2), np.float32)
    cons = np.array([[alpha, beta, mu[i], sd[i], 1e-3 * (1 + abs(mu[i]) + sd[i])]
                     for i in range(2)], np.float32)
    t = torch.as_tensor
    cnt, rows, cols = trg.region_znorm_near_multi(
        t(x), t(qhat), t(starts), t(qids), t(vfrom), t(vto), t(th), t(cons),
        length, m, 1 << 22)
    rows, cols = rows.numpy()[:cnt], cols.numpy()[:cnt]
    for qi in range(2):
        want = _brute(x, qs[qi], eps, alpha, beta)
        assert offs[qi] in want and want.size > 1
        sel = qids[rows] == qi
        got = set((starts[rows[sel]] + cols[sel]).tolist())
        assert set(want.tolist()) <= got


@pytest.fixture(scope="module")
def eng():
    host, dev = series_to_device(generate_series(N, seed=5), "cpu")
    index = build_index_device_stats(host, IndexConfig(), data_dev=dev)
    return NormQueryEngine(host, index=index, qcfg=SERVE, device_data=dev)


def _run(eng, batch):
    if batch:
        qs = np.stack([eng.data[o:o + L] for o, _ in BATCH])
        return eng.query_batch(qs, [e for _, e in BATCH], alpha=1.05,
                               beta=0.2)
    off, eps = REGION
    return [eng.query(eng.data[off:off + L], eps, alpha=1.05, beta=0.2)]


@pytest.mark.parametrize("batch", [False, True])
def test_overflow_fallback_gives_the_same_answers(eng, batch, monkeypatch):
    plans = []

    def spy(*a, _orig=eng._verify_regions, **kw):
        plans.append(a[2])
        return _orig(*a, **kw)
    monkeypatch.setattr(eng, "_verify_regions", spy)
    base = _run(eng, batch)
    assert len(plans) == 1
    qids = plans[0][3]
    for qi, r in enumerate(base):
        assert r.stats.n_region_rows == int(np.sum(qids == qi))
        assert r.stats.n_near_overflows == 0
    assert sum(r.stats.n_region_rows for r in base) == qids.size > 0
    # Every near-set now overflows its capacity: the full-matrix fallback.
    monkeypatch.setattr(norm_ed, "NEAR_K", 0)
    over = _run(eng, batch)
    for a, b in zip(over, base):
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.distances, b.distances)
        assert a.stats.n_near_overflows == 1
        assert a.stats.n_region_rows == b.stats.n_region_rows
    assert any(r.found for r in base)


def test_gather_route_serves_no_region_rows(eng):
    res = eng.query(eng.data[:L], 0.5, alpha=1.05, beta=0.2)
    assert res.found
    assert res.stats.n_region_rows == 0 == res.stats.n_near_overflows


@pytest.mark.parametrize("length", [25, 100, 512, 1000, 4096, 8192, 12_024,
                                    30_000, 106_600])
def test_near_sums_are_within_err_where_the_engines_plan(length):
    pow2 = 1 << int(np.ceil(np.log2(length)))
    for m in (512, max(512, pow2)):
        assert trg.near_sums_within_err(length, m)


@pytest.mark.parametrize("length,m", [(1, 512), (2, 1024), (5, 512)])
def test_near_sums_outside_err_are_refused(length, m):
    assert not trg.near_sums_within_err(length, m)
