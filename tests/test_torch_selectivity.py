"""selectivity.py: the decade targets, the top-K distance profile against
the JAX region ops with ``jax.lax.top_k`` and against an f64 brute-force
profile, calibrate + replay on the CPU, and one file per run.

Tolerances: a profile value may differ from JAX's, and from the f64
distance of its window, by the f32 error bound the region op returns beside
it (regions.py's ERR_C / FFT_ERR_C terms, tests/test_torch_regions.py).  So
the top-K sets may differ only in windows whose f64 distance lies within
that bound of the K-th smallest, and a replayed query must hit its target
exactly wherever the f64 gap at the target rank is wider than twice that
bound.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.ops import regions as jrg
from kvmatch_tpu_torch import selectivity as sel
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.engine.norm_ed import NormQueryEngine
from kvmatch_tpu_torch.engine.rsm_ed import QueryEngine
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
from kvmatch_tpu_torch.ops import regions as trg

torch.set_num_threads(2)

N, L, M, K = 200_003, 512, 4096, 256


@pytest.fixture(scope="module")
def series():
    data = generate_series(N, seed=17)
    return data, torch.as_tensor(data.astype(np.float32))


def _params(q):
    mu = q.mean()
    return mu, np.sqrt(max(np.mean(q * q) - mu * mu, 0.0))


def _profile64(kind, data, q):
    """f64 squared distances of q to every window (+inf outside cNSM's
    constraint, as kvmatch_tpu.oracle.nsm_ed) and each window's f32 error
    bound (the region ops' formulas)."""
    m, Lq = data.size - q.size + 1, q.size
    win = np.lib.stride_tricks.sliding_window_view(data, Lq)[:m]
    d2 = np.empty(m)
    s2 = np.empty(m)
    mean = win.mean(axis=1)
    std = np.sqrt(np.maximum((win * win).mean(axis=1) - mean * mean, 0.0))
    mu_q, sd_q = _params(q)
    center = float(np.float32(q.mean()))  # the RSM profile's centre
    for s in range(0, m, 20_000):
        w = win[s:s + 20_000]
        if kind == "rsm":
            x = w - center
            d2[s:s + 20_000] = ((w - q) ** 2).sum(axis=1)
            s2[s:s + 20_000] = (x * x).sum(axis=1)
        else:
            z = (w - mean[s:s + 20_000, None]) / std[s:s + 20_000, None]
            d2[s:s + 20_000] = ((z - (q - mu_q) / sd_q) ** 2).sum(axis=1)
            s2[s:s + 20_000] = (w * w).sum(axis=1)
    if kind == "rsm":
        qc = q - center
        q2 = float(qc @ qc)
        corr = np.sqrt(s2 * q2)  # Cauchy-Schwarz bound of |corr|
        err = trg.ERR_C * (s2 + 2 * corr + q2) + 2 * trg.FFT_ERR_C * corr
    else:
        ratio = std / sd_q
        ok = (np.abs(mean - mu_q) <= sel.BETA) & (ratio <= sel.ALPHA) \
            & (ratio >= 1.0 / sel.ALPHA)
        d2 = np.where(ok, d2, np.inf)
        err = (2 * trg.FFT_ERR_C * np.sqrt(s2 * Lq)
               + trg.ERR_C * 2 * Lq) / std
    return d2, err


def _jax_profile(kind, data, q, k):
    """kvmatch_tpu.ops.regions over the same rows, the same coverage mask
    and constraint, then jax.lax.top_k: the k smallest values, ascending."""
    n = data.size
    m = n - L + 1
    nrows = -(-m // M)
    starts = np.minimum(np.arange(nrows) * M, n - (M + L - 1))
    dj = jnp.asarray(data.astype(np.float32))
    sj = jnp.asarray(starts, jnp.int32)
    if kind == "rsm":
        center = float(np.float32(q.mean()))
        d2, _ = jrg.region_ed_distances(dj, jnp.asarray(q - center,
                                                        jnp.float32),
                                        sj, L, M, np.float32(center))
    else:
        mu_q, sd_q = _params(q)
        d2, mean, std = jrg.region_znorm_distances(
            dj, jnp.asarray((q - mu_q) / sd_q, jnp.float32), sj, L, M)
        a, b = np.float32(sel.ALPHA), np.float32(sel.BETA)
        mq, sq = np.float32(mu_q), np.float32(sd_q)
        ok = (jnp.abs(mean - mq) <= b) & (std <= a * sq) & (std >= sq / a)
        d2 = jnp.where(ok, d2, jnp.inf)
    pos = starts[:, None] + np.arange(M)[None, :]
    g = np.arange(nrows)[:, None]
    keep = (pos >= g * M) & (pos < np.minimum((g + 1) * M, m))
    d2 = jnp.where(jnp.asarray(keep), d2, jnp.inf)
    best, _ = jax.lax.top_k(-d2.reshape(-1), k)
    return -np.asarray(best)


def test_decade_targets_follow_n():
    assert sel.decade_targets(100_000_000) == {-8: 3, -7: 30, -6: 300,
                                               -5: 3000}
    assert [sel.decade_bounds(100_000_000, d) for d in sel.DECADES] == [
        (1, 10), (10, 100), (100, 1000), (1000, 10000)]
    assert sel.topk_size(100_000_000) == 4096
    assert sel.decade_targets(1_000_000) == {-8: 1, -7: 1, -6: 3, -5: 30}
    assert sel.decade_bounds(1_000_000, -5) == pytest.approx((10, 100))
    big = sel.topk_size(10_000_000_000)  # largest target 300,000
    assert big > max(sel.decade_targets(10_000_000_000).values())


@pytest.mark.parametrize("kind", ["rsm", "cnsm"])
def test_topk_profile_equals_jax_and_f64(series, kind):
    data, dt = series
    q = data[77_777:77_777 + L]
    vals, pos = sel.topk_profile(kind, dt, q, K, chunk=7)
    vals, pos = vals.numpy(), pos.numpy()
    assert len(set(pos.tolist())) == K
    # cNSM's constraint may leave fewer than K windows: the rest are +inf.
    fin = np.isfinite(vals)
    k = int(fin.sum())
    assert fin[:k].all() and np.all(np.diff(vals[:k]) >= 0)
    vals, pos = vals[:k], pos[:k]
    d64, err = _profile64(kind, data, q)
    want = _jax_profile(kind, data, q, K)
    assert int(np.isfinite(want).sum()) == k == min(K, np.isfinite(d64).sum())
    tol = err[pos].max()
    assert np.all(np.abs(vals - want[:k]) <= tol)
    assert np.all(np.abs(vals - d64[pos]) <= err[pos])
    # The k smallest as a set, but for ties inside the error bound.
    order = np.argsort(d64, kind="stable")
    kth = d64[order[k - 1]]
    for p in set(pos.tolist()) ^ set(order[:k].tolist()):
        assert abs(d64[p] - kth) <= 2 * err[p], (p, d64[p], kth)
    assert pos[0] == 77_777 and vals[0] <= err[77_777]


@pytest.mark.parametrize("kind", ["rsm", "cnsm"])
def test_calibrate_replay_hits_targets(series, kind):
    data, dt = series
    icfg = IndexConfig()
    index = build_index_device_stats(data, icfg, data_dev=dt)
    qcfg = QueryConfig(dense_probe_min_count=0)
    offs = np.sort(np.random.default_rng(5).integers(0, N - L, 3))
    targets = {-6: 1, -5: 6, -4: 40}
    eps, sec = sel.calibrate(kind, data, dt, offs, L, targets, K)
    assert sec > 0 and all(len(v) == 3 for v in eps.values())
    cls, params = ((QueryEngine, {}) if kind == "rsm" else
                   (NormQueryEngine, dict(alpha=sel.ALPHA, beta=sel.BETA)))
    eng = cls(data, index=index, icfg=icfg, qcfg=qcfg, device_data=dt)
    lines = sel.replay(eng, kind, data, offs, L, eps, params, targets)
    profiles = [_profile64(kind, data, data[o:o + L]) for o in offs]
    wide = 0
    for line, (d, t) in zip(lines, targets.items()):
        assert line["false_dismissals"] == 0
        assert line["target"] == t and line["n_queries"] == 3
        assert line["exact_count"] == sum(a == t for a in line["answers"])
        for j, (d64, err) in enumerate(profiles):
            order = np.argsort(d64, kind="stable")
            lo, hi = order[t - 1], order[t]
            if np.isfinite(d64[hi]) and \
                    d64[hi] - d64[lo] > 2 * (err[lo] + err[hi]):
                wide += 1
                assert line["answers"][j] == t, (d, offs[j])
    assert wide >= 6  # most (query, decade) gaps are wide


def test_rsm_calibration_far_from_the_series_mean(series):
    """A raw-ED query whose windows lie far from the series mean (the second
    half of the series lifted by 100): ``calibrate``'s eps gives an f64
    answer count equal to the target at every decade.  A centre shared by
    all queries, the series mean, would leave the near windows about 50
    from it, their energies about 1e6 (f32 ulp 0.06-0.125, as at n = 1e8
    and L = 8192) and eps on tied f32 values: 8 of these 12 counts then
    missed their targets."""
    data, _ = series
    far = data.copy()
    far[N // 2:] += 100.0
    dt = torch.as_tensor(far.astype(np.float32))
    offs = np.sort(np.random.default_rng(11).integers(N // 2, N - L, 3))
    targets = {-6: 1, -5: 6, -4: 40, -3: 200}
    eps, _ = sel.calibrate("rsm", far, dt, offs, L, targets, K)
    for j, o in enumerate(offs):
        d64, _ = _profile64("rsm", far, far[o:o + L])
        for d, t in targets.items():
            assert int(np.sum(d64 <= eps[d][j] ** 2)) == t, (o, d)


def test_two_runs_write_two_files(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sel, "OUT_DIR", tmp_path)
    argv = ["--n", "30000", "--length", "256", "--per-decade", "2",
            "--device", "cpu"]
    assert sel.main(argv) == 0
    assert sel.main(argv) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["selectivity_torch_run1.jsonl",
                     "selectivity_torch_run2.jsonl"]
    for f in files:
        lines = [json.loads(s) for s in (tmp_path / f).read_text().splitlines()]
        assert lines[0]["section"] == "setup" and lines[-1]["section"] == "done"
        decades = [ln for ln in lines if ln["section"].endswith("_decade")]
        assert len(decades) == 8 and lines[-1]["false_dismissals"] == 0
    with pytest.raises(FileExistsError):
        sel.main(argv + ["--out", str(tmp_path / files[0])])


def test_without_a_card_exits_2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sel.main(["--n", "30000"]) == 2
