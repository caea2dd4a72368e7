"""Region phase 2: the PyTorch port against kvmatch_tpu.ops.regions.

Distances: |d2_port - d2_jax| <= err_jax, the per-offset f32 error bound the
JAX function returns with them (regions.py:190-191); the engines add that
bound to their guard band.  Near sets: both packages' sets contain every
exact (f64) answer in the region rows.  The numpy helpers are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu import verify as vf
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.ops import regions as jrg
from kvmatch_tpu_torch.ops import regions as trg

torch.set_num_threads(2)

N = 30_000


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def workload():
    """Two self-queries and region rows over their neighbourhoods plus one
    row far away, packed as the engines pack them."""
    data = generate_series(N, seed=21)
    L, M = 700, 512
    offs = np.asarray([4_321, 17_000])
    queries = np.stack([data[o:o + L] for o in offs])
    left = [np.asarray([o - 900, o + 2_000]) for o in offs]
    right = [np.asarray([o + 300, o + 2_100]) for o in offs]
    starts, vfrom, vto, qids = [], [], [], []
    for qi, (l, r) in enumerate(zip(left, right)):
        s, a, b = trg.pack_regions(l, r, N, L, M)
        starts.append(s)
        vfrom.append(a)
        vto.append(b)
        qids.append(np.full(s.size, qi, np.int32))
    return dict(data=data, L=L, M=M, offs=offs, queries=queries,
                starts=np.concatenate(starts), vfrom=np.concatenate(vfrom),
                vto=np.concatenate(vto), qids=np.concatenate(qids))


def test_region_ed_distances_within_jax_error_bound(workload):
    w = workload
    data32 = w["data"].astype(np.float32)
    center = float(np.float32(w["data"].mean()))
    qc = (w["queries"] - center).astype(np.float32)
    d2_j, err_j = (np.asarray(a) for a in jrg.region_ed_distances_multi(
        jnp.asarray(data32), jnp.asarray(qc), jnp.asarray(w["starts"]),
        jnp.asarray(w["qids"]), w["L"], w["M"], np.float32(center)))
    d2_t, err_t = (a.numpy() for a in trg.region_ed_distances_multi(
        _t(data32), _t(qc), _t(w["starts"]), _t(w["qids"]), w["L"], w["M"],
        center))
    assert d2_t.shape == d2_j.shape == (w["starts"].size, w["M"])
    assert np.all(np.abs(d2_t - d2_j) <= err_j)
    np.testing.assert_allclose(err_t, err_j, rtol=1e-3)


def test_region_znorm_distances_within_jax_error_bound(workload):
    w = workload
    data32 = w["data"].astype(np.float32)
    q = w["queries"]
    qhat = ((q - q.mean(1, keepdims=True)) / q.std(1, keepdims=True)
            ).astype(np.float32)
    want = [np.asarray(a) for a in jrg.region_znorm_distances_multi(
        jnp.asarray(data32), jnp.asarray(qhat), jnp.asarray(w["starts"]),
        jnp.asarray(w["qids"]), w["L"], w["M"])]
    got = [a.numpy() for a in trg.region_znorm_distances_multi(
        _t(data32), _t(qhat), _t(w["starts"]), _t(w["qids"]), w["L"], w["M"])]
    assert np.all(np.abs(got[0] - want[0]) <= want[3])
    scale = np.abs(data32).max()
    for g, e in zip(got[1:3], want[1:3]):
        assert np.all(np.abs(g - e) <= 1e-5 * scale)


def _in_rows(w, offsets, qi):
    """Offsets of query qi inside its region rows' valid windows."""
    sel = w["qids"] == qi
    lo = w["starts"][sel] + w["vfrom"][sel]
    hi = w["starts"][sel] + w["vto"][sel]
    return [o for o in offsets if np.any((lo <= o) & (o < hi))]


@pytest.mark.parametrize("eps", [3.0, 12.0])
def test_region_ed_near_sets_hold_every_answer(workload, eps):
    w = workload
    data32 = w["data"].astype(np.float32)
    center = float(np.float32(w["data"].mean()))
    qc = (w["queries"] - center).astype(np.float32)
    eps2 = eps * eps
    th = np.full(2, eps2 + vf.guard_threshold(eps2, w["L"], 1e-2), np.float32)
    near_k = 4096
    j = jrg.region_ed_near_multi(
        jnp.asarray(data32), jnp.asarray(qc), jnp.asarray(w["starts"]),
        jnp.asarray(w["qids"]), jnp.asarray(w["vfrom"]), jnp.asarray(w["vto"]),
        jnp.asarray(th), w["L"], w["M"], near_k, np.float32(center))
    t = trg.region_ed_near_multi(
        _t(data32), _t(qc), _t(w["starts"]), _t(w["qids"]), _t(w["vfrom"]),
        _t(w["vto"]), _t(th), w["L"], w["M"], near_k, center)
    sets = []
    for cnt, rows, cols in (j, t):
        cnt = int(cnt)
        assert cnt <= near_k
        rows, cols = np.asarray(rows)[:cnt], np.asarray(cols)[:cnt]
        flat = rows.astype(np.int64) * w["M"] + cols
        assert np.all(np.diff(flat) > 0)  # ascending, no duplicates
        sets.append({(int(w["qids"][r]), int(w["starts"][r] + c))
                     for r, c in zip(rows, cols)})
    for qi in range(2):
        ans, _ = oracle.rsm_ed(w["data"], w["queries"][qi], eps)
        inside = _in_rows(w, ans.tolist(), qi)
        assert w["offs"][qi] in inside
        for s in sets:
            assert {(qi, o) for o in inside} <= s


def test_region_znorm_near_sets_hold_every_answer(workload):
    w = workload
    data32 = w["data"].astype(np.float32)
    q = w["queries"]
    mu, sd = q.mean(1), q.std(1)
    qhat = ((q - mu[:, None]) / sd[:, None]).astype(np.float32)
    eps, alpha, beta = 4.0, 1.5, 5.0
    eps2 = eps * eps
    th = np.full(2, eps2 + vf.guard_threshold(eps2, w["L"], 1e-2), np.float32)
    cons = np.stack([[alpha, beta, mu[i], sd[i], 1e-3 * (1 + abs(mu[i]) + sd[i])]
                     for i in range(2)]).astype(np.float32)
    near_k = 4096
    j = jrg.region_znorm_near_multi(
        jnp.asarray(data32), jnp.asarray(qhat), jnp.asarray(w["starts"]),
        jnp.asarray(w["qids"]), jnp.asarray(w["vfrom"]), jnp.asarray(w["vto"]),
        jnp.asarray(th), jnp.asarray(cons), w["L"], w["M"], near_k)
    t = trg.region_znorm_near_multi(
        _t(data32), _t(qhat), _t(w["starts"]), _t(w["qids"]), _t(w["vfrom"]),
        _t(w["vto"]), _t(th), _t(cons), w["L"], w["M"], near_k)
    for qi in range(2):
        ans, _ = oracle.nsm_ed(w["data"], q[qi], eps, alpha=alpha, beta=beta)
        inside = _in_rows(w, ans.tolist(), qi)
        assert w["offs"][qi] in inside
        for cnt, rows, cols in (j, t):
            cnt = int(cnt)
            rows, cols = np.asarray(rows)[:cnt], np.asarray(cols)[:cnt]
            got = {int(w["starts"][r] + c) for r, c in zip(rows, cols)
                   if w["qids"][r] == qi}
            assert set(inside) <= got


def test_near_compact_contract():
    """Count of every match, the first near_k in ascending row-major order,
    and an overflowing count the caller can see."""
    rng = np.random.default_rng(4)
    mask = rng.random((7, 300)) < 0.05
    want_r, want_c = np.nonzero(mask)
    cnt, rows, cols = trg._near_compact(torch.as_tensor(mask), 1000)
    assert cnt == want_r.size
    np.testing.assert_array_equal(rows.numpy()[:cnt], want_r)
    np.testing.assert_array_equal(cols.numpy()[:cnt], want_c)
    cnt, rows, cols = trg._near_compact(torch.as_tensor(mask), 10)
    assert cnt == want_r.size > 10
    np.testing.assert_array_equal(rows.numpy()[:10], want_r[:10])


@pytest.mark.parametrize("seed,gap", [(0, 0), (1, 5), (2, 512)])
def test_coalesce_and_pack_equal_jax(seed, gap):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 900, 40)
    gaps = rng.integers(1, 700, 40)
    left = np.cumsum(gaps + np.concatenate(([0], lengths[:-1]))).astype(np.int64)
    right = left + lengths - 1
    for a, b in zip(trg.coalesce_intervals(left, right, gap),
                    jrg.coalesce_intervals(left, right, gap)):
        np.testing.assert_array_equal(a, b)
    n = int(right[-1]) + 50
    for length, m in [(128, 512), (4096, 1024)]:
        for a, b in zip(trg.pack_regions(left, right, n, length, m),
                        jrg.pack_regions(left, right, n, length, m)):
            np.testing.assert_array_equal(a, b)
