"""DTW ops of the port (kvmatch_tpu_torch/ops/dtw.py) against kvmatch_tpu.

On the CPU every DP stage runs its kernel's plain version.  Tolerances:

* ``dtw_banded_plain`` (the plain version of K3/K4) against JAX's XLA DP and
  the f64 twin: rtol 1e-4 (f32 summation order; tests/test_dtw_kernels.py).
* ``dtw_banded_ds_plain`` (the plain version of the DS kernel): hi + lo
  within 8 eps32 (d64 + 1) of the f64 DP on the same f32 inputs, and within
  ds_guard / 4 of the all-f64 pipeline (tests/test_dtw_guard.py:62,81).
* LB stages: equal to JAX's within 1e-5 relative (f32 reductions), and never
  above the f64 banded DTW.
The CUDA kernels are held against these plain versions in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu import verify as vf
from kvmatch_tpu.oracle import dtw_banded
from kvmatch_tpu.ops import dtw as jd
from kvmatch_tpu.ops.sliding import sliding_min_max as jax_envelope
from kvmatch_tpu.plan import envelope
from kvmatch_tpu_torch.ops import dtw as td
from kvmatch_tpu_torch.ops.sliding import sliding_min_max

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _t(x, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)


# tests/test_dtw_kernels.py:11, plus a band wider than the window
@pytest.mark.parametrize("L,r", [(16, 3), (50, 5), (100, 10), (64, 0),
                                 (30, 29), (33, 7), (40, 100)])
def test_plain_dp_matches_jax_and_f64(L, r):
    rng = np.random.default_rng(L + r)
    B, Q = 6, 3
    a = rng.normal(size=(B, L)).astype(np.float32)
    qm = rng.normal(size=(Q, L)).astype(np.float32)
    qids = rng.integers(0, Q, B).astype(np.int32)
    got = td.dtw_banded_plain(_t(a), _t(qm), _t(qids), r).numpy()
    want = np.asarray(jd.dtw_banded_batch_multi(jnp.asarray(a),
                                                jnp.asarray(qm[qids]), r))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ref = np.array([dtw_banded(a[b].astype(np.float64),
                               qm[qids[b]].astype(np.float64), min(r, L - 1))
                    for b in range(B)])
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    f64 = td.dtw_banded_plain(_t(a, torch.float64), _t(qm, torch.float64),
                              _t(qids), r).numpy()
    np.testing.assert_allclose(f64, ref, rtol=1e-12)
    np.testing.assert_allclose(
        td._dtw_banded_batch_f64_np(a[:1], qm[qids[0]], min(r, L - 1)),
        ref[:1], rtol=1e-12)
    if r == 0:
        ed = ((a.astype(np.float64) - qm[qids]) ** 2).sum(axis=1)
        np.testing.assert_allclose(got, ed, rtol=1e-5)


def _guard_windows(kind, B, L, rng):
    """tests/test_dtw_guard.py's adversarial windows: half the batch is the
    query plus small noise (the near-threshold regime)."""
    n = 20_000
    if kind == "walk":
        x = np.cumsum(rng.standard_normal(n) * 0.5)
    elif kind == "spiky":
        x = rng.standard_normal(n)
        x[rng.integers(0, n, n // 50)] *= 40.0
    else:  # a large common-mode value
        x = 300.0 + np.cumsum(rng.standard_normal(n) * 0.1)
    offs = rng.integers(0, n - L, B)
    win = np.stack([x[o:o + L] for o in offs])
    q = x[offs[0]:offs[0] + L].copy()
    win[B // 2:] = q[None, :] + rng.standard_normal((B - B // 2, L)) * 0.05
    return win, q


@pytest.mark.parametrize("kind", ["walk", "spiky", "offset"])
def test_ds_plain_within_guard_bounds(kind):
    L, rho, B = 256, 12, 16
    rng = np.random.default_rng(len(kind))
    win, q = _guard_windows(kind, B, L, rng)
    w32 = win.astype(np.float32)
    q32 = q.astype(np.float32)
    hi, lo = td.dtw_banded_ds_plain(_t(w32), _t(q32[None]),
                                    _t(np.zeros(B, np.int32)), rho)
    got = td.ds_value(hi.numpy(), lo.numpy())
    same = td._dtw_banded_batch_f64_np(w32, q32, rho)
    assert np.all(np.abs(got - same) <= 8.0 * EPS32 * (same + 1.0))
    d64 = td._dtw_banded_batch_f64_np(win, q, rho)
    amp = np.abs(w32).max(axis=1) + abs(float(q.max())) + 1.0
    assert np.all(np.abs(got - d64) <= vf.ds_guard(d64, L, amp) / 4.0)
    jh, jl = jd.dtw_banded_batch_ds_multi(
        jnp.asarray(w32), jnp.asarray(np.broadcast_to(q32, w32.shape)), rho)
    assert np.all(np.abs(got - jd.ds_value(jh, jl))
                  <= 8.0 * EPS32 * (same + 1.0))


def _lb_case(seed, n=4000, L=64, r=6, B=128):
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(size=n)) * 0.1
    offs = rng.integers(0, n - L, size=B)
    return rng, data, data.astype(np.float32), offs, L, r


def test_lb_stage_matches_jax_and_bounds_dtw():
    """tests/test_dtw_kernels.py:46's cascade, with int64 offsets."""
    rng, data, d32, offs, L, r = _lb_case(5)
    q = data[100:100 + L] + rng.normal(size=L) * 0.05
    lo, hi = envelope(q, r)
    e_lo, e_hi = sliding_min_max(_t(d32), r)
    qids = np.zeros(offs.size, np.int32)
    got = td.lb_stage_multi(_t(d32), e_lo, e_hi, _t(q[None], torch.float32),
                            _t(lo[None], torch.float32),
                            _t(hi[None], torch.float32), _t(offs), _t(qids),
                            L).numpy()
    j_lo, j_hi = jax_envelope(jnp.asarray(d32), r)
    want = np.asarray(jd.lb_stage_multi(
        jnp.asarray(d32), j_lo, j_hi, jnp.asarray(q[None], jnp.float32),
        jnp.asarray(lo[None], jnp.float32), jnp.asarray(hi[None], jnp.float32),
        jnp.asarray(offs.astype(np.int32)), jnp.asarray(qids), L))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    true = td._dtw_banded_batch_f64_np(data[offs[:, None] + np.arange(L)],
                                       q, r)
    assert (got <= true * (1 + 1e-4) + 1e-3).all()
    assert (got > 0).any()


def test_lb_stage_znorm_matches_jax_and_bounds_dtw():
    """tests/test_dtw_kernels.py:86's z-space cascade; one query's rows
    carry constraints that fail (inf)."""
    rng, data, d32, offs, L, r = _lb_case(6)
    q = data[200:200 + L]
    mu_q, sd_q = q.mean(), q.std()
    zq = (q - mu_q) / sd_q
    lo, hi = envelope(zq, r)
    cons = np.asarray([[1e9, 1e9, mu_q, sd_q, 0.0],
                       [1.01, 1e-3, mu_q, sd_q, 0.0]], np.float32)
    zq_m, lo_m, hi_m = (np.stack([v, v]).astype(np.float32)
                        for v in (zq, lo, hi))
    qids = (np.arange(offs.size) % 2).astype(np.int32)
    e_lo, e_hi = sliding_min_max(_t(d32), r)
    got = td.lb_stage_znorm_multi(_t(d32), e_lo, e_hi, _t(zq_m), _t(lo_m),
                                  _t(hi_m), _t(cons), _t(offs), _t(qids),
                                  L).numpy()
    j_lo, j_hi = jax_envelope(jnp.asarray(d32), r)
    want = np.asarray(jd.lb_stage_znorm_multi(
        jnp.asarray(d32), j_lo, j_hi, jnp.asarray(zq_m), jnp.asarray(lo_m),
        jnp.asarray(hi_m), jnp.asarray(cons),
        jnp.asarray(offs.astype(np.int32)), jnp.asarray(qids), L))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin[qids == 0].all() and not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    windows = data[offs[:, None] + np.arange(L)]
    mu = windows.mean(axis=1, keepdims=True)
    sd = windows.std(axis=1, keepdims=True)
    true = td._dtw_banded_batch_f64_np((windows - mu) / sd, zq, r)
    assert (got[fin] <= true[fin] * (1 + 1e-3) + 1e-2).all()


def test_dp_stages_match_jax():
    """The gather + (z-)DP and DS stages against JAX's XLA stages."""
    rng, data, d32, offs, L, r = _lb_case(7, B=24)
    qs = np.stack([data[o:o + L] for o in (300, 1700)])
    zqs = (qs - qs.mean(1, keepdims=True)) / qs.std(1, keepdims=True)
    qids = rng.integers(0, 2, offs.size).astype(np.int32)
    dev = [_t(a) for a in (d32, qs.astype(np.float32),
                           zqs.astype(np.float32), offs, qids)]
    jx = [jnp.asarray(a) for a in (d32, qs.astype(np.float32),
                                   zqs.astype(np.float32),
                                   offs.astype(np.int32), qids)]
    got = td.dtw_stage_multi(dev[0], dev[1], dev[3], dev[4], L, r).numpy()
    want = np.asarray(jd._dtw_stage_multi_xla(jx[0], jx[1], jx[3], jx[4],
                                              L, r))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    got = td.dtw_stage_znorm_multi(dev[0], dev[2], dev[3], dev[4], L,
                                   r).numpy()
    want = np.asarray(jd._dtw_stage_znorm_multi_xla(jx[0], jx[2], jx[3],
                                                    jx[4], L, r))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    win = data[offs[:, None] + np.arange(L)]
    mu = win.mean(1).astype(np.float32)
    sd = win.std(1).astype(np.float32)
    got = td.dtw_stage_znorm_ds_multi(dev[0], dev[2], dev[3], dev[4],
                                      _t(mu), _t(sd), L, r)
    want = jd.dtw_stage_znorm_ds_multi(jx[0], jx[2], jx[3], jx[4],
                                       jnp.asarray(mu), jnp.asarray(sd), L, r)
    d_got = td.ds_value(got[0].numpy(), got[1].numpy())
    d_want = jd.ds_value(want[0], want[1])
    assert np.all(np.abs(d_got - d_want) <= 8.0 * EPS32 * (d_want + 1.0))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    got = td.dtw_stage_ds_multi(dev[0], dev[1], dev[3], dev[4], L, r)
    want = jd.dtw_stage_ds_multi(jx[0], jx[1], jx[3], jx[4], L, r)
    d_want = jd.ds_value(want[0], want[1])
    assert np.all(np.abs(td.ds_value(got[0].numpy(), got[1].numpy())
                         - d_want) <= 8.0 * EPS32 * (d_want + 1.0))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_variant_selects_k4_route(monkeypatch):
    """DTW_STATE picks the f32 DP the stages call (K3 by default)."""
    calls = []
    monkeypatch.setattr(td, "dtw_diag", lambda *a: calls.append("diag"))
    monkeypatch.setattr(td, "dtw_rows", lambda *a: calls.append("rows"))
    x = torch.zeros(500)
    args = (x, torch.zeros((1, 50)), torch.zeros(2, dtype=torch.int64),
            torch.zeros(2, dtype=torch.int32), 50, 3)
    td.dtw_stage_multi(*args)
    monkeypatch.setitem(td.DTW_STATE, "variant", "rows")
    td.dtw_stage_multi(*args)
    assert calls == ["diag", "rows"]


@pytest.mark.slow  # the Pallas kernels in interpret mode trace slowly
def test_plain_dp_matches_pallas_kernels():
    """dtw_banded_plain against both Pallas kernels (K3 and K4) in interpret
    mode, as tests/test_pallas_kernels.py:76-114 holds them to the f64 DP."""
    from kvmatch_tpu.ops.dtw_pallas import (dtw_banded_pallas_diag_multi,
                                            dtw_banded_pallas_multi)
    rng = np.random.default_rng(8)
    for B, L, r in [(5, 100, 7), (4, 128, 0), (3, 64, 200)]:
        a = rng.normal(size=(B, L)).astype(np.float32)
        a[0] += 100.0
        q = rng.normal(size=(B, L)).astype(np.float32)
        q[0] += 100.0
        got = td.dtw_banded_plain(_t(a), _t(q), _t(np.arange(B, dtype=np.int32)),
                                  r).numpy()
        for fn in (dtw_banded_pallas_diag_multi, dtw_banded_pallas_multi):
            rr = min(r, L - 1) if fn is dtw_banded_pallas_multi else r
            want = np.asarray(fn(jnp.asarray(a), jnp.asarray(q), rr,
                                 interpret=True))
            np.testing.assert_allclose(got, want, rtol=3e-4, atol=1e-2)
