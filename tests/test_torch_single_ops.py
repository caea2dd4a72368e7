"""The port's single-query device ops against their JAX originals.

``ed_distances`` / ``znorm_ed_distances`` (K2 with a one-row query batch),
``region_ed_distances`` / ``region_znorm_distances`` (the region FFT with
qids 0), ``dtw_banded_batch`` / ``dtw_banded_batch_multi`` (K3 or K4),
``dtw_banded_batch_ds_multi`` (DS), ``lb_kim`` / ``lb_keogh`` and the scalar
f64 DP ``oracle.dtw_banded``, on seeded numpy inputs at small sizes.  On
CPU tensors each wrapper runs its kernel's plain version; the card's
kernels are held bit-equal to the ``_multi`` calls in
tests/test_torch_kernels_cuda.py.

Tolerances:

* window distances: d2 within rtol 1e-5 (queries are noisy copies of
  windows, so no d2 is near 0); inf at the same rows (constant windows);
  the window mean within 1e-5 of the window's max |x| (the summation-order
  difference of tests/test_torch_ed.py), the std within rtol 1e-5;
* regions: raw d2 within JAX's own ``err``; z-norm d2 and std within rtol
  1e-4, the mean as above;
* banded DTW (f32): within ``verify.guard_threshold(d, L, 1e-2)`` of JAX's
  and within rtol 1e-4 of ``oracle.dtw_banded``, as
  tests/test_dtw_kernels.py holds JAX's;
* double-single DTW: hi + lo within 8 eps32 (d + 1) of JAX's ``ds_value``;
* LB_Kim and LB_Keogh: rtol 1e-6 of JAX's, and never above the f64 DTW
  (plus the f32 guard);
* ``oracle.dtw_banded``: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle as joracle
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.ops import dtw as jdtw
from kvmatch_tpu.ops import ed as jed
from kvmatch_tpu.ops import regions as jregions
from kvmatch_tpu_torch import oracle as toracle
from kvmatch_tpu_torch import verify
from kvmatch_tpu_torch.ops import dtw as tdtw
from kvmatch_tpu_torch.ops import ed as ted
from kvmatch_tpu_torch.ops import regions as tregions
from kvmatch_tpu_torch.plan import envelope

torch.set_num_threads(2)

LENGTHS = (64, 256, 1024)
EPS32 = float(np.finfo(np.float32).eps)


def _band(L, which):
    return {"0": 0, "5": 5, "L-1": L - 1}[which]


def _series(n, seed, flat_at=None, flat_len=0):
    """f32 series; ``flat_at``: a constant run of ``flat_len`` points."""
    data = generate_series(n, seed=seed).astype(np.float32)
    if flat_at is not None:
        data[flat_at:flat_at + flat_len] = 0.5
    return data


def _znorm(q):
    q = np.asarray(q, np.float64)
    return ((q - q.mean()) / q.std()).astype(np.float32)


def _rows(L, B, seed, znormed):
    """(B, L) windows of a series and a query per row (noisy windows)."""
    rng = np.random.default_rng(seed)
    data = generate_series(20_000 + L, seed=seed)
    offs = rng.integers(0, data.size - L + 1, 2 * B)
    a = np.stack([data[o:o + L] for o in offs[:B]])
    q = np.stack([data[o:o + L] for o in offs[B:]]) + \
        rng.normal(0, 0.1, (B, L))
    if znormed:
        a = np.stack([_znorm(x) for x in a])
        q = np.stack([_znorm(x) for x in q])
    return a.astype(np.float32), q.astype(np.float32)


# n = 50,000 keeps JAX's window gather on its direct path; 40,960 (a
# multiple of 256) on its tiled path (tests/conftest.py).
@pytest.mark.parametrize("n", [50_000, 40_960])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
@pytest.mark.parametrize("L", LENGTHS)
def test_window_distances_equal_jax(L, znorm, n):
    rng = np.random.default_rng(L + znorm)
    data = _series(n, seed=L, flat_at=1_000, flat_len=L + 20)
    offs = rng.integers(0, n - L + 1, 300).astype(np.int64)
    offs[:4] = [0, n - L, 1_000, 1_010]      # both ends, two flat windows
    s = int(rng.integers(0, n - L + 1))
    q = data[s:s + L] + rng.normal(0, 0.05, L).astype(np.float32)
    jdata, joffs = jnp.asarray(data), jnp.asarray(offs, jnp.int32)
    tdata, toffs = torch.as_tensor(data), torch.as_tensor(offs)
    if not znorm:
        want = np.asarray(jed.ed_distances(jdata, jnp.asarray(q), joffs, L))
        got = ted.ed_distances(tdata, torch.as_tensor(q), toffs, L).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        return
    qh = _znorm(q)
    want = [np.asarray(x) for x in jed.znorm_ed_distances(
        jdata, jnp.asarray(qh), joffs, L)]
    got = [x.numpy() for x in ted.znorm_ed_distances(
        tdata, torch.as_tensor(qh), toffs, L)]
    assert np.isinf(want[0][2:4]).all()
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(want[0]))
    fin = np.isfinite(want[0])
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=1e-5)
    amax = np.abs(np.stack([data[o:o + L] for o in offs])).max(axis=1)
    assert np.all(np.abs(got[1] - want[1]) <= 1e-5 * amax)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
@pytest.mark.parametrize("L", LENGTHS)
def test_region_distances_equal_jax(L, znorm):
    n, M, B = 40_000, 512, 6
    rng = np.random.default_rng(3 * L + znorm)
    data = _series(n, seed=L + 1)
    starts = rng.integers(0, n - (M + L - 1) + 1, B).astype(np.int64)
    s = int(rng.integers(0, n - L + 1))
    q = data[s:s + L].astype(np.float64)
    jdata, jstarts = jnp.asarray(data), jnp.asarray(starts, jnp.int32)
    tdata, tstarts = torch.as_tensor(data), torch.as_tensor(starts)
    if not znorm:
        center = np.float32(q.mean())
        qc = (q - center).astype(np.float32)
        d2j, errj = (np.asarray(x) for x in jregions.region_ed_distances(
            jdata, jnp.asarray(qc), jstarts, L, M, center))
        d2, err = (x.numpy() for x in tregions.region_ed_distances(
            tdata, torch.as_tensor(qc), tstarts, L, M, float(center)))
        assert d2.shape == err.shape == (B, M)
        assert np.all(np.abs(d2 - d2j) <= errj)
        np.testing.assert_allclose(err, errj, rtol=1e-4)
        return
    qh = _znorm(rng.normal(size=L))   # far from every window: d2 near 2L
    want = [np.asarray(x) for x in jregions.region_znorm_distances(
        jdata, jnp.asarray(qh), jstarts, L, M)]
    got = [x.numpy() for x in tregions.region_znorm_distances(
        tdata, torch.as_tensor(qh), tstarts, L, M)]
    assert len(got) == 3 and got[0].shape == (B, M)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    amax = np.abs(data).max()
    assert np.all(np.abs(got[1] - want[1]) <= 1e-5 * amax)


@pytest.mark.parametrize("form", ["single", "multi"])
@pytest.mark.parametrize("band", ["0", "5", "L-1"])
@pytest.mark.parametrize("L", LENGTHS)
def test_dtw_banded_batch_equals_jax(L, band, form):
    r = _band(L, band)
    a, q = _rows(L, 6, seed=L + r, znormed=True)
    if form == "single":
        q = np.broadcast_to(q[0], a.shape)
        want = np.asarray(jdtw.dtw_banded_batch(jnp.asarray(a),
                                                jnp.asarray(q[0]), r))
        got = tdtw.dtw_banded_batch(torch.as_tensor(a),
                                    torch.as_tensor(q[0].copy()), r).numpy()
    else:
        want = np.asarray(jdtw.dtw_banded_batch_multi(jnp.asarray(a),
                                                      jnp.asarray(q), r))
        got = tdtw.dtw_banded_batch_multi(torch.as_tensor(a),
                                          torch.as_tensor(q), r).numpy()
    assert got.dtype == np.float32 and got.shape == (a.shape[0],)
    assert np.all(np.abs(got - want) <= verify.guard_threshold(want, L, 1e-2))
    ref = np.array([toracle.dtw_banded(a[b].astype(np.float64),
                                       q[b].astype(np.float64), r)
                    for b in range(2)])
    np.testing.assert_allclose(got[:2], ref, rtol=1e-4)


def test_dtw_band_past_the_rows_is_the_widest_band():
    """A radius past L - 1 is the band L - 1, in the port as in JAX."""
    a, q = _rows(64, 4, seed=9, znormed=False)
    got = tdtw.dtw_banded_batch(torch.as_tensor(a), torch.as_tensor(q[0]), 500)
    want = tdtw.dtw_banded_batch(torch.as_tensor(a), torch.as_tensor(q[0]), 63)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jwant = np.asarray(jdtw.dtw_banded_batch(jnp.asarray(a),
                                             jnp.asarray(q[0]), 500))
    assert np.all(np.abs(got.numpy() - jwant)
                  <= verify.guard_threshold(jwant, 64, 1e-2))


@pytest.mark.parametrize("band", ["0", "5", "L-1"])
@pytest.mark.parametrize("L", LENGTHS)
def test_dtw_ds_multi_equals_jax(L, band):
    r = _band(L, band)
    a, q = _rows(L, 4, seed=2 * L + r, znormed=True)
    want = jdtw.ds_value(*jdtw.dtw_banded_batch_ds_multi(
        jnp.asarray(a), jnp.asarray(q), r))
    hi, lo = tdtw.dtw_banded_batch_ds_multi(torch.as_tensor(a),
                                            torch.as_tensor(q), r)
    assert hi.dtype == lo.dtype == torch.float32
    got = tdtw.ds_value(hi.numpy(), lo.numpy())
    assert np.all(np.abs(got - want) <= 8 * EPS32 * (want + 1.0))


@pytest.mark.parametrize("band", ["0", "5", "L-1"])
@pytest.mark.parametrize("L", LENGTHS)
def test_lower_bounds_equal_jax(L, band):
    r = _band(L, band)
    a, q = _rows(L, 32, seed=5 * L + r, znormed=True)
    q = q[0]
    lo, hi = (x.astype(np.float32) for x in envelope(q, r))
    kim = tdtw.lb_kim(torch.as_tensor(a), torch.as_tensor(q)).numpy()
    keogh = tdtw.lb_keogh(torch.as_tensor(a), torch.as_tensor(lo),
                          torch.as_tensor(hi)).numpy()
    np.testing.assert_allclose(
        kim, np.asarray(jdtw.lb_kim(jnp.asarray(a), jnp.asarray(q))),
        rtol=1e-6)
    np.testing.assert_allclose(
        keogh, np.asarray(jdtw.lb_keogh(jnp.asarray(a), jnp.asarray(lo),
                                        jnp.asarray(hi))), rtol=1e-6)
    d64 = tdtw._dtw_banded_batch_f64_np(a, q, r)
    slack = verify.guard_threshold(d64, L, 1e-2)
    assert np.all(kim <= d64 + slack) and np.all(keogh <= d64 + slack)


@pytest.mark.parametrize("L,r", [(16, 3), (64, 0), (64, 5), (64, 63),
                                 (256, 5), (257, 40)])
def test_oracle_dtw_banded_equals_jax(L, r):
    rng = np.random.default_rng(L + r)
    for _ in range(3):
        a, b = rng.normal(size=L), rng.normal(size=L)
        assert toracle.dtw_banded(a, b, r) == joracle.dtw_banded(a, b, r)
