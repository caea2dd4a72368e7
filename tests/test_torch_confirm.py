"""cNSM-ED's exact f64 confirm on the device, on the CPU.

K2's f64 form (``ops/ed.py:window_ed_f64``, its plain version
``window_ed_plain`` with f64 queries) against the host confirm's arithmetic
(``engine/norm_ed.py:host_znorm_stats``), and the engine's choice between
them: an engine whose device series holds the host shadow's values exactly
confirms on the device (``n_device_confirmed``), any other on the host
(``n_host_rechecked``), and both equal the oracle.  On the CPU the device
route runs the plain version; tests/test_torch_kernels_cuda.py holds the
kernel to it on the card.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu_torch import NormQueryEngine, NormQueryEngineDtw, oracle
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.engine.norm_ed import host_znorm_stats
from kvmatch_tpu_torch.index.device_build import (build_index_device,
                                                  build_index_device_stats)
from kvmatch_tpu_torch.ops import ed as ted
from kvmatch_tpu_torch.state import series_to_device

torch.set_num_threads(2)

N, L = 200_000, 512
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
ALPHA, BETA = 1.05, 0.2
#: Self-queries by the phase-2 route they take on the f32 series:
#: (offset, eps).
ROUTES = {"region": (161_000, 3.0), "gather": (0, 3.0)}


def _plain_f64(data, q_hat, offs):
    return [t.numpy() for t in ted.window_ed_plain(
        torch.as_tensor(data, dtype=torch.float32),
        torch.as_tensor(q_hat[None]), torch.as_tensor(offs),
        torch.zeros(offs.size, dtype=torch.int32), q_hat.size, znorm=True)]


def _exact(data, q_hat, offs):
    """(d2, mean, std) with two-pass centring in long double."""
    x = data[offs[:, None] + np.arange(q_hat.size)].astype(np.longdouble)
    mu = x.mean(axis=1)
    c = x - mu[:, None]
    sd = np.sqrt((c * c).mean(axis=1))
    diff = c / sd[:, None] - q_hat.astype(np.longdouble)
    return (diff * diff).sum(axis=1), mu, sd


def _windows(seed, offset=0.0):
    """An f32 series (a constant ``offset`` added), random window offsets
    and a z-normalized query row."""
    rng = np.random.default_rng(seed)
    data = (generate_series(50_000, seed=seed) + offset).astype(np.float32)
    offs = rng.integers(0, data.size - L + 1, 300)
    start = int(rng.integers(0, data.size - L))
    q = data[start:start + L].astype(np.float64)
    q_hat = (q - q.mean()) / q.std()
    return data, offs, q_hat


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_f64_equals_host_confirm(seed):
    """Within 1e-12 relative (d2 within 1e-12 L, its scale in z-space)."""
    data, offs, q_hat = _windows(seed)
    got = _plain_f64(data, q_hat, offs)
    want = host_znorm_stats(data.astype(np.float64), offs, q_hat)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12 * L)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def test_plain_f64_holds_a_large_constant_offset():
    """std/|mean| about 1e-4: the plain version's centred two passes stay
    within 1e-12 of a long-double reference; the host's one-pass variance
    E[x^2] - mean^2 loses about 8 digits there, and meets 1e-12 only in the
    mean."""
    data, offs, q_hat = _windows(3, offset=1e4)
    x = data[offs[:, None] + np.arange(L)].astype(np.float64)
    ratio = x.std(axis=1) / np.abs(x.mean(axis=1))
    assert 1e-5 < np.median(ratio) < 1e-3
    got = _plain_f64(data, q_hat, offs)
    exact = [e.astype(np.float64) for e in _exact(data, q_hat, offs)]
    np.testing.assert_allclose(got[0], exact[0], rtol=1e-12, atol=1e-12 * L)
    for g, e in zip(got[1:], exact[1:]):
        np.testing.assert_allclose(g, e, rtol=1e-12, atol=0)
    host = host_znorm_stats(data.astype(np.float64), offs, q_hat)
    np.testing.assert_allclose(host[1], exact[1], rtol=1e-12, atol=0)
    np.testing.assert_allclose(host[2], exact[2], rtol=1e-6, atol=0)


def test_plain_f64_flat_window_is_inf():
    data, offs, q_hat = _windows(4)
    data[1000:1000 + L] = 2.5
    offs[:2] = [1000, 999]
    got = _plain_f64(data, q_hat, offs)
    host = host_znorm_stats(data.astype(np.float64), offs, q_hat)
    assert got[2][0] == 0.0 and host[2][0] == 0.0 and got[1][0] == 2.5
    assert np.isinf(got[0][0])
    assert np.isfinite(got[0][1:]).all() and (got[2][1:] > 0).all()


def test_window_ed_f64_rejects_bad_input():
    data = torch.zeros(1000)
    q = torch.zeros((1, 100), dtype=torch.float64)
    off = torch.zeros(4, dtype=torch.int64)
    qid = torch.zeros(4, dtype=torch.int32)
    bad = [(data, q.float(), off, qid),  # f32 queries
           (data, q, qid, qid),  # int32 offsets
           (data.double(), q, off, qid),  # f64 data
           (torch.zeros(2000)[::2], q, off, qid)]  # not contiguous
    for args in bad:
        with pytest.raises(ValueError, match="window_ed_f64"):
            ted.window_ed_f64(*args, 100)
    out = ted.window_ed_f64(data, q, off, qid, 100)
    assert out.shape == (3, 4) and out.dtype == torch.float64


# ---------------------------------------------------------------- engines
def _series(dtype):
    return generate_series(N, seed=5).astype(dtype)


@pytest.fixture(scope="module")
def engines():
    """A resident engine on the f32 series, and one on the f64 series
    (whose values f32 does not hold), over the stats-only index."""
    out = {}
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        host, dev = series_to_device(_series(dt), "cpu")
        index = build_index_device_stats(host, IndexConfig(), data_dev=dev)
        out[name] = NormQueryEngine(host, index=index, qcfg=SERVE,
                                    device_data=dev)
    return out


def _spy_routes(eng, monkeypatch):
    taken = []
    for route, meth in (("region", "_verify_regions"),
                        ("gather", "_verify_gather")):
        def spy(*a, _orig=getattr(eng, meth), _route=route, **kw):
            taken.append(_route)
            return _orig(*a, **kw)
        monkeypatch.setattr(eng, meth, spy)
    return taken


def _oracle(eng, q, eps):
    want, _ = oracle.nsm_ed(eng.data, q, eps, alpha=ALPHA, beta=BETA,
                            device="cpu")
    return sorted(want.tolist())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_f32_series_confirms_on_the_device(engines, route, monkeypatch):
    eng = engines["f32"]
    assert eng.confirm_on_device
    taken = _spy_routes(eng, monkeypatch)
    off, eps = ROUTES[route]
    q = eng.data[off:off + L]
    res = eng.query(q, eps, alpha=ALPHA, beta=BETA)
    assert taken == [route]
    assert res.stats.n_device_confirmed > 0
    assert res.stats.n_host_rechecked == 0
    assert sorted(res.offsets.tolist()) == _oracle(eng, q, eps)
    assert off in res.offsets.tolist()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_f64_series_confirms_on_the_host(engines, route):
    eng = engines["f64"]
    assert not eng.confirm_on_device
    off, eps = ROUTES[route]
    q = eng.data[off:off + L]
    res = eng.query(q, eps, alpha=ALPHA, beta=BETA)
    assert res.stats.n_host_rechecked > 0
    assert res.stats.n_device_confirmed == 0
    assert sorted(res.offsets.tolist()) == _oracle(eng, q, eps)


def test_batch_counts_its_device_confirms(engines):
    eng = engines["f32"]
    offs = [161_000, 46_000, 0]
    qs = np.stack([eng.data[o:o + L] for o in offs])
    out = eng.query_batch(qs, 3.0, alpha=ALPHA, beta=BETA)
    for o, r in zip(offs, out):
        assert r.stats.n_host_rechecked == 0
        assert r.stats.n_device_confirmed >= r.offsets.size
        assert sorted(r.offsets.tolist()) == _oracle(eng, eng.data[o:o + L],
                                                     3.0)


def test_confirm_on_device_follows_the_values():
    """The check: an f32 input, an f64 input of f32 values and a tensor
    equal to the shadow pass; an f64 input f32 does not hold, a tensor one
    point off and a host-only engine do not."""
    data32 = _series(np.float32)[:20_000]
    data64 = _series(np.float64)[:20_000]
    index = build_index_device_stats(data32.astype(np.float64), IndexConfig(),
                                     device="cpu")

    def eng(data, **kw):
        return NormQueryEngine(data, index=index, qcfg=SERVE, device="cpu",
                               **kw).confirm_on_device

    bumped = data32.copy()
    bumped[12_345] = np.nextafter(bumped[12_345], np.float32(np.inf))
    off = torch.as_tensor(bumped)
    assert eng(data32)
    assert eng(data32.astype(np.float64))
    assert eng(data32.astype(np.float64), device_data=torch.as_tensor(data32))
    assert not eng(data64)
    assert not eng(data32, device_data=off)
    assert not eng(data32, device_data="host")
    assert eng(data32, device_data="stream")
    assert eng(data32.astype(np.float64), device_data="stream")
    assert not eng(data64, device_data="stream")


def test_confirm_on_device_is_decided_at_the_first_ask():
    """The comparison runs once, when a confirm first asks, and not at
    construction: the cNSM-DTW engine, which never asks, never pays it."""
    data = _series(np.float32)[:20_000]
    index = build_index_device_stats(data.astype(np.float64), IndexConfig(),
                                     device="cpu")
    dtw = NormQueryEngineDtw(data, index=index, qcfg=SERVE, device="cpu")
    dtw.query(data[1000:1256].astype(np.float64), 2.0, rho=12, alpha=1.5,
              beta=10.0)
    assert "confirm_on_device" not in vars(dtw)
    eng = NormQueryEngine(data, index=index, qcfg=SERVE, device="cpu")
    assert "confirm_on_device" not in vars(eng)
    eng.query(data[1000:1512].astype(np.float64), 4.0, alpha=1.5, beta=10.0)
    assert vars(eng)["confirm_on_device"] is True


def test_tiny_load_and_host_only_confirm_on_the_host():
    data = _series(np.float32)
    index = build_index_device(data, device="cpu")
    tiny = QueryConfig(host_verify_max_points=10 ** 9)
    q = data[161_000:161_000 + L].astype(np.float64)
    for kw in (dict(device="cpu"), dict(device_data="host")):
        eng = NormQueryEngine(data, index=index, qcfg=tiny, **kw)
        res = eng.query(q, 3.0, alpha=ALPHA, beta=BETA)
        assert res.stats.n_host_checked > 0
        assert res.stats.n_host_rechecked > 0
        assert res.stats.n_device_confirmed == 0
        assert sorted(res.offsets.tolist()) == _oracle(eng, q, 3.0)


def test_streamed_engine_confirms_on_the_device():
    data = _series(np.float32)
    index = build_index_device(data, device="cpu")
    resident = NormQueryEngine(data, index=index, qcfg=SERVE, device="cpu")
    streamed = NormQueryEngine(data, index=index, qcfg=SERVE,
                               device_data="stream", device="cpu")
    assert resident.confirm_on_device and streamed.confirm_on_device
    for off, n_q, eps in [(1234, 1024, 5.0), (0, 512, 4.0),
                          (N - 512, 512, 4.0)]:
        q = data[off:off + n_q].astype(np.float64)
        a = resident.query(q, eps, alpha=1.5, beta=10.0)
        b = streamed.query(q, eps, alpha=1.5, beta=10.0)
        assert streamed.stream_counts["groups"] >= 1
        assert b.stats.n_device_confirmed > 0
        assert b.stats.n_host_rechecked == 0
        assert set(a.offsets.tolist()) == set(b.offsets.tolist())
        assert off in b.offsets.tolist()
        np.testing.assert_allclose(np.sort(a.distances), np.sort(b.distances),
                                   rtol=0, atol=1e-9)
