"""Streamed phase 2 (device_data="stream") and host-only mode
(device_data="host") of the PyTorch port.

Mirrors tests/test_streamed.py, whose JAX engines are marked slow: here the
port's streamed engines are held to the port's resident engines over the
same index (answer sets equal, distances within 1e-9) and to the JAX
package's float64 oracle, for all four engines, at the series edges, over
several staged groups and on f32 host data.  Staging candidate runs with
halos into a compact buffer and verifying them in local coordinates only
re-addresses the same reads, so the two modes agree.  Phase 2 is forced
onto the device route (``host_verify_max_points=0``) wherever the staging
is what is tested.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu_torch import (NormQueryEngine, NormQueryEngineDtw,
                               QueryEngine, QueryEngineDtw)
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.index.build import build_index_host
from kvmatch_tpu_torch.index.device_build import build_index_device

torch.set_num_threads(2)

N = 40_000
DEVICE_ROUTE = QueryConfig(host_verify_max_points=0)
ENGINES = {
    "rsm_ed": (QueryEngine, {}),
    "rsm_dtw": (QueryEngineDtw, {"rho": 10}),
    "cnsm_ed": (NormQueryEngine, {"alpha": 1.3, "beta": 6.0}),
    "cnsm_dtw": (NormQueryEngineDtw, {"rho": 10, "alpha": 1.3, "beta": 6.0}),
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    data = np.cumsum(rng.standard_normal(N)) * 0.25
    # the full device build, its pieces kept on the device (CPU here):
    # host phase 1 reads them through the lazy interval fields
    return data, build_index_device(data, device="cpu")


def _answers(res):
    return set(np.asarray(res.offsets).tolist())


def _oracle(name, data, q, eps, kw):
    if name == "rsm_ed":
        return oracle.rsm_ed(data, q, eps)[0]
    if name == "cnsm_ed":
        return oracle.nsm_ed(data, q, eps, alpha=kw["alpha"],
                             beta=kw["beta"])[0]
    if name == "rsm_dtw":
        return oracle.rsm_dtw(data, q, eps, kw["rho"])[0]
    return oracle.cnsm_dtw(data, q, eps, kw["rho"], kw["alpha"], kw["beta"])[0]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_streamed_matches_resident_and_oracle(setup, name):
    data, idx = setup
    cls, kw = ENGINES[name]
    res_e = cls(data, index=idx, qcfg=DEVICE_ROUTE, device="cpu")
    str_e = cls(data, index=idx, qcfg=DEVICE_ROUTE, device_data="stream",
                device="cpu")
    assert str_e.data_dev is None and not str_e.host_only
    # the middle, and both edges of the series (halo replication)
    for off, L, eps in [(1234, 256, 5.0), (0, 256, 4.0), (N - 256, 256, 4.0)]:
        q = data[off:off + L]
        a = res_e.query(q, eps, **kw)
        b = str_e.query(q, eps, **kw)
        assert str_e.stream_counts["groups"] >= 1
        assert _answers(a) == _answers(b)
        assert _answers(b) == set(_oracle(name, data, q, eps, kw).tolist())
        assert off in _answers(b)
        np.testing.assert_allclose(np.sort(a.distances), np.sort(b.distances),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["rsm_ed", "rsm_dtw"])
def test_streamed_multi_group(setup, name):
    """A tiny staging budget splits a batch's verification into many
    groups; the answers are unchanged, and so are the DTW stage counts'
    totals."""
    data, idx = setup
    cls, kw = ENGINES[name]
    res_e = cls(data, index=idx, qcfg=DEVICE_ROUTE, device="cpu")
    str_e = cls(data, index=idx, qcfg=DEVICE_ROUTE, device_data="stream",
                device="cpu")
    str_e.STREAM_MAX_STAGE = 1 << 11
    offs = [5_000, 17_000, 26_000, 33_000]
    L, eps = 256, 6.0
    qs = np.stack([data[o:o + L] for o in offs])
    a = res_e.query_batch(qs, eps, **kw)
    b = str_e.query_batch(qs, eps, **kw)
    assert str_e.stream_counts["groups"] >= 2
    assert str_e.stream_counts["staged_bytes"] == \
        4 * str_e.stream_counts["staged_points"]
    for o, ra, rb in zip(offs, a, b):
        assert _answers(ra) == _answers(rb)
        assert o in _answers(rb)
    if name == "rsm_dtw":
        assert str_e.stage_counts["candidates"] == \
            res_e.stage_counts["candidates"]


def test_streamed_f32_host(setup):
    """f32 host data (no f64 copy of a series larger than device memory):
    answers equal a resident engine over the f64 promotion of the same f32
    values, and the cNSM prefix sums stay f64."""
    data, _ = setup
    d32 = data.astype(np.float32)
    d64 = d32.astype(np.float64)
    idx = build_index_host(d64)
    for cls, kw in (ENGINES["rsm_ed"], ENGINES["cnsm_ed"]):
        res_e = cls(d64, index=idx, qcfg=DEVICE_ROUTE, device="cpu")
        str_e = cls(d32, index=idx, qcfg=DEVICE_ROUTE, device_data="stream",
                    device="cpu")
        assert str_e.data.dtype == np.float32
        for off, L, eps in [(1234, 256, 5.0), (20_000, 512, 8.0)]:
            a = res_e.query(d64[off:off + L], eps, **kw)
            b = str_e.query(str_e.data[off:off + L], eps, **kw)
            assert _answers(a) == _answers(b) and off in _answers(b)
            np.testing.assert_allclose(np.sort(a.distances),
                                       np.sort(b.distances), rtol=0,
                                       atol=1e-9)
    # the tiny-load host route of a streamed engine sums its f32 series in f64
    tiny = NormQueryEngine(d32, index=idx, device_data="stream", device="cpu")
    assert tiny.query(d64[300:556], 4.0, alpha=1.3, beta=6.0).found
    assert tiny._cumsums()[0].dtype == np.float64


def test_streamed_batch_device_falls_back(setup):
    """With no resident series to probe, query_batch_device is
    query_batch (host phase 1), phase 2 streamed."""
    data, idx = setup
    str_e = QueryEngine(data, index=idx, qcfg=DEVICE_ROUTE,
                        device_data="stream", device="cpu")
    offs = [5_000, 30_000]
    L, eps = 256, 6.0
    qs = np.stack([data[o:o + L] for o in offs])
    got = str_e.query_batch_device(qs, eps)
    want = str_e.query_batch(qs, eps)
    for o, g, w in zip(offs, got, want):
        assert o in _answers(g) and _answers(g) == _answers(w)


def test_streamed_requires_index(setup):
    data, _ = setup
    with pytest.raises(ValueError, match="stream"):
        QueryEngine(data, index=None, device_data="stream", device="cpu")


def test_host_only_mode_answers_and_overflow():
    """device_data="host": tiny loads answer exactly on the host, with no
    device; loads past host_verify_max_points and the prefilter tier raise
    instead of touching a device."""
    data = generate_series(60_000, seed=21).astype(np.float32)
    icfg = IndexConfig()
    index = build_index_host(data.astype(np.float64), icfg)
    qcfg = QueryConfig()
    host = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                       device_data="host")
    assert host.host_only and host.device is None and host.data_dev is None
    ref = QueryEngine(data.astype(np.float64), index=index, icfg=icfg,
                      qcfg=qcfg, device="cpu")
    off, L, eps = 40_000, 512, 5.0
    q = data[off:off + L].astype(np.float64)
    rh = host.query(q, eps)
    rr = ref.query(q, eps)
    assert rh.offsets.tolist() == rr.offsets.tolist()
    assert np.allclose(rh.distances, rr.distances)
    assert off in rh.offsets.tolist()
    assert rh.stats.n_host_checked > 0
    assert set(rh.offsets.tolist()) == set(
        oracle.rsm_ed(data.astype(np.float64), q, eps)[0].tolist())
    tiny_cap = QueryEngine(data, index=index, icfg=icfg,
                           qcfg=dataclasses.replace(
                               qcfg, host_verify_max_points=1,
                               host_prefilter_max_offsets=0),
                           device_data="host")
    with pytest.raises(RuntimeError, match="host-only"):
        tiny_cap.query(q, eps)


@pytest.mark.parametrize("cls,kw", [
    (QueryEngineDtw, {}), (NormQueryEngineDtw, {"alpha": 1.4, "beta": 8.0})],
    ids=["rsm_dtw", "cnsm_dtw"])
def test_host_only_dtw_matches_device_route(cls, kw):
    """Host-only DTW engines answer tiny loads exactly through the f64 host
    pipeline (LB_Keogh prefilter + early-abandoning banded DP)."""
    data = generate_series(30_000, seed=23)
    icfg = IndexConfig()
    index = build_index_host(data, icfg)
    host = cls(data.astype(np.float32), index=index, icfg=icfg,
               qcfg=QueryConfig(host_verify_max_points=1 << 26),
               device_data="host")
    dev = cls(data, index=index, icfg=icfg, qcfg=DEVICE_ROUTE, device="cpu")
    off, L = 12_000, 256
    q = data[off:off + L]
    rh = host.query(q, 4.0, rho=12, **kw)
    rd = dev.query(q, 4.0, rho=12, **kw)
    assert rh.offsets.tolist() == rd.offsets.tolist()
    # the host engine stores f32 data, so its exact-f64 distances differ by
    # the f32 input quantization only
    assert np.allclose(rh.distances, rd.distances, rtol=1e-5, atol=1e-4)
    assert off in rh.offsets.tolist()
    assert rh.stats.n_host_checked > 0


@pytest.mark.parametrize("name,eps", [("rsm_ed", 20.0), ("rsm_dtw", 18.0),
                                      ("cnsm_ed", 6.0), ("cnsm_dtw", 5.0)])
def test_host_prefilter_tier_matches_resident(name, eps):
    """Mid-size host-only loads (past host_verify_max_points) answer through
    the run-local prefilter tier with the resident engine's answer set; with
    the tier off the same load raises."""
    data = generate_series(60_000, seed=29)
    index = build_index_host(data)
    qcfg = QueryConfig(host_verify_max_points=1 << 18,
                       host_prefilter_max_offsets=1 << 22)
    cls, kw = ENGINES[name]
    kw = dict(kw, rho=12) if "rho" in kw else kw
    off, L = 40_000, 256
    q = data[off:off + L]
    rr = cls(data, index=index, device="cpu").query(q, eps, **kw)
    rh = cls(data, index=index, qcfg=qcfg, device_data="host").query(
        q, eps, **kw)
    assert rh.offsets.tolist() == rr.offsets.tolist()
    np.testing.assert_allclose(np.sort(rh.distances), np.sort(rr.distances),
                               rtol=1e-5, atol=1e-4)
    assert off in rh.offsets.tolist()
    notier = cls(data, index=index, device_data="host",
                 qcfg=dataclasses.replace(qcfg, host_prefilter_max_offsets=0))
    with pytest.raises(RuntimeError, match="host-only"):
        notier.query(q, eps, **kw)
