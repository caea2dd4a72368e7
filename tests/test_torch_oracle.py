"""The port's float64 oracle against the JAX package's: equal answer sets,
distances within 1e-9 (float64 summation order)."""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle as ref
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu_torch import oracle

torch.set_num_threads(2)

N = 20_000


@pytest.fixture(scope="module")
def data():
    return generate_series(N, seed=11)


def _equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)


@pytest.mark.parametrize("offset,length,eps", [
    (123, 400, 5.0), (1234, 1600, 10.0), (50, 25, 0.5), (7777, 800, 60.0)])
def test_rsm_ed_equals_reference(data, offset, length, eps):
    q = data[offset:offset + length]
    got = oracle.rsm_ed(data, q, eps, device="cpu")
    _equal(got, ref.rsm_ed(data, q, eps))
    assert offset in got[0].tolist()


@pytest.mark.parametrize("offset,length,eps,alpha,beta", [
    (123, 400, 2.0, 1.5, 20.0), (1234, 1600, 5.0, 1.1, 8.0),
    (7777, 800, 8.0, 1.2, 5.0), (2048, 256, 4.0, None, None)])
def test_nsm_ed_equals_reference(data, offset, length, eps, alpha, beta):
    q = data[offset:offset + length]
    got = oracle.nsm_ed(data, q, eps, alpha=alpha, beta=beta, device="cpu")
    _equal(got, ref.nsm_ed(data, q, eps, alpha=alpha, beta=beta))
    assert offset in got[0].tolist()


def test_chunks_cover_every_window(data, monkeypatch):
    """Chunk boundaries change no answer (7 windows per chunk)."""
    x, q = data[:3000], data[500:564]
    monkeypatch.setattr(oracle, "_chunk_rows", lambda device, L: 7)
    want = ref.nsm_ed(x, q, 6.0, alpha=1.5, beta=10.0)
    assert want[0].size > 1
    _equal(oracle.nsm_ed(x, q, 6.0, alpha=1.5, beta=10.0, device="cpu"), want)
    _equal(oracle.rsm_ed(x, q, 8.0, device="cpu"), ref.rsm_ed(x, q, 8.0))


@pytest.mark.parametrize("offset,length,eps,rho", [
    (100, 64, 3.0, 3), (500, 128, 4.0, 6), (1000, 50, 2.0, 0),
    (200, 40, 6.0, 39), (1500, 45, 3.0, 100)])
def test_dtw_oracles_equal_reference(data, offset, length, eps, rho):
    """rsm_dtw and cnsm_dtw (anti-diagonal f64 DP on the device) equal the
    reference's (native f64 DP), on 3,000 points of the series."""
    x = data[:3000]
    q = x[offset:offset + length]
    got = oracle.rsm_dtw(x, q, eps, rho, device="cpu")
    _equal(got, ref.rsm_dtw(x, q, eps, rho))
    assert offset in got[0].tolist()
    got = oracle.cnsm_dtw(x, q, eps, rho, 1.5, 10.0, device="cpu")
    _equal(got, ref.cnsm_dtw(x, q, eps, rho, 1.5, 10.0))
    assert offset in got[0].tolist()


def test_dtw_chunks_cover_every_window(data, monkeypatch):
    """Chunk boundaries change no DTW answer (7 windows per chunk)."""
    x, q = data[:2000], data[500:564]
    monkeypatch.setattr(oracle, "_dtw_chunk_rows", lambda device, L, n: 7)
    want = ref.cnsm_dtw(x, q, 6.0, 5, 1.5, 10.0)
    assert want[0].size > 1
    _equal(oracle.cnsm_dtw(x, q, 6.0, 5, 1.5, 10.0, device="cpu"), want)
    _equal(oracle.rsm_dtw(x, q, 8.0, 5, device="cpu"), ref.rsm_dtw(x, q, 8.0, 5))
