"""The DTW engines' prefilters and series envelope in the port.

* ``_paa_prefilter(..., env=...)`` (RSM) and ``_paa_z_prefilter(...,
  env=...)`` (cNSM) take the envelope form of the PAA bound, which
  lower-bounds banded DTW: the same offsets as the JAX engines' methods on
  the same inputs, and no offset whose f64 banded DTW is within the
  threshold is dropped.
* ``data_envelope_dev`` is the series' Sakoe-Chiba envelope
  (ops/sliding.sliding_min_max), computed without jax and cached per radius.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.base import QueryStats, _Ctx
from kvmatch_tpu.engine.norm_ed import NormQueryEngine as JaxNorm
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JaxRaw
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu.plan import envelope
from kvmatch_tpu_torch import NormQueryEngine, QueryEngine
from kvmatch_tpu_torch.engine.rsm_dtw import paa_env_blocks
from kvmatch_tpu_torch.ops.dtw import _dtw_banded_batch_f64_np
from kvmatch_tpu_torch.ops.sliding import sliding_min_max
from kvmatch_tpu_torch.state import index_from_jax

torch.set_num_threads(2)

N = 6_000


@pytest.fixture(scope="module")
def setup():
    data = generate_series(N, seed=21)
    icfg = IndexConfig()
    jindex = build_index_tpu(data, icfg, backend="host")
    index = index_from_jax(jindex)
    kw = dict(icfg=icfg)
    return dict(data=data, jraw=JaxRaw(data, index=jindex, **kw),
                jnorm=JaxNorm(data, index=jindex, **kw),
                raw=QueryEngine(data, index=index, **kw),
                norm=NormQueryEngine(data, index=index, **kw))


def _ctx(q, eps, **params):
    return _Ctx(query=q, length=q.size, epsilon=eps, eps2=eps * eps,
                params=params, stats=QueryStats())


def _windows(data, offs, L):
    return data[offs[:, None] + np.arange(L)[None, :]]


@pytest.mark.parametrize("offset,L,eps,rho", [(700, 256, 6.0, 12),
                                              (3100, 512, 9.0, 51)])
def test_paa_envelope_prefilter_equals_jax_and_keeps_answers(
        setup, offset, L, eps, rho):
    data = setup["data"]
    q = data[offset:offset + L]
    env = paa_env_blocks(*envelope(q, rho), L)
    offs = np.arange(N - L + 1)
    thresh = eps * eps
    got = setup["raw"]._paa_prefilter(offs, _ctx(q, eps), thresh, env=env)
    want = setup["jraw"]._paa_prefilter(offs, _ctx(q, eps), thresh, env=env)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.size < offs.size
    d2 = _dtw_banded_batch_f64_np(_windows(data, offs, L), q, rho)
    assert set(offs[d2 <= thresh].tolist()) <= set(got.tolist())
    # the ED form (no env) prunes more: it does not bound DTW
    ed = setup["raw"]._paa_prefilter(offs, _ctx(q, eps), thresh)
    assert ed.size < got.size


@pytest.mark.parametrize("offset,L,eps,rho", [(1500, 256, 5.0, 12),
                                              (4000, 512, 4.0, 25)])
def test_paa_z_envelope_prefilter_equals_jax_and_keeps_answers(
        setup, offset, L, eps, rho):
    data = setup["data"]
    q = data[offset:offset + L]
    mu, sd = q.mean(), q.std()
    zq = (q - mu) / sd
    env = paa_env_blocks(*envelope(zq, rho), L)
    offs = np.arange(N - L + 1)
    thresh = eps * eps
    kw = dict(alpha=2.0, beta=50.0, _mu_q=mu, _sd_q=sd)
    got = setup["norm"]._paa_z_prefilter(offs, _ctx(q, eps, **kw), thresh,
                                         env=env)
    want = setup["jnorm"]._paa_z_prefilter(offs, _ctx(q, eps, **kw), thresh,
                                           env=env)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.size < offs.size
    win = _windows(data, offs, L)
    z = (win - win.mean(1, keepdims=True)) / win.std(1, keepdims=True)
    d2 = _dtw_banded_batch_f64_np(z, zq, rho)
    assert set(offs[d2 <= thresh].tolist()) <= set(got.tolist())


def test_data_envelope_is_cached_sliding_min_max(setup):
    eng = setup["raw"]
    lo, hi = eng.data_envelope_dev(51)
    want = sliding_min_max(eng.data_dev, 51)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    assert eng.data_envelope_dev(51)[0] is lo
    assert not torch.equal(eng.data_envelope_dev(7)[0], lo)
    x = eng.data
    for i in (0, 50, 3000, N - 1):
        sl = x[max(0, i - 51): i + 52].astype(np.float32)
        assert lo[i] == sl.min() and hi[i] == sl.max()
