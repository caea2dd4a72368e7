"""Phase-2 window distances (K2): the PyTorch port against kvmatch_tpu.ops.ed.

Tolerance: |d2_port - d2_jax| <= 1e-5 * L + 1e-5 * d2.  Both sum the same
f32 terms in different orders; the bound sits 10x inside the guard band
(verify.guard_threshold at guard 1e-2) that sends near-threshold offsets to
the exact f64 confirm.  Window mean and std: rtol 1e-5 of the window's
largest |x| (an f32 window sum errs in proportion to its terms, not to
their sum, so a mean near zero gets no tighter bound).  The CUDA kernel is
held against the plain version in tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.ops import ed as jed
from kvmatch_tpu_torch.ops import ed as ted

torch.set_num_threads(2)


def _inputs(n, L, B, Q, seed):
    rng = np.random.default_rng(seed)
    data = generate_series(n, seed=seed).astype(np.float32)
    offs = rng.integers(0, n - L + 1, B).astype(np.int64)
    offs[:3] = [0, n - L, offs[3]]  # both ends of the series
    qids = rng.integers(0, Q, B).astype(np.int32)
    starts = rng.integers(0, n - L + 1, Q)
    queries = np.stack([data[s:s + L] for s in starts])
    queries = queries + rng.normal(0, 0.05, queries.shape)
    return data, queries.astype(np.float32), offs, qids


def _port(fn, data, queries, offs, qids, L):
    out = fn(*(torch.as_tensor(a) for a in (data, queries, offs, qids)), L)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


def _check_d2(got, want, L):
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    bound = 1e-5 * L + 1e-5 * np.abs(want[finite])
    assert np.all(np.abs(got[finite] - want[finite]) <= bound)


# n not a multiple of 256 keeps the JAX gather on its direct path; the
# multiple of 256 takes its tiled barrel-shift path (tests/conftest.py).
@pytest.mark.parametrize("n,L,B,Q", [
    (40_001, 512, 700, 3),
    (40_960, 2048, 300, 2),
    (9_000, 25, 1000, 4),
])
def test_raw_distances_match_jax(n, L, B, Q):
    data, queries, offs, qids = _inputs(n, L, B, Q, seed=L)
    want = np.asarray(jed.ed_distances_multi(
        jnp.asarray(data), jnp.asarray(queries), jnp.asarray(offs, jnp.int32),
        jnp.asarray(qids), L))
    got = _port(ted.ed_distances_multi, data, queries, offs, qids, L)
    _check_d2(got, want, L)


@pytest.mark.parametrize("n,L,B,Q", [
    (40_001, 512, 700, 3),
    (40_960, 2048, 300, 2),
])
def test_znorm_distances_match_jax(n, L, B, Q):
    data, queries, offs, qids = _inputs(n, L, B, Q, seed=L + 1)
    qhat = (queries - queries.mean(1, keepdims=True)) / queries.std(
        1, keepdims=True)
    data[offs[5]:offs[5] + L] = 3.0  # a flat window: std 0, d2 inf
    want = [np.asarray(a) for a in jed.znorm_ed_distances_multi(
        jnp.asarray(data), jnp.asarray(qhat), jnp.asarray(offs, jnp.int32),
        jnp.asarray(qids), L)]
    got = _port(ted.znorm_ed_distances_multi, data, qhat, offs, qids, L)
    assert np.isinf(got[0][5]) and got[2][5] == 0.0
    _check_d2(got[0], want[0], L)
    scale = np.abs(data[offs[:, None] + np.arange(L)]).max(axis=1)
    for g, w in zip(got[1:], want[1:]):
        assert np.all(np.abs(g - w) <= 1e-5 * scale)


def test_int64_offsets_past_int32():
    """Offsets stay int64: a start past 2**31 is neither cut to 32 bits nor
    wrapped; like dynamic_slice, the gather clamps it to the last window."""
    data = torch.arange(10, dtype=torch.float32)
    offs = torch.tensor([2, 2 + (1 << 33)], dtype=torch.int64)
    x = ted._gather(data, offs, 4)  # clamps the far offset like dynamic_slice
    assert x.tolist() == [[2, 3, 4, 5], [6, 7, 8, 9]]

