"""Sliding-window primitives: the PyTorch port against kvmatch_tpu.ops.sliding.

Both packages add the same f32 values in the same order (log-depth doubling),
so bucket ids and window statistics must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.ops import sliding as jsl
from kvmatch_tpu_torch.ops import sliding as tsl
from kvmatch_tpu_torch.ops.probe import FLY_FILL

torch.set_num_threads(2)


def _series(n, seed, fly_tail=0):
    data = generate_series(n, seed=seed).astype(np.float32)
    if fly_tail:
        data = np.concatenate([data, np.full(fly_tail, FLY_FILL, np.float32)])
    return data


@pytest.mark.parametrize("n,seed,fly_tail,pos_of_d", [
    (20_000, 1, 0, 1),
    (33_333, 2, 1_000, 1),
    (12_345, 3, 0, 2),
])
def test_build_buckets_bit_identical(n, seed, fly_tail, pos_of_d):
    data = _series(n, seed, fly_tail)
    scales = tuple(IndexConfig().scales)
    want = jsl.build_buckets(jnp.asarray(data), scales, pos_of_d)
    got = tsl.build_buckets(torch.from_numpy(data), scales, pos_of_d)
    for w in scales:
        assert got[w].dtype == torch.int32
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(want[w]))


@pytest.mark.parametrize("length", [25, 256, 1000, 4096])
def test_sliding_window_stats_bit_identical(length):
    data = _series(20_000, 4, fly_tail=500)
    want = jsl.sliding_window_stats_fwd(jnp.asarray(data), length)
    got = tsl.sliding_window_stats_fwd(torch.from_numpy(data), length)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("radius", [0, 1, 7, 51, 409])
def test_sliding_min_max_bit_identical(radius):
    """The DTW cascade's series envelope equals the JAX reduce_window
    envelope bit for bit (min and max are exact), edges included."""
    data = _series(20_000, 5)
    want = jsl.sliding_min_max(jnp.asarray(data), radius)
    got = tsl.sliding_min_max(torch.from_numpy(data), radius)
    for g, w in zip(got, want):
        assert g.shape == (data.size,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
