"""Stats-only serving build: the PyTorch port against the JAX device build.

``build_index_device_stats`` counts per-bucket offsets and capped intervals
with a sort and a searchsorted; the planner statistics it returns must equal
the JAX build's exactly.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.index import device_build as jdb
from kvmatch_tpu_torch import config as tconfig
from kvmatch_tpu_torch.index import device_build as tdb

torch.set_num_threads(2)


@pytest.mark.parametrize("n,seed,max_diff", [
    (30_000, 5, 256),
    (47_111, 6, 64),
])
def test_stats_build_equals_jax(n, seed, max_diff):
    cfg = IndexConfig(maximum_diff=max_diff)
    data = generate_series(n, seed=seed)
    want = jdb.build_index_device_stats(data, cfg)
    stats = {}
    got = tdb.build_index_device_stats(
        data, tconfig.IndexConfig(maximum_diff=max_diff), stats=stats,
        device="cpu")
    assert stats["build_seconds"] > 0 and stats["mpts_per_second"] > 0
    assert sorted(got) == sorted(want)
    for w in cfg.scales:
        g, e = got[w], want[w]
        assert g.stats_only and g.n == n
        np.testing.assert_array_equal(g.keys, e.keys)
        np.testing.assert_array_equal(g.row_ptr, e.row_ptr)
        np.testing.assert_array_equal(g.cum_intervals, e.cum_intervals)
        np.testing.assert_array_equal(g.cum_offsets, e.cum_offsets)
        assert g.mean_upper_bound == e.mean_upper_bound
        # every window start counted once
        assert int(g.cum_offsets[-1]) == n - w + 1


def test_stats_build_from_resident_tensor():
    """Passing the resident f32 series skips the upload and gives the same
    statistics as uploading from numpy."""
    cfg = tconfig.IndexConfig()
    data = generate_series(20_000, seed=8)
    a = tdb.build_index_device_stats(data, cfg, device="cpu")
    b = tdb.build_index_device_stats(
        data, cfg, data_dev=torch.as_tensor(data, dtype=torch.float32))
    for w in cfg.scales:
        np.testing.assert_array_equal(a[w].keys, b[w].keys)
        np.testing.assert_array_equal(a[w].cum_intervals, b[w].cum_intervals)
        np.testing.assert_array_equal(a[w].cum_offsets, b[w].cum_offsets)


def test_stats_build_rejects_huge_bucket_range():
    data = np.zeros(5_000)
    data[7] = 1e6
    with pytest.raises(ValueError, match="histogram capacity"):
        tdb.build_index_device_stats(data, tconfig.IndexConfig(),
                                     device="cpu")
