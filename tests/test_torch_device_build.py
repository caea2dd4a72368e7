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


# ---------------------------------------------------- the full device build
# build_index_device's two stages and its host merge against the JAX
# package's semantics reference (_numpy_twin_scale) and its build, in the
# device-resident and the spill modes; the chunked device bucket pass and
# the device-bucket build against compute_buckets_tpu / build_index_tpu.

FULL_FIELDS = ("keys", "row_ptr", "left", "right", "cum_intervals",
               "cum_offsets")


@pytest.mark.parametrize("n,seed,max_diff", [(60_000, 31, 256),
                                             (25_000, 2, 64)])
def test_pipelines_equal_numpy_twin(n, seed, max_diff):
    """Stage A, the host merge and stage B on the port's bucket ids equal
    the JAX package's _numpy_twin_scale on the same ids, and the pieces
    tile the window starts exactly once."""
    from kvmatch_tpu_torch.ops.sliding import build_buckets
    cfg = tconfig.IndexConfig(maximum_diff=max_diff)
    cap = cfg.maximum_diff - 1
    data = generate_series(n, seed=seed)
    buckets = build_buckets(torch.as_tensor(data, dtype=torch.float32),
                            tuple(cfg.scales), cfg.pos_of_d)
    for w in cfg.scales:
        b = buckets[w]
        lo = int(b.min()) - 1
        ivs, (row_bucket, counts, offs, joins) = tdb._scale_pipeline_a(
            b, lo, cap)
        grp, n_groups = tdb._merge_scan(counts, offs, joins,
                                        cfg.merge_count_factor,
                                        cfg.merge_shrink_factor, cap)
        (p_l, p_r, p_row), (g_iv, g_off) = tdb._scale_pipeline_b(
            *ivs, torch.as_tensor(grp), n_groups, cap)
        gb = row_bucket[np.concatenate(([True], grp[1:] != grp[:-1]))]
        want = jdb._numpy_twin_scale(b.numpy(), cap, cfg.merge_count_factor,
                                     cfg.merge_shrink_factor)
        for got, exp in zip((p_l, p_r, p_row, gb, g_iv, g_off), want):
            np.testing.assert_array_equal(np.asarray(got), exp)
        assert p_l.dtype == torch.int32 and p_row.dtype == torch.int32
        assert int((p_r - p_l + 1).sum()) == b.shape[0]
        assert int((p_r - p_l + 1).max()) <= cap


@pytest.mark.parametrize("mode", ["keep_device", "spill", "host_copies"])
def test_full_build_equals_jax(mode, monkeypatch):
    """Pieces, keys, row_ptr and cum_* equal JAX's build_index_device:
    pieces left on the device (materialized at first host access), spilled
    scale by scale (SPILL_N lowered), or copied at once."""
    n = 47_111
    data = generate_series(n, seed=6)
    want = jdb.build_index_device(data, IndexConfig(), keep_device=False)
    if mode == "spill":
        monkeypatch.setattr(tdb, "SPILL_N", 1)
    stats = {}
    got = tdb.build_index_device(data, tconfig.IndexConfig(), stats=stats,
                                 device="cpu",
                                 keep_device=mode != "host_copies")
    assert stats["spilled"] == (mode == "spill")
    assert stats["mpts_per_second"] > 0 and stats["device_seconds"] > 0
    for w in want:
        g, e = got[w], want[w]
        assert (g.dev_pos_view is not None) == (mode != "spill")
        assert (g._left is None) == (mode == "keep_device")
        mem = g.memory_bytes()  # counting does not copy the view
        assert (g._left is None) == (mode == "keep_device")
        for f in FULL_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(e, f))
        assert g.mean_upper_bound == e.mean_upper_bound
        for x, y in zip(g.pos_sorted(), e.pos_sorted()):
            np.testing.assert_array_equal(x, y)
        if mode == "keep_device":
            assert mem == sum(a.nbytes for a in (
                g.keys, g.row_ptr, g.cum_intervals, g.cum_offsets)) \
                + 12 * g.num_intervals
        assert int(g.cum_offsets[-1]) == n - w + 1


def test_device_index_lazy_materialization():
    """A device-resident scale copies its pieces to the host only at the
    first host access; its row-CSR lists are position-sorted and its
    position-sorted view tiles the window starts."""
    from kvmatch_tpu_torch.index.structure import total_memory_bytes
    data = generate_series(30_000, seed=31)
    idx = tdb.build_index_device(data, device="cpu")
    before = total_memory_bytes(idx)
    for w, sc in idx.items():
        assert sc.dev_pos_view is not None and sc._left is None
        assert sc.has_pos_sorted and sc.num_intervals == int(sc.row_ptr[-1])
        left = sc.left
        assert left is not None and left.size == sc.num_intervals
        for r in (0, sc.num_rows // 2, sc.num_rows - 1):
            s, e = int(sc.row_ptr[r]), int(sc.row_ptr[r + 1])
            l_r, r_r = left[s:e], sc.right[s:e]
            assert np.all(np.diff(l_r) > 0) and np.all(l_r <= r_r)
        p_l, p_r, _ = sc.pos_sorted()
        assert np.all(np.diff(p_l) > 0)
        assert int((p_r - p_l + 1).sum()) == sc.n - w + 1
    assert total_memory_bytes(idx) > 0 and before > 0


def test_full_build_rejects_positions_past_int32(monkeypatch):
    monkeypatch.setattr(tdb, "MAX_POSITIONS", 1000)
    with pytest.raises(ValueError, match="int32 position limit 1000"):
        tdb.build_index_device(np.zeros(1001), device="cpu")


@pytest.mark.parametrize("chunk", [7_000, 12_345, None])
def test_compute_buckets_device_equals_jax(chunk):
    """The chunked device bucket pass (w_max - 1 right halos) equals
    compute_buckets_tpu bit for bit, across chunk boundaries."""
    from kvmatch_tpu.index import build as jbuild
    from kvmatch_tpu_torch.index import build as tbuild
    data = generate_series(50_000, seed=3)
    want = jbuild.compute_buckets_tpu(data, IndexConfig(), chunk=chunk)
    stats = {}
    got = tbuild.compute_buckets_device(data, tconfig.IndexConfig(),
                                        chunk=chunk, stats=stats,
                                        device="cpu")
    assert sorted(stats) == ["d2h_seconds", "device_seconds",
                             "upload_seconds"]
    for w in want:
        assert got[w].dtype == want[w].dtype
        np.testing.assert_array_equal(got[w], want[w])


def test_device_bucket_build_equals_jax():
    """build_index_device_buckets (the engines' default index) equals
    build_index_tpu on the same data, with the same stats keys; the port's
    host build (the fused C pass) equals the JAX package's."""
    from kvmatch_tpu.index import build as jbuild
    from kvmatch_tpu_torch.index import build as tbuild
    data = generate_series(40_000, seed=4)
    jstats, tstats = {}, {}
    want = jbuild.build_index_tpu(data, IndexConfig(), chunk=9_000,
                                  stats=jstats)
    got = tbuild.build_index_device_buckets(
        data, tconfig.IndexConfig(), chunk=9_000, stats=tstats, device="cpu")
    assert sorted(tstats) == sorted(jstats)
    host = tbuild.build_index_host(data, tconfig.IndexConfig())
    ref = jbuild.build_index_tpu(data, IndexConfig(), backend="host")
    for w in want:
        for f in FULL_FIELDS:
            np.testing.assert_array_equal(getattr(got[w], f),
                                          getattr(want[w], f))
            np.testing.assert_array_equal(getattr(host[w], f),
                                          getattr(ref[w], f))
