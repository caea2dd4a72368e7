"""The port's own host modules against the JAX package's originals.

kvmatch_tpu_torch keeps a copy of each jax-free host module it needs (it
imports nothing of kvmatch_tpu).  On seeded numpy inputs each copy gives
what its original gives: configs field for field, series and arrays
equal, query plans segment for segment, distances equal.  One parametrised
test per module.
"""

import dataclasses
import time

import numpy as np
import pytest

from kvmatch_tpu import config as jconfig
from kvmatch_tpu import native as jnative
from kvmatch_tpu import plan as jplan
from kvmatch_tpu import verify as jverify
from kvmatch_tpu.data import generators as jgen
from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw as JNormDtw
from kvmatch_tpu.engine.norm_ed import NormQueryEngine as JNorm
from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw as JDtw
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JRaw
from kvmatch_tpu.index import build as jbuild
from kvmatch_tpu.index import device_build as jdb
from kvmatch_tpu.utils import intervals as jiv
from kvmatch_tpu.utils import rounding as jrounding
from kvmatch_tpu_torch import config as tconfig
from kvmatch_tpu_torch import native as tnative
from kvmatch_tpu_torch import plan as tplan
from kvmatch_tpu_torch import verify as tverify
from kvmatch_tpu_torch.data import generators as tgen
from kvmatch_tpu_torch.engine.norm_dtw import NormQueryEngineDtw
from kvmatch_tpu_torch.engine.norm_ed import NormQueryEngine
from kvmatch_tpu_torch.engine.rsm_dtw import QueryEngineDtw
from kvmatch_tpu_torch.engine.rsm_ed import QueryEngine
from kvmatch_tpu_torch.index import build as tbuild
from kvmatch_tpu_torch.index.structure import IndexScale
from kvmatch_tpu_torch.state import index_from_arrays
from kvmatch_tpu_torch.utils import intervals as tiv
from kvmatch_tpu_torch.utils import rounding as trounding

SCALE_FIELDS = ("keys", "row_ptr", "left", "right", "cum_intervals",
                "cum_offsets")


@pytest.fixture(scope="module")
def series():
    data = jgen.generate_series(30_000, seed=13)
    icfg = jconfig.IndexConfig()
    return data, icfg, jbuild.build_index_tpu(data, icfg, backend="host")


def _same_scales(got, want, fields=SCALE_FIELDS):
    assert sorted(got) == sorted(want)
    for w in want:
        g, e = got[w], want[w]
        assert isinstance(g, IndexScale)
        assert (g.w, g.n, g.stats_only) == (e.w, e.n, e.stats_only)
        assert g.mean_upper_bound == e.mean_upper_bound
        for f in fields:
            np.testing.assert_array_equal(getattr(g, f), getattr(e, f))


@pytest.mark.parametrize("name", ["IndexConfig", "QueryConfig",
                                  "QueryConfig.tpu_tuned"])
def test_config_equals_jax(name):
    cls, _, ctor = name.partition(".")
    tcls, jcls = getattr(tconfig, cls), getattr(jconfig, cls)
    got = getattr(tcls, ctor)() if ctor else tcls()
    want = getattr(jcls, ctor)() if ctor else jcls()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tcls(**dataclasses.asdict(want)) == got
    if cls == "IndexConfig":
        assert (got.scales, got.unit, got.d) == (want.scales, want.unit,
                                                 want.d)
        with pytest.raises(ValueError, match="consecutive multiples"):
            tcls(wu_list=(25, 100), wu_enabled=(True, True))


@pytest.mark.parametrize("n,seed,frac", [(5_000, 0, 0.01), (40_000, 7, 0.05),
                                         (1_234, 3, 0.5)])
def test_generate_series_equals_jax(n, seed, frac):
    got = tgen.generate_series(n, seed=seed, max_segment_frac=frac)
    np.testing.assert_array_equal(
        got, jgen.generate_series(n, seed=seed, max_segment_frac=frac))
    assert got.dtype == np.float64 and got.size == n


@pytest.mark.parametrize("fn", ["to_round", "snap_down", "bucket_id",
                                "bucket_to_key", "grid_width", "to_upper",
                                "snap_up"])
def test_rounding_equals_jax(fn):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 20, 1000)
    keys = np.sort(rng.choice(np.round(x, 1), 100, replace=False))
    for pos_of_d in (1, 2, 3):
        if fn in ("snap_down", "snap_up"):
            args = (x, keys, pos_of_d)
        elif fn == "bucket_to_key":
            args = (rng.integers(-5000, 5000, 100), pos_of_d)
        elif fn == "grid_width":
            args = (pos_of_d,)
        else:
            args = (x, pos_of_d)
        np.testing.assert_array_equal(getattr(trounding, fn)(*args),
                                      getattr(jrounding, fn)(*args))


def _random_set(rng, k, n=10_000, payloads=("eps",)):
    left = np.sort(rng.integers(0, n, k))
    right = left + rng.integers(0, 40, k)
    cs = {"left": left, "right": right}
    for p in payloads:
        cs[p] = rng.integers(0, 1 << 8, k).astype(np.uint64) if p == "beta" \
            else rng.random(k)
    return cs


@pytest.mark.parametrize("fn", ["merge_intervals", "expand_offsets",
                                "intersect_with_sorted", "count_stats",
                                "shift", "empty_set", "intersect",
                                "clip_first_segment"])
def test_intervals_equal_jax(fn):
    rng = np.random.default_rng(2)
    pay = ("eps", "ex_lo", "ex_up", "beta")
    a = _random_set(rng, 300, payloads=pay)
    if fn == "intersect_with_sorted":
        cs = jiv.merge_intervals(a)
        args = (cs, _random_set(rng, 200, payloads=pay))
    elif fn == "intersect":
        args = (jiv.merge_intervals(a),
                jiv.merge_intervals(_random_set(rng, 200, payloads=pay)))
    elif fn == "clip_first_segment":
        args = (jiv.merge_intervals(a), 3, 25, 9_000, 600)
    elif fn == "shift":
        args = (a, 17)
    elif fn == "empty_set":
        args = (pay,)
    elif fn == "merge_intervals":
        args = (a,)
    else:
        args = (jiv.merge_intervals(a),)
    got, want = getattr(tiv, fn)(*args), getattr(jiv, fn)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,seed,max_diff", [(30_000, 13, 256),
                                             (21_111, 4, 64)])
def test_host_index_build_equals_jax(n, seed, max_diff):
    data = jgen.generate_series(n, seed=seed)
    jcfg = jconfig.IndexConfig(maximum_diff=max_diff)
    want = jbuild.build_index_tpu(data, jcfg, backend="host")
    stats = {}
    got = tbuild.build_index_host(
        data, tconfig.IndexConfig(maximum_diff=max_diff), stats=stats)
    assert stats["build_seconds"] > 0
    _same_scales(got, want)
    buckets = tbuild.compute_buckets_host(data, tconfig.IndexConfig())
    for w, b in jbuild.compute_buckets_host(data, jcfg).items():
        np.testing.assert_array_equal(buckets[w], b)


@pytest.mark.parametrize("kind", ["host", "stats_only", "device"])
def test_index_from_arrays_carries_a_jax_index(series, kind):
    """A JAX index crosses into the port: host-built, stats-only, or the
    full device build with its pieces left on the device (read through its
    lazy interval fields)."""
    data, icfg, jindex = series
    if kind == "stats_only":
        jindex = jdb.build_index_device_stats(data, icfg)
    elif kind == "device":
        jindex = jdb.build_index_device(data, icfg, keep_device=True)
        assert jindex[100]._left is None
    got = index_from_arrays(jindex)
    _same_scales(got, jindex, SCALE_FIELDS[:2] + SCALE_FIELDS[4:]
                 if kind == "stats_only" else SCALE_FIELDS)
    sc = got[100]
    if kind == "stats_only":
        with pytest.raises(RuntimeError, match="stats-only"):
            sc.left
    else:
        for g, e in zip(sc.pos_sorted(), jindex[100].pos_sorted()):
            np.testing.assert_array_equal(g, e)
        b, e = np.array([-1.0, 0.5]), np.array([2.0, 3.0])
        for g, w in zip(sc.counts_between_batch(b, e),
                        jindex[100].counts_between_batch(b, e)):
            np.testing.assert_array_equal(g, w)


ENGINES = {
    "rsm_ed": (QueryEngine, JRaw, {}),
    "cnsm_ed": (NormQueryEngine, JNorm, {"alpha": 1.5, "beta": 10.0}),
    "rsm_dtw": (QueryEngineDtw, JDtw, {"rho": 20}),
    "cnsm_dtw": (NormQueryEngineDtw, JNormDtw,
                 {"rho": 20, "alpha": 1.5, "beta": 10.0}),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_query_plans_equal_jax(series, engine):
    """plan.py and each engine's plan inputs and costs: the batched and the
    single-query plans equal the JAX engine's, segment for segment."""
    data, icfg, jindex = series
    tcls, jcls, kw = ENGINES[engine]
    port = tcls(data, index=index_from_arrays(jindex),
                icfg=tconfig.IndexConfig(), device="cpu")
    jax_eng = jcls(data, index=jindex, icfg=icfg)
    from kvmatch_tpu.engine.base import QueryStats as JStats, _Ctx as JCtx
    from kvmatch_tpu_torch.engine.base import QueryStats, _Ctx
    qs = [data[o:o + 400] for o in (100, 9_000, 21_000)]

    def ctxs(ctx_cls, stats_cls):
        return [ctx_cls(query=q, length=q.size, epsilon=3.0, eps2=9.0,
                        params=dict(kw), stats=stats_cls()) for q in qs]
    got = port._plan_batch(ctxs(_Ctx, QueryStats))
    want = jax_eng._plan_batch(ctxs(JCtx, JStats))
    assert [[dataclasses.astuple(s) for s in p] for p in got] == \
        [[dataclasses.astuple(s) for s in p] for p in want]
    single = port._plan(ctxs(_Ctx, QueryStats)[0])
    assert [dataclasses.astuple(s) for s in single] == \
        [dataclasses.astuple(s) for s in want[0]]
    assert isinstance(got[0][0], tplan.QuerySegment)
    lo, hi = tplan.envelope(qs[0], 7)
    for g, w in zip((lo, hi), jplan.envelope(qs[0], 7)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn", ["bucket_size", "guard_threshold", "ds_guard",
                                "run_bucketed"])
def test_verify_equals_jax(fn):
    rng = np.random.default_rng(4)
    if fn == "bucket_size":
        for m in (1, 700, 5000, 1 << 20):
            for lo, width in ((1, 8192), (1024, 1), (32, 8192 + 511)):
                assert tverify.bucket_size(m, lo=lo, width=width) == \
                    jverify.bucket_size(m, lo=lo, width=width)
    elif fn == "guard_threshold":
        for eps2 in (0.0, 1.0, 16.0, 1e4):
            assert tverify.guard_threshold(eps2, 8192, 1e-2) == \
                jverify.guard_threshold(eps2, 8192, 1e-2)
    elif fn == "ds_guard":
        d2, amp = rng.random(100) * 50, rng.random(100) * 30
        np.testing.assert_array_equal(tverify.ds_guard(d2, 8192, amp),
                                      jverify.ds_guard(d2, 8192, amp))
    else:
        offs = rng.integers(0, 1 << 40, 3000)
        kern = lambda o: (o * 2, o + 1)  # noqa: E731
        for g, w in zip(tverify.run_bucketed(kern, 3000, offs, lo=256),
                        jverify.run_bucketed(kern, 3000, offs, lo=256)):
            np.testing.assert_array_equal(g, w)


def jax_native_lib(getter: str, flag: str):
    """The JAX package's C library ``getter`` (``get_lib`` or
    ``get_baseline_lib``), loaded.  That package compiles it on first use
    through one fixed temporary file name; pytest-xdist workers importing
    ``tests/test_baseline_twin.py`` on a cold cache compile it at once, a
    worker whose rename loses the race gets None, and its ``flag`` then
    caches the failure for the whole process.  Reset the flag and load the
    library the winning worker put in place.  The CLI and baselines tests
    import it from here."""
    get = getattr(jnative, getter)
    for _ in range(30):
        lib = get()
        if lib is not None:
            return lib
        setattr(jnative, flag, False)
        time.sleep(1.0)
    raise AssertionError(
        f"kvmatch_tpu.native.{getter}() stayed None: the JAX package's "
        f"native build failed (or lost its shared .so.tmp race every time)")


@pytest.mark.parametrize("fn", ["dtw_band_f64", "intersect_ed", "bucket_pass",
                                "rle_cap", "merge_rows"])
def test_native_equals_jax(fn):
    rng = np.random.default_rng(5)
    assert tnative.get_lib() is not None
    jax_native_lib("get_lib", "_TRIED")
    if fn == "dtw_band_f64":
        a, q = rng.normal(size=(8, 300)), rng.normal(size=300)
        for r, ub in ((0, np.inf), (15, np.inf), (299, np.inf), (15, 50.0)):
            np.testing.assert_array_equal(tnative.dtw_band_f64(a, q, r, ub),
                                          jnative.dtw_band_f64(a, q, r, ub))
        return
    if fn == "intersect_ed":
        a = jiv.merge_intervals(_random_set(rng, 400))
        b = jiv.merge_intervals(_random_set(rng, 300))
        got = tnative.intersect_ed(a, b, 0.9, 5)
        got = ({k: v.copy() for k, v in got[0].items()},) + got[1:]
        want = jnative.intersect_ed(a, b, 0.9, 5)
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k])
        assert got[1:] == want[1:]
        return
    if fn == "bucket_pass":
        c1 = np.concatenate(([0.0], np.cumsum(rng.normal(0, 3, 5000))))
        np.testing.assert_array_equal(tnative.bucket_pass(c1, 50, 2),
                                      jnative.bucket_pass(c1, 50, 2))
        return
    if fn == "rle_cap":
        b = np.repeat(rng.integers(-5, 5, 300), rng.integers(1, 600, 300))
        for g, w in zip(tnative.rle_cap(b.astype(np.int32), 255),
                        jnative.rle_cap(b.astype(np.int32), 255)):
            np.testing.assert_array_equal(g, w)
        return
    sets = [jiv.merge_intervals(_random_set(rng, 50)) for _ in range(6)]
    row_ptr = np.cumsum([0] + [s["left"].size for s in sets])
    left = np.concatenate([s["left"] for s in sets])
    right = np.concatenate([s["right"] for s in sets])
    got = [x.copy() for x in tnative.merge_rows(row_ptr[:-1], row_ptr[1:],
                                                left, right)]
    for g, w in zip(got, jnative.merge_rows(row_ptr[:-1], row_ptr[1:], left,
                                            right)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn", ["_merge_scan", "_numpy_twin_scale",
                                "tune_glibc_malloc", "install_pieces"])
def test_device_build_host_functions_equal_jax(fn, monkeypatch):
    """The host half of the full device build (its row merge and NumPy
    twin), the allocator tuning and the piece install copied into the port
    give what the JAX package's give."""
    from kvmatch_tpu.utils import hostmem as jhostmem
    from kvmatch_tpu_torch.index import device_build as tdb
    from kvmatch_tpu_torch.utils import hostmem as thostmem
    rng = np.random.default_rng(6)
    if fn == "tune_glibc_malloc":
        # the opt-out, then the call on a fresh flag: both report the same
        for mod in (jhostmem, thostmem):
            monkeypatch.setattr(mod, "_APPLIED", False)
        monkeypatch.setenv("KVMATCH_NO_MALLOC_TUNE", "1")
        assert thostmem.tune_glibc_malloc() is jhostmem.tune_glibc_malloc() \
            is False
        monkeypatch.delenv("KVMATCH_NO_MALLOC_TUNE")
        assert thostmem.tune_glibc_malloc() == jhostmem.tune_glibc_malloc()
        return
    if fn == "install_pieces":
        jax_native_lib("get_lib", "_TRIED")
        p_l = np.sort(rng.choice(100_000, 500, replace=False)).astype(np.int32)
        p_r = p_l + rng.integers(0, 5, 500).astype(np.int32)
        p_row = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
        for g, w in zip(tnative.install_pieces(p_l, p_r, p_row, 40),
                        jnative.install_pieces(p_l, p_r, p_row, 40)):
            np.testing.assert_array_equal(g, w)
        return
    b = np.repeat(rng.integers(-40, 40, 400), rng.integers(1, 700, 400))
    for cap, cf, sf in ((255, 1.2, 0.8), (63, 2.0, 0.9)):
        if fn == "_numpy_twin_scale":
            got = tdb._numpy_twin_scale(b, cap, cf, sf)
            want = jdb._numpy_twin_scale(b, cap, cf, sf)
        else:
            R = 300
            counts = rng.integers(1, 60, R)
            offs = counts * rng.integers(1, 200, R)
            joins = rng.integers(0, 20, (R, jdb.DMAX))
            got = tdb._merge_scan(counts, offs, joins, cf, sf, cap)
            want = jdb._merge_scan(counts, offs, joins, cf, sf, cap)
            assert got[1] == want[1]
            got, want = got[:1], want[:1]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


class _StubEngine:
    """Deterministic per-query stats for fit_cost_model (no device): query
    ``i`` is the one whose first value is ``i``.  The JAX fit reads them
    from ``query_batch``, the port's from ``query``."""

    def __init__(self, qcfg, dtw):
        self.qcfg, self.use_dtw_cost_model = qcfg, dtw

    @staticmethod
    def _result(i):
        from types import SimpleNamespace
        return SimpleNamespace(stats=SimpleNamespace(
            n_disjoint=3 * i + 1, n_candidates=1000 * (i + 1) ** 2,
            t_phase2_ms=2.0 + 0.5 * i + 0.01 * i * i))

    def query(self, query, epsilon, **params):
        return self._result(int(query[0]))

    def query_batch(self, queries, epsilon, **params):
        return [self._result(int(q[0])) for q in queries]


@pytest.mark.parametrize("module", ["codec", "storage_file", "streaming",
                                    "experiments", "profiling", "mesh",
                                    "structure", "engine_base"])
def test_slice_module_equals_jax(series, tmp_path, module):
    """The modules copied for persistence, the append build, the workloads
    and profiling give what their JAX originals give, and so do the index
    scale's single-row and single-range reads and the engine's scale."""
    data, icfg, jindex = series
    rng = np.random.default_rng(8)
    if module == "structure":
        # row_slice and counts_between on a host-built scale, and on the
        # full device build's scales, whose pieces stay on the device until
        # row_slice materializes them on the host
        from kvmatch_tpu_torch.index.device_build import build_index_device
        pairs = ((index_from_arrays(jindex), jindex),
                 (build_index_device(data, tconfig.IndexConfig(),
                                     keep_device=True, device="cpu"),
                  jdb.build_index_device(data, icfg, keep_device=True)))
        for k, (got_index, want_index) in enumerate(pairs):
            assert all((sc._left is None) == (k == 1)
                       for sc in got_index.values())
            for w, want in want_index.items():
                got = got_index[w]
                for r in rng.integers(0, want.num_rows, 20):
                    for g, e in zip(got.row_slice(int(r)),
                                    want.row_slice(int(r))):
                        np.testing.assert_array_equal(g, e)
                for b, e in rng.normal(0, 2, (20, 2)):
                    assert got.counts_between(min(b, e), max(b, e)) == \
                        want.counts_between(min(b, e), max(b, e))
        return
    if module == "engine_base":
        port = QueryEngine(data, index=index_from_arrays(jindex),
                           icfg=tconfig.IndexConfig(), device="cpu")
        jax_eng = JRaw(data, index=jindex, icfg=icfg)
        for w in icfg.scales:
            _same_scales({w: port.scale(w)}, {w: jax_eng.scale(w)})
        return
    if module == "codec":
        from kvmatch_tpu.utils import codec as jcodec
        from kvmatch_tpu_torch.utils import codec as tcodec
        sc = jindex[50]
        for pos_bytes in (4, 8):
            assert tcodec.encode_positions_compact(
                sc.left, sc.right, pos_bytes=pos_bytes) == \
                jcodec.encode_positions_compact(sc.left, sc.right,
                                                pos_bytes=pos_bytes)
        assert tcodec.encode_statistic_info(
            sc.keys, sc.cum_intervals, sc.cum_offsets) == \
            jcodec.encode_statistic_info(sc.keys, sc.cum_intervals,
                                         sc.cum_offsets)
    elif module == "storage_file":
        from kvmatch_tpu.storage import file as jfile
        from kvmatch_tpu_torch.storage import file as tfile
        tfile.IndexFileStore(tmp_path / "t", n=data.size).save(
            index_from_arrays(jindex))
        jfile.IndexFileStore(tmp_path / "j", n=data.size).save(jindex)
        for w in jindex:
            name = f"index-{data.size}-{w}"
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()
        tfile.IndexNpzStore(tmp_path / "t.npz").save(index_from_arrays(jindex))
        _same_scales(tfile.IndexNpzStore(tmp_path / "t.npz").load(), jindex)
    elif module == "streaming":
        from kvmatch_tpu.index.streaming import StreamingIndexBuilder as JSB
        from kvmatch_tpu_torch.index.streaming import StreamingIndexBuilder
        t, j = StreamingIndexBuilder(), JSB()
        for s in (slice(0, 777), slice(777, 12_000), slice(12_000, None)):
            t.append(data[s])
            j.append(data[s])
        _same_scales(t.build(), j.build())
    elif module == "experiments":
        from kvmatch_tpu import experiments as jexp
        from kvmatch_tpu_torch import experiments as texp
        for sel in (0.0, 1e-7, 3.3e-5, 1e-3, 0.5):
            assert texp._bin_label(sel) == jexp._bin_label(sel)
        for cls in ("WorkloadEntry", "BinReport"):
            assert [f.name for f in dataclasses.fields(getattr(texp, cls))] \
                == [f.name for f in dataclasses.fields(getattr(jexp, cls))]
    elif module == "mesh":
        # pad_to_shards, and the ring order over device ids (stand-ins
        # carrying JAX's ``id``; the port's CUDA index), single- and
        # two-slice
        import types
        import torch
        from kvmatch_tpu.parallel import mesh as jmesh
        from kvmatch_tpu_torch.parallel import mesh as tmesh
        for size, n_sh, fill in ((0, 4, 0.0), (37, 8, 0.0), (40, 8, 1.5),
                                 (1001, 3, -2.0)):
            x = rng.normal(size=size)
            np.testing.assert_array_equal(tmesh.pad_to_shards(x, n_sh, fill),
                                          jmesh.pad_to_shards(x, n_sh, fill))
        ids = rng.permutation(12).tolist()
        for slice_of in (None, {i: i % 3 for i in range(12)},
                         lambda i: -(i // 4)):
            want = jmesh.order_devices_for_ring(
                [types.SimpleNamespace(id=i) for i in ids], slice_of=slice_of)
            got = tmesh.order_devices_for_ring(
                [torch.device("cuda", i) for i in ids], slice_of=slice_of)
            assert [d.index for d in got] == [d.id for d in want]
    else:
        from kvmatch_tpu.utils import profiling as jprof
        from kvmatch_tpu_torch.utils import profiling as tprof
        assert tprof.StatsWriter.FIELDS == jprof.StatsWriter.FIELDS
        qs = rng.normal(size=(6, 64))
        qs[:, 0] = np.arange(6)
        for dtw in (False, True):
            got = tprof.fit_cost_model(_StubEngine(tconfig.QueryConfig(), dtw),
                                       qs, 1.0, repeats=2)
            want = jprof.fit_cost_model(_StubEngine(jconfig.QueryConfig(), dtw),
                                        qs, 1.0, repeats=2)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
