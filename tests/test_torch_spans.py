"""The port's own spans (``utils/profiling.py``: ``span``, ``request``,
``fetch``) in the engines' probe and verify layers.

A small series with a stats-only index serves the dense route
(``dense_probe_min_count=0``), with the tiny-load host route off, so that
phase 2 runs the region route or the gather route.  While a profiler
records, each request keeps one list of span records, shared by its
queries' ``QueryStats.trace``; without one, ``trace`` is None and no
``record_function`` is entered.  An engine whose cached probe tables do not
fit its budget takes the per-block probe path, which records
``kv.probe.rebuild`` and counts its blocks in ``n_probe_blocks``.  The
``cuda`` case runs on the card only.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu_torch import NormQueryEngine
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.engine import norm_ed
from kvmatch_tpu_torch.index.device_build import (build_index_device,
                                                  build_index_device_stats)
from kvmatch_tpu_torch.ops.probe import FLAG
from kvmatch_tpu_torch.parallel import query as pq
from kvmatch_tpu_torch.state import series_to_device
from kvmatch_tpu_torch.utils import profiling

torch.set_num_threads(2)

N, L = 200_000, 512
SERVE = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
#: Self-queries by the phase-2 route they take: (offset, eps, alpha, beta).
ROUTES = {"region": (161_000, 0.5, 1.05, 0.2),
          "gather": (0, 0.5, 1.05, 0.2)}
BATCH = ((161_000, 0.5, 1.05, 0.2), (46_000, 0.5, 1.05, 0.2),
         (92_000, 0.5, 1.05, 0.2))
#: Each span's parent in the tree (the root's is None).
PARENT = {"kv.query": None, "kv.plan": "kv.query", "kv.probe": "kv.query",
          "kv.probe.k1": "kv.probe", "kv.probe.cons": "kv.probe",
          "kv.probe.wait": "kv.probe", "kv.probe.intervals": "kv.probe",
          "kv.verify": "kv.query", "kv.verify.plan": "kv.verify",
          "kv.verify.near": "kv.verify", "kv.verify.wait": "kv.verify.near",
          "kv.verify.confirm": "kv.verify"}
#: Tolerance of a stamp against its record_function event (ns).
STAMP_NS = 500_000


def _engine(device, dtype=np.float64):
    data = generate_series(N, seed=5).astype(dtype)
    host, dev = series_to_device(data, device)
    index = build_index_device_stats(host, IndexConfig(), data_dev=dev)
    return NormQueryEngine(host, index=index, qcfg=SERVE, device_data=dev)


@pytest.fixture(scope="module")
def eng():
    return _engine("cpu")


@pytest.fixture(scope="module")
def eng32():
    """The series' f32 copy: the engine confirms on the device."""
    return _engine("cpu", np.float32)


def _query(eng, route):
    off, eps, a, b = ROUTES[route]
    return eng.query(eng.data[off:off + L], eps, alpha=a, beta=b)


def _batch(eng):
    qs = np.stack([eng.data[o:o + L] for o, *_ in BATCH])
    return eng.query_batch(qs, [e for _, e, _, _ in BATCH], alpha=1.05,
                           beta=0.2)


def _routes(eng, monkeypatch):
    """The phase-2 routes the engine takes, in order, as a list that the
    calls append to."""
    taken = []
    for route, meth in (("region", "_verify_regions"),
                        ("gather", "_verify_gather")):
        def spy(*a, _orig=getattr(eng, meth), _route=route, **kw):
            taken.append(_route)
            return _orig(*a, **kw)
        monkeypatch.setattr(eng, meth, spy)
    return taken


def _traced(fn, tmp_path):
    with profiling.trace(tmp_path) as prof:
        out = fn()
    return out, prof


def _names(rec):
    return [s["name"] for s in rec]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_query_span_tree(eng, route, tmp_path, monkeypatch):
    taken = _routes(eng, monkeypatch)
    res, _ = _traced(lambda: _query(eng, route), tmp_path)
    assert taken == [route]
    rec = res.stats.trace
    assert rec[0]["name"] == "kv.query" and rec[0]["parent"] == -1
    assert set(rec[0]) == {"name", "parent", "start_ns", "end_ns",
                           "device_ms"}
    for s in rec[1:]:
        assert PARENT[s["name"]] == rec[s["parent"]]["name"], s["name"]
    names = _names(rec)
    for name in ("kv.plan", "kv.probe", "kv.probe.k1", "kv.probe.cons",
                 "kv.probe.wait", "kv.probe.intervals", "kv.verify",
                 "kv.verify.plan", "kv.verify.near", "kv.verify.wait",
                 "kv.verify.confirm"):
        assert name in names, name
    for name in ("kv.plan", "kv.probe", "kv.probe.k1", "kv.probe.cons",
                 "kv.probe.wait", "kv.verify", "kv.verify.near",
                 "kv.verify.confirm"):
        assert names.count(name) == 1, name
    assert all(s["device_ms"] is None for s in rec)  # the CPU


def test_batch_shares_one_record(eng, tmp_path):
    res, _ = _traced(lambda: _batch(eng), tmp_path)
    rec = res[0].stats.trace
    assert all(r.stats.trace is rec for r in res)
    assert _names(rec).count("kv.query") == 1
    assert _names(rec).count("kv.probe") == 1
    assert _names(rec).count("kv.verify") == 1
    for s in rec[1:]:
        assert PARENT[s["name"]] == rec[s["parent"]]["name"]


@pytest.mark.parametrize("entry", ["region", "gather", "batch"])
def test_stamps_inside_their_record_function_events(eng, entry, tmp_path):
    """Every record's start and end lie inside its own record_function
    event of the profiler's trace (the same clock), to 0.5 ms."""
    fn = (lambda: _batch(eng)[0]) if entry == "batch" else \
        (lambda: _query(eng, entry))
    res, prof = _traced(fn, tmp_path)
    from torch.autograd import DeviceType
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("kv.") and e.device_type() == DeviceType.CPU:
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    rec = res.stats.trace
    for name in set(_names(rec)):
        mine = sorted((s["start_ns"], s["end_ns"]) for s in rec
                      if s["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s0, s1), (k0, k1) in zip(mine, theirs):
            assert k0 - STAMP_NS <= s0 <= s1 <= k1 + STAMP_NS, name


@pytest.mark.parametrize("entry", ["region", "gather", "batch"])
def test_spans_nest_and_self_times_fit_the_request(eng, entry, tmp_path):
    fn = (lambda: _batch(eng)[0]) if entry == "batch" else \
        (lambda: _query(eng, entry))
    res, _ = _traced(fn, tmp_path)
    rec = res.stats.trace
    dur = [s["end_ns"] - s["start_ns"] for s in rec]
    child = [0] * len(rec)
    for i, s in enumerate(rec[1:], 1):
        p = rec[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        child[s["parent"]] += dur[i]
    self_ms = [d - c for d, c in zip(dur, child)]
    assert all(t >= 0 for t in self_ms)
    assert sum(self_ms[1:]) <= dur[0]


@pytest.mark.parametrize("entry", ["region", "gather", "batch"])
def test_confirm_rows_sum_to_host_rechecks(eng, eng32, entry, tmp_path,
                                           monkeypatch):
    """On the host route (a series whose values f32 does not hold), each
    query with host rechecks (``n_host_rechecked``, the rows of its exact
    confirm) has one ``kv.verify.confirm`` span; a query with none has
    none.  On the device route (the series' f32 copy) a batch has one span,
    holding the one launch of K2's f64 form and its read-back, and the
    launch's rows are the batch's ``n_device_confirmed``; no query
    rechecks on the host."""
    def run(e):
        return _traced((lambda: _batch(e)) if entry == "batch" else
                       (lambda: [_query(e, entry)]), tmp_path)[0]

    assert not eng.confirm_on_device and eng32.confirm_on_device
    out = run(eng)
    rec = out[0].stats.trace
    assert _names(rec).count("kv.verify.confirm") == \
        sum(r.stats.n_host_rechecked > 0 for r in out) > 0
    rows = []

    def spy(*a, _orig=norm_ed.window_ed_f64):
        rows.append(a[2].shape[0])
        return _orig(*a)
    monkeypatch.setattr(norm_ed, "window_ed_f64", spy)
    out = run(eng32)
    rec = out[0].stats.trace
    confirm = [i for i, s in enumerate(rec) if s["name"] == "kv.verify.confirm"]
    assert len(confirm) == len(rows) == 1
    assert sum(r.stats.n_device_confirmed for r in out) == rows[0] > 0
    assert all(r.stats.n_host_rechecked == 0 for r in out)
    assert [s["name"] for s in rec if s["parent"] == confirm[0]] == \
        ["kv.verify.wait"]


def test_no_profiler_records_nothing(eng, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling, "record_function", refuse)
    assert _query(eng, "region").stats.trace is None
    assert _query(eng, "gather").stats.trace is None
    assert all(r.stats.trace is None for r in _batch(eng))
    assert profiling._REQUEST.get() is None


def _blocked(monkeypatch):
    """An engine that takes the per-block probe path (no cached table fits
    its budget), over blocks of 2^14 positions: 13 of them."""
    monkeypatch.setattr(pq, "PROBE_BLOCK", 1 << 14)
    eng = _engine("cpu")
    eng.CACHE_MEM_FRACTION = 0
    return eng


@pytest.mark.parametrize("path", ["cached", "blocks"])
@pytest.mark.parametrize("entry", ["region", "batch"])
def test_rebuild_spans_and_block_count(eng, path, entry, tmp_path,
                                       monkeypatch):
    """``kv.probe.rebuild`` is recorded on the per-block path only, once a
    table a block, under ``kv.probe.k1`` (the bucket windows) and
    ``kv.probe.cons`` (the window statistics); every query's
    ``n_probe_blocks`` is the blocks times the two tables there, and 0 on
    the cached path."""
    e = _blocked(monkeypatch) if path == "blocks" else eng
    fn = (lambda: _batch(e)) if entry == "batch" else \
        (lambda: [_query(e, entry)])
    out, _ = _traced(fn, tmp_path)
    rec = out[0].stats.trace
    rebuild = [s for s in rec if s["name"] == "kv.probe.rebuild"]
    npos = -(-(N - L + 1) // FLAG) * FLAG
    blocks = -(-npos // pq.PROBE_BLOCK)
    if path == "cached":
        assert not rebuild
        assert all(r.stats.n_probe_blocks == 0 for r in out)
        return
    assert blocks == 13
    parents = [rec[s["parent"]]["name"] for s in rebuild]
    assert parents == ["kv.probe.k1"] * blocks + ["kv.probe.cons"] * blocks
    assert all(r.stats.n_probe_blocks == 2 * blocks for r in out)
    assert all(s["device_ms"] is None for s in rebuild)  # the CPU
    for a, b in zip(out, fn()):
        np.testing.assert_array_equal(a.offsets, b.offsets)


def test_no_profiler_records_nothing_on_the_per_block_path(monkeypatch):
    e = _blocked(monkeypatch)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling, "record_function", refuse)
    res = _batch(e)
    assert all(r.stats.trace is None for r in res)
    assert all(r.stats.n_probe_blocks == 26 for r in res)
    assert profiling._REQUEST.get() is None


@pytest.mark.parametrize("entry", ["region", "gather", "batch"])
def test_answers_equal_with_spans_on_and_off(eng, entry, tmp_path):
    fn = (lambda: _batch(eng)) if entry == "batch" else \
        (lambda: [_query(eng, entry)])
    off = fn()
    on, _ = _traced(fn, tmp_path)
    assert on[0].stats.trace and off[0].stats.trace is None
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.distances, b.distances)


def test_request_inside_a_request_is_a_span(tmp_path):
    with profiling.trace(tmp_path):
        with profiling.request() as outer:
            with profiling.request() as inner:
                with profiling.span("kv.x"):
                    pass
        assert profiling._REQUEST.get() is None
    assert inner is outer
    assert _names(outer) == ["kv.query", "kv.query", "kv.x"]
    assert [s["parent"] for s in outer] == [-1, 0, 1]


def test_request_ends_on_an_error(tmp_path):
    with profiling.trace(tmp_path):
        with pytest.raises(ValueError):
            with profiling.request() as rec:
                with profiling.span("kv.x"):
                    raise ValueError("stop")
        assert profiling._REQUEST.get() is None
    assert all(s["end_ns"] >= s["start_ns"] for s in rec)


def test_streamed_route_records_stage_and_h2d(tmp_path):
    rng = np.random.default_rng(42)
    data = np.cumsum(rng.standard_normal(40_000)) * 0.25
    eng = NormQueryEngine(data, index=build_index_device(data, device="cpu"),
                          qcfg=QueryConfig(host_verify_max_points=0),
                          device_data="stream", device="cpu")
    q = data[1234:1234 + 256]
    want = eng.query(q, 5.0, alpha=1.3, beta=6.0)
    res, _ = _traced(lambda: eng.query(q, 5.0, alpha=1.3, beta=6.0),
                     tmp_path)
    np.testing.assert_array_equal(res.offsets, want.offsets)
    rec = res.stats.trace
    counts = eng.stream_counts
    assert set(counts) == {"groups", "staged_points", "staged_bytes"}
    stage = [s for s in rec if s["name"] == "kv.verify.stage"]
    h2d = [s for s in rec if s["name"] == "kv.verify.h2d"]
    assert len(stage) == len(h2d) == counts["groups"] >= 1
    assert counts["staged_bytes"] == 4 * counts["staged_points"] > 0
    for s in stage + h2d:
        assert rec[s["parent"]]["name"] == "kv.verify"
    # the sub-engine's spans land in the same record
    assert "kv.verify.confirm" in _names(rec)


@pytest.mark.cuda
def test_device_legs_on_the_card():
    """On the card every device leg has a time, and every device event of
    the trace named after a span is a user annotation: the spans'
    annotations are not device activity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device legs are CUDA events")
    eng = _engine(torch.device("cuda", 0))
    for route in ROUTES:  # warm: builds the kernels
        _query(eng, route)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = [_query(eng, r) for r in ROUTES] + _batch(eng)
        torch.cuda.synchronize()
    for res in out:
        rec = res.stats.trace
        for s in rec:
            if s["name"] in ("kv.probe.k1", "kv.probe.cons",
                             "kv.verify.near"):
                assert s["device_ms"] is not None and s["device_ms"] > 0
            else:
                assert s["device_ms"] is None
    from torch.autograd import DeviceType
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() != DeviceType.CPU]
    assert [e for e in dev if not e.is_user_annotation()]
    assert not [e.name() for e in dev
                if e.name().startswith("kv.") and not e.is_user_annotation()]
