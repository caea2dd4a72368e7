"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports nothing of jax or of the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: K1 (dense probe) counts and flags exactly equal -- the kernel is
compiled without multiply-add contraction and repeats the plain version's
f32 operations in order.  K3 and DS equal their anti-diagonal plain versions
(dtw_diag_plain, dtw_ds_diag_plain) bit for bit, in the one-warp, one-block,
cluster and global forms; K4 equals dtw_rows_plain bit for bit on rows one
warp holds.  The plain DP versions themselves (dtw_diag_plain,
dtw_ds_diag_plain, dtw_rows_plain, dtw_banded_ds_plain) run their full
blocks of steps as replayed CUDA graphs and equal their loop form
(tests/test_torch_plain_blocks.py) bit for bit.  K2 (window distances):
|d2 - d2_plain| <= 1e-5 L + 1e-5 d2 and mean/std within 1e-5 of the
window's max |x| (summation order differs; see tests/test_torch_ed.py).
The single-query ops (ed_distances, znorm_ed_distances, the region
functions, dtw_banded_batch, dtw_banded_batch_multi,
dtw_banded_batch_ds_multi) equal their _multi calls bit for bit and raise
on bad input before any launch.  Engine answers EQUAL the oracle, and
streamed answers the resident engine's; the full device build on the card
equals its CPU run.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu_torch import oracle
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.engine.norm_ed import NormQueryEngine
from kvmatch_tpu_torch.engine.rsm_ed import QueryEngine
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
from kvmatch_tpu_torch.ops import ed as ted
from kvmatch_tpu_torch.ops.probe import FLAG, probe_flags, probe_flags_plain
from kvmatch_tpu_torch.ops.sliding import build_buckets
from kvmatch_tpu_torch.parallel.query import pack_segments_batch
from kvmatch_tpu_torch.plan import QuerySegment, envelope
from kvmatch_tpu_torch.state import series_to_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _probe_case(norm, dev, n=40_000, L=512, Q=3, seed=0,
                widths=(100, 50, 25, 200, 25, 400, 25), rho=None,
                reverse=False):
    """Hand-made plans over a random walk.  ``rho``: envelope segments
    (mean_lo < mean_hi, as the DTW engines plan them); ``reverse``: the
    tables' columns reversed, so the valid segments are not a prefix."""
    icfg = IndexConfig()
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(0, 0.1, n + L + 512)).astype(np.float32)
    offs = rng.integers(0, n - L, Q)
    seg_lists = []
    for o in offs:
        q = data[o:o + L]
        lo, hi = (q, q) if rho is None else envelope(q, rho)
        segs, pos = [], 0
        for w in widths:
            if (pos + 1) * icfg.unit + w > L:
                break
            span = slice(pos * icfg.unit, pos * icfg.unit + w)
            segs.append(QuerySegment(order=pos + 1, w=w,
                                     mean_lo=float(lo[span].mean()),
                                     mean_hi=float(hi[span].mean()), count=1))
            pos += w // icfg.unit
        seg_lists.append(segs)
    bk = build_buckets(torch.as_tensor(data, device=dev), tuple(icfg.scales),
                       icfg.pos_of_d)
    width = bk[max(icfg.scales)].shape[0]
    bstack = torch.stack([b[:width] for b in bk.values()]).contiguous()
    eps2 = torch.tensor([[1.0, 25.0, 4.0][i % 3] for i in range(Q)],
                        dtype=torch.float32, device=dev)
    if norm:
        cons = torch.tensor([[1.2, 5.0, data[o:o + L].mean(),
                              data[o:o + L].std()] for o in offs],
                            dtype=torch.float32, device=dev)
    else:
        cons = torch.zeros((Q, 4), dtype=torch.float32, device=dev)
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales), dev)
    if reverse:
        segs = type(segs)(*(t.flip(1).contiguous() for t in segs))
    return icfg, bstack, segs, eps2, cons, n - L + 1, L, data[:n]


def _run(fn, case, p0, npos, dev, norm, col0=0):
    """``fn`` over positions [p0, p0 + npos) of the case's bucket stack,
    given as the window of its columns from ``col0`` on."""
    icfg, bstack, segs, eps2, cons, m, L, _ = case
    Q = eps2.shape[0]
    flags = torch.zeros((Q, (p0 + npos) // FLAG), dtype=torch.bool, device=dev)
    counts = torch.zeros(Q, dtype=torch.int32, device=dev)
    fn(bstack[:, col0:].contiguous(), col0, segs, eps2, cons, p0, npos, m,
       flags, counts, length=L, unit=icfg.unit, d=icfg.d,
       slack=icfg.probe_guard, norm=norm)
    torch.cuda.synchronize(dev)
    return counts.cpu().numpy(), flags.cpu().numpy()


# (p0, npos, _probe_case arguments, and col0: the stack's first column in
# the window passed).  m = n - L + 1 is never a multiple of 128 here; the
# kernel's block takes 8192 positions in tiles of 2048, a warp 256 (two
# flags).
PROBE_CASES = {
    "whole": (0, 40_064, {}),                  # the last tile is partial
    "window": (8_192, 16_384, {}),             # p0 > 0, stops before m
    "window_col0": (8_192, 16_384, dict(col0=8_192)),  # col0 = p0 > 0
    "tail_col0": (23_552, 16_512, dict(col0=23_552)),  # ... past m
    "col0_below_p0": (16_384, 8_192, dict(col0=8_000)),
    "p0_odd": (384, 9_984, {}),                # p0, npos off the tile grid
    "q1": (0, 40_064, dict(Q=1)),
    "q32_holes": (128, 39_936, dict(Q=32, reverse=True)),
    "seg30_envelope": (0, 40_064, dict(        # 30 segments, mean_lo < mean_hi
        L=2048, Q=4, rho=40, widths=(25, 50, 25, 100, 25) * 6)),
}


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_kernel_equals_plain(dev, norm, case):
    p0, npos, kw = PROBE_CASES[case]
    kw = dict(kw)
    col0 = kw.pop("col0", 0)
    data = _probe_case(norm, dev, **kw)
    segs = data[2]
    if case == "seg30_envelope":
        assert int(segs.valid.sum(1).min()) == 30
        assert bool((segs.mean_lo < segs.mean_hi).all())
    before = probe_flags.launches
    got = _run(probe_flags, data, p0, npos, dev, norm, col0)
    assert probe_flags.launches == before + 1
    want = _run(probe_flags_plain, data, p0, npos, dev, norm, col0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[0].sum() > 0


@pytest.mark.parametrize("norm", [False, True])
def test_dense_probe_uncached_blocks_equal_plain(dev, norm, monkeypatch):
    """The probe without a cached stack: one K1 launch per 16,384-position
    block over a bucket window whose column 0 is the block's first
    position (col0 = p0 > 0 from the second block on), held equal to the
    plain version on the same windows."""
    from kvmatch_tpu_torch.parallel import query as tq
    icfg, _, segs, eps2, cons, m, L, data = _probe_case(norm, dev)
    n = data.shape[0]
    pad = tq.fly_pad_for(L, max(icfg.scales))
    data_p = torch.cat([torch.as_tensor(data, device=dev),
                        torch.full((pad,), float(tq.FLY_FILL), device=dev)])
    monkeypatch.setattr(tq, "PROBE_BLOCK", 1 << 14)
    blocks = -(-m // (1 << 14))
    assert blocks == 3
    before = probe_flags.launches
    got = tq.dense_probe_flags(data_p, segs, eps2, cons, n, icfg, L, norm)
    assert probe_flags.launches == before + blocks
    monkeypatch.setattr(tq, "probe_flags", probe_flags_plain)
    want = tq.dense_probe_flags(data_p, segs, eps2, cons, n, icfg, L, norm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert int(want[0].sum()) > 0


def test_probe_kernel_rejects_bad_input(dev):
    case = _probe_case(False, dev)
    with pytest.raises(ValueError, match="multiples of FLAG"):
        _run(probe_flags, case, 0, 1000, dev, False)


@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("L,B", [(8192, 4096), (25, 3000)])
def test_window_kernel_equals_plain(dev, znorm, L, B):
    n, Q = 300_000, 8
    rng = np.random.default_rng(L + znorm)
    data = generate_series(n, seed=4).astype(np.float32)
    data[1000:1000 + L] = 2.5  # flat window: std 0, d2 inf
    offs = rng.integers(0, n - L + 1, B)
    offs[:3] = [0, n - L, 1000]
    queries = np.stack([data[o:o + L] for o in rng.integers(0, n - L, Q)])
    if znorm:
        queries = (queries - queries.mean(1, keepdims=True)) / \
            queries.std(1, keepdims=True)
    args = (torch.as_tensor(data, device=dev),
            torch.as_tensor(queries, dtype=torch.float32, device=dev),
            torch.as_tensor(offs, device=dev),
            torch.as_tensor(rng.integers(0, Q, B).astype(np.int32), device=dev),
            L, znorm)
    before = ted.window_ed.launches
    got = ted.window_ed(*args)
    assert ted.window_ed.launches == before + 1
    want = ted.window_ed_plain(*args)
    got = [t.cpu().numpy() for t in (got if znorm else (got,))]
    want = [t.cpu().numpy() for t in (want if znorm else (want,))]
    finite = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), finite)
    assert finite.sum() == B - int(znorm)
    err = np.abs(got[0][finite] - want[0][finite])
    assert np.all(err <= 1e-5 * L + 1e-5 * np.abs(want[0][finite]))
    scale = np.abs(data[offs[:, None] + np.arange(L)]).max(axis=1)
    for g, w in zip(got[1:], want[1:]):
        assert np.all(np.abs(g - w) <= 1e-5 * scale)


# K2's (L, B): every rows-per-block form (one warp a row up to L = 1024,
# two up to 2048, four up to 4096, eight above, whose z-norm second pass
# walks backwards), L not a multiple of 4 or of 32, B = 1 and B not a
# multiple of the rows a block takes, L = 12,000 and L = 60,000 (past the
# plans of the default config).
K2_CASES = [(25, 1), (25, 13), (1000, 1001), (1500, 37), (3000, 250),
            (8191, 9), (12_000, 5), (60_000, 3)]


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("L,B", K2_CASES)
def test_window_kernel_shapes_offsets_and_edges(dev, L, B, znorm, shift):
    """K2 against window_ed_plain on rows of 5 queries, with offsets at every
    remainder modulo 4, at n - L and past both ends (clamped), and a flat
    window (std 0, d2 inf); ``shift`` 1 starts the series 4 bytes past a
    16-byte boundary."""
    n, Q = 200_000, 5
    rng = np.random.default_rng(7 * L + B + 2 * znorm + shift)
    base = generate_series(n + shift, seed=9).astype(np.float32)
    flat = 5000
    base[shift + flat:shift + flat + L] = -1.25
    data = torch.as_tensor(base, device=dev)[shift:]
    assert data.data_ptr() % 16 == 4 * shift
    special = [n - L + 7, 0, 1, 2, 3, n - L, n - L - 1, n - L - 2,
               n - L - 3, -3, flat, n + 50]
    offs = rng.integers(0, n - L + 1, B)
    offs[:min(B, len(special))] = special[:B]
    qoffs = rng.integers(0, n - L, Q)
    queries = np.stack([base[shift + o:shift + o + L] for o in qoffs])
    if znorm:
        queries = (queries - queries.mean(1, keepdims=True)) / \
            queries.std(1, keepdims=True)
    args = (data, torch.as_tensor(queries, dtype=torch.float32, device=dev),
            torch.as_tensor(offs, device=dev),
            torch.as_tensor(rng.integers(0, Q, B).astype(np.int32),
                            device=dev), L, znorm)
    before = ted.window_ed.launches
    key = f"B{B}_L{L}_{'znorm' if znorm else 'raw'}"
    shape_before = ted.window_ed.shapes.get(key, 0)
    got = ted.window_ed(*args)
    torch.cuda.synchronize()
    assert ted.window_ed.launches == before + 1
    assert ted.window_ed.shapes[key] == shape_before + 1
    want = ted.window_ed_plain(*args)
    got = [t.cpu().numpy() for t in (got if znorm else (got,))]
    want = [t.cpu().numpy() for t in (want if znorm else (want,))]
    finite = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), finite)
    if znorm and B > special.index(flat):
        assert not finite[special.index(flat)]
    err = np.abs(got[0][finite] - want[0][finite])
    assert np.all(err <= 1e-5 * L + 1e-5 * np.abs(want[0][finite]))
    start = np.clip(offs, 0, n - L)
    scale = np.abs(base[shift + start[:, None] + np.arange(L)]).max(axis=1)
    for g, w in zip(got[1:], want[1:]):
        assert np.all(np.abs(g - w) <= 1e-5 * scale)


def test_window_kernel_rejects_int32_offsets(dev):
    data = torch.zeros(1000, device=dev)
    q = torch.zeros((1, 100), device=dev)
    with pytest.raises(ValueError, match="int64 offsets"):
        ted.window_ed(data, q, torch.zeros(4, dtype=torch.int32, device=dev),
                      torch.zeros(4, dtype=torch.int32, device=dev), 100,
                      False)


def test_engines_on_the_card_equal_oracle(dev):
    data = generate_series(200_000, seed=7)
    icfg = IndexConfig()
    host, data_dev = series_to_device(data, dev)
    index = build_index_device_stats(host, icfg, data_dev=data_dev)
    qcfg = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
    norm = NormQueryEngine(host, index=index, icfg=icfg, qcfg=qcfg,
                           device_data=data_dev)
    raw = QueryEngine(host, index=index, icfg=icfg, qcfg=qcfg,
                      device_data=data_dev)
    k1, k2 = probe_flags.launches, ted.window_ed.launches
    for off, L, eps in [(1234, 1600, 5.0), (30_000, 4096, 8.0),
                        (7777, 800, 1.0)]:
        q = data[off:off + L]
        res = norm.query(q, eps, alpha=1.5, beta=10.0)
        want, _ = oracle.nsm_ed(data, q, eps, alpha=1.5, beta=10.0,
                                device=dev)
        assert set(res.offsets.tolist()) == set(want.tolist())
        res = raw.query(q, 2 * eps)
        want, _ = oracle.rsm_ed(data, q, 2 * eps, device=dev)
        assert set(res.offsets.tolist()) == set(want.tolist())
    assert probe_flags.launches > k1 and ted.window_ed.launches > k2


# ------------------------------------------ full device build, streaming
SCALE_FIELDS = ("keys", "row_ptr", "left", "right", "cum_intervals",
                "cum_offsets")


def test_full_build_on_the_card_equals_cpu(dev, monkeypatch):
    """build_index_device on the card, its pieces kept there or spilled
    scale by scale, equals its CPU run; so does the chunked device bucket
    pass (the elementwise f32 sums are the same on both)."""
    from kvmatch_tpu_torch.index import device_build
    from kvmatch_tpu_torch.index.build import compute_buckets_device
    from kvmatch_tpu_torch.index.device_build import build_index_device
    data = generate_series(300_000, seed=12)
    want = build_index_device(data, device="cpu", keep_device=False)
    for spill in (False, True):
        monkeypatch.setattr(device_build, "SPILL_N", 1 if spill else 10**9)
        got = build_index_device(data, device=dev)
        for w, e in want.items():
            g = got[w]
            assert (g.dev_pos_view is None) == spill
            if not spill:
                assert g.dev_pos_view[0].is_cuda and g._left is None
            for f in SCALE_FIELDS:
                np.testing.assert_array_equal(getattr(g, f), getattr(e, f))
            for x, y in zip(g.pos_sorted(), e.pos_sorted()):
                np.testing.assert_array_equal(x, y)
    icfg = IndexConfig()
    cpu = compute_buckets_device(data, icfg, chunk=70_000, device="cpu")
    card = compute_buckets_device(data, icfg, chunk=70_000, device=dev)
    for w in icfg.scales:
        np.testing.assert_array_equal(card[w], cpu[w])


@pytest.mark.parametrize("engine", ["cnsm_ed", "rsm_dtw"])
def test_streamed_query_on_the_card_equals_resident(dev, engine):
    """device_data="stream" on the card: host phase 1 over the full device
    index, candidate runs staged to the card; the answers equal a resident
    engine's over the same index, distances within 1e-9."""
    from kvmatch_tpu_torch.engine.rsm_dtw import QueryEngineDtw
    from kvmatch_tpu_torch.index.device_build import build_index_device
    data = generate_series(200_000, seed=7)
    index = build_index_device(data, device=dev)
    qcfg = QueryConfig(host_verify_max_points=0)
    cls, kw = {"cnsm_ed": (NormQueryEngine, dict(alpha=1.5, beta=10.0)),
               "rsm_dtw": (QueryEngineDtw, dict(rho=20))}[engine]
    resident = cls(data, index=index, qcfg=qcfg, device=dev)
    streamed = cls(data, index=index, qcfg=qcfg, device_data="stream",
                   device=dev)
    assert streamed.data_dev is None and streamed.device.type == "cuda"
    for off, L, eps in [(1234, 1024, 5.0), (0, 512, 4.0),
                        (200_000 - 512, 512, 4.0)]:
        q = data[off:off + L]
        a = resident.query(q, eps, **kw)
        b = streamed.query(q, eps, **kw)
        assert streamed.stream_counts["groups"] >= 1
        assert set(a.offsets.tolist()) == set(b.offsets.tolist())
        assert off in b.offsets.tolist()
        np.testing.assert_allclose(np.sort(a.distances), np.sort(b.distances),
                                   rtol=0, atol=1e-9)


# ------------------------------------------------------------ DTW kernels
# K3 (dtw_diag) and K4 (dtw_rows) differ from their plain version only in
# f32 summation order: |d - d_plain| <= verify.guard_threshold(d_plain, L,
# 1e-2), the band the engines rely on.  The DS kernel's hi + lo is within
# 8 eps32 (d64 + 1) of the f64 DP on the same f32 inputs
# (tests/test_dtw_guard.py:62).  K3 repeats the f32 operations of
# dtw_diag_plain, its anti-diagonal plain version, and equals it bit for
# bit.

def _dtw_case(B, L, Q, seed, common_mode=False):
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.normal(0, 0.3, (B, L)), axis=1).astype(np.float32)
    qm = np.cumsum(rng.normal(0, 0.3, (Q, L)), axis=1).astype(np.float32)
    qids = rng.integers(0, Q, B).astype(np.int32)
    if common_mode:  # tests/test_pallas_kernels.py:85-90
        a[0] += 100.0
        qm[qids[0]] += 100.0
    a[1] = qm[qids[1]] + rng.normal(0, 1e-3, L).astype(np.float32)
    return a, qm, qids


def _f64_dp(a, qm, qids, r):
    from kvmatch_tpu_torch.ops.dtw import _dtw_banded_batch_f64_np
    out = np.empty(a.shape[0])
    for q in np.unique(qids):
        rows = np.flatnonzero(qids == q)
        out[rows] = _dtw_banded_batch_f64_np(a[rows].astype(np.float64),
                                             qm[q].astype(np.float64),
                                             min(r, a.shape[1] - 1))
    return out


@pytest.mark.parametrize("B,L,r,common", [
    (37, 301, 0, False), (37, 301, 7, True), (5, 1001, 409, True),
    (9, 129, 200, False), (3, 2000, 1100, False)])
def test_dtw_kernels_equal_plain(dev, B, L, r, common):
    from kvmatch_tpu_torch import verify as vf
    from kvmatch_tpu_torch.ops import dtw as tdtw
    a, qm, qids = _dtw_case(B, L, 4, seed=L + r, common_mode=common)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    want = tdtw.dtw_banded_plain(*args, r).cpu().numpy().astype(np.float64)
    band = np.array([vf.guard_threshold(w, L, 1e-2) for w in want])
    outs = {}
    for fn in (tdtw.dtw_diag, tdtw.dtw_rows):
        before = fn.launches
        got = fn(*args, r)
        torch.cuda.synchronize(dev)
        assert fn.launches == before + 1
        outs[fn.__name__] = got.cpu().numpy().astype(np.float64)
        assert np.all(np.abs(outs[fn.__name__] - want) <= band), fn.__name__
    assert np.all(np.abs(outs["dtw_diag"] - outs["dtw_rows"]) <= band)
    before = tdtw.dtw_ds.launches
    hi, lo = tdtw.dtw_ds(*args, r)
    torch.cuda.synchronize(dev)
    assert tdtw.dtw_ds.launches == before + 1
    d64 = _f64_dp(a, qm, qids, r)
    eps32 = float(np.finfo(np.float32).eps)
    got = tdtw.ds_value(hi.cpu().numpy(), lo.cpu().numpy())
    assert np.all(np.abs(got - d64) <= 8.0 * eps32 * (d64 + 1.0))
    if r == 0:  # r = 0 is the squared Euclidean distance
        ed = ((a.astype(np.float64) - qm[qids].astype(np.float64)) ** 2).sum(1)
        np.testing.assert_allclose(got, ed, rtol=1e-6)


def test_dtw_kernels_reject_bad_input(dev):
    from kvmatch_tpu_torch.ops import dtw as tdtw
    a = torch.zeros((4, 100), device=dev)
    qm = torch.zeros((2, 100), device=dev)
    for fn in (tdtw.dtw_diag, tdtw.dtw_rows, tdtw.dtw_ds):
        with pytest.raises(ValueError, match="int32 qids"):
            fn(a, qm, torch.zeros(4, dtype=torch.int64, device=dev), 5)
        with pytest.raises(ValueError, match=r"\(Q, L\)"):
            fn(a, qm[:, :50].contiguous(),
               torch.zeros(4, dtype=torch.int32, device=dev), 5)


@pytest.mark.parametrize("B,L,r", [
    (64, 1024, 51), (16, 1024, 409), (13, 1024, 1100), (6, 1024, 52),
    (37, 301, 0), (9, 129, 200), (7, 500, 479), (7, 1500, 480),
    (3, 4000, 1500)])
def test_dtw_diag_equals_diag_plain_bitwise(dev, B, L, r):
    """K3 against dtw_diag_plain: bit for bit, on one-warp rows (r <= 479;
    r = 409 is the main path's 26-lane form) and on wide rows of several
    warps (r = 480 and beyond; r = 1100 at L = 1024 clamps to 1023)."""
    from kvmatch_tpu_torch.ops import dtw as tdtw
    a, qm, qids = _dtw_case(B, L, 5, seed=3 * L + r, common_mode=True)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    got = tdtw.dtw_diag(*args, r)
    torch.cuda.synchronize(dev)
    want = tdtw.dtw_diag_plain(*args, r)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,L,r", [
    (64, 1024, 51), (16, 1024, 409), (13, 1024, 1100), (6, 1024, 52),
    (37, 301, 0), (9, 129, 200), (7, 500, 479), (7, 1500, 480),
    (3, 4000, 1500)])
def test_dtw_ds_equals_diag_plain_bitwise(dev, B, L, r):
    """DS against dtw_ds_diag_plain: hi and lo bit for bit, in K3's shapes
    (one warp per row up to r = 479, several warps beyond)."""
    from kvmatch_tpu_torch.ops import dtw as tdtw
    a, qm, qids = _dtw_case(B, L, 5, seed=3 * L + r + 1, common_mode=True)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    before = tdtw.dtw_ds.launches
    hi, lo = tdtw.dtw_ds(*args, r)
    torch.cuda.synchronize(dev)
    assert tdtw.dtw_ds.launches == before + 1
    want_hi, want_lo = tdtw.dtw_ds_diag_plain(*args, r)
    assert torch.isfinite(want_hi).all() and (want_hi < tdtw.BIG).all()
    assert torch.equal(hi, want_hi)
    assert torch.equal(lo, want_lo)


def test_dtw_diag_rejects_bands_beyond_its_rows(dev):
    """Past K3_MAX_R = 106,495 (the widest band of a cluster of 8 blocks,
    where K3 and DS once raised) both take the global form, one launch
    each, and equal dtw_diag_plain / dtw_ds_diag_plain bit for bit."""
    from kvmatch_tpu_torch.ops import dtw as tdtw
    assert tdtw.K3_MAX_R == 106_495
    L = tdtw.K3_MAX_R + 2
    a, qm, qids = _znormed_case(2, L, 2, seed=L)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    assert tdtw.k3_form(args[0], L - 1) == "global"
    before = (tdtw.dtw_diag.global_launches, tdtw.dtw_ds.global_launches)
    k3 = tdtw.dtw_diag(*args, L - 1)
    hi, lo = tdtw.dtw_ds(*args, L - 1)
    torch.cuda.synchronize(dev)
    assert (tdtw.dtw_diag.global_launches,
            tdtw.dtw_ds.global_launches) == (before[0] + 1, before[1] + 1)
    want = tdtw.dtw_diag_plain(*args, L - 1)
    assert torch.isfinite(want).all() and (want < tdtw.BIG).all()
    assert torch.equal(k3, want)
    want_hi, want_lo = tdtw.dtw_ds_diag_plain(*args, L - 1)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)


@pytest.mark.parametrize("B,L,r", [
    (64, 1024, 51), (16, 1024, 409), (6, 1024, 52), (37, 301, 0),
    (9, 129, 200), (7, 500, 479), (8, 8192, 409)])
def test_dtw_rows_equals_rows_plain_bitwise(dev, B, L, r):
    """K4's one-warp form (2r + 1 <= 960) against dtw_rows_plain, its plain
    version in the same chunked scan order: bit for bit."""
    from kvmatch_tpu_torch.ops import dtw as tdtw
    a, qm, qids = _dtw_case(B, L, 5, seed=3 * L + r + 2, common_mode=True)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    before = tdtw.dtw_rows.launches
    got = tdtw.dtw_rows(*args, r)
    torch.cuda.synchronize(dev)
    assert tdtw.dtw_rows.launches == before + 1
    want = tdtw.dtw_rows_plain(*args, r)
    assert torch.isfinite(want).all() and (want < tdtw.BIG).all()
    assert torch.equal(got, want)


# Bands past one block of K3 (r > K3_BLOCK_MAX_R = 13,311): the first band
# past it (a cluster of 2 blocks), and clusters of 2 and 3 blocks.
WIDE_BANDS = [(3, 13_313, 13_312), (2, 32_768, 20_000), (2, 40_000, 30_000)]


def _znormed_case(B, L, Q, seed):
    """z-normed windows of the synthetic series, as the DTW engines pass
    them, row 1 a near-copy of its query.  (The row form's prefix sums of a
    wide band of raw random walks reach 1e8, where f32 cancellation alone
    passes the guard band; the engines' rows stay far from that.)"""
    rng = np.random.default_rng(seed)
    data = generate_series(L + 20_000, seed=seed)
    offs = rng.integers(0, data.size - L, B + Q)
    w = np.stack([data[o:o + L] for o in offs])
    w = ((w - w.mean(1, keepdims=True)) / w.std(1, keepdims=True))
    a, qm = w[:B].astype(np.float32), w[B:].astype(np.float32)
    qids = rng.integers(0, Q, B).astype(np.int32)
    a[1] = qm[qids[1]] + rng.normal(0, 1e-3, L).astype(np.float32)
    return a, qm, qids


@pytest.mark.parametrize("B,L,r", WIDE_BANDS)
def test_dtw_wide_bands_equal_plain(dev, B, L, r):
    """K3 and DS in the cluster form bit for bit against dtw_diag_plain and
    dtw_ds_diag_plain; K4 (its block form, carries in the global
    workspace) within the guard band of dtw_banded_plain and of K3."""
    from kvmatch_tpu_torch import verify as vf
    from kvmatch_tpu_torch.ops import dtw as tdtw
    assert r > tdtw.K3_BLOCK_MAX_R
    a, qm, qids = _znormed_case(B, L, 2, seed=L + r)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    before = (tdtw.dtw_diag.cluster_launches, tdtw.dtw_ds.cluster_launches)
    k3 = tdtw.dtw_diag(*args, r)
    hi, lo = tdtw.dtw_ds(*args, r)
    torch.cuda.synchronize(dev)
    assert (tdtw.dtw_diag.cluster_launches,
            tdtw.dtw_ds.cluster_launches) == (before[0] + 1, before[1] + 1)
    want = tdtw.dtw_diag_plain(*args, r)
    assert torch.isfinite(want).all() and (want < tdtw.BIG).all()
    assert torch.equal(k3, want)
    want_hi, want_lo = tdtw.dtw_ds_diag_plain(*args, r)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    k4 = tdtw.dtw_rows(*args, r).cpu().numpy().astype(np.float64)
    rows = tdtw.dtw_banded_plain(*args, r).cpu().numpy().astype(np.float64)
    band = np.array([vf.guard_threshold(w, L, 1e-2) for w in rows])
    assert np.all(np.abs(k4 - rows) <= band)
    assert np.all(np.abs(k4 - k3.cpu().numpy().astype(np.float64)) <= band)


def test_dtw_rows_workspace_strides_over_rows(dev):
    """K4's block form with its carries in the global workspace: sized for
    the blocks resident at once, which stride over more rows than that."""
    import ctypes
    from kvmatch_tpu_torch import kernels
    from kvmatch_tpu_torch import verify as vf
    from kvmatch_tpu_torch.ops import dtw as tdtw
    B, L, r = 300, 9_801, 9_800
    n = ctypes.c_longlong(0)
    assert kernels.lib().kvm_dtw_rows_workspace(B, L, 2, r,
                                                ctypes.byref(n)) == 0
    per_block = 3 * 1024 * -(-(2 * r + 1) // 1024)  # 3 carries of 1024 runs
    grid = n.value // per_block
    assert 0 < grid < B and n.value == grid * per_block
    a, qm, qids = _znormed_case(B, L, 2, seed=11)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    got = tdtw.dtw_rows(*args, r).cpu().numpy().astype(np.float64)
    want = tdtw.dtw_banded_plain(*args, r).cpu().numpy().astype(np.float64)
    band = np.array([vf.guard_threshold(w, L, 1e-2) for w in want])
    assert np.all(np.abs(got - want) <= band)


@pytest.mark.parametrize("name", ["dtw_diag_plain", "dtw_ds_diag_plain",
                                  "dtw_rows_plain", "dtw_banded_ds_plain"])
@pytest.mark.parametrize("B,L,r", [(256, 1024, 51), (256, 1024, 409),
                                   (2, 4096, 4095)])
def test_plain_graphs_equal_loop_form(dev, name, B, L, r):
    """The plain DP versions on the card, their full blocks of steps
    replayed CUDA graphs (``graph_replays`` goes up), bit for bit against
    their loop form (tests/test_torch_plain_blocks.py) on the card."""
    from kvmatch_tpu_torch.ops import dtw as tdtw
    from test_torch_plain_blocks import LOOP_BY_NAME
    a, qm, qids = _znormed_case(B, L, 2, seed=L + r)
    args = tuple(torch.as_tensor(x, device=dev) for x in (a, qm, qids))
    fn = getattr(tdtw, name)
    before = fn.graph_replays
    got = fn(*args, r)
    torch.cuda.synchronize(dev)
    assert fn.graph_replays > before
    want = LOOP_BY_NAME[name](*args, r)
    got, want = ((got, want) if isinstance(got, tuple)
                 else ((got,), (want,)))
    assert (want[0] < tdtw.BIG).all()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32),
                                                  w.view(torch.int32))


# The JAX package's single-query ops (ops/ed.py, ops/regions.py, ops/dtw.py)
# on the card: each is its ``_multi`` form (or the DP wrapper) with a
# one-row query batch or a query per row, so the two are equal bit for bit,
# and each launches its kernel (the counters move) or raises.
def _single_case(dev, n=200_000, L=1024, B=300, seed=11):
    rng = np.random.default_rng(seed)
    data = generate_series(n, seed=seed).astype(np.float32)
    data[500:500 + L] = 1.5  # a flat window: z-norm d2 inf
    offs = rng.integers(0, n - L + 1, B)
    offs[:3] = [0, n - L, 500]
    q = data[7000:7000 + L].astype(np.float64)
    qh = (q - q.mean()) / q.std()
    t = lambda x, **kw: torch.as_tensor(x, device=dev, **kw)  # noqa: E731
    return (t(data), t(q, dtype=torch.float32), t(qh, dtype=torch.float32),
            t(offs), L)


def test_single_query_window_ops_equal_multi(dev):
    data, q, qh, offs, L = _single_case(dev)
    zeros = torch.zeros(offs.shape[0], dtype=torch.int32, device=dev)
    before = ted.window_ed.launches
    raw = ted.ed_distances(data, q, offs, L)
    zn = ted.znorm_ed_distances(data, qh, offs, L)
    assert ted.window_ed.launches == before + 2
    assert torch.equal(raw, ted.ed_distances_multi(data, q[None], offs,
                                                   zeros, L))
    for g, w in zip(zn, ted.znorm_ed_distances_multi(data, qh[None], offs,
                                                     zeros, L)):
        assert torch.equal(g, w)
    assert bool(torch.isinf(zn[0][2])) and int(torch.isinf(zn[0]).sum()) == 1


def test_single_query_region_ops_equal_multi(dev):
    from kvmatch_tpu_torch.ops import regions as treg
    data, q, qh, offs, L = _single_case(dev)
    starts, M = offs[:8].clamp(max=data.shape[0] - (512 + L - 1)), 512
    zeros = torch.zeros(8, dtype=torch.int32, device=dev)
    center = float(q.mean())
    qc = q - center
    for g, w in zip(treg.region_ed_distances(data, qc, starts, L, M, center),
                    treg.region_ed_distances_multi(data, qc[None], starts,
                                                   zeros, L, M, center)):
        assert torch.equal(g, w)
    got = treg.region_znorm_distances(data, qh, starts, L, M)
    want = treg.region_znorm_distances_multi(data, qh[None], starts, zeros,
                                             L, M)
    assert len(got) == 3
    for g, w in zip(got, want[:3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", ["diag", "rows"])
@pytest.mark.parametrize("L,r", [(1024, 0), (1024, 51), (1024, 1023),
                                 (301, 500)])
def test_single_query_dtw_ops_equal_multi(dev, variant, L, r, monkeypatch):
    from kvmatch_tpu_torch.ops import dtw as tdtw
    monkeypatch.setitem(tdtw.DTW_STATE, "variant", variant)
    f32 = tdtw.dtw_diag if variant == "diag" else tdtw.dtw_rows
    a, qm, _ = _dtw_case(64, L, 64, seed=L + r)
    a, qm = (torch.as_tensor(x, device=dev) for x in (a, qm))
    zeros = torch.zeros(64, dtype=torch.int32, device=dev)
    rows = torch.arange(64, dtype=torch.int32, device=dev)
    before = (f32.launches, tdtw.dtw_ds.launches)
    one = tdtw.dtw_banded_batch(a, qm[3], r)
    per_row = tdtw.dtw_banded_batch_multi(a, qm, r)
    hi, lo = tdtw.dtw_banded_batch_ds_multi(a, qm, r)
    assert (f32.launches, tdtw.dtw_ds.launches) == (before[0] + 2,
                                                    before[1] + 1)
    assert torch.equal(one, f32(a, qm[3:4].contiguous(), zeros, r))
    assert torch.equal(per_row, f32(a, qm, rows, r))
    for g, w in zip((hi, lo), tdtw.dtw_ds(a, qm, rows, r)):
        assert torch.equal(g, w)
    d64 = _f64_dp(a.cpu().numpy(), qm.cpu().numpy(), rows.cpu().numpy(), r)
    eps32 = float(np.finfo(np.float32).eps)
    ds = tdtw.ds_value(hi.cpu().numpy(), lo.cpu().numpy())
    assert np.all(np.abs(ds - d64) <= 8.0 * eps32 * (d64 + 1.0))


def test_single_query_ops_raise_on_bad_input(dev):
    """Bad input raises before any launch; nothing runs the plain version."""
    from kvmatch_tpu_torch.ops import dtw as tdtw
    data, q, qh, offs, L = _single_case(dev, n=20_000, B=16)
    kernels = (ted.window_ed, tdtw.dtw_diag, tdtw.dtw_rows, tdtw.dtw_ds)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="int64 offsets"):
        ted.ed_distances(data, q, offs.to(torch.int32), L)
    with pytest.raises(ValueError, match="int64 offsets"):
        ted.znorm_ed_distances(data.double(), qh, offs, L)
    with pytest.raises(ValueError, match=r"\(Q, L\)"):
        ted.znorm_ed_distances(data, qh[:100], offs, L)
    a = torch.randn(8, 200, device=dev)
    with pytest.raises(ValueError, match="f32 rows"):
        tdtw.dtw_banded_batch(a.double(), a[0].double(), 5)
    with pytest.raises(ValueError, match=r"\(Q, L\)"):
        tdtw.dtw_banded_batch(a, a[0, :100], 5)
    with pytest.raises(ValueError, match="a query per row"):
        tdtw.dtw_banded_batch_multi(a, a[:4], 5)
    with pytest.raises(ValueError, match="a query per row"):
        tdtw.dtw_banded_batch_ds_multi(a, a[:, :100], 5)
    with pytest.raises(ValueError, match="contiguous"):
        tdtw.dtw_banded_batch_ds_multi(a[:, ::2], a[:, ::2], 5)
    assert [k.launches for k in kernels] == before
