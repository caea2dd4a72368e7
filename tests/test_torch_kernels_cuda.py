"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: K1 (dense probe) counts and flags exactly equal -- the kernel is
compiled without multiply-add contraction and repeats the plain version's
f32 operations in order.  K2 (window distances): |d2 - d2_plain| <= 1e-5 L +
1e-5 d2 and mean/std within 1e-5 of the window's max |x| (summation order
differs; see tests/test_torch_ed.py).  Engine answers EQUAL the oracle.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.plan import QuerySegment
from kvmatch_tpu_torch.engine.norm_ed import NormQueryEngine
from kvmatch_tpu_torch.engine.rsm_ed import QueryEngine
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
from kvmatch_tpu_torch.ops import ed as ted
from kvmatch_tpu_torch.ops.probe import FLAG, probe_flags, probe_flags_plain
from kvmatch_tpu_torch.ops.sliding import build_buckets
from kvmatch_tpu_torch.parallel.query import pack_segments_batch
from kvmatch_tpu_torch.state import series_to_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _probe_case(norm, dev, n=40_000, L=512, Q=3, seed=0):
    icfg = IndexConfig()
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(0, 0.1, n + L + 512)).astype(np.float32)
    offs = rng.integers(0, n - L, Q)
    seg_lists = []
    for o in offs:
        q = data[o:o + L]
        segs, pos = [], 0
        for w in (100, 50, 25, 200, 25, 400, 25):
            if (pos + 1) * icfg.unit + w > L:
                break
            mean = float(q[pos * icfg.unit: pos * icfg.unit + w].mean())
            segs.append(QuerySegment(order=pos + 1, w=w, mean_lo=mean,
                                     mean_hi=mean, count=1))
            pos += w // icfg.unit
        seg_lists.append(segs)
    bk = build_buckets(torch.as_tensor(data, device=dev), tuple(icfg.scales),
                       icfg.pos_of_d)
    width = bk[max(icfg.scales)].shape[0]
    bstack = torch.stack([b[:width] for b in bk.values()]).contiguous()
    eps2 = torch.tensor([1.0, 25.0, 4.0][:Q], dtype=torch.float32, device=dev)
    if norm:
        cons = torch.tensor([[1.2, 5.0, data[o:o + L].mean(),
                              data[o:o + L].std()] for o in offs],
                            dtype=torch.float32, device=dev)
    else:
        cons = torch.zeros((Q, 4), dtype=torch.float32, device=dev)
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales), dev)
    return icfg, bstack, segs, eps2, cons, n - L + 1, L


def _run(fn, case, p0, npos, dev, norm):
    icfg, bstack, segs, eps2, cons, m, L = case
    Q = eps2.shape[0]
    flags = torch.zeros((Q, (p0 + npos) // FLAG), dtype=torch.bool, device=dev)
    counts = torch.zeros(Q, dtype=torch.int32, device=dev)
    fn(bstack, 0, segs, eps2, cons, p0, npos, m, flags, counts, length=L,
       unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard, norm=norm)
    torch.cuda.synchronize(dev)
    return counts.cpu().numpy(), flags.cpu().numpy()


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("p0,npos", [(0, 40_064), (8_192, 16_384)])
def test_probe_kernel_equals_plain(dev, norm, p0, npos):
    case = _probe_case(norm, dev)
    before = probe_flags.launches
    got = _run(probe_flags, case, p0, npos, dev, norm)
    assert probe_flags.launches == before + 1
    want = _run(probe_flags_plain, case, p0, npos, dev, norm)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[0].sum() > 0


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
        want, _ = oracle.nsm_ed(data, q, eps, alpha=1.5, beta=10.0)
        assert set(res.offsets.tolist()) == set(want.tolist())
        res = raw.query(q, 2 * eps)
        want, _ = oracle.rsm_ed(data, q, 2 * eps)
        assert set(res.offsets.tolist()) == set(want.tolist())
    assert probe_flags.launches > k1 and ted.window_ed.launches > k2


# ------------------------------------------------------------ DTW kernels
# K3 (dtw_diag) and K4 (dtw_rows) differ from their plain version only in
# f32 summation order: |d - d_plain| <= verify.guard_threshold(d_plain, L,
# 1e-2), the band the engines rely on.  The DS kernel's hi + lo is within
# 8 eps32 (d64 + 1) of the f64 DP on the same f32 inputs
# (tests/test_dtw_guard.py:62).

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
    from kvmatch_tpu import verify as vf
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
