"""Dense phase-1 probe (K1): the PyTorch port against the JAX XLA probe.

The port's plain version of K1 must reproduce the per-position bound of
``kvmatch_tpu.parallel.query._dense_probe`` / ``_dense_probe_norm`` op for op
in f32, so counts and 128-position flags are exactly equal.  The full flags
step (cached bucket stack, K1, constraint AND) is held against the JAX
``make_dense_probe_step_flags(flag_block=128)``: counts equal, the constraint
only removes flags, and no exact answer's block is dismissed.  The AND's
flags equal a brute force in numpy f32 (the same operations, position by
position, column by column), on its own, in the resident probe's pass
(engine/probe.py) and in the cNSM engine's.  The CUDA kernels are held
against the plain versions in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.base import QueryStats, _Ctx
from kvmatch_tpu.index.build import build_index_tpu
from kvmatch_tpu.ops.sliding import build_buckets as jax_build_buckets
from kvmatch_tpu.parallel import query as jq
from kvmatch_tpu.plan import QuerySegment, envelope
from kvmatch_tpu_torch.engine.probe import ResidentProbe
from kvmatch_tpu_torch.ops import probe as tp
from kvmatch_tpu_torch.ops.probe import FLAG, probe_flags

torch.set_num_threads(2)

TILE = 8192


def _mk_segments(data, offs, L, icfg, widths, rho=None):
    """Hand-made plans; with ``rho`` the segments are envelope segments, as
    the DTW engines' ``_plan_inputs`` make them: mean_lo and mean_hi are the
    means of the query's Sakoe-Chiba envelope (mean_lo < mean_hi)."""
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
                                     mean_lo=lo[span].mean(),
                                     mean_hi=hi[span].mean(), count=1))
            pos += w // icfg.unit
        seg_lists.append(segs)
    return seg_lists


# (Q, L, plan widths): the fixture of tests/test_probe_pallas.py, and the
# widest plan tables the kernel takes -- 32 queries of 30 segments each.
PROBE_SHAPES = {"q2": (2, 512, [100, 50, 25, 200, 25]),
                "q32_seg30": (32, 1536, [25, 50, 25, 100, 25] * 6)}


def _probe_fixture(norm, rho=None, shape="q2"):
    """The fixture of tests/test_probe_pallas.py: two tiles of positions,
    the window end inside the block, hand-made segment plans (envelope
    segments with ``rho``)."""
    icfg = IndexConfig()
    rng = np.random.default_rng(0)
    Q, L, widths = PROBE_SHAPES[shape]
    blk = 2 * TILE
    halo = TILE
    n = blk - 3000
    data = np.cumsum(rng.normal(0, 0.1, blk + halo + 400))
    offs = rng.integers(0, n - L, Q)
    seg_lists = _mk_segments(data, offs, L, icfg, widths, rho)
    eps2 = np.asarray([1.0, 25.0] * (Q // 2), np.float32)
    if norm:
        cons = np.asarray([[1.2, 5.0, data[o:o + L].mean(), data[o:o + L].std()]
                           for o in offs], np.float32)
    else:
        cons = np.zeros((Q, 4), np.float32)
    bk = jax_build_buckets(jnp.asarray(data, jnp.float32), tuple(icfg.scales),
                           icfg.pos_of_d)
    bwin = np.stack([np.asarray(bk[w][: blk + halo]) for w in icfg.scales])
    return icfg, data, L, Q, blk, n - L + 1, seg_lists, eps2, cons, bwin


def _port_probe(icfg, L, Q, blk, m, seg_lists, eps2, cons, bwin, norm):
    segs = tp.pack_segments_batch(seg_lists, tuple(icfg.scales), "cpu")
    flags = torch.zeros((Q, blk // FLAG), dtype=torch.bool)
    counts = torch.zeros(Q, dtype=torch.int32)
    probe_flags(torch.as_tensor(bwin), 0, segs, torch.as_tensor(eps2),
                torch.as_tensor(cons), 0, blk, m, flags, counts, length=L,
                unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard, norm=norm)
    return counts.numpy(), flags.numpy()


@pytest.mark.parametrize("norm,rho,shape", [
    (False, None, "q2"), (True, None, "q2"), (False, 25, "q2"),
    (True, 25, "q2"), (False, 25, "q32_seg30"), (True, 25, "q32_seg30")])
def test_plain_probe_matches_xla_probe(norm, rho, shape):
    """Counts and flags equal the XLA probe's, on point segments and (rho)
    on the DTW engines' envelope segments, where both z-bounds of the
    where-form are live; q32_seg30 is the widest table K1 takes."""
    icfg, data, L, Q, blk, m, seg_lists, eps2, cons, bwin = _probe_fixture(
        norm, rho, shape)
    if rho is not None:
        assert all(s.mean_lo < s.mean_hi for segs in seg_lists for s in segs)
    assert min(map(len, seg_lists)) == len(PROBE_SHAPES[shape][2])
    segs = jq.pack_segments_batch(seg_lists, tuple(icfg.scales))
    slack = np.float32(icfg.probe_guard)
    bw = jnp.asarray(bwin)
    if norm:
        acc = jax.vmap(lambda sg, c: jq._dense_probe_norm(
            bw, sg, icfg.unit, icfg.d, blk, slack, c[0], c[1], c[2], c[3],
            L))(segs, jnp.asarray(cons))
    else:
        acc = jax.vmap(lambda sg: jq._dense_probe(
            bw, sg, icfg.unit, icfg.d, blk, slack, L))(segs)
    mask = (np.asarray(acc) <= eps2[:, None]) & (np.arange(blk)[None, :] < m)
    counts, flags = _port_probe(icfg, L, Q, blk, m, seg_lists, eps2, cons,
                                bwin, norm)
    np.testing.assert_array_equal(counts, mask.sum(axis=1))
    np.testing.assert_array_equal(flags,
                                  mask.reshape(Q, blk // FLAG, FLAG).any(2))
    assert counts.min() >= 1  # self-query offsets are candidates


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_plain_probe_terms_count_open_positions(norm, blocked, monkeypatch):
    """probe_work, the work K1's early exit needs: every live position is
    open before the first segment, a position never reopens (each term is
    >= 0), and after the last segment the open positions are the plain
    probe's counts (RSM-ED) or a superset of them (the sigma filter of
    cNSM removes some).  The entries read cover each query's first segment
    over all m positions and touch no row outside the plans.  ``blocked``:
    summed over several position blocks."""
    if blocked:
        monkeypatch.setattr(tp, "PROBE_BLOCK", 1 << 12)
    icfg, data, L, Q, blk, m, seg_lists, eps2, cons, bwin = _probe_fixture(
        norm, 25)
    segs = tp.pack_segments_batch(seg_lists, tuple(icfg.scales), "cpu")
    terms, reads = tp.probe_work(
        torch.as_tensor(bwin), segs, torch.as_tensor(eps2),
        torch.as_tensor(cons), m, unit=icfg.unit, d=icfg.d,
        slack=icfg.probe_guard, norm=norm)
    want = _port_probe(icfg, L, Q, blk, m, seg_lists, eps2, cons, bwin, norm)
    for t, segs_q, c in zip(terms, seg_lists, want[0]):
        assert len(t) == len(segs_q) + 1 and t[0] == m
        assert all(a >= b for a, b in zip(t, t[1:]))
        assert t[-1] == c if not norm else t[-1] >= c
    assert sum(map(sum, terms)) < (len(seg_lists[0]) + 1) * m * Q
    rows = {icfg.scales.index(s.w) for segs_q in seg_lists for s in segs_q}
    assert all(reads[icfg.scales.index(segs_q[0].w)] >= m
               for segs_q in seg_lists)
    assert all(r == 0 for i, r in enumerate(reads) if i not in rows)
    assert sum(reads) < len(rows) * bwin.shape[1]


@pytest.fixture(scope="module")
def flags_setup():
    """The workload of tests/test_probe_pallas.py's flags-step test: plans
    and constraint rows exactly as the JAX engine builds them."""
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    icfg = IndexConfig()
    n, L, Q = 60_000, 512, 2
    data = generate_series(n, seed=11)
    index = build_index_tpu(data, icfg, backend="host")
    eng = NormQueryEngine(data, index=index, icfg=icfg)
    offs = np.random.default_rng(3).integers(0, n - L, Q)
    alpha, beta, eps = 1.3, 8.0, 6.0
    ctxs, seg_lists = [], []
    for o in offs:
        ctx = _Ctx(query=data[o:o + L], length=L, epsilon=eps, eps2=eps * eps,
                   params={"alpha": alpha, "beta": beta}, stats=QueryStats())
        seg_lists.append(eng._plan(ctx))
        ctxs.append(ctx)
    cons = np.asarray([[alpha, beta, c.params["_mu_q"], c.params["_sd_q"]]
                       for c in ctxs], np.float32)
    eps2 = np.full(Q, eps * eps, np.float32)
    jpad = jq.fly_pad_for(L, max(icfg.scales))
    jdata_p = jnp.concatenate([jnp.asarray(data, jnp.float32),
                               jnp.full(jpad, jq.FLY_FILL, jnp.float32)])
    jsegs = jq.pack_segments_batch(seg_lists, tuple(icfg.scales))
    ref = {}
    for norm in (False, True):
        step = jq.make_dense_probe_step_flags(icfg, L, flag_block=FLAG,
                                              norm=norm)
        ref[norm] = tuple(np.asarray(a) for a in step(
            jdata_p, jsegs, jnp.asarray(eps2), jnp.asarray(cons), jnp.int32(n)))
    tpad = tp.fly_pad_for(L, max(icfg.scales))
    tdata_p = torch.cat([torch.as_tensor(data, dtype=torch.float32),
                         torch.full((tpad,), float(tp.FLY_FILL))])
    return dict(icfg=icfg, n=n, L=L, data=data, offs=offs, alpha=alpha,
                beta=beta, eps=eps, seg_lists=seg_lists, cons=cons, eps2=eps2,
                ref=ref, data_p=tdata_p)


def _port_step(s, norm, cached):
    """The resident probe's pass over the setup's series: through the
    cached tables (a budget of all free memory) or the per-block route (a
    budget of 0).  Returns (counts, flags, rebuilds)."""
    icfg, L = s["icfg"], s["L"]
    segs = tp.pack_segments_batch(s["seg_lists"], tuple(icfg.scales), "cpu")
    probe = ResidentProbe(torch.as_tensor(s["data"], dtype=torch.float32),
                          icfg)
    counts, flags, rebuilds = probe.run(
        segs, torch.as_tensor(s["eps2"]), torch.as_tensor(s["cons"]), L,
        norm, 1.0 if cached else 0.0)
    assert torch.equal(probe.padded(L), s["data_p"])
    return counts.numpy(), flags.numpy(), rebuilds


def test_flags_step_raw_equals_xla(flags_setup):
    s = flags_setup
    counts, flags, rebuilds = _port_step(s, norm=False, cached=True)
    assert rebuilds == 0
    nx, fx = s["ref"][False]
    np.testing.assert_array_equal(counts, nx)
    k = flags.shape[1]
    np.testing.assert_array_equal(flags, fx[:, :k])
    assert not fx[:, k:].any()  # JAX pads its flag grid past m


def test_flags_step_norm_constraint_and_sound(flags_setup):
    s = flags_setup
    counts, flags, _ = _port_step(s, norm=True, cached=True)
    nx, fx = s["ref"][True]
    np.testing.assert_array_equal(counts, nx)  # counts stay probe-only
    k = flags.shape[1]
    assert not (flags & ~fx[:, :k]).any()  # the constraint only removes flags
    assert flags.sum() < fx[:, :k].sum()   # ... and removes some here
    data, L = s["data"], s["L"]
    for qi, o in enumerate(s["offs"]):
        ans, _ = oracle.nsm_ed(data, data[o:o + L], s["eps"],
                               alpha=s["alpha"], beta=s["beta"])
        assert o in ans.tolist()
        assert flags[qi][ans // FLAG].all(), f"query {qi}: answer dismissed"


@pytest.mark.parametrize("norm", [False, True])
def test_flags_step_uncached_blocked_bit_identical(flags_setup, norm,
                                                    monkeypatch):
    """Without the cached stack and stats the step rebuilds bucket windows
    and window stats per position block; results are bit-identical, and
    the pass counts the tables it made."""
    s = flags_setup
    want = _port_step(s, norm, cached=True)
    monkeypatch.setattr(tp, "PROBE_BLOCK", 1 << 14)
    got = _port_step(s, norm, cached=False)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    blocks = -(-(s["n"] - s["L"] + 1) // (1 << 14))
    assert want[2] == 0 and got[2] == blocks * (1 + norm) and blocks > 1



def _cons_brute(s, stats3, flags_k1, p0=0, npos=None, cons=None):
    """The AND over positions [p0, p0 + npos) of ``flags_k1`` (bool (Q, NF),
    copied), in numpy f32, one operation at a time as
    ops/probe.py:_cons_ok_flags writes them, and each query's count of
    the columns it clears, column by column.  ``cons``: the setup's rows
    unless given."""
    L, m = s["L"], s["n"] - s["L"] + 1
    npos = flags_k1.shape[1] * FLAG - p0 if npos is None else npos
    f32 = np.float32
    eps32 = np.finfo(f32).eps
    inv_l = f32(1.0 / L)
    km = f32(4 * (np.log2(L) + 2) * eps32)
    kv = f32(8 * (np.log2(L) + 2) * eps32)
    s1, s2, amax = (np.asarray(r[p0:p0 + npos], f32) for r in stats3)
    mean = s1 * inv_l
    var = np.maximum(s2 * inv_l - mean * mean, f32(0))
    m_tol = km * amax + f32(1e-7)
    v_tol = kv * amax * amax + f32(2) * amax * m_tol + f32(1e-7)
    live = p0 + np.arange(npos) < m
    flags = flags_k1.copy()
    cleared = np.zeros(flags.shape[0], np.int64)
    rows = s["cons"] if cons is None else cons
    for q, (alpha, beta, mu_q, sd_q) in enumerate(rows):
        hi2, lo2 = alpha * sd_q, sd_q / alpha
        ok = (live & (np.abs(mean - mu_q) <= beta + m_tol)
              & (var <= hi2 * hi2 + v_tol) & (var >= lo2 * lo2 - v_tol))
        for c in range(npos // FLAG):
            j = p0 // FLAG + c
            if flags[q, j] and not ok[c * FLAG:(c + 1) * FLAG].any():
                flags[q, j] = False
                cleared[q] += 1
    return flags, cleared


def _k1_flags(s, seg_lists=None, cons=None):
    """K1's flags alone (the plain version, cNSM), before the AND; the
    setup's plans and constraint rows unless given."""
    from kvmatch_tpu_torch.ops.probe import probe_flags_plain
    icfg, L, n = s["icfg"], s["L"], s["n"]
    seg_lists = s["seg_lists"] if seg_lists is None else seg_lists
    cons = s["cons"] if cons is None else cons
    m = n - L + 1
    npos = -(-m // FLAG) * FLAG
    segs = tp.pack_segments_batch(seg_lists, tuple(icfg.scales), "cpu")
    Q = len(seg_lists)
    flags = torch.zeros((Q, npos // FLAG), dtype=torch.bool)
    probe_flags_plain(tp.make_bucket_stack(s["data_p"], icfg), 0, segs,
                      torch.as_tensor(s["eps2"]), torch.as_tensor(cons),
                      0, npos, m, flags, torch.zeros(Q, dtype=torch.int32),
                      length=L, unit=icfg.unit, d=icfg.d,
                      slack=icfg.probe_guard, norm=True)
    return flags


# (p0, npos) of one cons_and call over a flag matrix of the whole range,
# with PROBE_BLOCK (the plain version's pass): the whole range in one
# pass; in passes of 4096 positions; a window off the range's start that
# ends before m; a window over the last, partial column.
CONS_WINDOWS = {"whole": (0, None, None), "passes": (0, None, 1 << 12),
                "window": (8192, 16384, None),
                "tail": (59392, 128, 1 << 12)}


@pytest.mark.parametrize("case", sorted(CONS_WINDOWS))
def test_cons_and_plain_equals_brute_force(flags_setup, case, monkeypatch):
    """The AND's wrapper on CPU tensors over positions [p0, p0 + npos):
    the flags outside the window are left as they were, and those inside
    equal the numpy brute force."""
    s = flags_setup
    p0, npos, block = CONS_WINDOWS[case]
    if block is not None:
        monkeypatch.setattr(tp, "PROBE_BLOCK", block)
    k1 = _k1_flags(s)
    npos = k1.shape[1] * FLAG - p0 if npos is None else npos
    m = s["n"] - s["L"] + 1
    assert m % FLAG and (case != "tail" or p0 + npos > m)
    stats3 = tp.make_cons_stats(s["data_p"], s["L"])
    flags = k1.clone()
    tp.cons_and(*stats3[:, p0:], torch.as_tensor(s["cons"]), p0, npos, m,
                s["L"], flags)
    want, n_clear = _cons_brute(s, stats3.numpy(), k1.numpy(), p0, npos)
    np.testing.assert_array_equal(flags.numpy(), want)
    if case != "tail":
        assert n_clear.min() > 0  # the AND clears some of K1's flags here


@pytest.mark.parametrize("cached", [True, False])
def test_dense_probe_cleared_counts_brute_force(flags_setup, cached,
                                                monkeypatch):
    """The resident probe's flags, through the cached statistics (one AND
    over all positions) and the per-block route (one a block): the brute
    force's AND over K1's flags, which clears some of them for every
    query."""
    s = flags_setup
    if not cached:
        monkeypatch.setattr(tp, "PROBE_BLOCK", 1 << 14)
    _, flags, _ = _port_step(s, norm=True, cached=cached)
    stats3 = tp.make_cons_stats(s["data_p"], s["L"]).numpy()
    want, n_clear = _cons_brute(s, stats3, _k1_flags(s).numpy())
    np.testing.assert_array_equal(flags, want)
    assert n_clear.min() > 0


def test_engine_reports_cons_cleared(flags_setup, monkeypatch):
    """The cNSM engine's probe pass: its flags are the brute force's AND
    over K1's flags on the engine's own plans and constraint rows, which
    clears some of them for every query; the RSM engine's pass runs no
    AND."""
    from kvmatch_tpu_torch.engine import probe as ep
    from kvmatch_tpu_torch.engine.base import QueryStats as TQueryStats
    from kvmatch_tpu_torch.engine.base import _Ctx as TCtx
    from kvmatch_tpu_torch.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu_torch.engine.rsm_ed import QueryEngine
    s = flags_setup
    data, L, eps = s["data"], s["L"], s["eps"]
    queries = np.stack([data[o:o + L] for o in s["offs"]])
    params = dict(alpha=s["alpha"], beta=s["beta"])
    eng = NormQueryEngine(data, icfg=s["icfg"], device="cpu")
    passes = []

    def spy(*a, _orig=eng.probe.run, **kw):
        passes.append(_orig(*a, **kw))
        return passes[-1]
    monkeypatch.setattr(eng.probe, "run", spy)
    eng.query_batch_device(queries, eps, **params)
    ctxs = [TCtx(query=q, length=L, epsilon=eps, eps2=eps * eps,
                 params=dict(params), stats=TQueryStats()) for q in queries]
    seg_lists = eng._plan_batch(ctxs)
    cons = np.asarray([[c.params[k] for k in ("alpha", "beta", "_mu_q",
                                              "_sd_q")] for c in ctxs],
                      np.float32)
    stats3 = tp.make_cons_stats(s["data_p"], L).numpy()
    want, n_clear = _cons_brute(
        s, stats3, _k1_flags(s, seg_lists, cons).numpy(), cons=cons)
    assert n_clear.min() > 0
    ((_, flags, _),) = passes
    np.testing.assert_array_equal(flags.numpy(), want)
    ands = []
    monkeypatch.setattr(ep, "cons_and", lambda *a: ands.append(a))
    rsm = QueryEngine(data, icfg=s["icfg"], device="cpu")
    assert all(r.found for r in rsm.query_batch_device(queries, eps))
    assert not ands
