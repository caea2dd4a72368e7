"""Dense phase-1 probe (K1): the PyTorch port against the JAX XLA probe.

The port's plain version of K1 must reproduce the per-position bound of
``kvmatch_tpu.parallel.query._dense_probe`` / ``_dense_probe_norm`` op for op
in f32, so counts and 128-position flags are exactly equal.  The full flags
step (cached bucket stack, K1, constraint AND) is held against the JAX
``make_dense_probe_step_flags(flag_block=128)``: counts equal, the constraint
only removes flags, and no exact answer's block is dismissed.  The CUDA kernel
is held against the plain version in tests/test_torch_kernels_cuda.py.
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
from kvmatch_tpu_torch.ops.probe import FLAG, probe_flags
from kvmatch_tpu_torch.parallel import query as tq

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


def _probe_fixture(norm, rho=None):
    """The fixture of tests/test_probe_pallas.py: two tiles of positions,
    the window end inside the block, hand-made segment plans (envelope
    segments with ``rho``)."""
    icfg = IndexConfig()
    rng = np.random.default_rng(0)
    L, Q = 512, 2
    blk = 2 * TILE
    halo = TILE
    n = blk - 3000
    data = np.cumsum(rng.normal(0, 0.1, blk + halo + 400))
    offs = rng.integers(0, n - L, Q)
    seg_lists = _mk_segments(data, offs, L, icfg, [100, 50, 25, 200, 25],
                             rho)
    eps2 = np.asarray([1.0, 25.0], np.float32)
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
    segs = tq.pack_segments_batch(seg_lists, tuple(icfg.scales), "cpu")
    flags = torch.zeros((Q, blk // FLAG), dtype=torch.bool)
    counts = torch.zeros(Q, dtype=torch.int32)
    probe_flags(torch.as_tensor(bwin), 0, segs, torch.as_tensor(eps2),
                torch.as_tensor(cons), 0, blk, m, flags, counts, length=L,
                unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard, norm=norm)
    return counts.numpy(), flags.numpy()


@pytest.mark.parametrize("norm,rho", [(False, None), (True, None),
                                      (False, 25), (True, 25)])
def test_plain_probe_matches_xla_probe(norm, rho):
    """Counts and flags equal the XLA probe's, on point segments and (rho)
    on the DTW engines' envelope segments, where both z-bounds of the
    where-form are live."""
    icfg, data, L, Q, blk, m, seg_lists, eps2, cons, bwin = _probe_fixture(
        norm, rho)
    if rho is not None:
        assert all(s.mean_lo < s.mean_hi for segs in seg_lists for s in segs)
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
    tpad = tq.fly_pad_for(L, max(icfg.scales))
    tdata_p = torch.cat([torch.as_tensor(data, dtype=torch.float32),
                         torch.full((tpad,), float(tq.FLY_FILL))])
    return dict(icfg=icfg, n=n, L=L, data=data, offs=offs, alpha=alpha,
                beta=beta, eps=eps, seg_lists=seg_lists, cons=cons, eps2=eps2,
                ref=ref, data_p=tdata_p)


def _port_step(s, norm, cached):
    icfg, L = s["icfg"], s["L"]
    segs = tq.pack_segments_batch(s["seg_lists"], tuple(icfg.scales), "cpu")
    kw = {}
    if cached:
        kw["bstack"] = tq.make_bucket_stack(s["data_p"], icfg)
        kw["stats3"] = tq.make_cons_stats(s["data_p"], L) if norm else None
    counts, flags = tq.dense_probe_flags(
        s["data_p"], segs, torch.as_tensor(s["eps2"]),
        torch.as_tensor(s["cons"]), s["n"], icfg, L, norm, **kw)
    return counts.numpy(), flags.numpy()


def test_flags_step_raw_equals_xla(flags_setup):
    s = flags_setup
    counts, flags = _port_step(s, norm=False, cached=True)
    nx, fx = s["ref"][False]
    np.testing.assert_array_equal(counts, nx)
    k = flags.shape[1]
    np.testing.assert_array_equal(flags, fx[:, :k])
    assert not fx[:, k:].any()  # JAX pads its flag grid past m


def test_flags_step_norm_constraint_and_sound(flags_setup):
    s = flags_setup
    counts, flags = _port_step(s, norm=True, cached=True)
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
    and window stats per position block; results are bit-identical."""
    s = flags_setup
    want = _port_step(s, norm, cached=True)
    monkeypatch.setattr(tq, "PROBE_BLOCK", 1 << 14)
    got = _port_step(s, norm, cached=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

