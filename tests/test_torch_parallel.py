"""The port's sharded build and query (kvmatch_tpu_torch/parallel/) against
the JAX package's on the same inputs.

JAX runs on the conftest's 8-CPU mesh, the port on a ``Mesh`` of 8
``torch.device("cpu")`` (the kernels' plain versions).  The setup is
tests/test_parallel.py's: ``generate_series(40_000, seed=13)`` and its
offsets, epsilons and constraints.  Both packages' steps take the same
bucket stack (the JAX stack, split by ``shards_from_numpy``) and the same
plans (JAX's planner, packed by each package).  Per-shard probe counts are
equal; every step keeps the float64 oracle's answers; its float64-confirmed
answer set equals JAX's and the oracle's; its distances agree with JAX's on
the candidates both return.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kvmatch_tpu.config import IndexConfig as JIndexConfig
from kvmatch_tpu.config import QueryConfig as JQueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.base import QueryStats as JQueryStats
from kvmatch_tpu.engine.base import _Ctx as JCtx
from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw as JNormDtw
from kvmatch_tpu.engine.norm_ed import NormQueryEngine as JNorm
from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw as JDtw
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JRaw
from kvmatch_tpu.parallel import build as jpb
from kvmatch_tpu.parallel import mesh as jmesh
from kvmatch_tpu.parallel import query as jpq
from kvmatch_tpu_torch import NormQueryEngine, QueryEngine, oracle
from kvmatch_tpu_torch.config import IndexConfig
from kvmatch_tpu_torch.ops.dtw import dtw_banded_batch_f64
from kvmatch_tpu_torch.parallel import build as pb
from kvmatch_tpu_torch.parallel import mesh as pmesh
from kvmatch_tpu_torch.parallel import query as pq
from kvmatch_tpu_torch.parallel import dryrun
from kvmatch_tpu_torch.parallel.dryrun import dryrun_multichip
from kvmatch_tpu_torch.parallel.query import make_bucket_stack
from kvmatch_tpu_torch.storage.memory import HbmStore

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 40_000


@pytest.fixture(scope="module")
def data():
    return generate_series(N, seed=13)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jmesh.make_mesh(jax.devices()), pmesh.make_mesh([CPU] * 8)


@pytest.fixture(scope="module")
def built(data, meshes):
    jm, tm = meshes
    jindex, jstack = jpb.build_index_sharded(data, jm, JIndexConfig())
    return jindex, np.asarray(jstack)


# --------------------------------------------------------------------- mesh
def test_mesh_ring_order_equals_jax():
    """Slice-major ring order over the same ids and slice maps as JAX's,
    including tests/test_parallel.py's shuffled two-slice case; with no map
    the order is by id, and a CPU list stays as it came."""
    jdevs = sorted(jax.devices(), key=lambda d: d.id)
    ids = [d.id for d in jdevs]
    shuffle = [5, 0, 3, 6, 1, 7, 2, 4]
    slice_of = {i: (0 if k < 4 else 1) for k, i in enumerate(ids)}
    cases = [None, slice_of, lambda i: slice_of[i], lambda i: -i]
    for sl in cases:
        want = [d.id for d in jmesh.order_devices_for_ring(
            [jdevs[k] for k in shuffle], slice_of=sl)]
        got = pmesh.order_devices_for_ring(
            [torch.device("cuda", ids[k]) for k in shuffle], slice_of=sl)
        assert [d.index for d in got] == want
        ms = pmesh.make_mesh_multislice(
            [torch.device("cuda", ids[k]) for k in shuffle], slice_of=sl)
        assert [d.index for d in ms.devices] == want
        if sl is slice_of:
            seen = [slice_of[i] for i in want]
            assert seen == sorted(seen) != [slice_of[ids[k]] for k in shuffle]
    cpus = pmesh.order_devices_for_ring([CPU] * 3)
    assert cpus == [CPU] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh()
    else:
        assert pmesh.make_mesh().size == torch.cuda.device_count()


# -------------------------------------------------------------------- build
@pytest.mark.parametrize("n,n_sh", [(N, 8), (N + 3, 8), (N, 3)],
                         ids=["divisible", "padded", "three_shards"])
def test_sharded_build_equals_jax(data, n, n_sh):
    """The sharded stack equals JAX's make_sharded_buckets output bit for
    bit (through shards_from_numpy and back), and the single-device stack
    over the valid starts; the index equals JAX's sharded build's.  Three
    shards exercise the last shard's wrapped halo."""
    series = generate_series(n, seed=13) if n != N else data
    icfg = IndexConfig()
    jm = jmesh.make_mesh(jax.devices()[:n_sh])
    tm = pmesh.make_mesh([CPU] * n_sh)
    jindex, jstack = jpb.build_index_sharded(series, jm, JIndexConfig())
    jstack = np.asarray(jstack)
    index, stack = pb.build_index_sharded(series, tm, icfg)
    assert len(stack) == n_sh and all(t.dtype == torch.int32 for t in stack)
    np.testing.assert_array_equal(pb.shards_to_numpy(stack), jstack)
    back = pb.shards_to_numpy(pb.shards_from_numpy(jstack, tm))
    np.testing.assert_array_equal(back, jstack)
    single = make_bucket_stack(torch.as_tensor(series.astype(np.float32)),
                               icfg).numpy()
    for i, w in enumerate(icfg.scales):
        np.testing.assert_array_equal(jstack[i, :n - w + 1],
                                      single[i, :n - w + 1])
    for w in icfg.scales:
        for f in ("keys", "left", "right", "row_ptr"):
            np.testing.assert_array_equal(getattr(index[w], f),
                                          getattr(jindex[w], f))


def test_hbm_store_sharded(data):
    mesh = pmesh.make_mesh([CPU] * 3)
    store = HbmStore(data, sharding=mesh)
    assert isinstance(store.device, pb.Shards) and len(store.device) == 3
    padded = pmesh.pad_to_shards(data.astype(np.float32), 3)
    per = padded.size // 3
    for i, t in enumerate(store.device):
        assert t.dtype == torch.float32 and t.device == CPU
        np.testing.assert_array_equal(t.numpy(), padded[i * per:(i + 1) * per])
    assert store.length() == N and store.read_all().dtype == np.float64
    np.testing.assert_array_equal(store.read(100, 5), data[100:105])
    with pytest.raises(ValueError):
        HbmStore(data, device="cpu", sharding=mesh)


def test_haloed_keeps_one_copy_at_the_widest_halo():
    x = np.arange(30, dtype=np.int32)
    sh = pb.shards_from_numpy(x, pmesh.make_mesh([CPU] * 3))
    wide = sh.haloed(6, 2, -1)
    for i, t in enumerate(wide):
        want = np.concatenate([x[i * 10:i * 10 + 10],
                               x[(i + 1) % 3 * 10:][:6], [-1, -1]])
        np.testing.assert_array_equal(t.numpy(), want)
    assert sh.haloed(4, 2, -1) is wide  # a narrower halo reads the copy
    assert sh.halo_bytes == sh.haloed_bytes - 3 * 12 * 4 == 3 * 6 * 4
    wider = sh.haloed(8, 2, -1)  # replaces it: one copy held
    assert [t.shape[0] for t in wider] == [20] * 3
    assert sh.haloed_bytes == 3 * 20 * 4 and sh.halo_bytes == 3 * 14 * 4
    assert sh.haloed(3) is not wider and sh.haloed_bytes == 3 * 13 * 4
    with pytest.raises(ValueError):
        sh.haloed(11)


# -------------------------------------------------------------------- steps
# name: (JAX engine, L, eps, params, query offsets, top_k) from
# tests/test_parallel.py (cNSM-DTW: tests/test_sharded_recovery.py's
# constraints and offsets, K = the per-shard position count).
STEPS = {
    "ed": (JRaw, 512, 6.0, {}, [21000], 512),
    "ed_batched": (JRaw, 512, 6.0, {}, [3000, 15000, 27000, 36000], 128),
    "norm": (JNorm, 256, 2.0, {"alpha": 1.4, "beta": 5.0},
             [5000, 18000, 31000], 4096),
    "dtw": (JDtw, 256, 4.0, {"rho": 12}, [8000, 24000], 2048),
    "norm_dtw": (JNormDtw, 256, 2.0, {"alpha": 1.5, "beta": 8.0, "rho": 10},
                 [4096, 8192], N // 8),
}


def plans(cls, data, jindex, queries, eps, params):
    eng = cls.__new__(cls)
    eng.data, eng.n, eng.icfg, eng.index = data, data.size, JIndexConfig(), \
        jindex
    eng.qcfg = JQueryConfig()
    ctxs = [JCtx(query=q, length=q.size, epsilon=eps, eps2=eps * eps,
                 params=dict(params), stats=JQueryStats()) for q in queries]
    return [eng._plan(c) for c in ctxs], ctxs


def oracle_set(name, data, q, eps, params):
    if name.startswith("ed"):
        o = oracle.rsm_ed(data, q, eps, device="cpu")
    elif name == "norm":
        o = oracle.nsm_ed(data, q, eps, device="cpu", **params)
    elif name == "dtw":
        o = oracle.rsm_dtw(data, q, eps, params["rho"], device="cpu")
    else:
        o = oracle.cnsm_dtw(data, q, eps, device="cpu", **params)
    return set(o[0].tolist())


def constrained(mu, sd, q, params):
    """The windows (means mu, stds sd) meeting the cNSM constraints."""
    mq, sq = q.mean(), q.std()
    a, b = params["alpha"], params["beta"]
    return (sd > 0) & (np.abs(mu - mq) <= b) & (sd / sq <= a) & \
        (sd / sq >= 1 / a)


def confirm_f64(name, data, q, cand, eps, params):
    """The candidates that meet the query in float64 (distance and, for
    cNSM, the constraints)."""
    cand = np.asarray(sorted(cand), np.int64)
    if cand.size == 0:
        return set()
    L = q.size
    w = data[cand[:, None] + np.arange(L)[None, :]]
    if name in ("norm", "norm_dtw"):
        mu, sd = w.mean(axis=1), w.std(axis=1)
        ok = constrained(mu, sd, q, params)
        cand, w, mu, sd = cand[ok], w[ok], mu[ok], sd[ok]
        w = (w - mu[:, None]) / sd[:, None]
        q = (q - q.mean()) / q.std()
    if name.endswith("dtw"):
        d2 = dtw_banded_batch_f64(w, q, params["rho"])
    else:
        d2 = np.sum((w - q[None, :]) ** 2, axis=1)
    return set(cand[d2 <= eps * eps].tolist())


def run_jax(name, jm, jstack, data, L, queries, segl, ctxs, eps, params, k):
    scales = tuple(JIndexConfig().scales)
    icfg = JIndexConfig()
    data_sh = jax.device_put(data.astype(np.float32),
                             NamedSharding(jm, P("shard")))
    stack = jax.device_put(jstack, NamedSharding(jm, P(None, "shard")))
    Q = len(queries)
    e2 = jnp.full(Q, eps * eps, jnp.float32)
    nt = jnp.int32(data.size)
    if name == "ed":
        out = jpq.make_sharded_query_step(jm, icfg, L, top_k=k)(
            data_sh, stack, jnp.asarray(queries[0], jnp.float32),
            jpq.pack_segments(segl[0], scales), jnp.float32(eps * eps), nt)
        return [np.asarray(o) for o in out]
    segs = jpq.pack_segments_batch(segl, scales)
    if name in ("norm", "norm_dtw"):
        cons, qhat = norm_inputs(ctxs, queries)
        fac = (jpq.make_sharded_query_step_norm_batched(jm, icfg, L, top_k=k)
               if name == "norm" else
               jpq.make_sharded_query_step_norm_dtw_batched(
                   jm, icfg, L, params["rho"], top_k=k))
        out = fac(data_sh, stack, jnp.asarray(qhat), segs, e2,
                  jnp.asarray(cons), nt)
    elif name == "dtw":
        out = jpq.make_sharded_query_step_dtw_batched(
            jm, icfg, L, params["rho"], top_k=k)(
            data_sh, stack, jnp.asarray(queries, jnp.float32), segs, e2, nt)
    else:
        out = jpq.make_sharded_query_step_batched(jm, icfg, L, top_k=k)(
            data_sh, stack, jnp.asarray(queries, jnp.float32), segs, e2, nt)
    return [np.asarray(o) for o in out]


def norm_inputs(ctxs, queries):
    """dryrun.norm_inputs as numpy arrays, for both packages' steps."""
    return tuple(t.numpy() for t in dryrun.norm_inputs(ctxs, queries))


def run_port(name, tm, stack, data, L, queries, segl, ctxs, eps, params, k):
    icfg = IndexConfig()
    scales = tuple(icfg.scales)
    data_sh = pb.shard_series(data, tm)
    Q = len(queries)
    e2 = torch.full((Q,), eps * eps)
    if name == "ed":
        out = pq.make_sharded_query_step(tm, icfg, L, top_k=k)(
            data_sh, stack, queries[0], pq.pack_segments(segl[0], scales, CPU),
            np.float32(eps * eps), data.size)
        return [o.numpy() for o in out]
    segs = pq.pack_segments_batch(segl, scales, CPU)
    if name in ("norm", "norm_dtw"):
        cons, qhat = norm_inputs(ctxs, queries)
        fac = (pq.make_sharded_query_step_norm_batched(tm, icfg, L, top_k=k)
               if name == "norm" else
               pq.make_sharded_query_step_norm_dtw_batched(
                   tm, icfg, L, params["rho"], top_k=k))
        out = fac(data_sh, stack, torch.as_tensor(qhat), segs, e2,
                  torch.as_tensor(cons), data.size)
    elif name == "dtw":
        out = pq.make_sharded_query_step_dtw_batched(
            tm, icfg, L, params["rho"], top_k=k)(
            data_sh, stack, queries, segs, e2, data.size)
    else:
        out = pq.make_sharded_query_step_batched(tm, icfg, L, top_k=k)(
            data_sh, stack, queries, segs, e2, data.size)
    return [o.numpy() for o in out]


def per_query(name, out, qi):
    """(offsets, d2) of query qi, flattened over the shards."""
    idx, d2 = out[1], out[2]
    if name == "ed":
        return idx.ravel(), d2.ravel()
    return idx[:, qi, :].ravel(), d2[:, qi, :].ravel()


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sharded_step_equals_jax(data, meshes, built, name):
    jm, tm = meshes
    jindex, jstack = built
    cls, L, eps, params, q_offs, k = STEPS[name]
    queries = np.stack([data[o:o + L] for o in q_offs])
    segl, ctxs = plans(cls, data, jindex, queries, eps, params)
    jout = run_jax(name, jm, jstack, data, L, queries, segl, ctxs, eps,
                   params, k)
    stack = pb.shards_from_numpy(jstack, tm)
    out = run_port(name, tm, stack, data, L, queries, segl, ctxs, eps,
                   params, k)
    np.testing.assert_array_equal(out[0], jout[0])  # probe counts
    if name != "ed_batched":
        assert out[0].shape[0] == 8
    dtw = name.endswith("dtw")
    # The JAX tests' thresholds for the f32 candidates (test_parallel.py,
    # test_sharded_recovery.py:95).
    thresh = {"ed": eps * eps * (1 + 1e-3), "ed_batched": eps * eps * (1 + 1e-3),
              "norm": eps * eps * (1 + 1e-2) + 1e-3,
              "dtw": eps * eps * (1 + 1e-2) + 1e-3,
              "norm_dtw": eps * eps + 1e-3}[name]
    for qi, off in enumerate(q_offs):
        want = oracle_set(name, data, queries[qi], eps, params)
        assert off in want
        idx, d2 = per_query(name, out, qi)
        jidx, jd2 = per_query(name, jout, qi)
        got = set(idx[d2 <= thresh].tolist())
        jgot = set(jidx[jd2 <= thresh].tolist())
        assert want <= got, f"query {qi} lost {sorted(want - got)[:5]}"
        mine = confirm_f64(name, data, queries[qi], got, eps, params)
        theirs = confirm_f64(name, data, queries[qi], jgot, eps, params)
        assert mine == theirs == want
        # soundness: the clearly-inside f32 answers are real answers (the
        # cNSM-ED step, like JAX's, leaves the alpha/beta test to the
        # caller's confirm: its windows failing it are not answers)
        clear = idx[d2 <= eps * eps * (1 - 1e-3)]
        if name == "norm":
            w = data[clear[:, None] + np.arange(L)[None, :]]
            clear = clear[constrained(w.mean(axis=1), w.std(axis=1),
                                      queries[qi], params)]
        assert set(clear.tolist()) <= want
        # distances on the candidates both return
        a = dict(zip(idx[np.isfinite(d2)].tolist(), d2[np.isfinite(d2)]))
        b = dict(zip(jidx[np.isfinite(jd2)].tolist(), jd2[np.isfinite(jd2)]))
        common = sorted(a.keys() & b.keys())
        assert len(common) >= len(want)
        x = np.asarray([a[c] for c in common], np.float64)
        y = np.asarray([b[c] for c in common], np.float64)
        if dtw:  # the guard band of test_parallel.py:285
            assert np.all(np.abs(x - y) <= 1e-2 * y + 1e-3)
        else:  # f32 sums of L squares in another order
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=L * 1e-7)


@pytest.mark.parametrize("name", ["ed", "norm"])
def test_one_shard_mesh_equals_single_device_engine(data, name):
    """A 1-shard mesh answers as the port's single-device engine."""
    icfg = IndexConfig()
    tm = pmesh.make_mesh([CPU])
    index, stack = pb.build_index_sharded(data, tm, icfg)
    cls, L, eps, params, q_offs, k = STEPS[name]
    queries = np.stack([data[o:o + L] for o in q_offs])
    eng_cls = QueryEngine if name == "ed" else NormQueryEngine
    eng = eng_cls(data, index=index, icfg=icfg, device="cpu")
    segl, ctxs = plans({"ed": JRaw, "norm": JNorm}[name], data, index,
                       queries, eps, params)
    out = run_port(name, tm, stack, data, L, queries, segl, ctxs, eps,
                   params, N)
    for qi in range(len(q_offs)):
        idx, d2 = per_query(name, out, qi)
        got = confirm_f64(name, data, queries[qi],
                          set(idx[d2 <= eps * eps * (1 + 1e-2) + 1e-3].tolist()),
                          eps, params)
        res = eng.query(queries[qi], eps, **params)
        assert got == set(res.offsets.tolist())


@pytest.mark.parametrize("n_shards", [8, 1])
def test_dryrun_multichip(n_shards, capsys):
    dryrun_multichip(n_shards, [CPU] * n_shards)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip OK: {n_shards} devices, ")
