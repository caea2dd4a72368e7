"""The port's sharded cNSM-DTW step and its top-K overflow recovery against
the JAX package's (tests/test_sharded_recovery.py's setup: n = 8 * 2048,
seed 11, L = 256, rho = 10, alpha = 1.5, beta = 8, eps = 2).

JAX runs on the conftest's 8-CPU mesh, the port on 8 ``torch.device("cpu")``
shards over the same bucket stack and plans.  The per-shard counts are
equal, so the recovery ladder escalates to the same ``used_k`` in both
packages; at the cap it raises or returns the host fallback.
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
from kvmatch_tpu.engine.base import QueryStats, _Ctx
from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
from kvmatch_tpu.engine.norm_ed import NormQueryEngine
from kvmatch_tpu.parallel import build as jpb
from kvmatch_tpu.parallel import mesh as jmesh
from kvmatch_tpu.parallel import query as jpq
from kvmatch_tpu_torch import oracle
from kvmatch_tpu_torch.config import IndexConfig
from kvmatch_tpu_torch.parallel import build as pb
from kvmatch_tpu_torch.parallel import mesh as pmesh
from kvmatch_tpu_torch.parallel import query as pq
from kvmatch_tpu_torch.parallel.dryrun import norm_inputs

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 8 * 2048
PER = N // 8
LENGTH = 256
RHO = 10
ALPHA, BETA, EPS = 1.5, 8.0, 2.0


@pytest.fixture(scope="module")
def setup():
    icfg = JIndexConfig()
    data = generate_series(N, seed=11)
    jm = jmesh.make_mesh(jax.devices()[:8])
    tm = pmesh.make_mesh([CPU] * 8)
    index, jstack = jpb.build_index_sharded(data, jm, icfg)
    q_offs = [N // 4, N // 2]
    queries = np.stack([data[o:o + LENGTH] for o in q_offs])
    jdata = jax.device_put(data.astype(np.float32), NamedSharding(jm, P("shard")))
    tdata = pb.shard_series(data, tm)
    tstack = pb.shards_from_numpy(np.asarray(jstack), tm)
    inputs = {}
    for name, cls, params in (
            ("norm_dtw", NormQueryEngineDtw,
             {"alpha": ALPHA, "beta": BETA, "rho": RHO}),
            ("norm", NormQueryEngine, {"alpha": ALPHA, "beta": BETA})):
        eng = cls.__new__(cls)
        eng.data, eng.n, eng.icfg, eng.index = data, data.size, icfg, index
        eng.qcfg = JQueryConfig()
        ctxs = [_Ctx(query=q, length=LENGTH, epsilon=EPS, eps2=EPS * EPS,
                     params=dict(params), stats=QueryStats()) for q in queries]
        segl = [eng._plan(c) for c in ctxs]
        cons, qhat = (t.numpy() for t in norm_inputs(ctxs, queries))
        inputs[name] = dict(
            jax=(jdata, jstack, jnp.asarray(qhat),
                 jpq.pack_segments_batch(segl, tuple(icfg.scales)),
                 jnp.full(2, EPS * EPS, jnp.float32), jnp.asarray(cons),
                 jnp.int32(N)),
            port=(tdata, tstack, torch.as_tensor(qhat),
                  pq.pack_segments_batch(segl, tuple(icfg.scales), CPU),
                  torch.full((2,), EPS * EPS), torch.as_tensor(cons), N),
            qhat=qhat)
    return dict(data=data, jm=jm, tm=tm, q_offs=q_offs, queries=queries,
                inputs=inputs)


def factories(s, name):
    """(JAX factory, port factory) of the step ``name``: top_k -> step."""
    jicfg, icfg = JIndexConfig(), IndexConfig()
    if name == "norm_dtw":
        return (lambda k: jpq.make_sharded_query_step_norm_dtw_batched(
                    s["jm"], jicfg, LENGTH, RHO, top_k=k),
                lambda k: pq.make_sharded_query_step_norm_dtw_batched(
                    s["tm"], icfg, LENGTH, RHO, top_k=k))
    return (lambda k: jpq.make_sharded_query_step_norm_batched(
                s["jm"], jicfg, LENGTH, top_k=k),
            lambda k: pq.make_sharded_query_step_norm_batched(
                s["tm"], icfg, LENGTH, top_k=k))


def test_norm_dtw_sharded_parity_and_no_false_dismissal(setup):
    s = setup
    jfac, tfac = factories(s, "norm_dtw")
    inp = s["inputs"]["norm_dtw"]
    jcounts = np.asarray(jfac(PER)(*inp["jax"])[0])
    counts, idx, d2, mean, std = (t.numpy() for t in tfac(PER)(*inp["port"]))
    assert counts.shape == (8, 2)
    np.testing.assert_array_equal(counts, jcounts)
    assert counts.max() <= PER, "top_k = per-shard positions cannot truncate"
    assert idx.shape == d2.shape == mean.shape == std.shape
    for qi, off in enumerate(s["q_offs"]):
        got = set(idx[:, qi, :][d2[:, qi, :] <= EPS * EPS + 1e-3].tolist())
        assert off in got, "lost the self-match"
        want = set(oracle.cnsm_dtw(s["data"], s["queries"][qi], EPS, RHO,
                                   ALPHA, BETA, device="cpu")[0].tolist())
        assert want <= got, f"missing {sorted(want - got)[:5]}"
        # soundness with a borderline guard: clear step answers are real
        clear = idx[:, qi, :][d2[:, qi, :] <= EPS * EPS * (1 - 1e-3)]
        assert set(clear.tolist()) <= want


@pytest.mark.parametrize("name", ["norm_dtw", "norm"])
def test_recovery_reaches_jax_used_k(setup, name):
    """From top_k = 64 both packages' ladders take the same rounds to the
    same used_k, and the final counts fit it."""
    s = setup
    jfac, tfac = factories(s, name)
    inp = s["inputs"][name]
    calls = {"jax": [], "port": []}

    def logged(fac, key):
        def make(k):
            calls[key].append(k)
            return fac(k)
        return make

    (jout, jk) = jpq.run_sharded_step_with_recovery(
        logged(jfac, "jax"), inp["jax"], top_k=64, k_cap=PER)
    (out, k) = pq.run_sharded_step_with_recovery(
        logged(tfac, "port"), inp["port"], top_k=64, k_cap=PER)
    assert calls["port"] == calls["jax"] and len(calls["port"]) > 1
    assert k == jk and k > 64
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    assert int(out[0].max()) <= k
    idx, d2 = out[1].numpy(), out[2].numpy()
    for qi, off in enumerate(s["q_offs"]):
        assert off in idx[:, qi, :][d2[:, qi, :] <= EPS * EPS + 1e-3].tolist()


def test_recovery_escalates_in_one_step(setup):
    """tests/test_sharded_recovery.py's ladder: from 8 with growth = per,
    one escalation straight to the cap."""
    s = setup
    _, tfac = factories(s, "norm_dtw")
    calls = []

    def factory(k):
        calls.append(k)
        return tfac(k)

    out, used_k = pq.run_sharded_step_with_recovery(
        factory, s["inputs"]["norm_dtw"]["port"], top_k=8, k_cap=PER,
        growth=PER)
    assert calls == [8, PER]
    assert used_k == PER and int(out[0].max()) <= used_k


def test_recovery_cap_raises_or_falls_back(setup):
    s = setup
    _, tfac = factories(s, "norm_dtw")
    inputs = s["inputs"]["norm_dtw"]["port"]
    with pytest.raises(OverflowError):
        pq.run_sharded_step_with_recovery(tfac, inputs, top_k=8, k_cap=8)
    sentinel = object()
    out, used_k = pq.run_sharded_step_with_recovery(
        tfac, inputs, top_k=8, k_cap=8, host_fallback=lambda: sentinel)
    assert out is sentinel and used_k == 0
