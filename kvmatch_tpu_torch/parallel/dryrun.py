"""The multi-shard dry run (port of __graft_entry__.py:dryrun_multichip).

Runs the sharded build and all five sharded query steps at tiny shapes over
an ``n_shards`` mesh and checks each keeps its self-matches:

    python -c "from kvmatch_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

With no device list the mesh takes the visible CUDA devices in turn (four
shards on one card are ``cuda:0`` four times; four cards give
``cuda:0..3``) and raises without one; the tests pass CPU devices.  The
JAX version re-runs itself in a subprocess to provision a device count; a
device list that repeats a device needs no such step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import IndexConfig
from ..data.generators import generate_series
from ..engine.base import QueryStats, _Ctx
from ..engine.norm_dtw import NormQueryEngineDtw
from ..engine.norm_ed import NormQueryEngine
from ..engine.rsm_dtw import QueryEngineDtw
from ..engine.rsm_ed import QueryEngine
from .build import build_index_sharded, shard_series
from .mesh import _visible_cuda_devices, make_mesh
from .query import (make_sharded_query_step, make_sharded_query_step_batched,
                    make_sharded_query_step_dtw_batched,
                    make_sharded_query_step_norm_batched,
                    make_sharded_query_step_norm_dtw_batched, pack_segments,
                    pack_segments_batch, run_sharded_step_with_recovery)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def plan_group(eng, queries, eps: float, **params):
    """(segment lists, contexts) of a same-length query group, planned on the
    host by engine ``eng`` as its own batches are (``_plan_batch``)."""
    ctxs = [_Ctx(query=q, length=q.size, epsilon=eps, eps2=eps * eps,
                 params=dict(params), stats=QueryStats()) for q in queries]
    return eng._plan_batch(ctxs), ctxs


def norm_inputs(ctxs, queries, device=None):
    """cons rows (alpha, beta, mu_q, sd_q) and the z-normalized queries of
    planned cNSM contexts, f32 tensors (on ``device``)."""
    cons = np.asarray([[c.params["alpha"], c.params["beta"],
                        c.params["_mu_q"], c.params["_sd_q"]] for c in ctxs],
                      np.float32)
    qhat = np.stack([(q - c.params["_mu_q"]) / c.params["_sd_q"]
                     for q, c in zip(queries, ctxs)]).astype(np.float32)
    return (torch.as_tensor(cons, device=device),
            torch.as_tensor(qhat, device=device))


def _found(offsets, d2, qi: int, off: int, thresh: float) -> bool:
    o, d = offsets[:, qi, :], d2[:, qi, :]
    return off in o[d <= thresh].tolist()


def dryrun_multichip(n_shards: int, devices: Optional[Sequence] = None
                     ) -> None:
    """Run the sharded build and the five sharded steps over an
    ``n_shards`` mesh (tiny shapes); raises on any failed check."""
    if devices is None:
        cards = _visible_cuda_devices()
        devices = [cards[i % len(cards)] for i in range(n_shards)]
    devices = list(devices)
    _check(len(devices) >= n_shards,
           f"{len(devices)} devices for {n_shards} shards")
    mesh = make_mesh(devices[:n_shards])
    icfg = IndexConfig()
    n, length = n_shards * 4096, 256
    data = generate_series(n, seed=3)
    q_off = n // 4
    eps = 5.0
    scales = tuple(icfg.scales)
    cpu = torch.device("cpu")

    # Sharded index build: per-shard bucket pass with a right halo.
    index, stack = build_index_sharded(data, mesh, icfg)
    data_sh = shard_series(data, mesh)
    engines = {cls: cls(data, index=index, icfg=icfg, device_data="host")
               for cls in (QueryEngine, NormQueryEngine, QueryEngineDtw,
                           NormQueryEngineDtw)}  # host planners

    # Single-query step: K1 probe + K2 verify + candidate all-gather.
    q = data[q_off:q_off + length]
    (segments,), _ = plan_group(engines[QueryEngine], [q], eps)
    step = make_sharded_query_step(mesh, icfg, length, top_k=256)
    counts, idx, d2 = step(data_sh, stack, q, pack_segments(segments, scales,
                                                            cpu),
                           eps * eps, n)
    counts, idx, d2 = (t.cpu().numpy() for t in (counts, idx, d2))
    _check((counts <= 256).all(), f"per-shard top-K overflow: "
                                  f"{counts.tolist()}")
    total = int(counts.sum())
    answers = idx[d2 <= eps * eps]
    _check(total >= 1, "the probe lost the self-match candidate")
    _check(q_off in answers.tolist(), "sharded query lost the self-match")

    # Batched multi-query ED step.
    q_offs = [q_off, min(n // 2, n - length), n // 8]
    queries = np.stack([data[o:o + length] for o in q_offs])
    seg_lists, _ = plan_group(engines[QueryEngine], queries, eps)
    _, bidx, bd2 = make_sharded_query_step_batched(
        mesh, icfg, length, top_k=128)(
        data_sh, stack, queries, pack_segments_batch(seg_lists, scales, cpu),
        torch.full((3,), eps * eps), n)
    bidx, bd2 = bidx.cpu().numpy(), bd2.cpu().numpy()
    for qi, off in enumerate(q_offs):
        _check(_found(bidx, bd2, qi, off, eps * eps),
               f"batched step lost query {qi}'s self-match")

    # cNSM-ED step: z-space probe + sigma filter + z-norm verify.
    alpha, beta, neps = 1.5, 8.0, 2.0
    nsegs, nctxs = plan_group(engines[NormQueryEngine], queries[:2], neps,
                              alpha=alpha, beta=beta)
    cons, qhat = norm_inputs(nctxs, queries[:2])
    # K = the per-shard position count: the z and envelope bounds do not
    # select at these tiny shapes.
    _, nidx, nd2, _, _ = make_sharded_query_step_norm_batched(
        mesh, icfg, length, top_k=4096)(
        data_sh, stack, qhat, pack_segments_batch(nsegs, scales, cpu),
        torch.full((2,), neps * neps), cons, n)
    nidx, nd2 = nidx.cpu().numpy(), nd2.cpu().numpy()
    for qi, off in enumerate(q_offs[:2]):
        _check(_found(nidx, nd2, qi, off, neps * neps + 1e-3),
               f"norm step lost query {qi}'s self-match")

    # RSM-DTW step: envelope probe + banded DP (K3).
    rho = 10
    dsegs, _ = plan_group(engines[QueryEngineDtw], queries[:2], eps, rho=rho)
    _, didx, dd2 = make_sharded_query_step_dtw_batched(
        mesh, icfg, length, rho, top_k=4096)(
        data_sh, stack, queries[:2], pack_segments_batch(dsegs, scales, cpu),
        torch.full((2,), eps * eps), n)
    didx, dd2 = didx.cpu().numpy(), dd2.cpu().numpy()
    for qi, off in enumerate(q_offs[:2]):
        _check(_found(didx, dd2, qi, off, eps * eps + 1e-3),
               f"dtw step lost query {qi}'s self-match")

    # cNSM-DTW step through the top-K overflow recovery, from a K small
    # enough that the escalation runs.
    cdsegs, cdctxs = plan_group(engines[NormQueryEngineDtw], queries[:2],
                                neps, alpha=alpha, beta=beta, rho=rho)
    cd_cons, cd_qhat = norm_inputs(cdctxs, queries[:2])
    cd_inputs = (data_sh, stack, cd_qhat,
                 pack_segments_batch(cdsegs, scales, cpu),
                 torch.full((2,), neps * neps), cd_cons, n)
    (cdc, cdi, cdd, _, _), used_k = run_sharded_step_with_recovery(
        lambda k: make_sharded_query_step_norm_dtw_batched(
            mesh, icfg, length, rho, top_k=k),
        cd_inputs, top_k=64, k_cap=data_sh.per)
    cdc, cdi, cdd = (t.cpu().numpy() for t in (cdc, cdi, cdd))
    _check(cdc.max() <= used_k, "recovery returned a truncated result")
    for qi, off in enumerate(q_offs[:2]):
        _check(_found(cdi, cdd, qi, off, neps * neps + 1e-3),
               f"cNSM-DTW step lost query {qi}'s self-match")
    print(f"dryrun_multichip OK: {n_shards} devices, "
          f"{total} candidates, {answers.size} answers, "
          f"batched {len(q_offs)}-query ED + 2-query cNSM + 2-query DTW + "
          f"2-query cNSM-DTW (recovery K={used_k}) steps OK")
