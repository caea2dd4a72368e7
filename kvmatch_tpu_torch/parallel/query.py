"""The sharded query steps in PyTorch (port of the mesh-sharded steps of
kvmatch_tpu/parallel/query.py).

The steps (``make_sharded_query_step*``, ``run_sharded_step_with_
recovery``) run one query group over a ``parallel.mesh.Mesh`` whose series
and bucket stack are split by offset range (parallel/build.py).  Each shard
reads its own slice plus an ``L``-point right halo, probes it with K1
(ops/probe.py: exact per-position counts, a flag per 128 positions), takes
the starts of its flagged blocks as candidates and verifies them with K2
(ED) or K3/K4 (DTW); the stacked per-shard outputs are the JAX steps'
candidate all-gather.  The JAX steps' dense bound, ``lax.top_k`` and fixed
``K`` exist because XLA needs static shapes; here the ``K`` axis is as long
as the longest list.  The plan tables (``DenseSegments``,
``pack_segments_batch``) and the bucket stack are ops/probe.py's; the
single-card probe over a resident series is engine/probe.py's.

``PROBE_BLOCK`` read or set on this module is ops/probe.py's: the
benchmark's per-block test cuts the probe's block here.
"""

from __future__ import annotations

import contextlib
import sys
import types
from typing import Tuple

import torch

from .. import verify as vf
from ..config import IndexConfig
from ..ops import probe as _probe
from ..ops.dtw import _dtw_f32, _znorm_rows
from ..ops.ed import _gather, window_ed
from ..ops.probe import (BIG_BUCKET, FLAG, DenseSegments, pack_segments_batch,
                         probe_flags)
from .mesh import Mesh


class _Module(types.ModuleType):
    """This module, with ``PROBE_BLOCK`` forwarded to ops/probe.py's."""

    @property
    def PROBE_BLOCK(self) -> int:
        return _probe.PROBE_BLOCK

    @PROBE_BLOCK.setter
    def PROBE_BLOCK(self, value: int) -> None:
        _probe.PROBE_BLOCK = value


sys.modules[__name__].__class__ = _Module


# ------------------------------------------------------------ sharded steps
#: DP rows a K3/K4 launch of the sharded DTW steps.
DTW_CHUNK = 16_384


def pack_segments(segments, scales: Tuple[int, ...], device) -> DenseSegments:
    """One query's plan as (MAX_SEGMENTS,) tables (the single-query sharded
    step's segments)."""
    return DenseSegments(*(t[0] for t in pack_segments_batch(
        [segments], scales, device)))


def _on(x, dev, dtype):
    """A replicated argument (tensor, array or number) on ``dev``."""
    return torch.as_tensor(x, dtype=dtype).to(dev)


def _chunked(fn, offs, qids, step: int):
    """``fn(offs, qids)`` (a tuple of (B,) tensors) over row chunks."""
    parts = [fn(offs[s:s + step], qids[s:s + step])
             for s in range(0, offs.shape[0], step)]
    return tuple(torch.cat(col) for col in zip(*parts))


def _on_device(dev):
    """The kernels launch on the current stream of the current device."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _ranks(qids, Q: int):
    """Each row's position within its query's run (rows sorted by query)."""
    lens = torch.bincount(qids, minlength=Q)
    first = torch.cumsum(lens, 0) - lens
    return torch.arange(qids.shape[0], dtype=first.dtype,
                        device=qids.device) - first[qids.long()], lens


def _candidates(flags, cnt, m: int, top_k: int):
    """A shard's candidate lists from K1's flags: every start below ``m`` of
    each flagged FLAG-block of query q, or its first ``top_k`` when q's
    count exceeds ``top_k``.  Returns (int64 starts, int32 qids), sorted by
    query then start.  Starts past ``m`` sort last in their query's run, so
    a rank over the unfiltered run is the rank among the valid starts."""
    dev = flags.device
    qb = torch.nonzero(flags).to(torch.int32)  # (query, block), by query
    lane = torch.arange(FLAG, dtype=torch.int32, device=dev)
    starts = (qb[:, 1:] * FLAG + lane[None, :]).flatten()
    qids = qb[:, :1].expand(-1, FLAG).flatten()
    rank, _ = _ranks(qids, flags.shape[0])
    keep = (starts < m) & ((rank < top_k) | (cnt[qids.long()] <= top_k))
    return starts[keep].to(torch.int64), qids[keep]


def _run_sharded(mesh: Mesh, icfg: IndexConfig, length: int, top_k: int,
                 data, bstack, segs: DenseSegments, eps2, cons, n_total: int,
                 norm: bool, verify, n_out: int):
    """The body every sharded step shares.

    Per shard: K1 over the shard's haloed bucket stack (exact counts of the
    positions whose bound is <= eps2, a flag per FLAG positions); the
    candidate list of query q is every start of its flagged blocks when
    its count is <= top_k, else the first top_k of them; ``verify(dev,
    data_h, offs, qids)`` -> ``n_out`` (B,) f32 rows (d2 first) over the
    list, with int64 offsets local to the shard.  Returns counts int32
    (n_sh, Q), global int64 offsets (n_sh, Q, K) and the ``n_out`` f32
    outputs (n_sh, Q, K) on the mesh's first device; K is the longest list,
    shorter ones padded with offset 0, d2 = inf and 0 elsewhere.

    K1 is launched on every shard before any host read, and each shard's
    verify before the next shard's lists are read, so the shards of
    different cards overlap; the host waits on a shard only for its flags
    (two reads a shard) and, at the end, for the list lengths."""
    n_sh = mesh.size
    if len(data) != n_sh or len(bstack) != n_sh:
        raise ValueError(f"{len(data)} series and {len(bstack)} stack shards "
                         f"for a mesh of {n_sh}")
    L = int(length)
    per = data.per
    if bstack.per != per:
        raise ValueError("series and stack shards differ in length")
    npad = -(-per // FLAG) * FLAG
    data_h = data.haloed(L)
    b_h = bstack.haloed(L, npad - per, BIG_BUCKET)
    Q = int(eps2.shape[0])
    m_all = int(n_total) - L + 1
    kw = dict(length=L, unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard,
              norm=norm)

    probes = []
    for s, dev in enumerate(mesh.devices):
        m = min(max(m_all - s * per, 0), per)
        cnt = torch.zeros(Q, dtype=torch.int32, device=dev)
        flags = None
        if m > 0:
            with _on_device(dev):
                npos = -(-m // FLAG) * FLAG
                flags = torch.zeros((Q, npos // FLAG), dtype=torch.bool,
                                    device=dev)
                probe_flags(b_h[s], 0, DenseSegments(*(
                    t.to(dev) for t in segs)), _on(eps2, dev, torch.float32),
                    _on(cons, dev, torch.float32), 0, npos, m, flags, cnt,
                    **kw)
        probes.append((m, cnt, flags))

    shards = []
    for s, dev in enumerate(mesh.devices):
        m, cnt, flags = probes[s]
        offs = qids = res = None
        if flags is not None:
            with _on_device(dev):
                offs, qids = _candidates(flags, cnt, m, top_k)
                if offs.numel():
                    res = verify(dev, data_h[s], offs, qids)
        shards.append((offs, qids, res))

    out_dev = mesh.devices[0]
    ranked = [_ranks(q, Q) if res is not None else None
              for _, q, res in shards]
    K = max((int(r[1].max()) for r in ranked if r is not None), default=0)
    offsets = torch.zeros((n_sh, Q, K), dtype=torch.int64, device=out_dev)
    vals = [torch.full((n_sh, Q, K), torch.inf if j == 0 else 0.0,
                       dtype=torch.float32, device=out_dev)
            for j in range(n_out)]
    for s, (offs, qids, res) in enumerate(shards):
        if res is None:
            continue
        at = (qids.long().to(out_dev), ranked[s][0].to(out_dev))
        offsets[s].index_put_(at, offs.to(out_dev) + s * per)
        for j in range(n_out):
            vals[j][s].index_put_(at, res[j].to(out_dev))
    return (torch.stack([p[1].to(out_dev) for p in probes]), offsets, *vals)


def _ed_verify(length: int, queries, znorm: bool):
    """K2 over the candidate rows, in ``verify.bucket_size`` chunks."""
    def verify(dev, data_h, offs, qids):
        qs = _on(queries, dev, torch.float32).contiguous()
        step = vf.bucket_size(offs.shape[0], lo=1, width=length)

        def fn(o, qi):
            r = window_ed(data_h, qs, o.contiguous(), qi.contiguous(), length,
                          znorm)
            return r if znorm else (r,)
        return _chunked(fn, offs, qids, step)
    return verify


def _dtw_verify(length: int, rho: int, queries, cons=None):
    """K3 (or K4, ops/dtw.DTW_STATE) over the gathered candidate rows in
    chunks of at most DTW_CHUNK rows.  With ``cons`` (cNSM-DTW; rows alpha,
    beta, mu_q, sd_q) the rows are z-normalized, the alpha/beta test of
    kvmatch_tpu/parallel/query.py:1073-1078 runs with its float32
    tolerance, and only the rows passing it take a DP row (the others'
    d2 is inf, as the JAX step masks them); returns (d2, mean, std)."""
    def verify(dev, data_h, offs, qids):
        qs = _on(queries, dev, torch.float32).contiguous()
        step = min(vf.bucket_size(offs.shape[0], lo=1, width=length),
                   DTW_CHUNK)
        if cons is None:
            return _chunked(lambda o, qi: (_dtw_f32(
                _gather(data_h, o, length), qs, qi, rho),), offs, qids, step)
        c = _on(cons, dev, torch.float32)

        def fn(o, qi):
            z, mean, std = _znorm_rows(_gather(data_h, o, length), length)
            alpha, beta, mu_q, sd_q = (c[qi.long(), k] for k in range(4))
            tol = 1e-3 * (1.0 + torch.abs(mu_q) + sd_q)
            ok = ((torch.abs(mean - mu_q) <= beta + tol)
                  & (std <= alpha * sd_q + tol)
                  & (std >= sd_q / alpha - tol) & (std > 0))
            d2 = torch.full_like(mean, torch.inf)
            keep = torch.nonzero(ok).flatten()
            if keep.numel():
                d2[keep] = _dtw_f32(z[keep].contiguous(), qs, qi[keep], rho)
            return d2, mean, std
        return _chunked(fn, offs, qids, step)
    return verify


def _raw_cons(Q: int):
    return torch.zeros((Q, 4), dtype=torch.float32)


def make_sharded_query_step(mesh: Mesh, icfg: IndexConfig, length: int,
                            top_k: int = 1024):
    """Mesh-sharded single-query RSM-ED step (kvmatch_tpu/parallel/
    query.py:927).

    Args to the returned fn: (data Shards f32, bstack Shards int32 (S, per),
    query (L,), segs from ``pack_segments``, eps2 scalar, n_total) ->
    (counts int32 (n_sh,) per shard, offsets int64 (n_sh, K) global, d2 f32
    (n_sh, K)).  ``counts[i] > top_k`` means shard i's list is truncated."""
    def step(data, bstack, query, segs: DenseSegments, eps2, n_total):
        q = torch.as_tensor(query, dtype=torch.float32).reshape(1, -1)
        segs1 = DenseSegments(*(t.reshape(1, -1) for t in segs))
        e2 = torch.as_tensor(eps2, dtype=torch.float32).reshape(1)
        counts, offs, d2 = _run_sharded(
            mesh, icfg, length, top_k, data, bstack, segs1, e2, _raw_cons(1),
            n_total, False, _ed_verify(length, q, False), 1)
        return counts[:, 0], offs[:, 0], d2[:, 0]
    return step


def make_sharded_query_step_batched(mesh: Mesh, icfg: IndexConfig,
                                    length: int, top_k: int = 256):
    """Mesh-sharded multi-query RSM-ED step (kvmatch_tpu/parallel/
    query.py:877).

    Args: (data, bstack, queries (Q, L), segs (Q, S), eps2 (Q,), n_total)
    -> (totals int32 (Q,), offsets int64 (n_sh, Q, K), d2 f32 (n_sh, Q,
    K)).  As in the JAX step, the counts are summed over the shards (its
    ``psum``): a total <= top_k means no shard truncated."""
    def step(data, bstack, queries, segs: DenseSegments, eps2, n_total):
        e2 = torch.as_tensor(eps2, dtype=torch.float32)
        counts, offs, d2 = _run_sharded(
            mesh, icfg, length, top_k, data, bstack, segs, e2,
            _raw_cons(e2.shape[0]), n_total, False,
            _ed_verify(length, queries, False), 1)
        return counts.sum(0, dtype=torch.int32), offs, d2
    return step


def make_sharded_query_step_norm_batched(mesh: Mesh, icfg: IndexConfig,
                                         length: int, top_k: int = 256):
    """Mesh-sharded multi-query cNSM-ED step (kvmatch_tpu/parallel/
    query.py:1101).

    Args: (data, bstack, queries_hat (Q, L) z-normalized, segs, eps2 (Q,),
    cons (Q, 4) rows (alpha, beta, mu_q, sd_q), n_total) -> (counts int32
    (n_sh, Q), offsets int64 (n_sh, Q, K), d2, mean, std f32 (n_sh, Q, K)).
    Phase 1 is K1's z-space bound with the sigma-filter tracks (the probe
    bound alone, as in the JAX step: no alpha/beta AND); phase 2 is K2 in
    z-norm mode (d2 inf where a window's std is 0)."""
    def step(data, bstack, queries_hat, segs: DenseSegments, eps2, cons,
             n_total):
        return _run_sharded(mesh, icfg, length, top_k, data, bstack, segs,
                            eps2, cons, n_total, True,
                            _ed_verify(length, queries_hat, True), 3)
    return step


def make_sharded_query_step_dtw_batched(mesh: Mesh, icfg: IndexConfig,
                                        length: int, rho: int,
                                        top_k: int = 256):
    """Mesh-sharded multi-query RSM-DTW step (kvmatch_tpu/parallel/
    query.py:1173): K1 over the envelope plans' segments, then banded DTW of
    raw rows (K3, or K4 under ops/dtw.DTW_STATE).  Args and outputs as
    ``make_sharded_query_step_norm_batched`` without cons, mean and std;
    counts are per shard, (n_sh, Q)."""
    def step(data, bstack, queries, segs: DenseSegments, eps2, n_total):
        e2 = torch.as_tensor(eps2, dtype=torch.float32)
        return _run_sharded(mesh, icfg, length, top_k, data, bstack, segs,
                            e2, _raw_cons(e2.shape[0]), n_total, False,
                            _dtw_verify(length, rho, queries), 1)
    return step


def make_sharded_query_step_norm_dtw_batched(mesh: Mesh, icfg: IndexConfig,
                                             length: int, rho: int,
                                             top_k: int = 256):
    """Mesh-sharded multi-query cNSM-DTW step (kvmatch_tpu/parallel/
    query.py:1015): K1's z-space bound over the envelope plans' segments,
    then z-normalized rows, the guarded alpha/beta test and banded DTW
    against the z-normalized queries.  Args and outputs as
    ``make_sharded_query_step_norm_batched``; d2 is inf where the
    constraints fail."""
    def step(data, bstack, queries_hat, segs: DenseSegments, eps2, cons,
             n_total):
        return _run_sharded(mesh, icfg, length, top_k, data, bstack, segs,
                            eps2, cons, n_total, True,
                            _dtw_verify(length, rho, queries_hat, cons), 3)
    return step


def run_sharded_step_with_recovery(factory, inputs, *, top_k: int, k_cap: int,
                                   counts_pos: int = 0, growth: int = 4,
                                   host_fallback=None):
    """Run a sharded query step with the top-K overflow recovery of
    kvmatch_tpu/parallel/query.py:974.

    Every ``make_sharded_query_step*`` returns its candidate counts as
    ``outputs[counts_pos]``; a count above the step's ``top_k`` means a
    shard truncated its candidate list.  The ladder:

      1. run ``factory(top_k)(*inputs)``;
      2. on overflow, rebuild with ``min(top_k * growth, k_cap)`` (``k_cap``
         normally the per-shard position count, where truncation is
         impossible) and re-run;
      3. if even ``k_cap`` overflows, return ``host_fallback()`` with
         used_k = 0 when given, else raise ``OverflowError``.

    Returns ``(outputs, used_top_k)``."""
    k = int(top_k)
    while True:
        out = factory(k)(*inputs)
        counts = out[counts_pos].cpu().numpy()
        if counts.size == 0 or int(counts.max()) <= k:
            return out, k
        if k >= k_cap:
            if host_fallback is not None:
                return host_fallback(), 0
            raise OverflowError(
                f"sharded step overflowed top_k={k} at the cap k_cap={k_cap} "
                f"(max per-shard count {int(counts.max())}) and no "
                f"host_fallback was provided")
        k = min(k * growth, int(k_cap))
