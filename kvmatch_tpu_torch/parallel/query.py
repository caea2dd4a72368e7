"""Dense phase-1 probe and the sharded query steps in PyTorch (port of the
flag route and of the mesh-sharded steps of kvmatch_tpu/parallel/query.py).

The bucket stack (per-scale bucket id of every window start) and the
width-L window statistics are query-independent, so an engine builds them
once per series and query length (``make_bucket_stack``,
``make_cons_stats``).  ``dense_probe_flags`` then runs K1 (ops/probe.py) over
the whole cached stack in one launch and, for cNSM, ANDs the guarded alpha/beta
window constraint into the flags as plain tensor ops, exactly as the JAX
package runs that AND in XLA outside its Pallas kernel.

``_dense_probe`` / ``_dense_probe_norm`` are the plain per-position bounds
(kvmatch_tpu/parallel/query.py:104-132, 235-300), op for op in f32; they are
K1's plain version.

The sharded steps (``make_sharded_query_step*``, ``run_sharded_step_with_
recovery``) run one query group over a ``parallel.mesh.Mesh`` whose series
and bucket stack are split by offset range (parallel/build.py).  Each shard
reads its own slice plus an ``L``-point right halo, probes it with K1 (exact
per-position counts, a flag per 128 positions), takes the starts of its
flagged blocks as candidates and verifies them with K2 (ED) or K3/K4 (DTW);
the stacked per-shard outputs are the JAX steps' candidate all-gather.  The
JAX steps' dense bound, ``lax.top_k`` and fixed ``K`` exist because XLA
needs static shapes; here the ``K`` axis is as long as the longest list.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import verify as vf
from ..config import IndexConfig
from ..ops.dtw import _dtw_f32, _znorm_rows
from ..ops.ed import _gather, window_ed
from ..ops.probe import FLAG, PROBE_BLOCK, probe_flags
from ..ops.sliding import build_buckets, sliding_window_stats_fwd
from ..utils.profiling import span
from .mesh import Mesh

MAX_SEGMENTS = 30
# Bucket id past the end of a scale's windows: an astronomically distant
# mean cell, so out-of-range windows prune themselves.
BIG_BUCKET = 1 << 30
# Padding fill of the probe's data copy: window means over the fill land in a
# distant key cell (bucket ~2e8, still int32), so padded positions prune
# themselves; they are also masked by pos < m.
FLY_FILL = np.float32(1e7)


class DenseSegments(NamedTuple):
    """Per-query plan segments, padded to MAX_SEGMENTS, shape (Q, S)."""
    scale_idx: torch.Tensor  # int32 index into the scale list
    order: torch.Tensor      # int32 1-based unit offset
    mean_lo: torch.Tensor    # float32
    mean_hi: torch.Tensor    # float32
    width: torch.Tensor      # float32 window width w
    valid: torch.Tensor      # int32 0/1


def pack_segments_batch(segment_lists, scales: Tuple[int, ...],
                        device) -> DenseSegments:
    """Stack per-query segment lists into (Q, MAX_SEGMENTS) tables."""
    S = MAX_SEGMENTS
    scale_pos = {w: i for i, w in enumerate(scales)}
    Q = len(segment_lists)
    scale_idx = np.zeros((Q, S), np.int32)
    order = np.ones((Q, S), np.int32)
    mean_lo = np.zeros((Q, S), np.float32)
    mean_hi = np.zeros((Q, S), np.float32)
    width = np.ones((Q, S), np.float32)
    valid = np.zeros((Q, S), np.int32)
    for qi, segs in enumerate(segment_lists):
        k = len(segs)
        if k > S:
            raise ValueError(f"plan has {k} segments, more than {S}")
        scale_idx[qi, :k] = [scale_pos[s.w] for s in segs]
        order[qi, :k] = [s.order for s in segs]
        mean_lo[qi, :k] = [s.mean_lo for s in segs]
        mean_hi[qi, :k] = [s.mean_hi for s in segs]
        width[qi, :k] = [float(s.w) for s in segs]
        valid[qi, :k] = 1
    return DenseSegments(*(torch.as_tensor(a, device=device) for a in (
        scale_idx, order, mean_lo, mean_hi, width, valid)))


def fly_pad_for(length: int, w_max: int) -> int:
    """Right padding of the probe's data copy: flag blocks reach up to FLAG-1
    positions past the last window start, segment shifts up to length, and
    the widest window w_max beyond that."""
    return length + w_max + FLAG


def _f32(x) -> float:
    return float(np.float32(x))


def _dense_probe(bwin, seg, unit: int, d: float, out_len: int, slack: float):
    """Accumulated raw-space lower bound for positions [0, out_len) of the
    window (column 0 = first position); ``seg`` is one query's six rows."""
    scale_idx, order, mean_lo, mean_hi, width, valid = seg
    sidx, orders, vals = scale_idx.tolist(), order.tolist(), valid.tolist()
    d32, slack32, slack2 = _f32(d), _f32(slack), _f32(2 * np.float32(slack))
    acc = torch.zeros(out_len, dtype=torch.float32, device=bwin.device)
    for s in range(len(sidx)):
        if not vals[s]:
            continue
        shift = (orders[s] - 1) * unit
        b = bwin[sidx[s], shift: shift + out_len].to(torch.float32)
        key_lo = b * d32 - slack32
        key_hi = key_lo + d32 + slack2
        delta = torch.clamp_min(torch.maximum(key_lo - mean_hi[s],
                                              mean_lo[s] - key_hi), 0.0)
        acc = acc + width[s] * delta * delta
    return acc


def _dense_probe_norm(bwin, seg, unit: int, d: float, out_len: int,
                      slack: float, alpha, beta, mu_q, sd_q, qlen: int):
    """cNSM bound: z-space lower bound plus the Ex/Ex2 tracks of the
    derived-sigma filter (engine/norm_ed.py _std_filter); +inf where the
    filter rejects.  alpha..sd_q are f32 0-dim tensors."""
    scale_idx, order, mean_lo, mean_hi, width, valid = seg
    sidx, orders, vals = scale_idx.tolist(), order.tolist(), valid.tolist()
    d32, slack32, slack2 = _f32(d), _f32(slack), _f32(2 * np.float32(slack))
    one = torch.ones((), dtype=torch.float32, device=bwin.device)
    s_small = sd_q / alpha
    s_big = alpha * sd_q
    inv_big = torch.div(one, s_big)
    inv_small = torch.div(one, s_small)
    inv_sd = torch.div(one, sd_q)
    mub = mu_q + beta
    mmb = mu_q - beta
    zero = torch.zeros(out_len, dtype=torch.float32, device=bwin.device)
    acc, exlo, exup, ex2lo = zero, zero, zero, zero
    punits = torch.zeros((), dtype=torch.float32, device=bwin.device)
    for s in range(len(sidx)):
        if not vals[s]:
            continue
        shift = (orders[s] - 1) * unit
        b = bwin[sidx[s], shift: shift + out_len].to(torch.float32)
        key_lo = b * d32 - slack32
        key_hi = key_lo + d32 + slack2
        n_lo = key_lo - mub
        n_hi = key_hi - mmb
        z_lo = torch.where(n_lo >= 0, n_lo * inv_big, n_lo * inv_small)
        z_hi = torch.where(n_hi >= 0, n_hi * inv_small, n_hi * inv_big)
        zq_lo = (mean_lo[s] - mu_q) * inv_sd
        zq_hi = (mean_hi[s] - mu_q) * inv_sd
        delta = torch.clamp_min(torch.maximum(z_lo - zq_hi, zq_lo - z_hi), 0.0)
        k_units = width[s] / unit
        acc = acc + width[s] * delta * delta
        exlo = exlo + key_lo * k_units
        exup = exup + key_hi * k_units
        sq = torch.where(key_lo > 0, key_lo * key_lo,
                         torch.where(key_hi < 0, key_hi * key_hi, 0.0))
        ex2lo = ex2lo + sq * k_units
        punits = punits + k_units
    punits = torch.clamp_min(punits, 1.0)
    rest = qlen - punits * unit
    a_sd = alpha * sd_q
    limit = a_sd * a_sd + 1e-6
    mean_lo_t = exlo / punits
    mean_up_t = exup / punits
    over = mean_lo_t > mub
    under = mean_up_t < mmb
    rest_s = torch.clamp_min(rest, 1.0)
    nv_o = mub - (mean_lo_t - mub) * punits * unit / rest_s
    var_o = (ex2lo * unit + rest * nv_o * nv_o) / qlen - mub * mub
    nv_u = mmb + (mmb - mean_up_t) * punits * unit / rest_s
    var_u = (ex2lo * unit + rest * nv_u * nv_u) / qlen - mmb * mmb
    if bool(rest > 0):
        bad = (over & (var_o > limit)) | (under & (var_u > limit))
    else:
        t_o = mean_lo_t - mub
        t_u = mmb - mean_up_t
        bad = torch.where(over, t_o * t_o > limit,
                          under & (t_u * t_u > limit))
    return torch.where(bad, torch.inf, acc)


def make_bucket_stack(data_padded: torch.Tensor, icfg: IndexConfig,
                      scales: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """int32 (S, npad): bucket id of the window of each scale starting at each
    position of the padded series; BIG_BUCKET where the window would run
    past the end."""
    scales = tuple(scales or icfg.scales)
    npad = data_padded.shape[0]
    out = torch.full((len(scales), npad), BIG_BUCKET, dtype=torch.int32,
                     device=data_padded.device)
    bk = build_buckets(data_padded, scales, icfg.pos_of_d)
    for i, w in enumerate(scales):
        out[i, : bk[w].shape[0]] = bk[w]
    return out


def make_cons_stats(data_padded: torch.Tensor, length: int) -> torch.Tensor:
    """f32 (3, npad): width-L window sum, sum of squares and max|x| of each
    position (zeros where the window runs past the end)."""
    npad = data_padded.shape[0]
    s1, s2, lo, hi = sliding_window_stats_fwd(data_padded, length)
    out = torch.zeros((3, npad), dtype=torch.float32, device=data_padded.device)
    k = s1.shape[0]
    out[0, :k] = s1
    out[1, :k] = s2
    out[2, :k] = torch.maximum(torch.abs(lo), torch.abs(hi))
    return out


def _cons_ok_flags(s1, s2, amax, cons, p0: int, m: int, length: int):
    """bool (Q, npos/FLAG): the block holds a position passing the guarded
    alpha/beta window constraint (kvmatch_tpu/parallel/query.py:762-785)."""
    inv_l = _f32(1.0 / length)
    eps32 = np.finfo(np.float32).eps
    km = _f32(4 * (np.log2(max(length, 2)) + 2) * eps32)
    kv = _f32(8 * (np.log2(max(length, 2)) + 2) * eps32)
    mean = s1 * inv_l
    var = torch.clamp_min(s2 * inv_l - mean * mean, 0.0)
    m_tol = km * amax + 1e-7
    v_tol = kv * amax * amax + 2 * amax * m_tol + 1e-7
    alpha, beta = cons[:, 0:1], cons[:, 1:2]
    mu_q, sd_q = cons[:, 2:3], cons[:, 3:4]
    hi2 = alpha * sd_q
    lo2 = sd_q / alpha
    ok = ((torch.abs(mean[None, :] - mu_q) <= beta + m_tol[None, :])
          & (var[None, :] <= hi2 * hi2 + v_tol[None, :])
          & (var[None, :] >= lo2 * lo2 - v_tol[None, :]))
    pos = p0 + torch.arange(s1.shape[0], device=s1.device)
    ok &= (pos < m)[None, :]
    return ok.reshape(ok.shape[0], -1, FLAG).any(2)


def dense_probe_flags(data_padded: torch.Tensor, segs: DenseSegments,
                      eps2: torch.Tensor, cons: torch.Tensor, n_total: int,
                      icfg: IndexConfig, length: int, norm: bool,
                      bstack: Optional[torch.Tensor] = None,
                      stats3: Optional[torch.Tensor] = None):
    """Phase-1 flags for a same-length query group.

    Returns (counts int32 (Q,) exact probe candidate counts, flags bool (Q, NF))
    with flag j covering positions [j*FLAG, (j+1)*FLAG), NF = ceil(m/FLAG).
    With ``bstack`` (make_bucket_stack over ``data_padded``) the probe is
    one K1 launch; without it, bucket windows are built per PROBE_BLOCK
    positions.  For cNSM (``norm``) the window-constraint AND is applied with
    ``stats3`` (make_cons_stats) or per-block statistics.  Counts stay
    probe-only, as in the JAX package.  While a profiler records, the
    spans ``kv.probe.k1`` and ``kv.probe.cons`` time the two parts' launches
    on the device, and on the per-block path ``kv.probe.rebuild`` times
    each block's bucket windows and statistics apart from them
    (``probe_rebuilds`` counts those blocks)."""
    scales = tuple(icfg.scales)
    w_max = max(scales)
    dev = data_padded.device
    Q = eps2.shape[0]
    m = n_total - length + 1
    npos_all = -(-m // FLAG) * FLAG
    if data_padded.shape[0] < n_total + fly_pad_for(length, w_max):
        raise ValueError("data_padded must carry fly_pad_for(length, w_max) "
                         "padding")
    flags = torch.zeros((Q, npos_all // FLAG), dtype=torch.bool, device=dev)
    counts = torch.zeros(Q, dtype=torch.int32, device=dev)
    kw = dict(length=length, unit=icfg.unit, d=icfg.d,
              slack=icfg.probe_guard, norm=norm)
    blocks = [(p0, min(PROBE_BLOCK, npos_all - p0))
              for p0 in range(0, npos_all, PROBE_BLOCK)]
    with span("kv.probe.k1") as sp:
        if bstack is not None:
            with sp.device(dev):
                probe_flags(bstack, 0, segs, eps2, cons, 0, npos_all, m,
                            flags, counts, **kw)
        else:
            for p0, npos in blocks:
                with span("kv.probe.rebuild") as rb, rb.device(dev):
                    bwin = make_bucket_stack(
                        data_padded[p0: p0 + npos + length + w_max], icfg,
                        scales)
                with sp.device(dev):
                    probe_flags(bwin, p0, segs, eps2, cons, p0, npos, m,
                                flags, counts, **kw)
    if norm:
        with span("kv.probe.cons") as sp:
            def cons_and(p0, npos, s1, s2, amax):
                flags[:, p0 // FLAG:(p0 + npos) // FLAG] &= _cons_ok_flags(
                    s1, s2, amax, cons, p0, m, length)

            if stats3 is not None:
                with sp.device(dev):
                    for p0, npos in blocks:
                        cons_and(p0, npos, *stats3[:, p0: p0 + npos])
            else:
                for p0, npos in blocks:
                    with span("kv.probe.rebuild") as rb, rb.device(dev):
                        s1, s2, lo, hi = sliding_window_stats_fwd(
                            data_padded[p0: p0 + npos + length - 1], length)
                        amax = torch.maximum(torch.abs(lo), torch.abs(hi))
                    with sp.device(dev):
                        cons_and(p0, npos, s1, s2, amax)
    return counts, flags


def probe_rebuilds(n_total: int, length: int, norm: bool,
                   bstack: Optional[torch.Tensor] = None,
                   stats3: Optional[torch.Tensor] = None) -> int:
    """The PROBE_BLOCK rebuilds of one ``dense_probe_flags`` call with these
    arguments: the blocks of bucket windows without ``bstack``, and for
    cNSM (``norm``) the blocks of window statistics without ``stats3``."""
    npos_all = -(-(n_total - length + 1) // FLAG) * FLAG
    tables = (bstack is None) + (norm and stats3 is None)
    return -(-npos_all // PROBE_BLOCK) * tables


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
