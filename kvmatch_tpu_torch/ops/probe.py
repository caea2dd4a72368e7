"""The dense phase-1 probe's bottom layer: its plan tables, the per-series
tables it reads, K1 and the constraint AND with their plain versions.

Port of kvmatch_tpu/ops/probe_pallas.py:probe_flags_tiles and of the
tables of kvmatch_tpu/parallel/query.py.  The resident pass over them is
engine/probe.py's; the sharded steps (parallel/query.py) launch K1 here.

``DenseSegments`` holds a query group's plans as (Q, MAX_SEGMENTS) tables
(``pack_segments_batch``).  ``make_bucket_stack`` and ``make_cons_stats``
make the query-independent tables of a padded series (``fly_pad_for``,
``FLY_FILL``): the per-scale bucket id of every window start and the
width-L window statistics.

``probe_flags`` launches the CUDA kernel K1 (csrc/probe.cu) for a CUDA
tensor and runs ``probe_flags_plain`` for a CPU tensor; the plain version
runs on any device and repeats the per-position bound ``_dense_probe`` /
``_dense_probe_norm`` (kvmatch_tpu/parallel/query.py:104-132, 235-300) op
for op in f32.  The tests and chip_smoke.py hold the kernel against it.
Both write into caller-allocated outputs so a position-blocked caller can
fill one flag matrix: positions [p0, p0 + npos) of the series (p0 and npos
multiples of FLAG) read ``bwin[:, p - col0 + shift]``; flag column
p // FLAG of ``flags`` (bool, (Q, NF)) is set when the block holds a position
with bound <= eps2 and p < m, and ``counts`` (int32, (Q,)) gains the exact
number of such positions.

``cons_and`` launches the AND kernel (csrc/probe.cu: cons_and_kernel) for
CUDA tensors and ``cons_and_plain`` for CPU tensors; the plain version
repeats ``_cons_ok_flags`` over blocks of PROBE_BLOCK positions.  Both
update the same flag matrix in place: flag column p // FLAG, p in
[p0, p0 + npos), stays set only where it was set and a position p < m of
its block passes the query's constraint.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import backend, kernels
from ..config import IndexConfig
from .sliding import build_buckets, sliding_window_stats_fwd

FLAG = 128           # flag granularity: one flag per 128 positions
MAX_QUERIES = 32     # shared-memory segment tables of the kernel
MAX_SEGMENTS = 30
# Positions per pass of the plain versions and of the resident probe's
# per-block route: bounds their (Q, block) temporaries.
PROBE_BLOCK = 1 << 24
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


def probe_flags_plain(bwin, col0, segs, eps2, cons, p0, npos, m, flags,
                      counts, *, length, unit, d, slack, norm):
    """Plain PyTorch version of K1 (same contract as ``probe_flags``)."""
    Q = eps2.shape[0]
    for b0 in range(p0, p0 + npos, PROBE_BLOCK):
        nb = min(PROBE_BLOCK, p0 + npos - b0)
        live = max(min(m, b0 + nb) - b0, 0)
        win = bwin[:, b0 - col0:]
        for q in range(Q):
            seg = tuple(f[q] for f in segs)
            if norm:
                acc = _dense_probe_norm(win, seg, unit, d, live, slack,
                                        cons[q, 0], cons[q, 1], cons[q, 2],
                                        cons[q, 3], length)
            else:
                acc = _dense_probe(win, seg, unit, d, live, slack)
            mask = torch.zeros(nb, dtype=torch.bool, device=bwin.device)
            mask[:live] = acc <= eps2[q]
            counts[q] += mask.sum().to(torch.int32)
            flags[q, b0 // FLAG:(b0 + nb) // FLAG] = mask.reshape(-1, FLAG).any(1)


def probe_work(bstack, segs, eps2, cons, m, *, unit, d, slack, norm):
    """The work K1 needs on this data over positions [0, m) of the bucket
    stack ``bstack`` (column 0 = position 0), for its bound (chip_smoke.py).

    K1 leaves a position once its bound exceeds eps2: every term is >= 0,
    so the bound only grows.  Returns ``(terms, reads)``: ``terms[q][t]``
    is the number of positions whose bound is still <= eps2 when query q's
    t-th valid segment is reached (t = k, after the last one: the positions
    whose cNSM sigma-filter tracks read every segment again); ``reads[s]``
    is the number of distinct entries of stack row s that those terms and
    tracks read.  The bound repeats the plain version's f32 operations
    (``_dense_probe``, ``_dense_probe_norm``)."""
    dev = bstack.device
    d32, slack32 = float(np.float32(d)), float(np.float32(slack))
    slack2 = float(2 * np.float32(slack))
    one = torch.ones((), dtype=torch.float32, device=dev)
    read = torch.zeros(bstack.shape, dtype=torch.bool, device=dev)
    terms = []
    for q in range(eps2.shape[0]):
        scale_idx, order, mean_lo, mean_hi, width, valid = (f[q] for f in segs)
        segs_q = [(s, int(scale_idx[s]), (int(order[s]) - 1) * unit)
                  for s in range(valid.shape[0]) if int(valid[s])]
        if norm:
            alpha, beta, mu_q, sd_q = cons[q]
            inv_big = torch.div(one, alpha * sd_q)
            inv_small = torch.div(one, sd_q / alpha)
            inv_sd = torch.div(one, sd_q)
            mub, mmb = mu_q + beta, mu_q - beta
        tq = [0] * (len(segs_q) + 1)
        for b0 in range(0, m, PROBE_BLOCK):
            nb = min(PROBE_BLOCK, m - b0)
            acc = torch.zeros(nb, dtype=torch.float32, device=dev)
            for t, (s, row, shift) in enumerate(segs_q):
                cols = slice(b0 + shift, b0 + shift + nb)
                live = acc <= eps2[q]
                tq[t] += int(live.sum())
                read[row, cols] |= live
                key_lo = bstack[row, cols].to(torch.float32) * d32 - slack32
                key_hi = key_lo + d32 + slack2
                if norm:
                    n_lo, n_hi = key_lo - mub, key_hi - mmb
                    lo = torch.where(n_lo >= 0, n_lo * inv_big,
                                     n_lo * inv_small)
                    hi = torch.where(n_hi >= 0, n_hi * inv_small,
                                     n_hi * inv_big)
                    m_lo = (mean_lo[s] - mu_q) * inv_sd
                    m_hi = (mean_hi[s] - mu_q) * inv_sd
                else:
                    lo, hi, m_lo, m_hi = key_lo, key_hi, mean_lo[s], mean_hi[s]
                delta = torch.clamp_min(torch.maximum(lo - m_hi, m_lo - hi),
                                        0.0)
                acc = acc + width[s] * delta * delta
            live = acc <= eps2[q]
            tq[-1] += int(live.sum())
            if norm:
                for _, row, shift in segs_q:
                    read[row, b0 + shift: b0 + shift + nb] |= live
        terms.append(tq)
    return terms, read.sum(1).tolist()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"probe_flags: {what}")


def probe_flags(bwin, col0, segs, eps2, cons, p0, npos, m, flags, counts, *,
                length, unit, d, slack, norm):
    """Dense probe over positions [p0, p0 + npos): CUDA kernel K1 for CUDA
    tensors, the plain version for CPU tensors."""
    if backend.route(bwin) == "plain":
        return probe_flags_plain(bwin, col0, segs, eps2, cons, p0, npos, m,
                                 flags, counts, length=length, unit=unit,
                                 d=d, slack=slack, norm=norm)
    dev = bwin.device
    Q, S_SEG = segs.scale_idx.shape
    tabs = (segs.scale_idx, segs.order, segs.valid, segs.mean_lo,
            segs.mean_hi, segs.width)
    for t, dt in zip(tabs, (torch.int32,) * 3 + (torch.float32,) * 3):
        _check(t.device == dev and t.dtype == dt and t.shape == (Q, S_SEG)
               and t.is_contiguous(), "segment tables must be contiguous "
               "(Q, S) int32/float32 on the stack's device")
    _check(bwin.dtype == torch.int32 and bwin.dim() == 2
           and bwin.is_contiguous(), "bwin must be contiguous int32 (S, W)")
    _check(eps2.device == dev and eps2.dtype == torch.float32
           and eps2.shape == (Q,) and eps2.is_contiguous(), "eps2 (Q,) f32")
    _check(cons.device == dev and cons.dtype == torch.float32
           and cons.shape == (Q, 4) and cons.is_contiguous(), "cons (Q, 4) f32")
    _check(flags.device == dev and flags.dtype == torch.bool
           and flags.dim() == 2 and flags.shape[0] == Q
           and flags.is_contiguous(), "flags (Q, NF) bool")
    _check(counts.device == dev and counts.dtype == torch.int32
           and counts.shape == (Q,), "counts (Q,) int32")
    _check(1 <= Q <= MAX_QUERIES and 1 <= S_SEG <= 30,
           f"Q in [1, {MAX_QUERIES}] and S <= 30")
    _check(p0 % FLAG == 0 and npos % FLAG == 0 and npos > 0 and p0 >= col0,
           "p0, npos must be positive multiples of FLAG with p0 >= col0")
    _check((p0 + npos) // FLAG <= flags.shape[1], "flags too narrow")
    last = min(m, p0 + npos) - 1
    _check(last - col0 + (length - unit) < bwin.shape[1],
           "bucket window too narrow for the segment shifts")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = kernels.lib().kvm_probe_flags(
        bwin.data_ptr(), bwin.stride(0), col0,
        *(t.data_ptr() for t in tabs), eps2.data_ptr(), cons.data_ptr(),
        Q, S_SEG, p0, npos, m, unit, float(np.float32(d)),
        float(np.float32(slack)), length, int(norm),
        flags.data_ptr(), flags.stride(0), counts.data_ptr(), stream)
    probe_flags.launches += 1
    kernels.check(code, "probe_flags")


probe_flags.launches = 0


def cons_tolerances(length: int) -> Tuple[float, float, float]:
    """f32 constants of the constraint AND at query length ``length``: 1/L
    and the factors of max|x| in the mean and variance guards."""
    eps32 = np.finfo(np.float32).eps
    return (_f32(1.0 / length),
            _f32(4 * (np.log2(max(length, 2)) + 2) * eps32),
            _f32(8 * (np.log2(max(length, 2)) + 2) * eps32))


def _cons_ok_flags(s1, s2, amax, cons, p0: int, m: int, length: int):
    """bool (Q, npos/FLAG): the block holds a position passing the guarded
    alpha/beta window constraint (kvmatch_tpu/parallel/query.py:762-785).
    The plain version of the AND kernel (``cons_and``)."""
    inv_l, km, kv = cons_tolerances(length)
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


def cons_and_plain(s1, s2, amax, cons, p0, npos, m, length, flags):
    """Plain PyTorch version of the AND kernel (same contract as
    ``cons_and``)."""
    for b0 in range(0, npos, PROBE_BLOCK):
        nb = min(PROBE_BLOCK, npos - b0)
        ok = _cons_ok_flags(s1[b0:b0 + nb], s2[b0:b0 + nb],
                            amax[b0:b0 + nb], cons, p0 + b0, m, length)
        flags[:, (p0 + b0) // FLAG:(p0 + b0 + nb) // FLAG] &= ok


def cons_and(s1, s2, amax, cons, p0, npos, m, length, flags):
    """AND the alpha/beta window constraint into ``flags`` over positions
    [p0, p0 + npos) (multiples of FLAG), any number of queries in one
    launch: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``s1``, ``s2``, ``amax``: f32 window sum, sum of squares and
    max|x| with element i at position p0 + i; ``cons`` (Q, 4) f32 rows
    (alpha, beta, mu_q, sd_q)."""
    if backend.route(s1) == "plain":
        return cons_and_plain(s1, s2, amax, cons, p0, npos, m, length, flags)
    dev = s1.device
    Q = cons.shape[0]
    for t in (s1, s2, amax):
        _check(t.device == dev and t.dtype == torch.float32 and t.dim() == 1
               and t.stride(0) == 1 and t.shape[0] >= npos,
               "s1, s2, amax must be f32 rows of at least npos elements")
    _check(cons.device == dev and cons.dtype == torch.float32
           and cons.dim() == 2 and cons.shape[1] == 4
           and cons.is_contiguous() and Q >= 1, "cons (Q, 4) f32")
    _check(flags.device == dev and flags.dtype == torch.bool
           and flags.dim() == 2 and flags.shape[0] == Q
           and flags.stride(1) == 1, "flags (Q, NF) bool")
    _check(p0 % FLAG == 0 and npos % FLAG == 0 and npos > 0 and p0 >= 0,
           "p0, npos must be positive multiples of FLAG")
    _check((p0 + npos) // FLAG <= flags.shape[1], "flags too narrow")
    inv_l, km, kv = cons_tolerances(length)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = kernels.lib().kvm_cons_and(
        s1.data_ptr(), s2.data_ptr(), amax.data_ptr(), cons.data_ptr(), Q,
        p0, npos, m, inv_l, km, kv, flags.data_ptr(), flags.stride(0),
        stream)
    cons_and.launches += 1
    kernels.check(code, "cons_and")


cons_and.launches = 0
