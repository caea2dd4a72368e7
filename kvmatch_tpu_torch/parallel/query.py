"""Dense phase-1 probe in PyTorch (port of the flag route of
kvmatch_tpu/parallel/query.py).

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
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kvmatch_tpu.config import IndexConfig

from ..ops.probe import FLAG, PROBE_BLOCK, probe_flags
from ..ops.sliding import build_buckets, sliding_window_stats_fwd

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
    probe-only, as in the JAX package."""
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
    if bstack is not None:
        probe_flags(bstack, 0, segs, eps2, cons, 0, npos_all, m, flags,
                    counts, **kw)
    else:
        for p0 in range(0, npos_all, PROBE_BLOCK):
            npos = min(PROBE_BLOCK, npos_all - p0)
            bwin = make_bucket_stack(
                data_padded[p0: p0 + npos + length + w_max], icfg, scales)
            probe_flags(bwin, p0, segs, eps2, cons, p0, npos, m, flags,
                        counts, **kw)
    if norm:
        for p0 in range(0, npos_all, PROBE_BLOCK):
            npos = min(PROBE_BLOCK, npos_all - p0)
            if stats3 is not None:
                s1, s2, amax = stats3[:, p0: p0 + npos]
            else:
                s1, s2, lo, hi = sliding_window_stats_fwd(
                    data_padded[p0: p0 + npos + length - 1], length)
                amax = torch.maximum(torch.abs(lo), torch.abs(hi))
            flags[:, p0 // FLAG:(p0 + npos) // FLAG] &= _cons_ok_flags(
                s1, s2, amax, cons, p0, m, length)
    return counts, flags
