"""K1 and constraint-AND wrappers: the dense phase-1 probe over a
bucket-stack window, and the cNSM alpha/beta window constraint ANDed into
its flags.

Port of kvmatch_tpu/ops/probe_pallas.py:probe_flags_tiles.  ``probe_flags``
launches the CUDA kernel (csrc/probe.cu) for a CUDA tensor and runs
``probe_flags_plain`` for a CPU tensor; ``probe_flags_plain`` is the plain
PyTorch version on any device (parallel/query.py's per-position bound), which
the tests and chip_smoke.py hold the kernel against.

Both write into caller-allocated outputs so a position-blocked caller can
fill one flag matrix: positions [p0, p0 + npos) of the series (p0 and npos
multiples of FLAG) read ``bwin[:, p - col0 + shift]``; flag column
p // FLAG of ``flags`` (bool, (Q, NF)) is set when the block holds a position
with bound <= eps2 and p < m, and ``counts`` (int32, (Q,)) gains the exact
number of such positions.

``cons_and`` launches the AND kernel (csrc/probe.cu: cons_and_kernel) for
CUDA tensors and ``cons_and_plain`` for CPU tensors; the plain version
repeats ``_cons_ok_flags`` over blocks of PROBE_BLOCK
positions.  Both update the same flag matrix in place: flag column
p // FLAG, p in [p0, p0 + npos), stays set only where it was set and a
position p < m of its block passes the query's constraint, and
``cleared`` (int32, (Q,)) gains the number of columns each query had set
and lost.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import backend, kernels

FLAG = 128           # flag granularity: one flag per 128 positions
MAX_QUERIES = 32     # shared-memory segment tables of the kernel
# Positions per pass of the plain versions and of the uncached probe route:
# bounds their (Q, block) temporaries.
PROBE_BLOCK = 1 << 24
# Queries a launch of the AND kernel, whose per-query counts take 32 KB of
# shared memory (csrc/probe.cu: CA_MAX_Q); ``cons_and`` splits a larger group.
CONS_MAX_Q = 8192


def _f32(x) -> float:
    return float(np.float32(x))


def probe_flags_plain(bwin, col0, segs, eps2, cons, p0, npos, m, flags,
                      counts, *, length, unit, d, slack, norm):
    """Plain PyTorch version of K1 (same contract as ``probe_flags``)."""
    from ..parallel.query import _dense_probe, _dense_probe_norm
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
    (parallel/query.py:_dense_probe, _dense_probe_norm)."""
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


def cons_and_plain(s1, s2, amax, cons, p0, npos, m, length, flags, cleared):
    """Plain PyTorch version of the AND kernel (same contract as
    ``cons_and``)."""
    for b0 in range(0, npos, PROBE_BLOCK):
        nb = min(PROBE_BLOCK, npos - b0)
        ok = _cons_ok_flags(s1[b0:b0 + nb], s2[b0:b0 + nb],
                            amax[b0:b0 + nb], cons, p0 + b0, m, length)
        cols = flags[:, (p0 + b0) // FLAG:(p0 + b0 + nb) // FLAG]
        cleared += (cols & ~ok).sum(1, dtype=torch.int32)
        cols &= ok


def cons_and(s1, s2, amax, cons, p0, npos, m, length, flags, cleared):
    """AND the alpha/beta window constraint into ``flags`` over positions
    [p0, p0 + npos) (multiples of FLAG): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``s1``, ``s2``, ``amax``: f32 window
    sum, sum of squares and max|x| with element i at position p0 + i;
    ``cons`` (Q, 4) f32 rows (alpha, beta, mu_q, sd_q)."""
    if backend.route(s1) == "plain":
        return cons_and_plain(s1, s2, amax, cons, p0, npos, m, length, flags,
                              cleared)
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
    _check(cleared.device == dev and cleared.dtype == torch.int32
           and cleared.shape == (Q,) and cleared.is_contiguous(),
           "cleared (Q,) int32")
    _check(p0 % FLAG == 0 and npos % FLAG == 0 and npos > 0 and p0 >= 0,
           "p0, npos must be positive multiples of FLAG")
    _check((p0 + npos) // FLAG <= flags.shape[1], "flags too narrow")
    inv_l, km, kv = cons_tolerances(length)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for q0 in range(0, Q, CONS_MAX_Q):
        nq = min(CONS_MAX_Q, Q - q0)
        code = kernels.lib().kvm_cons_and(
            s1.data_ptr(), s2.data_ptr(), amax.data_ptr(),
            cons[q0].data_ptr(), nq, p0, npos, m, inv_l, km, kv,
            flags[q0].data_ptr(), flags.stride(0), cleared[q0:].data_ptr(),
            stream)
        cons_and.launches += 1
        kernels.check(code, "cons_and")


cons_and.launches = 0
