"""K1 wrapper: the dense phase-1 probe over a bucket-stack window.

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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend, kernels

FLAG = 128           # flag granularity: one flag per 128 positions
MAX_QUERIES = 32     # shared-memory segment tables of the kernel
# Positions per pass of the plain version, of the uncached probe route and of
# the constraint AND: bounds their (Q, block) temporaries.
PROBE_BLOCK = 1 << 24


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
