"""Banded DTW and its lower-bound cascade for the DTW engines.

Port of kvmatch_tpu/ops/dtw.py.  A batch of candidate windows moves through

    LB_Kim + both LB_Keogh directions  ->  f32 banded DP  ->  double-single DP

and the host f64 DP confirms the few candidates inside the DS guard band.
The window gather and the z-normalisation are torch ops, as in JAX; the two
DPs are hand-written kernels (csrc/dtw.cu) behind three wrappers:

* ``dtw_diag`` -- K3, the anti-diagonal walk (replaces
  kvmatch_tpu/ops/dtw_pallas.py:_dtw_diag_kernel), the default variant;
* ``dtw_rows`` -- K4, the row prefix-scan form (replaces
  kvmatch_tpu/ops/dtw_pallas.py:_dtw_kernel), the selectable variant;
* ``dtw_ds``   -- the double-single DP (XLA in JAX,
  kvmatch_tpu/ops/dtw.py:dtw_banded_batch_ds_multi), K3's walk on f32
  pairs.

Each takes the gathered (B, L) f32 rows, the (Q, L) f32 query matrix with
int32 ``qids`` and the band radius ``r``.  On a CPU tensor it runs its plain
PyTorch version (``dtw_banded_plain``, ``dtw_banded_ds_plain``), on a CUDA
tensor its kernel; ``dtw_diag_plain`` and ``dtw_ds_diag_plain`` repeat
K3's and DS's operations in their anti-diagonal order, and
``dtw_rows_plain`` K4's one-warp form in its chunked scan order, for the
bitwise checks on the card.  ``DTW_STATE["variant"]`` picks K3 or K4 for
the f32 stages, as ``_PALLAS_DTW_STATE`` does in JAX.

``dtw_banded_batch``, ``dtw_banded_batch_multi`` and
``dtw_banded_batch_ds_multi`` take JAX's arguments (one query, or a query
per row) and go through the same wrappers; ``lb_kim`` and ``lb_keogh`` take
one query or envelope for the batch.

Offsets are int64 end to end (JAX casts them to int32).  The f64 host DP is
the port's native host kernel (``native.dtw_band_f64``), with the NumPy twin
as its fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend, kernels, native
from .ed import _gather, _one_query

BIG = 1e30

#: f32 DP variant of the stages: "diag" (K3) or "rows" (K4).
DTW_STATE = {"variant": "diag"}

#: Widest band one block of K3 and DS holds: 32 warps of 32 threads, 26
#: lanes a thread (csrc/dtw.cu:k3_shape).  Wider bands span the blocks of a
#: thread-block cluster.
K3_BLOCK_MAX_R = (32 * 32 * 26 - 1) // 2
#: Widest band the cluster form holds: a cluster of at most 8 such blocks.
#: Wider bands take the global form (one block a row, the carries in a
#: global workspace), so K3 and DS take any band.
K3_MAX_R = (8 * 32 * 32 * 26 - 1) // 2
#: Widest band K4's one-warp form holds (32 threads of up to 30 lanes);
#: wider bands take its block form.
K4_WARP_LANES = 32 * 30


# ----------------------------------------------------------- plain versions
# The plain versions of K3, K4 and DS walk their steps (anti-diagonals, or
# DP rows) in blocks.  The step-dependent inputs of a block are staged by a
# few batched ops into buffers whose shapes and addresses do not depend on
# the step; then a step body runs the same elementwise operations, in the
# same order, as each step of the walk always has, so every value is the
# same bit for bit.  On a CUDA device the steps of a full block are
# captured once a call as a CUDA graph and replayed for every full block:
# the host pays about 12 us a launch, a replayed node costs the card about
# 1-2 us.  The tail block, and every block on the CPU, runs eagerly.
#: Most steps of a block.
BLOCK_STEPS = 64
#: Most bytes of a block's staged inputs.
BLOCK_BYTES = 1 << 26


def _band_limits(i: int, r: int, L: int):
    """Valid band lanes [lo, hi] of DP row i (j = i - r + k in [0, L))."""
    return max(0, r - i), min(2 * r, L - 1 - i + r)


def _mask_outside(t: torch.Tensor, lo: int, hi: int, value: float) -> None:
    if lo > 0:
        t[:, :lo] = value
    if hi < t.shape[1] - 1:
        t[:, hi + 1:] = value


def _row_inputs(a, qm, qids, r):
    """(B, L, clamped r, W, query rows padded so qpad[:, i + k] = q[i-r+k])."""
    B, L = a.shape
    r = min(r, L - 1)
    q = qm[qids.long()]
    return B, L, r, 2 * r + 1, F.pad(q, (r, r))


def _block_steps(step_bytes: int, even: bool = False) -> int:
    """Steps a block: at most BLOCK_STEPS, and at most BLOCK_BYTES of staged
    inputs at ``step_bytes`` a step, but at least one; an even number, at
    least two, when ``even``."""
    steps = max(1, min(BLOCK_STEPS, BLOCK_BYTES // max(1, step_bytes)))
    return max(2, steps - steps % 2) if even else steps


def _capture(block, state, steps: int):
    """``block(state, steps)`` captured as a CUDA graph (which runs
    nothing), after a warm-up of two steps on copies of ``state`` on a side
    stream.  Only this thread's calls are checked during the capture."""
    dev = state[0].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block([x.clone() for x in state], min(2, steps))
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        block(state, steps)
    return graph


def _run_blocks(fn, begin: int, end: int, steps: int, stage, step, state):
    """Steps ``begin`` .. ``end`` - 1 in blocks of ``steps``: ``stage(s0,
    k)`` writes the inputs of steps s0 .. s0 + k - 1 to rows 0 .. k - 1 of
    the staged buffers, then ``step(t, state)`` runs step s0 + t for each
    t < k, in place on the tensors of ``state``.  On a CUDA device the
    steps of a full block are captured once as a CUDA graph and every full
    block replays it, each replay counted in ``fn.graph_replays``; a
    capture or a replay that fails raises.  The tail block, and every block
    on the CPU, runs eagerly."""
    def block(st, k):
        for t in range(k):
            step(t, st)
    graph = None
    for s0 in range(begin, end, steps):
        k = min(steps, end - s0)
        stage(s0, k)
        if k < steps or state[0].device.type != "cuda":
            block(state, k)
            continue
        if graph is None:
            graph = _capture(block, state, steps)
        graph.replay()
        fn.graph_replays += 1


def _staged_rows(a, qwin, r: int, W: int):
    """The staged inputs of the row forms, rows i of ``a`` (B, L) against
    ``qwin`` (B, L, K), whose row i holds the K band lanes q[i - r + k].
    Returns (steps, d, dead, stage): ``stage(i0, k)`` writes, for rows i =
    i0 .. i0 + k - 1, d[i - i0] = (a[:, i] - q[i - r + k])^2 with 0 on the
    dead lanes (j = i - r + k outside [0, L), or k >= W) and dead[i - i0] =
    those lanes."""
    B, L = a.shape
    K = qwin.shape[2]
    dt, dev = torch.promote_types(a.dtype, qwin.dtype), a.device
    steps = _block_steps(B * K * dt.itemsize)
    d = torch.empty((steps, B, K), dtype=dt, device=dev)
    dead = torch.empty((steps, K), dtype=torch.bool, device=dev)
    lanes = torch.arange(K, device=dev)
    j0, past_w = lanes - r, lanes >= W
    rows = torch.arange(steps, device=dev)[:, None]
    at, qt = a.t(), qwin.transpose(0, 1)

    def stage(i0, k):
        torch.sub(at[i0:i0 + k, :, None], qt[i0:i0 + k], out=d[:k]).square_()
        j = j0 + (rows[:k] + i0)
        torch.logical_or((j < 0) | (j >= L), past_w, out=dead[:k])
        d[:k].masked_fill_(dead[:k, None], 0.0)
    return steps, d, dead, stage


def dtw_banded_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                     r: int) -> torch.Tensor:
    """Plain version of K3/K4: squared banded DTW of each row of ``a`` (B, L)
    against ``qm[qids]``, in the row prefix-scan form of
    kvmatch_tpu/ops/dtw.py:dtw_banded_batch_multi.  With M[k] = min(P[k],
    P[k+1]) and C = cumsum(d) the row recurrence is D[k] = C[k] +
    min_{j<=k} (M[j] - C[j-1]).  Dead lanes hold BIG and every row is capped
    at BIG.  Any float dtype (float64 gives the f64 DP of the same inputs)."""
    B, L, r, W, qpad = _row_inputs(a, qm, qids, r)
    dt, dev = a.dtype, a.device
    first = torch.full((B, W), BIG, dtype=dt, device=dev)
    first[:, r] = 0.0
    P = first
    for i in range(L):
        lo, hi = _band_limits(i, r, L)
        d = (a[:, i:i + 1] - qpad[:, i:i + W]).square_()
        _mask_outside(d, lo, hi, 0.0)
        M = first if i == 0 else torch.minimum(
            P, F.pad(P[:, 1:], (0, 1), value=BIG))
        C = torch.cumsum(d, dim=1)
        G = M - F.pad(C[:, :-1], (1, 0))
        D = torch.clamp_max_(C + torch.cummin(G, dim=1).values, BIG)
        _mask_outside(D, lo, hi, BIG)
        P = D
    return P[:, r]


def _diagonals(a, qm, qids, r):
    """The anti-diagonal walk shared by the two diag plain versions, over
    the 2L-1 diagonals s = i + j.  The lanes k = p + 2t of diagonal s (p =
    (s + r) & 1, t < ``nt[p]``) sit at the strided slice ``_lanes(p, nt[p],
    o)`` of a (B, W + 2) carry, shifted by ``o`` lanes (k + o + 1), and
    s & 1 is the carry the diagonal rewrites.  Returns (steps, nt, df,
    stage): ``stage(s0, k)`` writes df[s - s0] = a[i] - q[j] per lane of the
    diagonals s = s0 .. s0 + k - 1 (i = (s + r - k) / 2, j = s - i; a
    parity-1 diagonal in its first nt[1] lanes).  The rows are reversed and
    padded with +inf past both ends, so a lane outside the matrix gets df =
    inf or NaN without a mask (the caller maps that to BIG), as the
    kernel's sentinels do.  ``steps`` is even, so every block starts on an
    even diagonal and its step t has the parities of diagonal t."""
    B, L = a.shape
    W = 2 * r + 1
    nt = ((W + 1) // 2, W // 2)  # lanes of parity 0 and 1
    dt, dev = torch.promote_types(a.dtype, qm.dtype), a.device
    steps = _block_steps(B * nt[0] * dt.itemsize, even=True)
    df = torch.empty((steps, B, nt[0]), dtype=dt, device=dev)
    # lane t of diagonal s holds i = i0 - t, j = s - i0 + t
    s = torch.arange(2 * L - 1, device=dev)
    i0 = (s + r) >> 1
    ai, qj = W + L - 1 - i0, W + s - i0
    arev = F.pad(a.flip(1), (W, W), value=float("inf"))
    q = F.pad(qm[qids.long()], (W, W), value=float("inf"))
    au = arev.unfold(1, nt[0], 1).transpose(0, 1)
    qu = q.unfold(1, nt[0], 1).transpose(0, 1)

    def stage(s0, k):
        torch.sub(au[ai[s0:s0 + k]], qu[qj[s0:s0 + k]], out=df[:k])
    return steps, nt, df, stage


def _lanes(p: int, n: int, o: int) -> slice:
    """The n lanes k = p + 2t of a diagonal in a carry, shifted by o."""
    return slice(p + o + 1, p + o + 1 + 2 * n, 2)


def dtw_diag_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                   r: int) -> torch.Tensor:
    """Plain version of K3 in its own form: the f32 walk over the 2L-1
    anti-diagonals s = i + j on (B, W + 2) carries with a BIG lane on each
    side, one carry per step parity (D_{s-2}, rewritten in place, and
    D_{s-1}).  Diagonal s rewrites the lanes k with s + r - k even:
    D_s[k] = min(d(i, j) + min(D_{s-1}[k-1], D_{s-1}[k+1], D_{s-2}[k]), BIG),
    BIG outside the matrix.  The same f32 operations as the kernel, so the
    two are equal bit for bit; its sums run in another order than
    ``dtw_banded_plain``'s row form, within the guard band of it.  The
    diagonals run in blocks (``_run_blocks``; on the card replayed CUDA
    graphs, counted in ``dtw_diag_plain.graph_replays``)."""
    B, L = a.shape
    r = min(r, L - 1)
    carry = [torch.full((B, 2 * r + 3), BIG, dtype=a.dtype, device=a.device)
             for _ in range(2)]
    carry[0][:, r + 1] = 0.0  # D_{-2}: the seed of cell (0, 0)
    big = torch.tensor(BIG, dtype=a.dtype, device=a.device)
    steps, nt, df, stage = _diagonals(a, qm, qids, r)

    def step(t, carry):
        p = (t + r) & 1
        n = nt[p]
        cur, prev = carry[t & 1], carry[1 - (t & 1)]
        m = torch.minimum(torch.minimum(prev[:, _lanes(p, n, -1)],
                                        prev[:, _lanes(p, n, 1)]),
                          cur[:, _lanes(p, n, 0)])
        d = df[t, :, :n]
        # fmin: a lane outside the matrix has df*df + m = inf or NaN -> BIG
        cur[:, _lanes(p, n, 0)] = torch.fmin(d * d + m, big)
    _run_blocks(dtw_diag_plain, 0, 2 * L - 1, steps, stage, step, carry)
    return carry[(2 * L - 2) & 1][:, r + 1]


def k4_chunk(W: int) -> int:
    """Band lanes a thread of K4's one-warp form holds: the least C = 2 mod 4
    with 32 C >= W (csrc/dtw.cu:warp_chunk)."""
    C = 2
    while 32 * C < W:
        C += 4
    return C


def _warp_scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive Hillis-Steele scan of (B, 32) chunk totals, as a warp runs
    it: 5 steps, x[t] = op(x[t - o], x[t]) for t >= o."""
    for o in (1, 2, 4, 8, 16):
        x = torch.cat([x[:, :o], op(x[:, :-o], x[:, o:])], dim=1)
    return x


def dtw_rows_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                   r: int) -> torch.Tensor:
    """Plain version of K4's one-warp form in its own order: the row
    recurrence of ``dtw_banded_plain`` on (B, 32, C) chunks, C =
    ``k4_chunk(W)``, the band padded to 32 C lanes (d = 0 and D = BIG on
    the padding).  In each row the running sum inside a chunk is
    sequential, and the chunk offsets are the exclusive form of
    ``_warp_scan`` over the 32 chunk totals; the running minima take any
    order (min is exact), here ``torch.cummin`` and ``_warp_scan``.  The
    same f32 operations as the kernel, so the two are equal bit for bit on
    rows one warp holds (2r + 1 <= K4_WARP_LANES); wider rows take K4's
    block form, whose sums run in another order (within the guard band).
    The rows after the first run in blocks (``_run_blocks``; on the card
    replayed CUDA graphs, counted in ``dtw_rows_plain.graph_replays``)."""
    B, L, r, W, _ = _row_inputs(a, qm, qids, r)
    C = k4_chunk(W)
    K = 32 * C
    dt, dev = a.dtype, a.device
    qpad = F.pad(qm[qids.long()], (r, K))  # qpad[:, i + k] = q[i - r + k]
    first = torch.full((B, K), BIG, dtype=dt, device=dev)
    first[:, r] = 0.0
    steps, d_rows, dead, stage = _staged_rows(a, qpad.unfold(1, K, 1), r, W)

    def step(t, state, first_row=False):
        P, = state
        d = d_rows[t].view(B, 32, C)
        c = torch.empty_like(d)
        run = torch.zeros((B, 32), dtype=dt, device=dev)
        for u in range(C):
            run = run + d[:, :, u]
            c[:, :, u] = run
        off = F.pad(_warp_scan(run, torch.add)[:, :-1], (1, 0))
        Cc = (off[:, :, None] + c).view(B, K)
        M = first if first_row else torch.minimum(
            P, F.pad(P[:, 1:], (0, 1), value=BIG))
        g = torch.cummin((M - F.pad(Cc[:, :-1], (1, 0))).view(B, 32, C),
                         dim=2).values
        pre = F.pad(_warp_scan(g[:, :, -1], torch.minimum)[:, :-1], (1, 0),
                    value=float("inf"))
        D = torch.clamp_max(Cc + torch.minimum(pre[:, :, None], g).view(B, K),
                            BIG)
        P.copy_(D.masked_fill_(dead[t], BIG))
    state = [first.to(d_rows.dtype, copy=True)]
    stage(0, 1)
    step(0, state, first_row=True)
    _run_blocks(dtw_rows_plain, 1, L, steps, stage, step, state)
    return state[0][:, r]


def _ds_two_sum(ah, al, bh, bl):
    """(ah + al) + (bh + bl) as a normalized double-single pair (Knuth
    TwoSum on the high parts, error folded into the low parts, Fast2Sum
    renorm) -- kvmatch_tpu/ops/dtw.py:162-171."""
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    lo = e + (al + bl)
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo


def _ds_min(ah, al, bh, bl):
    take_a = (ah < bh) | ((ah == bh) & (al <= bl))
    return torch.where(take_a, ah, bh), torch.where(take_a, al, bl)


def _ds_scan(h, l, op):
    """Inclusive log-step (Hillis-Steele) scan of pairs along dim 1."""
    s = 1
    while s < h.shape[1]:
        nh, nl = op(h[:, :-s], l[:, :-s], h[:, s:], l[:, s:])
        h = torch.cat([h[:, :s], nh], dim=1)
        l = torch.cat([l[:, :s], nl], dim=1)
        s *= 2
    return h, l


def dtw_banded_ds_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                        r: int):
    """Double-single DP in the row form of kvmatch_tpu/ops/dtw.py:
    dtw_banded_batch_ds_multi, every DP value an unevaluated f32 pair
    (hi, lo); the row's cumsum and cummin are log-step scans of
    ``_ds_two_sum`` / ``_ds_min``.  Returns (hi, lo), each (B,) f32.  The
    CPU route of ``dtw_ds``; the kernel's own form is ``dtw_ds_diag_plain``.
    The rows after the first run in blocks (``_run_blocks``; on the card
    replayed CUDA graphs, counted in ``dtw_banded_ds_plain.graph_replays``)."""
    B, L, r, W, qpad = _row_inputs(a, qm, qids, r)
    dev = a.device
    zeros = torch.zeros((B, W), dtype=torch.float32, device=dev)
    first = torch.full((B, W), BIG, dtype=torch.float32, device=dev)
    first[:, r] = 0.0
    steps, d_rows, dead, stage = _staged_rows(a, qpad.unfold(1, W, 1), r, W)

    def step(t, state, first_row=False):
        Ph, Pl = state
        if first_row:
            Mh, Ml = first, zeros
        else:
            Mh, Ml = _ds_min(Ph, Pl, F.pad(Ph[:, 1:], (0, 1), value=BIG),
                             F.pad(Pl[:, 1:], (0, 1)))
        Ch, Cl = _ds_scan(d_rows[t], zeros, _ds_two_sum)
        Gh, Gl = _ds_two_sum(Mh, Ml, -F.pad(Ch[:, :-1], (1, 0)),
                             -F.pad(Cl[:, :-1], (1, 0)))
        Gh, Gl = _ds_scan(Gh, Gl, _ds_min)
        Dh, Dl = _ds_two_sum(Ch, Cl, Gh, Gl)
        Dh = torch.clamp_max_(Dh, BIG).masked_fill_(dead[t], BIG)
        Dl = torch.where(Dh < BIG, Dl, 0.0)
        Ph.copy_(Dh)
        Pl.copy_(Dl)
    dt = torch.promote_types(d_rows.dtype, torch.float32)
    state = [first.to(dt, copy=True), zeros.to(dt, copy=True)]
    stage(0, 1)
    step(0, state, first_row=True)
    _run_blocks(dtw_banded_ds_plain, 1, L, steps, stage, step, state)
    return state[0][:, r], state[1][:, r]


def dtw_ds_diag_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                      r: int):
    """Plain version of the DS kernel in its own form: ``dtw_diag_plain``'s
    walk over the 2L-1 anti-diagonals on (B, W + 2) carries of f32 pairs.
    A cell is (vh, vl) = ds_two_sum(ds_min(ds_min(D_{s-1}[k-1],
    D_{s-1}[k+1]), D_{s-2}[k]), (d, 0)), capped to (BIG, 0) where
    !(vh < BIG) and outside the matrix: the kernel's pair operations, so
    the two are equal bit for bit.  Returns (hi, lo), each (B,) f32.  The
    diagonals run in blocks (``_run_blocks``; on the card replayed CUDA
    graphs, counted in ``dtw_ds_diag_plain.graph_replays``)."""
    B, L = a.shape
    r = min(r, L - 1)
    dev = a.device
    hi = [torch.full((B, 2 * r + 3), BIG, dtype=a.dtype, device=dev)
          for _ in range(2)]
    lo = [torch.zeros((B, 2 * r + 3), dtype=a.dtype, device=dev)
          for _ in range(2)]
    hi[0][:, r + 1] = 0.0  # D_{-2}: the seed of cell (0, 0)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    steps, nt, df, stage = _diagonals(a, qm, qids, r)

    def step(t, state):
        hi, lo = state[:2], state[2:]
        c, p = t & 1, (t + r) & 1
        n = nt[p]
        k, kl, kr = (_lanes(p, n, o) for o in (0, -1, 1))
        mh, ml = _ds_min(hi[1 - c][:, kl], lo[1 - c][:, kl], hi[1 - c][:, kr],
                         lo[1 - c][:, kr])
        mh, ml = _ds_min(mh, ml, hi[c][:, k], lo[c][:, k])
        d = df[t, :, :n]
        # a lane outside the matrix has vh = inf or NaN: not < BIG
        vh, vl = _ds_two_sum(mh, ml, d * d, zero)
        ok = vh < BIG
        hi[c][:, k] = torch.where(ok, vh, BIG)
        lo[c][:, k] = torch.where(ok, vl, 0.0)
    _run_blocks(dtw_ds_diag_plain, 0, 2 * L - 1, steps, stage, step, hi + lo)
    last = (2 * L - 2) & 1
    return hi[last][:, r + 1], lo[last][:, r + 1]


dtw_diag_plain.graph_replays = dtw_rows_plain.graph_replays = 0
dtw_banded_ds_plain.graph_replays = dtw_ds_diag_plain.graph_replays = 0


# ------------------------------------------------------------ the kernels
def _launch(name: str, a, qm, qids, r: int, n_out: int):
    """Validate, allocate and launch one DP kernel of csrc/dtw.cu, with the
    global workspace its form asks for (``kvm_<name>_workspace``: K3's and
    DS's global form, K4's block form past the shared-memory limit)."""
    dev = a.device
    B = a.shape[0] if a.dim() == 2 else 0
    ok = (a.dtype == torch.float32 and a.dim() == 2 and a.is_contiguous()
          and qm.device == dev and qm.dtype == torch.float32
          and qm.dim() == 2 and qm.shape[1] == a.shape[1]
          and qm.is_contiguous() and qids.device == dev
          and qids.dtype == torch.int32 and qids.shape == (B,)
          and qids.is_contiguous() and B > 0 and a.shape[1] > 0
          and qm.shape[0] > 0 and r >= 0)
    if not ok:
        raise ValueError(
            f"{name}: need contiguous f32 rows (B, L), f32 queries (Q, L) and "
            f"int32 qids (B,) on one CUDA device, B, L, Q > 0, r >= 0 (got "
            f"rows {tuple(a.shape)} {a.dtype}, queries {tuple(qm.shape)} "
            f"{qm.dtype}, qids {tuple(qids.shape)} {qids.dtype}, r={r})")
    L, Q = a.shape[1], qm.shape[0]
    r = min(r, L - 1)
    lib = kernels.lib()
    outs = [torch.empty(B, dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    n = ctypes.c_longlong(0)
    code = getattr(lib, f"kvm_{name}_workspace")(B, L, Q, r, ctypes.byref(n))
    if code:
        return code, outs
    # Freed when this returns: the caching allocator hands it out again only
    # to work queued after the launch on the same stream.
    ws = torch.empty(n.value, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = getattr(lib, f"kvm_{name}")(
        a.data_ptr(), qm.data_ptr(), qids.data_ptr(), B, L, Q, r,
        *(o.data_ptr() for o in outs), ws.data_ptr() if n.value else None,
        n.value, stream)
    return code, outs


def k3_form(a, r: int) -> str:
    """The form K3 and DS take for rows ``a`` (B, L) and radius ``r``
    (clamped to L - 1): "block" (one warp, or the warps of one block, a
    row), "cluster" (a thread-block cluster of at most 8 blocks a row, r <=
    K3_MAX_R) or "global" (one block a row, carries in device memory)."""
    if a.dim() == 2:
        r = min(r, a.shape[1] - 1)
    if r <= K3_BLOCK_MAX_R:
        return "block"
    return "cluster" if r <= K3_MAX_R else "global"


def dtw_diag(a, qm, qids, r: int) -> torch.Tensor:
    """Banded DTW (B,) f32: kernel K3 for CUDA tensors, the plain version
    for CPU tensors.  K3 equals ``dtw_diag_plain`` bit for bit in each of
    its forms (``k3_form``)."""
    if backend.route(a) == "plain":
        return dtw_banded_plain(a, qm, qids, r)
    form = k3_form(a, r)
    code, (out,) = _launch("dtw_diag", a, qm, qids, r, 1)
    dtw_diag.launches += 1
    dtw_diag.cluster_launches += form == "cluster"
    dtw_diag.global_launches += form == "global"
    kernels.check(code, "dtw_diag")
    return out


def dtw_rows(a, qm, qids, r: int) -> torch.Tensor:
    """Banded DTW (B,) f32: kernel K4 for CUDA tensors, the plain version
    for CPU tensors.  On rows one warp holds K4 equals ``dtw_rows_plain``
    bit for bit; wider rows take its block form (a block scan of the row
    recurrence without prefix-sum cancellation, within the guard band),
    with a global workspace once the carries pass the shared-memory limit
    (any band)."""
    if backend.route(a) == "plain":
        return dtw_banded_plain(a, qm, qids, r)
    code, (out,) = _launch("dtw_rows", a, qm, qids, r, 1)
    dtw_rows.launches += 1
    kernels.check(code, "dtw_rows")
    return out


def dtw_ds(a, qm, qids, r: int):
    """Double-single banded DTW, (hi, lo) each (B,) f32: the DS kernel for
    CUDA tensors, the plain version for CPU tensors.  The DS kernel is K3's
    walk on pairs (K3's forms, ``k3_form``) and equals ``dtw_ds_diag_plain``
    bit for bit."""
    if backend.route(a) == "plain":
        return dtw_banded_ds_plain(a, qm, qids, r)
    form = k3_form(a, r)
    code, (hi, lo) = _launch("dtw_ds", a, qm, qids, r, 2)
    dtw_ds.launches += 1
    dtw_ds.cluster_launches += form == "cluster"
    dtw_ds.global_launches += form == "global"
    kernels.check(code, "dtw_ds")
    return hi, lo


dtw_diag.launches = dtw_diag.cluster_launches = dtw_diag.global_launches = 0
dtw_rows.launches = 0
dtw_ds.launches = dtw_ds.cluster_launches = dtw_ds.global_launches = 0


def _dtw_f32(x, qm, qids, r: int) -> torch.Tensor:
    if DTW_STATE["variant"] == "rows":
        return dtw_rows(x, qm, qids, r)
    return dtw_diag(x, qm, qids, r)


def ds_value(hi, lo) -> np.ndarray:
    """Combine a (hi, lo) double-single pair into host float64."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# ------------------------------------------- the JAX package's batch forms
# One query for the batch, or a query per row, as the functions of these
# names in kvmatch_tpu/ops/dtw.py take them: the wrappers above with a
# one-row query matrix (qids 0) or the rows' own (qids 0 .. B - 1).  A band
# past L - 1 is the band L - 1, as in JAX.
def _per_row(a_batch, q_batch) -> torch.Tensor:
    """qids 0 .. B - 1: row b takes query b of ``q_batch``, which must have
    the rows' shape."""
    if q_batch.shape != a_batch.shape:
        raise ValueError(f"need a query per row: q_batch "
                         f"{tuple(q_batch.shape)} against rows "
                         f"{tuple(a_batch.shape)}")
    return torch.arange(a_batch.shape[0], dtype=torch.int32,
                        device=a_batch.device)


def dtw_banded_batch(a_batch, q, r: int) -> torch.Tensor:
    """Squared banded DTW of a (B, L) batch against one query (L,), f32:
    K3, or K4 when selected (``DTW_STATE``)."""
    return _dtw_f32(a_batch, q[None], _one_query(a_batch), r)


def dtw_banded_batch_multi(a_batch, q_batch, r: int) -> torch.Tensor:
    """Banded DTW where every row of ``a_batch`` (B, L) has its own query,
    the same row of ``q_batch`` (B, L)."""
    return _dtw_f32(a_batch, q_batch, _per_row(a_batch, q_batch), r)


def dtw_banded_batch_ds_multi(a_batch, q_batch, r: int):
    """Double-single banded DTW, a query per row: the (hi, lo) f32 pair per
    row (``ds_value`` combines it in float64 on the host)."""
    return dtw_ds(a_batch, q_batch, _per_row(a_batch, q_batch), r)


# ------------------------------------------------------ lower-bound cascade
def lb_keogh_multi(a_batch, lo_batch, hi_batch) -> torch.Tensor:
    """LB_Keogh with a per-row query envelope ((B, L) each)."""
    exc = torch.clamp_min(torch.maximum(a_batch - hi_batch, lo_batch - a_batch),
                          0.0)
    return torch.sum(exc * exc, dim=1)


def lb_kim_multi(a_batch, q_batch) -> torch.Tensor:
    """LB_Kim with a per-row query ((B, L)): the full 3-front/3-back sum."""
    def dist(x, y):
        return (x - y) ** 2
    x = [a_batch[:, t] for t in range(3)]
    y = [a_batch[:, -1 - t] for t in range(3)]
    q = [q_batch[:, t] for t in range(3)]
    p = [q_batch[:, -1 - t] for t in range(3)]
    mn = torch.minimum
    lb = dist(x[0], q[0]) + dist(y[0], p[0])
    lb = lb + mn(mn(dist(x[1], q[0]), dist(x[0], q[1])), dist(x[1], q[1]))
    lb = lb + mn(mn(dist(y[1], p[0]), dist(y[0], p[1])), dist(y[1], p[1]))
    d = mn(mn(dist(x[0], q[2]), dist(x[1], q[2])), dist(x[2], q[2]))
    lb = lb + mn(d, mn(dist(x[2], q[1]), dist(x[2], q[0])))
    d = mn(mn(dist(y[0], p[2]), dist(y[1], p[2])), dist(y[2], p[2]))
    return lb + mn(d, mn(dist(y[2], p[1]), dist(y[2], p[0])))


def lb_kim(a_batch, q) -> torch.Tensor:
    """LB_Kim of a (B, L) batch against one query (L,)."""
    return lb_kim_multi(a_batch, q[None].expand_as(a_batch))


def lb_keogh(a_batch, q_lo, q_hi) -> torch.Tensor:
    """LB_Keogh of a (B, L) batch against one query envelope (L,) each."""
    return lb_keogh_multi(a_batch, q_lo[None], q_hi[None])


def lb_stage_multi(data, env_lo, env_hi, qm, lo_m, hi_m, offs, qids,
                   length: int) -> torch.Tensor:
    """max(LB_Kim, query-envelope LB_Keogh, data-envelope LB_Keogh) per
    candidate.  ``env_lo``/``env_hi`` are the series' global Sakoe-Chiba
    envelope (ops/sliding.sliding_min_max); a window of it encloses the
    window-local envelope, so the data-side Keogh stays a lower bound of
    banded DTW (kvmatch_tpu/ops/dtw.py:344-363)."""
    x = _gather(data, offs, length)
    e_lo = _gather(env_lo, offs, length)
    e_hi = _gather(env_hi, offs, length)
    qi = qids.long()
    q = qm[qi]
    lb = torch.maximum(lb_kim_multi(x, q), lb_keogh_multi(x, lo_m[qi], hi_m[qi]))
    return torch.maximum(lb, lb_keogh_multi(q, e_lo, e_hi))


def _znorm_rows(x, length: int):
    """(z rows, mean, std) with the f32 reductions of ops/dtw.py:399-406."""
    inv_l = float(np.float32(1.0 / length))
    mean = torch.sum(x, dim=1) * inv_l
    centered = x - mean[:, None]
    var = torch.sum(centered * centered, dim=1) * inv_l
    std = torch.sqrt(var)
    safe = torch.where(std > 0, std, 1.0)
    return centered / safe[:, None], mean, std


def lb_stage_znorm_multi(data, env_lo, env_hi, zq_m, lo_m, hi_m, cons, offs,
                         qids, length: int) -> torch.Tensor:
    """cons rows (alpha, beta, mu_q, sd_q, cg): inf where the guarded
    constraints fail, else the z-space cascade max(LB_Kim, query-envelope
    LB_Keogh, data-envelope LB_Keogh); the raw data envelope is mapped with
    the window's own (mean, std), a monotone affine map for std > 0
    (kvmatch_tpu/ops/dtw.py:409-439)."""
    x = _gather(data, offs, length)
    z, mean, std = _znorm_rows(x, length)
    qi = qids.long()
    a, b, mq, sq, cg = (cons[qi, k] for k in range(5))
    ratio = std / sq
    ok = ((torch.abs(mean - mq) <= b + cg) & (ratio <= a + cg)
          & (ratio >= 1.0 / a - cg) & (std > 0))
    zq = zq_m[qi]
    lb = torch.maximum(lb_kim_multi(z, zq),
                       lb_keogh_multi(z, lo_m[qi], hi_m[qi]))
    safe = torch.where(std > 0, std, 1.0)[:, None]
    z_elo = (_gather(env_lo, offs, length) - mean[:, None]) / safe
    z_ehi = (_gather(env_hi, offs, length) - mean[:, None]) / safe
    lb = torch.maximum(lb, lb_keogh_multi(zq, z_elo, z_ehi))
    return torch.where(ok, lb, torch.inf)


# ----------------------------------------------------------- the DP stages
def dtw_stage_multi(data, qm, offs, qids, length: int, r: int):
    """f32 banded-DP stage on raw windows (K3, or K4 when selected).  Its
    rounding differs from JAX's only in summation order, which the engines'
    guard band (verify.guard_threshold) absorbs."""
    return _dtw_f32(_gather(data, offs, length), qm, qids, r)


def dtw_stage_znorm_multi(data, zq_m, offs, qids, length: int, r: int):
    """f32 banded-DP stage on z-normalized windows."""
    z, _, _ = _znorm_rows(_gather(data, offs, length), length)
    return _dtw_f32(z, zq_m, qids, r)


def dtw_stage_ds_multi(data, qm, offs, qids, length: int, r: int):
    """Double-single confirm stage on raw windows: (hi, lo, max|x|), the
    last the input-amplitude term of verify.ds_guard."""
    x = _gather(data, offs, length)
    hi, lo = dtw_ds(x, qm, qids, r)
    return hi, lo, torch.amax(torch.abs(x), dim=1)


def dtw_stage_znorm_ds_multi(data, zq_m, offs, qids, mu, sd, length: int,
                             r: int):
    """Double-single confirm stage on z-normalized windows.  ``mu``/``sd``
    are per-candidate window stats computed exactly on the host (f64 prefix
    sums rounded to f32), so the z rows carry only elementwise f32 rounding.
    Returns (hi, lo, amp) with amp = (max|x| + |mu| + sd) / sd, the z-space
    image of the raw data's rounding for verify.ds_guard
    (kvmatch_tpu/ops/dtw.py:478-497)."""
    x = _gather(data, offs, length)
    z = (x - mu[:, None]) / sd[:, None]
    hi, lo = dtw_ds(z, zq_m, qids, r)
    amp = (torch.amax(torch.abs(x), dim=1) + torch.abs(mu) + sd) / sd
    return hi, lo, amp


# ------------------------------------------------------------- host f64 DP
def dtw_banded_batch_f64(a_batch: np.ndarray, q: np.ndarray, r: int,
                         ub: float = float("inf")) -> np.ndarray:
    """Float64 banded DTW for the host confirmation: the native C DP when
    the library builds, the NumPy twin otherwise.  A finite ``ub`` lets the
    native DP abandon windows that provably exceed it (they report a value
    > ub)."""
    res = native.dtw_band_f64(a_batch, q, r, ub)
    if res is not None:
        return res
    return _dtw_banded_batch_f64_np(a_batch, q, r)


def _dtw_banded_batch_f64_np(a_batch: np.ndarray, q: np.ndarray, r: int
                             ) -> np.ndarray:
    """NumPy twin of the f64 DP (kvmatch_tpu/ops/dtw.py:277-301)."""
    a_batch = np.asarray(a_batch, np.float64)
    q = np.asarray(q, np.float64)
    Bsz, L = a_batch.shape
    W = 2 * r + 1
    ks = np.arange(W)
    P = np.full((Bsz, W), np.inf)
    for i in range(L):
        j = i - r + ks
        valid = (j >= 0) & (j < L)
        qv = q[np.clip(j, 0, L - 1)]
        d = (a_batch[:, i][:, None] - qv[None, :]) ** 2
        d[:, ~valid] = 0.0
        shifted = np.concatenate([P[:, 1:], np.full((Bsz, 1), np.inf)], axis=1)
        M = np.minimum(P, shifted)
        if i == 0:
            M = np.where(ks == r, 0.0, np.inf)[None, :].repeat(Bsz, 0)
        C = np.cumsum(d, axis=1)
        Cprev = np.concatenate([np.zeros((Bsz, 1)), C[:, :-1]], axis=1)
        with np.errstate(invalid="ignore"):
            D = C + np.minimum.accumulate(M - Cprev, axis=1)
        D[:, ~valid] = np.inf
        P = D
    return P[:, r]
