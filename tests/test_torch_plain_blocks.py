"""The plain DP versions' block form against their loop form, on the CPU.

``kvmatch_tpu_torch/ops/dtw.py`` runs ``dtw_diag_plain``,
``dtw_ds_diag_plain``, ``dtw_rows_plain`` and ``dtw_banded_ds_plain`` in
blocks of steps (anti-diagonals or rows), their step-dependent inputs
staged a block at a time; on a CUDA device each full block is a replayed
CUDA graph.  Below is a verbatim copy of the loop form they had before
(one step at a time, its inputs sliced out in the step), the reference:
the block form must equal it bit for bit, for every L, band, batch, block
size (``BLOCK_STEPS`` set so the tail block runs, or so one block holds
every step) and dtype.  On the CPU no graph runs (``graph_replays`` stays).
The file imports nothing of jax or of the JAX package, so
``tests/test_torch_kernels_cuda.py`` holds the graphs on the card against
the same copies.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kvmatch_tpu_torch.ops import dtw as td

BIG = 1e30


# ------------------------------------------------- the loop form, verbatim
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


def _diagonals(a, qm, qids, r):
    """The anti-diagonal walk shared by the two diag plain versions: yields
    (s, c, sl, df) for s = 0 .. 2L-2, where the lanes k = p + 2t of diagonal
    s (p = (s + r) & 1, t = 0, 1, ...) sit at the strided slice ``sl(o)`` of
    a (B, W + 2) carry, shifted by ``o`` lanes (k + o + 1), c = s & 1 is the
    carry the diagonal rewrites, and df = a[i] - q[j] per lane with
    i = (s + r - k) / 2 and j = s - i.  The rows are reversed and padded with
    +inf past both ends, so a lane outside the matrix gets df = inf or NaN
    without a mask (the caller maps that to BIG), as the kernel's sentinels
    do."""
    B, L = a.shape
    r = min(r, L - 1)
    W = 2 * r + 1
    arev = F.pad(a.flip(1), (W, W), value=float("inf"))
    q = F.pad(qm[qids.long()], (W, W), value=float("inf"))
    nt = ((W + 1) // 2, W // 2)  # lanes of parity 0 and 1
    for s in range(2 * L - 1):
        p = (s + r) & 1
        n = nt[p]
        i0 = (s + r - p) >> 1     # lane t holds i = i0 - t, j = s - i0 + t
        ai, qj = W + L - 1 - i0, W + s - i0
        df = arev[:, ai:ai + n] - q[:, qj:qj + n]

        def sl(o, p=p, n=n):
            return slice(p + o + 1, p + o + 1 + 2 * n, 2)
        yield s, s & 1, sl, df


def dtw_diag_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                   r: int) -> torch.Tensor:
    """Plain version of K3 in its own form: the f32 walk over the 2L-1
    anti-diagonals s = i + j on (B, W + 2) carries with a BIG lane on each
    side, one carry per step parity (D_{s-2}, rewritten in place, and
    D_{s-1}).  Diagonal s rewrites the lanes k with s + r - k even:
    D_s[k] = min(d(i, j) + min(D_{s-1}[k-1], D_{s-1}[k+1], D_{s-2}[k]), BIG),
    BIG outside the matrix.  The same f32 operations as the kernel, so the
    two are equal bit for bit; its sums run in another order than
    ``dtw_banded_plain``'s row form, within the guard band of it."""
    B, L = a.shape
    r = min(r, L - 1)
    carry = [torch.full((B, 2 * r + 3), BIG, dtype=a.dtype, device=a.device)
             for _ in range(2)]
    carry[0][:, r + 1] = 0.0  # D_{-2}: the seed of cell (0, 0)
    big = torch.tensor(BIG, dtype=a.dtype, device=a.device)
    for s, c, sl, df in _diagonals(a, qm, qids, r):
        cur, prev = carry[c], carry[1 - c]
        m = torch.minimum(torch.minimum(prev[:, sl(-1)], prev[:, sl(1)]),
                          cur[:, sl(0)])
        # fmin: a lane outside the matrix has df*df + m = inf or NaN -> BIG
        cur[:, sl(0)] = torch.fmin(df * df + m, big)
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
    block form, whose sums run in another order (within the guard band)."""
    B, L, r, W, _ = _row_inputs(a, qm, qids, r)
    C = k4_chunk(W)
    K = 32 * C
    dt, dev = a.dtype, a.device
    qpad = F.pad(qm[qids.long()], (r, K))  # qpad[:, i + k] = q[i - r + k]
    k = torch.arange(K, device=dev)
    first = torch.full((B, K), BIG, dtype=dt, device=dev)
    first[:, r] = 0.0
    P = first
    for i in range(L):
        j = i - r + k
        valid = (j >= 0) & (j < L) & (k < W)
        d = torch.where(valid, (a[:, i:i + 1] - qpad[:, i:i + K]).square_(),
                        0.0).view(B, 32, C)
        c = torch.empty_like(d)
        run = torch.zeros((B, 32), dtype=dt, device=dev)
        for u in range(C):
            run = run + d[:, :, u]
            c[:, :, u] = run
        off = F.pad(_warp_scan(run, torch.add)[:, :-1], (1, 0))
        Cc = (off[:, :, None] + c).view(B, K)
        M = first if i == 0 else torch.minimum(
            P, F.pad(P[:, 1:], (0, 1), value=BIG))
        g = torch.cummin((M - F.pad(Cc[:, :-1], (1, 0))).view(B, 32, C),
                         dim=2).values
        pre = F.pad(_warp_scan(g[:, :, -1], torch.minimum)[:, :-1], (1, 0),
                    value=float("inf"))
        D = torch.clamp_max(Cc + torch.minimum(pre[:, :, None], g).view(B, K),
                            BIG)
        P = torch.where(valid, D, BIG)
    return P[:, r]


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
    CPU route of ``dtw_ds``; the kernel's own form is ``dtw_ds_diag_plain``."""
    B, L, r, W, qpad = _row_inputs(a, qm, qids, r)
    dev = a.device
    zeros = torch.zeros((B, W), dtype=torch.float32, device=dev)
    first = torch.full((B, W), BIG, dtype=torch.float32, device=dev)
    first[:, r] = 0.0
    Ph, Pl = first, zeros
    for i in range(L):
        lo, hi = _band_limits(i, r, L)
        d = (a[:, i:i + 1] - qpad[:, i:i + W]).square_()
        _mask_outside(d, lo, hi, 0.0)
        if i == 0:
            Mh, Ml = first, zeros
        else:
            Mh, Ml = _ds_min(Ph, Pl, F.pad(Ph[:, 1:], (0, 1), value=BIG),
                             F.pad(Pl[:, 1:], (0, 1)))
        Ch, Cl = _ds_scan(d, zeros, _ds_two_sum)
        Gh, Gl = _ds_two_sum(Mh, Ml, -F.pad(Ch[:, :-1], (1, 0)),
                             -F.pad(Cl[:, :-1], (1, 0)))
        Gh, Gl = _ds_scan(Gh, Gl, _ds_min)
        Dh, Dl = _ds_two_sum(Ch, Cl, Gh, Gl)
        Dh = torch.clamp_max_(Dh, BIG)
        _mask_outside(Dh, lo, hi, BIG)
        Dl = torch.where(Dh < BIG, Dl, 0.0)
        Ph, Pl = Dh, Dl
    return Ph[:, r], Pl[:, r]


def dtw_ds_diag_plain(a: torch.Tensor, qm: torch.Tensor, qids: torch.Tensor,
                      r: int):
    """Plain version of the DS kernel in its own form: ``dtw_diag_plain``'s
    walk over the 2L-1 anti-diagonals on (B, W + 2) carries of f32 pairs.
    A cell is (vh, vl) = ds_two_sum(ds_min(ds_min(D_{s-1}[k-1],
    D_{s-1}[k+1]), D_{s-2}[k]), (d, 0)), capped to (BIG, 0) where
    !(vh < BIG) and outside the matrix: the kernel's pair operations, so
    the two are equal bit for bit.  Returns (hi, lo), each (B,) f32."""
    B, L = a.shape
    r = min(r, L - 1)
    dev = a.device
    hi = [torch.full((B, 2 * r + 3), BIG, dtype=a.dtype, device=dev)
          for _ in range(2)]
    lo = [torch.zeros((B, 2 * r + 3), dtype=a.dtype, device=dev)
          for _ in range(2)]
    hi[0][:, r + 1] = 0.0  # D_{-2}: the seed of cell (0, 0)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    for s, c, sl, df in _diagonals(a, qm, qids, r):
        p = 1 - c
        mh, ml = _ds_min(hi[p][:, sl(-1)], lo[p][:, sl(-1)], hi[p][:, sl(1)],
                         lo[p][:, sl(1)])
        mh, ml = _ds_min(mh, ml, hi[c][:, sl(0)], lo[c][:, sl(0)])
        # a lane outside the matrix has vh = inf or NaN: not < BIG
        vh, vl = _ds_two_sum(mh, ml, df * df, zero)
        ok = vh < BIG
        hi[c][:, sl(0)] = torch.where(ok, vh, BIG)
        lo[c][:, sl(0)] = torch.where(ok, vl, 0.0)
    last = (2 * L - 2) & 1
    return hi[last][:, r + 1], lo[last][:, r + 1]


#: Each converted function's loop form, by name.
LOOP_BY_NAME = {"dtw_diag_plain": dtw_diag_plain,
                "dtw_ds_diag_plain": dtw_ds_diag_plain,
                "dtw_rows_plain": dtw_rows_plain,
                "dtw_banded_ds_plain": dtw_banded_ds_plain}


def _inputs(B, L, dtype, seed, Q=2):
    """Random walks (a row near its query, a common-mode offset on another)
    as (a, qm, qids)."""
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.normal(0, 0.3, (B, L)), axis=1)
    qm = np.cumsum(rng.normal(0, 0.3, (Q, L)), axis=1)
    qids = rng.integers(0, Q, B).astype(np.int32)
    a[0] = qm[qids[0]] + rng.normal(0, 1e-3, L)
    if B > 1:
        a[1] += 100.0
    return (torch.as_tensor(a, dtype=dtype), torch.as_tensor(qm, dtype=dtype),
            torch.as_tensor(qids))


@functools.lru_cache(maxsize=None)
def _loop_result(name, B, L, r, dtype):
    out = LOOP_BY_NAME[name](*_inputs(B, L, dtype, seed=L + r), r)
    return out if isinstance(out, tuple) else (out,)


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _cases():
    """Every converted function at L in {1, 2, 64, 257}, r in {0, 1, 5,
    L - 1, L + 3} (the last clamped to L - 1), B alternating 1 and 3; block
    sizes of 5 steps (4 for the diagonal walks, which take an even number:
    the tail block runs) and 2L + 2 (one block, all tail) in f32, 5 in f64,
    and the module's own sizes at L = 257 (whose tail runs too)."""
    out = []
    for name in LOOP_BY_NAME:
        for L in (1, 2, 64, 257):
            for r in sorted({0, 1, 5, L - 1, L + 3}):
                B = 3 if (L + r) % 2 else 1
                kinds = [(5, torch.float32), (2 * L + 2, torch.float32),
                         (5, torch.float64)]
                if L == 257:
                    kinds.append((None, torch.float32))
                for steps, dtype in kinds:
                    out.append(pytest.param(
                        name, B, L, r, steps, dtype,
                        id=f"{name}-B{B}-L{L}-r{r}-S{steps or 'default'}-"
                           f"{str(dtype)[6:]}"))
    return out


@pytest.mark.parametrize("name,B,L,r,steps,dtype", _cases())
def test_block_form_equals_loop_form(monkeypatch, name, B, L, r, steps,
                                     dtype):
    fn = getattr(td, name)
    if steps is not None:
        monkeypatch.setattr(td, "BLOCK_STEPS", steps)
    before = fn.graph_replays
    got = fn(*_inputs(B, L, dtype, seed=L + r), r)
    got = got if isinstance(got, tuple) else (got,)
    want = _loop_result(name, B, L, r, dtype)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B,) and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))
    assert (want[0] < BIG).all()
    assert fn.graph_replays == before  # no graph on the CPU


def test_block_steps_cap_steps_and_bytes(monkeypatch):
    """A block holds at most BLOCK_STEPS steps and BLOCK_BYTES of staged
    inputs, at least one step, and an even number (at least 2) for the
    diagonal walks."""
    monkeypatch.setattr(td, "BLOCK_STEPS", 64)
    monkeypatch.setattr(td, "BLOCK_BYTES", 1000)
    assert [td._block_steps(b) for b in (1, 10, 99, 501, 2000)] == \
        [64, 64, 10, 1, 1]
    assert [td._block_steps(b, even=True) for b in (1, 99, 200, 501)] == \
        [64, 10, 4, 2]
    monkeypatch.setattr(td, "BLOCK_STEPS", 7)
    assert (td._block_steps(1), td._block_steps(1, even=True)) == (7, 6)


def test_plain_bench_needs_the_card(monkeypatch, capsys):
    """The plain versions' timer measures the card: without one it exits
    2 and times nothing."""
    from kvmatch_tpu_torch.utils import plain_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert plain_bench.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
