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
  kvmatch_tpu/ops/dtw.py:dtw_banded_batch_ds_multi).

Each takes the gathered (B, L) f32 rows, the (Q, L) f32 query matrix with
int32 ``qids`` and the band radius ``r``.  On a CPU tensor it runs its plain
PyTorch version (``dtw_banded_plain``, ``dtw_banded_ds_plain``), on a CUDA
tensor its kernel.  ``DTW_STATE["variant"]`` picks K3 or K4 for the f32
stages, as ``_PALLAS_DTW_STATE`` does in JAX.

Offsets are int64 end to end (JAX casts them to int32).  The f64 host DP is
the JAX package's jax-free native kernel (``kvmatch_tpu.native``), with the
NumPy twin as its fallback.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend, kernels
from .ed import _gather

BIG = 1e30

#: f32 DP variant of the stages: "diag" (K3) or "rows" (K4).
DTW_STATE = {"variant": "diag"}


# ----------------------------------------------------------- plain versions
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
    """Plain version of the DS kernel: kvmatch_tpu/ops/dtw.py:
    dtw_banded_batch_ds_multi with every DP value an unevaluated f32 pair
    (hi, lo); the row's cumsum and cummin are log-step scans of
    ``_ds_two_sum`` / ``_ds_min``.  Returns (hi, lo), each (B,) f32."""
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


# ------------------------------------------------------------ the kernels
def _launch(name: str, a, qm, qids, r: int, n_out: int):
    """Validate, allocate and launch one DP kernel of csrc/dtw.cu."""
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
    L = a.shape[1]
    outs = [torch.empty(B, dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = getattr(kernels.lib(), f"kvm_{name}")(
        a.data_ptr(), qm.data_ptr(), qids.data_ptr(), B, L, qm.shape[0],
        min(r, L - 1), *(o.data_ptr() for o in outs), stream)
    return code, outs


def dtw_diag(a, qm, qids, r: int) -> torch.Tensor:
    """Banded DTW (B,) f32: kernel K3 for CUDA tensors, the plain version
    for CPU tensors."""
    if backend.route(a) == "plain":
        return dtw_banded_plain(a, qm, qids, r)
    code, (out,) = _launch("dtw_diag", a, qm, qids, r, 1)
    dtw_diag.launches += 1
    kernels.check(code, "dtw_diag")
    return out


def dtw_rows(a, qm, qids, r: int) -> torch.Tensor:
    """Banded DTW (B,) f32: kernel K4 for CUDA tensors, the plain version
    for CPU tensors."""
    if backend.route(a) == "plain":
        return dtw_banded_plain(a, qm, qids, r)
    code, (out,) = _launch("dtw_rows", a, qm, qids, r, 1)
    dtw_rows.launches += 1
    kernels.check(code, "dtw_rows")
    return out


def dtw_ds(a, qm, qids, r: int):
    """Double-single banded DTW, (hi, lo) each (B,) f32: the DS kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if backend.route(a) == "plain":
        return dtw_banded_ds_plain(a, qm, qids, r)
    code, (hi, lo) = _launch("dtw_ds", a, qm, qids, r, 2)
    dtw_ds.launches += 1
    kernels.check(code, "dtw_ds")
    return hi, lo


dtw_diag.launches = 0
dtw_rows.launches = 0
dtw_ds.launches = 0


def _dtw_f32(x, qm, qids, r: int) -> torch.Tensor:
    if DTW_STATE["variant"] == "rows":
        return dtw_rows(x, qm, qids, r)
    return dtw_diag(x, qm, qids, r)


def ds_value(hi, lo) -> np.ndarray:
    """Combine a (hi, lo) double-single pair into host float64."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


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
    from kvmatch_tpu.native import dtw_band_f64
    res = dtw_band_f64(a_batch, q, r, ub)
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
