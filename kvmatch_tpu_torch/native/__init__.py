"""Native host runtime of the PyTorch port (C, ctypes-bound), built at first use.

This is host code for the CPU, not a device kernel: the phase-1 candidate-set
intersections and joins that the reference runs as Java two-pointer merges
(QueryEngine.java:279-305), the fused scan and row merge over the index, the
exact float64 banded DTW of the host confirm, and the passes of the host
index build.  A copy of the functions of kvmatch_tpu/native/__init__.py that
the port calls, over its own copies of the C sources (``interval_kernels.c``,
and ``baseline_scalar.c``, the scalar reference twin of baseline_twin.py).

Each library is compiled with the system C compiler into ``build/native/`` at
the repository root, named by a hash of the source (an edited source
rebuilds).  If the build fails, every wrapper returns None and the callers
take their NumPy paths (utils/intervals.py, index/build.py,
ops/dtw._dtw_banded_batch_f64_np), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("interval_kernels.c")
_SRC_BASE = Path(__file__).with_name("baseline_scalar.c")
_CACHE = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = None
_TRIED = False
_BASE_LIB = None
_BASE_TRIED = False

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _compile_shared(src: Path) -> ctypes.CDLL | None:
    """``src`` compiled by cc into ``build/native/`` (named by a hash of the
    source) and loaded, or None when the compiler fails."""
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    _CACHE.mkdir(parents=True, exist_ok=True)
    so = _CACHE / f"{src.stem}_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CC", "cc"), "-O3", "-march=native", "-shared",
               "-fPIC", str(src), "-o", str(tmp), "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            try:  # retry without -march=native for odd toolchains
                cmd.remove("-march=native")
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _build() -> ctypes.CDLL | None:
    lib = _compile_shared(_SRC)
    if lib is None:
        return None
    # The phase-1 hot wrappers take raw pointers (ndpointer validation costs
    # ~8% of phase 1 at 26 array args a call); the wrappers guarantee dtype
    # and contiguity via _c64/_cf.
    P = ctypes.c_void_p
    lib.intersect_ed.restype = ctypes.c_long
    lib.intersect_ed.argtypes = [
        ctypes.c_long, P, P, P,
        ctypes.c_long, P, P, P,
        ctypes.c_double, ctypes.c_int64, P, P, P, P, P]
    lib.intersect_norm.restype = ctypes.c_long
    lib.intersect_norm.argtypes = [
        ctypes.c_long, P, P, P, P, P, P, P, P,
        ctypes.c_long, P, P, P, P, P, P, P, P,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64,
        P, P, P, P, P, P, P, P, P, P]
    lib.dtw_band_f64.restype = None
    lib.dtw_band_f64.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        _F64, _F64, _F64, _F64]
    lib.bucket_pass.restype = None
    lib.bucket_pass.argtypes = [
        _F64, ctypes.c_long, ctypes.c_long, ctypes.c_double, _I32]
    lib.rle_cap.restype = ctypes.c_long
    lib.rle_cap.argtypes = [
        _I32, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.group_merge.restype = ctypes.c_long
    lib.group_merge.argtypes = [
        ctypes.c_long, _I64, _I64, _I64, _I64, _I64,
        ctypes.c_double, ctypes.c_double, ctypes.c_long,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64]
    lib.group_rows.restype = ctypes.c_long
    lib.group_rows.argtypes = [
        ctypes.c_long, _I32, _I64, _I64,
        ctypes.c_int64, ctypes.c_int64, _I64,
        _I64, _I64, _I64, _I64]
    lib.install_pieces.restype = ctypes.c_long
    lib.install_pieces.argtypes = [
        ctypes.c_long, _I32, _I32, _I32, ctypes.c_int64, _I64,
        _I64, _I64, _I64, _I64, _I64]
    lib.merge_rows.restype = ctypes.c_long
    lib.merge_rows.argtypes = [
        ctypes.c_long, P, P, P, P, P, P, P, P, P, P]
    lib.join_ed.restype = ctypes.c_long
    lib.join_ed.argtypes = [
        ctypes.c_long, P, P, P,
        ctypes.c_long, P, P, P,
        ctypes.c_long, ctypes.c_long, P, ctypes.c_double, ctypes.c_long,
        P, P, P]
    lib.join_norm.restype = ctypes.c_long
    lib.join_norm.argtypes = [
        ctypes.c_long, P, P, P, P, P, P, P, P,
        ctypes.c_long, P, P, P,
        ctypes.c_long, ctypes.c_long,
        P, P, P, P, P, P,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_long,
        P, P, P, P, P, P, P, P]
    lib.scan_fill.restype = ctypes.c_long
    lib.scan_fill.argtypes = [
        ctypes.c_long, P, P, P,
        ctypes.c_long, ctypes.c_long, ctypes.c_int64,
        P, P, P, P, P, P,
        ctypes.c_int,
        P, P, P, P, P, P, P, P]
    return lib


def get_baseline_lib() -> ctypes.CDLL | None:
    """The scalar reference-twin library (``baseline_scalar.c``, a copy of
    kvmatch_tpu/native/baseline_scalar.c): the measured single-thread
    baseline standing in for the Java reference (baseline_twin.py), or None
    when the compiler fails or native is disabled (``KVMATCH_NO_NATIVE``)."""
    global _BASE_LIB, _BASE_TRIED
    if os.environ.get("KVMATCH_NO_NATIVE"):
        return None
    if not _BASE_TRIED:
        _BASE_TRIED = True
        try:
            lib = _compile_shared(_SRC_BASE)
        except Exception:
            lib = None
        if lib is not None:
            lib.base_ed_scan.restype = ctypes.c_long
            lib.base_ed_scan.argtypes = [
                _F64, ctypes.c_long, _I64, _I64, ctypes.c_long,
                _F64, ctypes.c_long, ctypes.c_double, _I64, _F64]
            lib.base_nsm_scan.restype = ctypes.c_long
            lib.base_nsm_scan.argtypes = [
                _F64, ctypes.c_long, _I64, _I64, ctypes.c_long,
                _F64, _I64, ctypes.c_long, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, _I64, _F64]
            lib.base_dtw_scan.restype = ctypes.c_long
            lib.base_dtw_scan.argtypes = [
                _F64, ctypes.c_long, _I64, _I64, ctypes.c_long,
                _F64, _F64, _F64, _I64, ctypes.c_long, ctypes.c_long,
                ctypes.c_double, _I64, _F64]
            lib.base_nsm_dtw_scan.restype = ctypes.c_long
            lib.base_nsm_dtw_scan.argtypes = [
                _F64, ctypes.c_long, _I64, _I64, ctypes.c_long,
                _F64, _F64, _F64, _I64, ctypes.c_long, ctypes.c_long,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, _I64, _F64]
        _BASE_LIB = lib
    return _BASE_LIB


def get_lib() -> ctypes.CDLL | None:
    """The compiled library, or None if native is unavailable or disabled
    (``KVMATCH_NO_NATIVE``, as for the JAX package)."""
    global _LIB, _TRIED
    if os.environ.get("KVMATCH_NO_NATIVE"):
        return None
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build()
        except Exception:
            _LIB = None
    return _LIB


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _cf(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


# Ping-pong generation for the intersection scratch: a result must stay valid
# while the NEXT intersection (which reads it as input) writes — two alternating
# pools give exactly that lifetime without copying outputs (phase 1 consumes a
# candidate set in the iteration after it is produced, then drops it).
#
# SHARED-PING INVARIANT (correctness-critical): on the engines' join path the
# live candidate set CS can be an *uncopied view* of one generation of these
# pools — utils.intervals.shift copies only left/right and merge_intervals has
# a return-input fast path for already-sorted-disjoint sets, so CS payload
# columns (eps, ex_*, beta) may alias f"ied*"/f"inorm*" scratch directly
# (engine/base.py:_phase1).  This is safe only because EVERY native producer
# that writes these pools (intersect_ed/intersect_norm/join_ed/join_norm)
# flips the SAME _PING counter for its family exactly once per call, so the
# generation CS aliases is never written before CS is consumed.  Any new
# kernel that writes a pool without flipping the counter, or flips it more
# than once per phase-1 iteration, silently corrupts the running candidate
# set — flip first, write the fresh generation only.
_PING = {"ied": 0, "inorm": 0}


def intersect_ed(cs: dict, raw: dict, eps2: float, delta: int = 0):
    """Fused sorted-x-sorted ED intersection + eps filter + frame shift; returns
    (cs-style dict, n_offsets, min_eps) or None when native is unavailable.
    The arrays are scratch VIEWS valid until the second-next intersect_ed
    call."""
    lib = get_lib()
    if lib is None:
        return None
    na, nb = cs["left"].size, raw["left"].size
    cap = na + nb
    g = _PING["ied"] = 1 - _PING["ied"]
    ol = _scratch(f"ied_l{g}", cap, np.int64)
    orr = _scratch(f"ied_r{g}", cap, np.int64)
    oe = _scratch(f"ied_e{g}", cap, np.float64)
    a_l, a_r, a_e = _c64(cs["left"]), _c64(cs["right"]), _cf(cs["eps"])
    b_l, b_r, b_e = _c64(raw["left"]), _c64(raw["right"]), _cf(raw["eps"])
    n_off = np.zeros(1, np.int64)
    emin = np.zeros(1, np.float64)
    k = lib.intersect_ed(na, a_l.ctypes.data, a_r.ctypes.data, a_e.ctypes.data,
                         nb, b_l.ctypes.data, b_r.ctypes.data, b_e.ctypes.data,
                         eps2, int(delta),
                         ol.ctypes.data, orr.ctypes.data, oe.ctypes.data,
                         n_off.ctypes.data, emin.ctypes.data)
    return ({"left": ol[:k], "right": orr[:k], "eps": oe[:k]},
            int(n_off[0]), float(emin[0]))


def intersect_norm(cs: dict, raw: dict, eps2: float, use_beta: bool,
                   use_std: bool, unit: int, qlen: int, p_units: int,
                   alpha: float, beta: float, mu_q: float, sd_q: float,
                   delta: int = 0):
    lib = get_lib()
    if lib is None:
        return None
    na, nb = cs["left"].size, raw["left"].size
    cap = na + nb
    g = _PING["inorm"] = 1 - _PING["inorm"]
    out = {name: _scratch(f"inorm{g}_{name}", cap,
                          np.uint64 if name == "beta" else
                          (np.int64 if name in ("left", "right") else np.float64))
           for name in ("left", "right", "eps", "ex_lo", "ex2_lo",
                        "ex_up", "ex2_up", "beta")}
    cols = ("left", "right", "eps", "ex_lo", "ex2_lo", "ex_up", "ex2_up", "beta")
    a_in = [np.ascontiguousarray(cs[c], np.uint64) if c == "beta" else
            (_c64(cs[c]) if c in ("left", "right") else _cf(cs[c])) for c in cols]
    b_in = [np.ascontiguousarray(raw[c], np.uint64) if c == "beta" else
            (_c64(raw[c]) if c in ("left", "right") else _cf(raw[c])) for c in cols]
    n_off = np.zeros(1, np.int64)
    emin = np.zeros(1, np.float64)
    k = lib.intersect_norm(
        na, *(a.ctypes.data for a in a_in),
        nb, *(b.ctypes.data for b in b_in),
        eps2, int(use_beta), int(use_std),
        float(unit), float(qlen), float(p_units),
        alpha, beta, mu_q, sd_q, int(delta),
        *(out[c].ctypes.data for c in cols),
        n_off.ctypes.data, emin.ctypes.data)
    # Scratch VIEWS, valid until the second-next intersect_norm call.
    return ({name: a[:k] for name, a in out.items()},
            int(n_off[0]), float(emin[0]))


_EMPTY_F = np.empty(0, np.float64)
_EMPTY_U = np.empty(0, np.uint64)

# Reusable output scratch for the interval kernels: the C calls write at most
# ``cap`` rows but typically keep far fewer, so allocating cap-sized arrays per
# call (and trimming with views that pin them) dominated phase-1 profile time.
# Engines are single-threaded per query (as in the reference), so a module
# scratch pool is safe; results are copied out at their exact size.
_SCRATCH: dict = {}


def _scratch(name: str, n: int, dtype) -> np.ndarray:
    buf = _SCRATCH.get(name)
    if buf is None or buf.size < n or buf.dtype != dtype:
        buf = np.empty(max(n, 4096), dtype)
        _SCRATCH[name] = buf
    return buf


def scan_fill(p_left, p_right, p_row, a: int, b: int, i0: int, i1: int,
              min_right: int, row_payloads: dict):
    """Fused segment scan over pos-sorted slice [a, b); returns interval dict or
    None when native is unavailable.  ``row_payloads`` maps column name to a
    per-row array of length i1-i0 ('eps' required)."""
    lib = get_lib()
    if lib is None:
        return None
    np_ = b - a
    norm = "ex_lo" in row_payloads
    ncols = 6 if norm else 1
    cap = int(np_)
    ol = _scratch("sf_l", cap, np.int64)
    orr = _scratch("sf_r", cap, np.int64)
    oe = _scratch("sf_e", cap, np.float64)
    if norm:
        o_exlo = _scratch("sf_exlo", cap, np.float64)
        o_ex2lo = _scratch("sf_ex2lo", cap, np.float64)
        o_exup = _scratch("sf_exup", cap, np.float64)
        o_ex2up = _scratch("sf_ex2up", cap, np.float64)
        o_beta = _scratch("sf_beta", cap, np.uint64)
    else:
        o_exlo = o_ex2lo = o_exup = o_ex2up = _EMPTY_F
        o_beta = _EMPTY_U
    ins = [_c64(p_left[a:b]), _c64(p_right[a:b]), _c64(p_row[a:b]),
           _cf(row_payloads["eps"]),
           _cf(row_payloads.get("ex_lo", _EMPTY_F)) if norm else _EMPTY_F,
           _cf(row_payloads.get("ex2_lo", _EMPTY_F)) if norm else _EMPTY_F,
           _cf(row_payloads.get("ex_up", _EMPTY_F)) if norm else _EMPTY_F,
           _cf(row_payloads.get("ex2_up", _EMPTY_F)) if norm else _EMPTY_F,
           np.ascontiguousarray(row_payloads.get("beta", _EMPTY_U), np.uint64)
           if norm else _EMPTY_U]
    k = lib.scan_fill(
        np_, ins[0].ctypes.data, ins[1].ctypes.data, ins[2].ctypes.data,
        i0, i1, min_right,
        *(x.ctypes.data for x in ins[3:]),
        ncols, ol.ctypes.data, orr.ctypes.data, oe.ctypes.data,
        o_exlo.ctypes.data, o_ex2lo.ctypes.data, o_exup.ctypes.data,
        o_ex2up.ctypes.data, o_beta.ctypes.data)
    # Scratch VIEWS, valid until the next scan_fill call: phase 1 consumes a
    # scan's output in the same iteration (intersection or first-segment clip).
    out = {"left": ol[:k], "right": orr[:k], "eps": oe[:k]}
    if norm:
        out.update(ex_lo=o_exlo[:k], ex2_lo=o_ex2lo[:k],
                   ex_up=o_exup[:k], ex2_up=o_ex2up[:k], beta=o_beta[:k])
    return out


def join_ed(cs: dict, p_left, p_right, p_row, i0: int, i1: int,
            row_eps, eps2: float, max_diff: int, row_total: int | None = None):
    """Fused scan+intersect join of the running candidate set against the
    probed rows' intervals via the position-sorted view (binary search per CS
    interval — O(|CS| log P) instead of an O(P) walk).  Returns a cs-style
    dict of ping-pong scratch VIEWS (same lifetime as intersect_ed) or None
    when native is unavailable.

    ``row_total`` is the interval count of the probed rows [i0, i1) — the
    kernel's true output bound.  Without it the scratch is sized to the whole
    position-sorted view, which at n=1e9 scales transiently allocates tens of
    GB of host memory exactly when the join path is chosen."""
    lib = get_lib()
    if lib is None:
        return None
    ncs = int(cs["left"].size)
    if row_total is None:
        row_total = int(p_row.size)  # conservative fallback
    cap = ncs + int(row_total)
    g = _PING["ied"] = 1 - _PING["ied"]
    ol = _scratch(f"ied_l{g}", cap, np.int64)
    orr = _scratch(f"ied_r{g}", cap, np.int64)
    oe = _scratch(f"ied_e{g}", cap, np.float64)
    a_l, a_r, a_e = _c64(cs["left"]), _c64(cs["right"]), _cf(cs["eps"])
    pl, pr, prw = _c64(p_left), _c64(p_right), _c64(p_row)
    re = _cf(row_eps)
    k = lib.join_ed(ncs, a_l.ctypes.data, a_r.ctypes.data, a_e.ctypes.data,
                    int(p_left.size), pl.ctypes.data, pr.ctypes.data,
                    prw.ctypes.data, int(i0), int(i1), re.ctypes.data,
                    float(eps2), int(max_diff),
                    ol.ctypes.data, orr.ctypes.data, oe.ctypes.data)
    return {"left": ol[:k], "right": orr[:k], "eps": oe[:k]}


_NORM_COLS = ("left", "right", "eps", "ex_lo", "ex2_lo", "ex_up", "ex2_up", "beta")


def join_norm(cs: dict, p_left, p_right, p_row, i0: int, i1: int,
              row_payloads: dict, eps2: float, use_beta: bool, use_std: bool,
              unit: int, qlen: int, p_units: int,
              alpha: float, beta: float, mu_q: float, sd_q: float,
              max_diff: int, row_total: int | None = None):
    """cNSM fused scan+intersect join (see join_ed, incl. the ``row_total``
    scratch bound); returns a cs-style dict of ping-pong scratch VIEWS or None
    when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ncs = int(cs["left"].size)
    if row_total is None:
        row_total = int(p_row.size)  # conservative fallback
    cap = ncs + int(row_total)
    g = _PING["inorm"] = 1 - _PING["inorm"]
    out = {name: _scratch(f"inorm{g}_{name}", cap,
                          np.uint64 if name == "beta" else
                          (np.int64 if name in ("left", "right") else np.float64))
           for name in _NORM_COLS}
    c_in = [np.ascontiguousarray(cs[c], np.uint64) if c == "beta" else
            (_c64(cs[c]) if c in ("left", "right") else _cf(cs[c])) for c in _NORM_COLS]
    pl, pr, prw = _c64(p_left), _c64(p_right), _c64(p_row)
    r_in = [_cf(row_payloads["eps"]), _cf(row_payloads["ex_lo"]),
            _cf(row_payloads["ex2_lo"]), _cf(row_payloads["ex_up"]),
            _cf(row_payloads["ex2_up"]),
            np.ascontiguousarray(row_payloads["beta"], np.uint64)]
    k = lib.join_norm(
        ncs, *(a.ctypes.data for a in c_in),
        int(p_left.size), pl.ctypes.data, pr.ctypes.data, prw.ctypes.data,
        int(i0), int(i1),
        *(a.ctypes.data for a in r_in),
        eps2, int(use_beta), int(use_std),
        float(unit), float(qlen), float(p_units),
        alpha, beta, mu_q, sd_q, int(max_diff),
        *(out[c].ctypes.data for c in _NORM_COLS))
    return {name: a[:k] for name, a in out.items()}


def merge_rows(row_start, row_end, left, right):
    """Left-sorted k-way merge of R position-sorted CSR interval rows; returns
    (row_of_interval, left, right) scratch VIEWS (valid until the next
    merge_rows call) or None when native is unavailable.  row_start/row_end
    are ABSOLUTE indices into left/right."""
    lib = get_lib()
    if lib is None:
        return None
    row_start = _c64(row_start)
    row_end = _c64(row_end)
    left = _c64(left)
    right = _c64(right)
    R = int(row_start.size)
    total = int((row_end - row_start).sum())
    ol = _scratch("mr_l", total, np.int64)
    orr = _scratch("mr_r", total, np.int64)
    orow = _scratch("mr_row", total, np.int64)
    hv = _scratch("mr_hv", R, np.int64)
    hr = _scratch("mr_hr", R, np.int64)
    cur = _scratch("mr_cur", R, np.int64)
    k = lib.merge_rows(R, row_start.ctypes.data, row_end.ctypes.data,
                       left.ctypes.data, right.ctypes.data,
                       ol.ctypes.data, orr.ctypes.data, orow.ctypes.data,
                       hv.ctypes.data, hr.ctypes.data, cur.ctypes.data)
    return orow[:k], ol[:k], orr[:k]


def dtw_band_f64(a_batch: np.ndarray, q: np.ndarray, r: int,
                 ub: float = float("inf")):
    """Exact float64 banded DTW distances^2 for (B, L) windows, or None.

    With a finite ``ub``, windows whose distance provably exceeds ub are
    early-abandoned and report a value > ub (not their exact distance)."""
    lib = get_lib()
    if lib is None:
        return None
    a_batch = np.ascontiguousarray(a_batch, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    nb, m = a_batch.shape
    out = np.empty(nb, np.float64)
    work = np.empty(2 * (m + 2), np.float64)
    lib.dtw_band_f64(nb, m, int(r), float(ub), a_batch, q, out, work)
    return out


def bucket_pass(c1: np.ndarray, w: int, pos_of_d: int) -> np.ndarray | None:
    """Fused window-mean -> int32 bucket-id pass from the f64 prefix array
    (one stream, no temporaries); None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    c1 = np.ascontiguousarray(c1, np.float64)
    m = c1.size - w      # = n - w + 1 outputs for n = c1.size - 1 points
    out = np.empty(m, np.int32)
    lib.bucket_pass(c1, m, int(w), 10.0 ** (pos_of_d - 1), out)
    return out


def rle_cap(buckets: np.ndarray, cap: int):
    """Run-length encode with cap split (two C passes: count then fill);
    returns (bucket, left, right) or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(buckets, np.int32)
    m = b.size
    k = lib.rle_cap(b, m, int(cap), None, None, None)
    # Scratch VIEWS (valid until the next rle_cap call): the build consumes
    # them immediately in group_rows/group_merge.
    ob = _scratch("rle_b", k, np.int32)
    ol = _scratch("rle_l", k, np.int64)
    orr = _scratch("rle_r", k, np.int64)
    lib.rle_cap(b, m, int(cap),
                ob.ctypes.data_as(ctypes.c_void_p),
                ol.ctypes.data_as(ctypes.c_void_p),
                orr.ctypes.data_as(ctypes.c_void_p))
    return ob[:k], ol[:k], orr[:k]


def group_merge(row_start, row_end, ubucket, left, right,
                merge_thresh: float, shrink_factor: float, cap: int):
    """Variable-width row merge (IndexBuilder.java:308-346 policy) in C;
    returns (keys, counts, flat_left, flat_right) with rows in ASCENDING key
    order (intra-row interval order preserved), or None when native is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    total = int(left.size)
    R = int(ubucket.size)
    # Buffers come from the persistent scratch pool: fresh glibc allocations of
    # this size page-fault at first touch, which dominated the (1-core) build.
    out_key = _scratch("gm_key", R, np.int64)
    out_count = _scratch("gm_cnt", R, np.int64)
    ol = _scratch("gm_l", total, np.int64)
    orr = _scratch("gm_r", total, np.int64)
    wl = _scratch("gm_wl", total, np.int64)
    wr = _scratch("gm_wr", total, np.int64)
    w2l = _scratch("gm_w2l", total, np.int64)
    w2r = _scratch("gm_w2r", total, np.int64)
    nrows = lib.group_merge(R, _c64(row_start), _c64(row_end), _c64(ubucket),
                            _c64(left), _c64(right),
                            float(merge_thresh), float(shrink_factor), int(cap),
                            out_key, out_count, ol, orr, wl, wr, w2l, w2r)
    keys = out_key[R - nrows:R].copy()
    counts = out_count[R - nrows:R].copy()
    used = int(counts.sum())
    return keys, counts, ol[total - used:total].copy(), orr[total - used:total].copy()


# Counting-sort scratch cap: bucket ranges past this fall back to argsort
# (8 * 2^26 = 512 MB of cursor scratch would be the histogram cost).
_GROUP_ROWS_MAX_RANGE = 1 << 26


def group_rows(ivl_bucket, left, right):
    """Counting-sort grouping of intervals by bucket id; returns
    (ubuckets i64[R], row_start i64[R+1], l_sorted, r_sorted) or None when
    native is unavailable or the bucket range is degenerate."""
    lib = get_lib()
    if lib is None or ivl_bucket.size == 0:
        return None
    bmin = int(ivl_bucket.min())
    rng = int(ivl_bucket.max()) - bmin + 1
    if rng > _GROUP_ROWS_MAX_RANGE:
        return None
    n = int(ivl_bucket.size)
    b = np.ascontiguousarray(ivl_bucket, np.int32)
    cnt = _scratch("gr_cnt", rng, np.int64)
    cnt[:rng] = 0  # the C kernel requires zeroed counters
    ubucket = _scratch("gr_ub", min(rng, n), np.int64)
    row_start = _scratch("gr_rs", min(rng, n) + 1, np.int64)
    # ol/orr are scratch VIEWS: valid until the next group_rows call (the build
    # consumes them immediately in group_merge; copying n*16B here would cost
    # more than the kernel).
    ol = _scratch("gr_l", n, np.int64)
    orr = _scratch("gr_r", n, np.int64)
    R = lib.group_rows(n, b, _c64(left), _c64(right),
                       bmin, rng, cnt, ubucket, row_start, ol, orr)
    return ubucket[:R].copy(), row_start[:R + 1].copy(), ol[:n], orr[:n]


def install_pieces(p_l32, p_r32, p_row32, n_rows: int):
    """Fused install of a device-built int32 position-sorted piece view: one
    streaming C pass widens to the persistent int64 pos-sorted copies AND
    counting-scatters the row-CSR interval copies.  ``p_row32`` must hold
    ascending group ids in [0, n_rows) (the device builder's layout).
    Returns persistent arrays (p_l, p_r, p_row, left_rowsorted,
    right_rowsorted) or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(np.asarray(p_l32).size)
    l32 = np.ascontiguousarray(p_l32, np.int32)
    r32 = np.ascontiguousarray(p_r32, np.int32)
    row32 = np.ascontiguousarray(p_row32, np.int32)
    # Ids are ascending by contract: an O(1) endpoint check guards the C
    # counting scatter against out-of-bounds row ids.
    if n == 0 or int(row32[0]) < 0 or int(row32[-1]) >= int(n_rows):
        return None
    cnt = np.zeros(int(n_rows), np.int64)
    l64 = np.empty(n, np.int64)
    r64 = np.empty(n, np.int64)
    row64 = np.empty(n, np.int64)
    ol = np.empty(n, np.int64)
    orr = np.empty(n, np.int64)
    lib.install_pieces(n, l32, r32, row32, int(n_rows), cnt,
                       l64, r64, row64, ol, orr)
    return l64, r64, row64, ol, orr
