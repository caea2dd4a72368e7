"""Kernel efficiency against the card's roofline (port of
kvmatch_tpu/utils/kernel_bench.py).

For each phase-2 kernel and the build pass this reports

    achieved GB/s = mandatory bytes / device time per call

where the mandatory bytes count each input element read once and each
output element written once (the JAX package's byte formulas, kept so the
fields read beside ``BENCH_r0x``'s), and beside each the least time the
card could take for the same work (``*_bound_ms``, from ``bound``) and the
share of it reached (``*_share`` = bound / time).

``cons_and_times`` times the cNSM constraint AND alone (``cons_and_work``
its bound); ``region_near`` is the region near-set's section
(``near_work`` its bound).  ``bound`` is the one roofline of the port: ``chip_smoke.py``'s
kernel table uses it too.  Its peaks are the published ones of one H100 SXM at 700 W;
its operation counts per unit of work were counted in the kernels'
sources (``K1_*``, ``K2_OPS``, ``DP_OPS``, ``DS_OPS``).

Each section has a factory returning a ``Section`` (the call ``fn(i)``, its
bytes, the JAX formula's flops where the JAX section reports a rate of
them, and the f32 operations the roofline counts), so a test can build and
run one section alone at a small shape.  ``measure_kernel_efficiency``
times them all at the JAX package's shapes unless ``shapes`` overrides
one; on a CPU tensor every wrapper runs its plain version and the fields
name what ran (``*_kernel``).
"""

from __future__ import annotations

import math
import subprocess
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once) over
# the memory rate and its f32 operations over the f32 rate outside the
# tensor cores -- the published peaks of one H100 SXM at 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 33.5e12
# f32 operations per unit of work, counted in the kernels' sources:
# K1 per (position, query, plan segment) term of the bound: 1 convert, 4 for
# the key bounds, 4 for delta, 3 for the bound sum; cNSM adds 2 + 4 for the
# z-bounds.  K1 leaves a position once its bound exceeds eps^2, so the work
# a run needs is the terms still open when reached (ops/probe.py:
# probe_work), plus, for cNSM, the Ex/Ex2 tracks (4 + 5 a term) over every
# segment of the positions left for the sigma filter; its bytes are the
# distinct stack entries those read.  K1_OPS_FULL is the whole
# (position, segment) grid with the tracks, the count of a probe without
# the early exit, over the whole stack.
K1_OPS = {False: 12, True: 18}
K1_TRACK_OPS = 9
K1_OPS_FULL = 27
K2_OPS = {"raw": 3, "znorm": 9}  # per window element: sub, mul, add; z-norm
# adds the mean sum (1), the centred square sum (3) and the z-difference (2).
DP_OPS = 5   # K3, K4 per band cell: sub, mul, add, two mins (cap not counted)
DS_OPS = 20  # DS per band cell: d (2), two pair minima (2 x 4), TwoSum (10)
# The build pass (ops/sliding.build_buckets): per point, the unit sum's 4
# doubling and 2 combining adds and the 4 scale-doubling adds; per point and
# scale, the bucketing's multiply, floor, subtract, compare and convert.
BUILD_OPS_POINT, BUILD_OPS_SCALE = 10, 5
# A real FFT of N points: 2.5 N log2 N operations (half a complex FFT's).
FFT_OPS = 2.5
# The constraint AND (csrc/probe.cu: cons_and_kernel): per position the
# mean (1), the variance (3 and the clamp) and the two guards (2 and 6);
# per (position, query) the three compares, their three adds or subtracts
# and the |.|, and one more per compare taken as the AND of the compares.
CONS_OPS_POS = 13
CONS_OPS_PAIR = 8

#: The JAX package's shapes (kvmatch_tpu/utils/kernel_bench.py:85, 108,
#: 133, 168, 184), section -> shape.
DEFAULT_SHAPES = dict(gather_ed=(65536, 1024), region_fft=(8192, 512, 1024),
                      banded_dtw=(8192, 1024, 51), ds_dtw=1024,
                      build_pass=1 << 24)
#: compare_window_kernel's (B, L), the JAX package's (kernel_bench.py:217).
WINDOW_SHAPES = ((4096, 1024), (1024, 8192))
#: Rounds of ``reps`` calls each; the least round is kept.
ROUNDS = 3
#: K2's shapes on record (B, L), timed by ``window_kernel_times``: the
#: JAX package's compare shapes, the kernels phase's (verify.bucket_size's
#: cap at L = 8192) and the gather section's.
K2_SHAPES = ((4096, 1024), (1024, 8192), (16384, 8192), (65536, 1024))
#: K2's f64 form at the cells' confirm loads (B, L): about 700 rows a query
#: of cnsm_ed.b1.sel3e-7, about 1,100 a batch of cnsm_ed.b8.sel3e-8.
K2_F64_SHAPES = ((700, 4096), (1100, 4096))
#: Queries of a K2 measurement (the north-star batch's 8).
K2_QUERIES = 8
#: Traces ``device_ms`` takes before it gives up on one that is whole.
DEVICE_TRACE_TRIES = 5
#: K2's kernel, as torch.profiler names it (csrc/window_ed.cu).
K2_KERNEL = "window_ed_kernel"
#: The most of its bound a timed K2 call may reach: a device time past it is
#: not physical, so ``window_kernel_times`` takes such a trace again.
MAX_SHARE = 1.05
#: Least bytes of windows a K2 measurement walks through: about three times
#: the card's 50 MB L2, so that its windows come from device memory.
K2_WALK_BYTES = 160 << 20
#: The AND's shapes on record (name, positions, Q) at L = 4096: the whole
#: series (None: every window start, the cached route of the n = 1e8 cells)
#: for one query and for a batch of 8, and one PROBE_BLOCK of 2^24
#: positions (a launch of the per-block route) for 8.
CONS_SHAPES = (("all", None, 1), ("all", None, 8), ("block", 1 << 24, 8))
CONS_LENGTH = 4096
#: The AND's kernel, as torch.profiler names it (csrc/probe.cu).
CONS_KERNEL = "cons_and_kernel"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> dict:
    """bound_ms and what sets it, from the work's bytes and its ops (f32,
    unless ``ops_per_s`` gives another rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops)


def k2_work(B: int, L: int, Q: int, znorm: bool) -> dict:
    """K2's ``bound`` for B rows of width L against Q query rows: each
    window, offset (8 bytes), query id (4) and query row read once, d2 (and
    mean and std) written once; K2_OPS a window element."""
    return bound(B * (4 * L + 12) + Q * L * 4 + B * 4 * (3 if znorm else 1),
                 K2_OPS["znorm" if znorm else "raw"] * B * L)


def k2_f64_work(B: int, L: int, Q: int) -> dict:
    """``bound`` of K2's f64 form: its bytes as ``k2_work``'s z-norm form
    with f64 query rows and outputs; its K2_OPS["znorm"] operations a window
    element are f64, counted at F64_OPS_PER_S."""
    return bound(B * (4 * L + 12) + Q * L * 8 + B * 8 * 3,
                 K2_OPS["znorm"] * B * L, F64_OPS_PER_S)


def cons_and_work(npos: int, Q: int) -> dict:
    """The AND's ``bound`` over ``npos`` positions and Q queries: three f32
    statistics a position and a flag byte a (query, 128 positions) read
    once; CONS_OPS_POS a position and CONS_OPS_PAIR a (position, query)."""
    return bound(12 * npos + Q * npos / 128,
                 npos * (CONS_OPS_POS + CONS_OPS_PAIR * Q))


def near_work(rows: int, L: int, M: int) -> dict:
    """The region near-set's bound (ops/regions.region_znorm_near_multi)
    over ``rows`` region rows: a row's R = M + L - 1 points read to stage it
    and its N = next_pow2(R) f32 written, the same points and its M
    correlations read by the near pass, and each of the two transforms'
    4N bytes in and 4N out; the transforms' operations."""
    R = M + L - 1
    N = 1 << max(math.ceil(math.log2(R)), 1)
    return bound(rows * (4 * R + 4 * N + 4 * R + 4 * M + 2 * (4 * N + 4 * N)),
                 rows * 2 * FFT_OPS * N * math.log2(N))


def band_cells(L: int, r: int) -> int:
    """Cells of an L x L Sakoe-Chiba band of radius r."""
    r = min(r, L - 1)
    return L * (2 * r + 1) - r * (r + 1)


def _timed(fn: Callable[[int], object], reps: int, device,
           rounds: int) -> float:
    """Least milliseconds per call of ``fn(i)`` over ``rounds`` runs of
    ``reps`` calls, after one warm call; ``i`` is distinct across the calls
    (0 .. rounds * reps), so a caller must take ``fn(i)`` for ``i`` up to
    ``rounds * reps``.  On the card each run lies between two CUDA events on
    the current stream; on the CPU between two ``perf_counter`` reads.  The
    least run is the estimator of a fixed time plus non-negative noise."""
    fn(rounds * reps)
    best = math.inf
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for k in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for j in range(reps):
                fn(k * reps + j)
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end))
    else:
        for k in range(rounds):
            t0 = time.perf_counter()
            for j in range(reps):
                fn(k * reps + j)
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / reps


def split_trace(events, calls: int, blocks: int, kernel: str,
                library: bool, floors: Sequence[float] = ()):
    """Per-call milliseconds of ``blocks`` blocks of ``calls`` calls that
    each launch one ``kernel``, then (``library``) of a block of ``calls``
    library calls, from a trace's device activities ``(name, start_us,
    duration_us)``.  Raises ValueError, saying why, for a trace that is not
    whole: other than ``blocks * calls`` activities named ``kernel``; other
    activities without a library block; library activities that are none,
    no whole multiple of ``calls``, or start before the kernel's last; a
    block under its least physical time (``floors``, ms a call)."""
    events = sorted(events, key=lambda e: e[1])
    named = [e for e in events if kernel in e[0]]
    rest = [e for e in events if kernel not in e[0]]
    if len(named) != blocks * calls:
        raise ValueError(f"{len(named)} {kernel} activities for "
                         f"{blocks * calls} calls")
    if library and (not rest or len(rest) % calls
                    or rest[0][1] < named[-1][1]):
        raise ValueError(f"{len(rest)} library activities for {calls} "
                         f"calls, or amid the kernel's")
    if not library and rest:
        raise ValueError(f"{len(rest)} activities besides {kernel}")
    ms = [sum(e[2] for e in named[k * calls:(k + 1) * calls]) / 1e3 / calls
          for k in range(blocks)]
    for k, (t, least) in enumerate(zip(ms, floors)):
        if t < least:
            raise ValueError(f"block {k}: {t} ms a call, under its least "
                             f"physical {least} ms")
    return ms, (sum(e[2] for e in rest) / 1e3 / calls if library else None)


def device_ms(fns: Sequence[Callable[[int], object]], calls: int, device,
              kernel: str = K2_KERNEL,
              library: Optional[Callable[[int], object]] = None,
              floors: Sequence[float] = ()):
    """Device milliseconds a call of each of ``fns``, each of which
    launches one ``kernel`` a call, and of ``library``: one torch.profiler
    trace, after a warm call of each, of ``calls`` calls ``fn(i)`` of each
    in turn, then of ``library``; each block's summed kernel durations over
    ``calls``.  The launch path on the host and the gaps between kernels
    are left out, so this is the kernels' own time; ``_timed`` includes
    them.  A trace that is not whole (``split_trace``) is taken again, up
    to DEVICE_TRACE_TRIES in all, then RuntimeError gives each one's
    fault.  Returns (a time for each of ``fns``, the library's time or
    None, the traces taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        raise ValueError("device_ms times the card's device activities: "
                         f"{device} is not a CUDA device")
    run = list(fns) + ([library] if library is not None else [])
    for fn in run:
        fn(calls)
    torch.cuda.synchronize(device)
    faults = []
    for tries in range(1, DEVICE_TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in run:
                for i in range(calls):
                    fn(i)
            torch.cuda.synchronize(device)
        try:
            ms, lib = split_trace(
                [(e.name, e.time_range.start, e.time_range.elapsed_us())
                 for e in prof.events() if e.device_type == DeviceType.CUDA],
                calls, len(fns), kernel, library is not None, floors)
        except ValueError as fault:
            faults.append(str(fault))
            continue
        return ms, lib, tries
    raise RuntimeError(f"torch.profiler recorded no whole trace of {calls} "
                       f"calls a block in {DEVICE_TRACE_TRIES}: {faults}")


def timed_ms(fn: Callable[[], object], reps: int, device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm one,
    timed as ``_timed`` times one round."""
    return _timed(lambda _i: fn(), reps, device, rounds=1)


class Section(NamedTuple):
    """One timed call ``fn(i)`` and its work: ``nbytes`` (the JAX
    package's byte formula), ``flops`` (its flop formula, where the JAX
    section reports a rate of them, else None) and ``ops`` (the f32
    operations of the roofline)."""
    fn: Callable[[int], object]
    nbytes: float
    flops: Optional[float]
    ops: float


def _on(device, a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def gather_ed(data_dev, offs, L: int) -> Section:
    """Raw squared ED of the B windows at ``offs + i`` against the series'
    first L points: ``ops/ed.ed_distances_multi``, K2 on the card
    (JAX: ``ops/ed.ed_distances``, kernel_bench.py:85-99)."""
    from ..ops.ed import ed_distances_multi
    dev = data_dev.device
    B = len(offs)
    q = data_dev[:L][None].contiguous()
    offs_t = _on(dev, offs, torch.int64)
    qids = torch.zeros(B, dtype=torch.int32, device=dev)
    return Section(lambda i: ed_distances_multi(data_dev, q, offs_t + i, qids,
                                                L),
                   B * L * 4 + L * 4 + B * 4, None, K2_OPS["raw"] * B * L)


def region_fft(data_dev, starts, L: int, M: int) -> Section:
    """Z-normalised distances of the M offsets of each region row at
    ``starts + i`` by FFT correlation: ``ops/regions.
    region_znorm_distances_multi`` (JAX: ``region_znorm_distances``,
    kernel_bench.py:101-117).  Operations: the three real FFTs of N points
    a row (the row, its query, the product's inverse)."""
    from ..ops.regions import region_znorm_distances_multi
    dev = data_dev.device
    R = len(starts)
    r_len = M + L - 1
    q = data_dev[:L]
    qh = ((q - q.mean()) / (q.std(unbiased=False) + 1e-9))[None].contiguous()
    starts_t = _on(dev, starts, torch.int64)
    qids = torch.zeros(R, dtype=torch.int32, device=dev)
    N = 1 << max(math.ceil(math.log2(r_len)), 1)
    return Section(lambda i: region_znorm_distances_multi(
        data_dev, qh, starts_t + i, qids, L, M),
        R * r_len * 4 + L * 4 + 3 * R * M * 4, None,
        R * 3 * FFT_OPS * N * math.log2(N))


def region_near(data_dev, queries_hat, starts, qids, vfrom, vto, threshs,
                cons, L: int, M: int, near_k: int) -> Section:
    """The region near-set (``ops/regions.region_znorm_near_multi``: the
    kernels on the card) of region rows at ``starts + i`` (device tensors,
    as the engine sends them); its bytes and operations are ``near_work``'s
    over the rows that are not padding."""
    from ..ops.regions import region_znorm_near_multi
    rows = int((vto > vfrom).sum())
    work = near_work(rows, L, M)
    return Section(lambda i: region_znorm_near_multi(
        data_dev, queries_hat, starts + i, qids, vfrom, vto, threshs, cons,
        L, M, near_k), work["bound_bytes"], None, work["bound_ops"])


def banded_dtw(data_dev, offs, L: int, rho: int, dp) -> Section:
    """The windows at ``offs + i`` gathered, then ``dp(rows, q, qids, rho)``
    against the series' first L points: ``ops/dtw.dtw_diag`` (K3, the
    engines' DP), ``dtw_rows`` (K4) or ``dtw_banded_plain`` (JAX:
    kernel_bench.py:127-153; flops 8 per cell of the unclamped L x W band,
    the JAX formula; ops ``DP_OPS`` per cell of the band)."""
    from ..ops.ed import _gather
    dev = data_dev.device
    B = len(offs)
    q = data_dev[:L][None].contiguous()
    offs_t = _on(dev, offs, torch.int64)
    qids = torch.zeros(B, dtype=torch.int32, device=dev)
    W = 2 * rho + 1
    return Section(lambda i: dp(_gather(data_dev, offs_t + i, L), q, qids,
                                rho),
                   B * L * 4 + L * 4 + B * 4, B * L * W * 8,
                   DP_OPS * B * band_cells(L, rho))


def ds_dtw(data_dev, offs, L: int, rho: int) -> Section:
    """The double-single confirm stage ``ops/dtw.dtw_stage_ds_multi`` (the
    DS kernel) on the windows at ``offs + i`` (JAX: kernel_bench.py:
    166-179, which reports no byte count; here the windows, the query and
    the three outputs)."""
    from ..ops.dtw import dtw_stage_ds_multi
    dev = data_dev.device
    B = len(offs)
    q = data_dev[:L][None].contiguous()
    offs_t = _on(dev, offs, torch.int64)
    qids = torch.zeros(B, dtype=torch.int32, device=dev)
    return Section(lambda i: dtw_stage_ds_multi(data_dev, q, offs_t + i, qids,
                                                L, rho),
                   B * L * 4 + L * 4 + 3 * B * 4, None,
                   DS_OPS * B * band_cells(L, rho))


def build_pass(data_dev, nb: int, scales, pos_of_d: int) -> Section:
    """Bucket ids of every scale over the first ``nb`` points:
    ``ops/sliding.build_buckets`` (JAX: kernel_bench.py:181-199).  The JAX
    section adds i * 1e-12 to the points against its backend's memoization;
    that is a full pass over them here and the card memoizes nothing, so
    every call takes the same points."""
    from ..ops.sliding import build_buckets
    piece = data_dev[:nb]
    scales = tuple(scales)
    return Section(lambda i: build_buckets(piece, scales, pos_of_d),
                   nb * 4 + len(scales) * nb * 4, None,
                   nb * (BUILD_OPS_POINT + BUILD_OPS_SCALE * len(scales)))


def _fields(out: dict, prefix: str, sec: Section, reps: int, device,
            rounds: int = ROUNDS) -> float:
    """Time ``sec`` and write its ``prefix``_{ms, gbps, [gflops],
    bound_ms, bound_by, share} fields; returns the seconds a call."""
    ms = _timed(sec.fn, reps, device, rounds)
    sec_s = ms / 1e3
    work = bound(sec.nbytes, sec.ops)
    out[f"{prefix}_ms"] = ms
    out[f"{prefix}_gbps"] = sec.nbytes / sec_s / 1e9
    if sec.flops is not None:
        out[f"{prefix}_gflops"] = sec.flops / sec_s / 1e9
    out[f"{prefix}_bound_ms"] = work["bound_ms"]
    out[f"{prefix}_bound_by"] = work["bound_by"]
    # The bound is the card's: a share only of a time taken on the card.
    out[f"{prefix}_share"] = (work["bound_ms"] / ms
                              if device.type == "cuda" else None)
    return sec_s


def measure_kernel_efficiency(data_dev: torch.Tensor, reps: int = 8,
                              shapes: Optional[dict] = None
                              ) -> Dict[str, object]:
    """Time the hot kernels against ``data_dev`` (the f32 series on its
    device; n >= 2^21 at the default shapes).  Returns a flat dict of the
    JAX package's fields (``banded_dtw_xla_*`` becomes
    ``banded_dtw_plain_*``, the plain PyTorch DP, timed one call a round;
    the non-selected variant ``banded_dtw_rows_*`` is K4), each timed field
    with its bound and share.  ``shapes`` overrides ``DEFAULT_SHAPES`` per
    section; the gather, region and build sections take 8 * ``reps`` calls
    a round (the JAX package's 64)."""
    from ..config import DEFAULT_INDEX_CONFIG
    from ..ops import dtw as td
    shapes = dict(DEFAULT_SHAPES, **(shapes or {}))
    device = data_dev.device
    n = int(data_dev.shape[0])
    out: Dict[str, object] = {}
    rng = np.random.default_rng(0)
    fast_reps = 8 * reps
    on_card = device.type == "cuda"

    B, L = shapes["gather_ed"]
    offs = rng.integers(0, n - L - 4 * fast_reps, B)
    _fields(out, "gather_ed", gather_ed(data_dev, offs, L), fast_reps,
            device)
    out["gather_ed_shape"] = f"B={B} L={L}"
    out["gather_ed_kernel"] = "K2 window_ed" if on_card else "window_ed_plain"

    R, M, Lr = shapes["region_fft"]
    starts = rng.integers(0, n - (M + Lr - 1) - 4 * fast_reps, R)
    sec_s = _fields(out, "region_fft", region_fft(data_dev, starts, Lr, M),
                    fast_reps, device)
    out["region_fft_shape"] = f"R={R} M={M} L={Lr}"
    out["region_fft_offsets_per_s"] = R * M / sec_s

    Bd, Ld, rho = shapes["banded_dtw"]
    offs_d = rng.integers(0, n - Ld - 4 * reps, Bd)
    for prefix, dp, kernel, plain in (
            ("banded_dtw", td.dtw_diag, "K3 dtw_diag", "dtw_banded_plain"),
            ("banded_dtw_rows", td.dtw_rows, "K4 dtw_rows",
             "dtw_banded_plain"),
            ("banded_dtw_plain", td.dtw_banded_plain, "dtw_banded_plain",
             "dtw_banded_plain")):
        # The plain DP is L steps of a dozen small launches each: one call
        # a round.
        one = dp is td.dtw_banded_plain
        sec_s = _fields(out, prefix, banded_dtw(data_dev, offs_d, Ld, rho, dp),
                        1 if one else reps, device, 1 if one else ROUNDS)
        out[f"{prefix}_cands_per_s"] = Bd / sec_s
        out[f"{prefix}_kernel"] = kernel if on_card else plain
    out["banded_dtw_shape"] = f"B={Bd} L={Ld} rho={rho}"

    Bds = shapes["ds_dtw"]
    sec_s = _fields(out, "ds_dtw", ds_dtw(data_dev, offs_d[:Bds], Ld, rho),
                    reps, device)
    out["ds_dtw_cands_per_s"] = Bds / sec_s
    out["ds_dtw_shape"] = f"B={Bds} L={Ld} rho={rho}"
    out["ds_dtw_kernel"] = "DS dtw_ds" if on_card else "dtw_banded_ds_plain"

    nb = min(n, shapes["build_pass"])
    scales = tuple(DEFAULT_INDEX_CONFIG.scales)
    sec_s = _fields(out, "build_pass", build_pass(
        data_dev, nb, scales, DEFAULT_INDEX_CONFIG.pos_of_d), fast_reps,
        device)
    out["build_pass_mpts_per_s"] = nb * len(scales) / sec_s / 1e6
    out["build_pass_shape"] = f"n={nb} scales={len(scales)}"
    out["device"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    return out


def compare_window_kernel(data_dev: torch.Tensor, reps: int = 8
                          ) -> Dict[str, object]:
    """K2 (``window_ed``, raw) against its plain version
    ``window_ed_plain`` and the library yardstick (``torch.cdist`` of the
    pre-gathered windows, the gather excluded) at each (B, L) of
    ``WINDOW_SHAPES`` (the JAX package's ``compare_pallas_gather``).  On the
    card K2 and the library call are timed by ``window_kernel_times``
    (their device time, ``reps`` calls); on a CPU tensor the kernel cannot
    run, and the plain version and the library call are timed under their
    own names."""
    from ..ops.ed import _gather, window_ed_plain
    device = data_dev.device
    n = int(data_dev.shape[0])
    on_card = device.type == "cuda"
    card = (window_kernel_times(data_dev, WINDOW_SHAPES, calls=reps)
            if on_card else {})
    out: Dict[str, object] = {}
    rng = np.random.default_rng(1)
    for B, L in WINDOW_SHAPES:
        offs = _on(device, rng.integers(0, n - L - 4 * reps, B), torch.int64)
        q = data_dev[:L][None].contiguous()
        qids = torch.zeros(B, dtype=torch.int32, device=device)
        tag = f"B{B}_L{L}"
        plain = _timed(lambda i: window_ed_plain(data_dev, q, offs + i, qids,
                                                 L, False), reps, device,
                       ROUNDS)
        out[f"plain_ms_{tag}"] = plain
        if on_card:
            k2, library = (card[tag]["raw"][k]
                           for k in ("device_ms", "library_ms"))
            out[f"library_ms_{tag}"] = library
            out[f"k2_ms_{tag}"] = k2
            out[f"k2_speedup_vs_plain_{tag}"] = plain / k2
            out[f"k2_speedup_vs_library_{tag}"] = library / k2
        else:
            # As chip_smoke.py's K2 row: each window against its query row.
            xw = _gather(data_dev, offs, L)[:, None, :]
            qw = q[qids.long()][:, None, :]
            library = _timed(lambda i: torch.cdist(xw, qw), reps, device,
                             ROUNDS)
            out[f"library_ms_{tag}"] = library
            out[f"plain_speedup_vs_library_{tag}"] = library / plain
    out["library"] = ("torch.cdist of the pre-gathered raw windows against "
                      "the query, gather excluded")
    out["device"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    return out


def window_kernel_times(data_dev: torch.Tensor, shapes=K2_SHAPES,
                        calls: int = 20, seed: int = 3) -> Dict[str, dict]:
    """K2 on the card at each (B, L) of ``shapes``, raw and z-normalised,
    against K2_QUERIES query rows (rows sorted by query, as the engines
    send them): ``device_ms`` (the kernel alone, torch.profiler; one trace
    a shape with the library call, taken again while a form's share of its
    bound is past MAX_SHARE; ``traces``), ``host_us`` (the wrapper's host
    time a call: checks, allocations, the ctypes launch), the bound and
    its share of ``device_ms``; for the raw form
    ``library_ms``, the device time of ``torch.cdist`` of the pre-gathered
    windows against their query rows (the gather excluded).  Each call
    takes the next of several offset sets that together span
    K2_WALK_BYTES, so the windows come from device memory and not from
    L2."""
    from ..ops.ed import _gather, window_ed
    device = data_dev.device
    if device.type != "cuda":
        raise ValueError("window_kernel_times measures the kernel on the card")
    n = int(data_dev.shape[0])
    rng = np.random.default_rng(seed)
    out: Dict[str, dict] = {}
    for B, L in shapes:
        tag = f"B{B}_L{L}"
        sets = max(1, -(-K2_WALK_BYTES // (B * L * 4)))
        offs = [_on(device, rng.integers(0, n - L + 1, B), torch.int64)
                for _ in range(sets)]
        qids = _on(device, np.sort(rng.integers(0, K2_QUERIES, B))
                   .astype(np.int32))
        qraw = _gather(data_dev, _on(device, rng.integers(
            0, n - L + 1, K2_QUERIES), torch.int64), L).contiguous()
        mu = qraw.mean(dim=1, keepdim=True)
        qhat = ((qraw - mu) / qraw.std(dim=1, unbiased=False, keepdim=True)
                ).contiguous()
        forms = (("raw", qraw, False), ("znorm", qhat, True))
        fns = [lambda i, qm=qm, z=z: window_ed(data_dev, qm, offs[i % sets],
                                               qids, L, z)
               for _, qm, z in forms]
        works = [k2_work(B, L, K2_QUERIES, z) for _, _, z in forms]
        xw = [_gather(data_dev, o, L)[:, None, :] for o in offs]
        qw = qraw[qids.long()][:, None, :]
        dms, library_ms, traces = device_ms(
            fns, calls, device, K2_KERNEL,
            library=lambda i: torch.cdist(xw[i % sets], qw),
            floors=[w["bound_ms"] / MAX_SHARE for w in works])
        del xw, qw
        entry: Dict[str, object] = dict(offset_sets=sets, traces=traces)
        for (form, _, _), fn, ms, work in zip(forms, fns, dms, works):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize(device)
            entry[form] = dict(device_ms=ms, host_us=host_s / calls * 1e6,
                               share_of_bound=work["bound_ms"] / ms,
                               library_ms=library_ms if form == "raw"
                               else None, **work)
        out[tag] = entry
    return out


def window_f64_times(data_dev: torch.Tensor, shapes=K2_F64_SHAPES,
                     calls: int = 20, seed: int = 5) -> Dict[str, dict]:
    """K2's f64 form (``ops/ed.window_ed_f64``) on the card at each (B, L)
    of ``shapes``, against K2_QUERIES f64 query rows, as
    ``window_kernel_times`` times the f32 forms: ``device_ms`` (the kernel
    alone), ``host_us`` (the wrapper's host time a call), the bound
    (``k2_f64_work``) and its share, and ``plain_ms``, the plain version
    (``window_ed_plain``'s f64 mode) a call by CUDA events."""
    from ..ops.ed import _gather, window_ed_f64, window_ed_plain
    device = data_dev.device
    if device.type != "cuda":
        raise ValueError("window_f64_times measures the kernel on the card")
    n = int(data_dev.shape[0])
    rng = np.random.default_rng(seed)
    out: Dict[str, dict] = {}
    for B, L in shapes:
        sets = max(1, -(-K2_WALK_BYTES // (B * L * 4)))
        offs = [_on(device, rng.integers(0, n - L + 1, B), torch.int64)
                for _ in range(sets)]
        qids = _on(device, np.sort(rng.integers(0, K2_QUERIES, B))
                   .astype(np.int32))
        q = _gather(data_dev, _on(device, rng.integers(
            0, n - L + 1, K2_QUERIES), torch.int64), L).double()
        qhat = ((q - q.mean(dim=1, keepdim=True))
                / q.std(dim=1, unbiased=False, keepdim=True)).contiguous()

        def fn(i):
            return window_ed_f64(data_dev, qhat, offs[i % sets], qids, L)
        work = k2_f64_work(B, L, K2_QUERIES)
        (ms,), _, traces = device_ms(
            [fn], calls, device, K2_KERNEL,
            floors=[work["bound_ms"] / MAX_SHARE])
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        plain = timed_ms(lambda: window_ed_plain(
            data_dev, qhat, offs[0], qids, L, znorm=True), 5, device)
        out[f"B{B}_L{L}"] = dict(
            device_ms=ms, host_us=host_s / calls * 1e6, plain_ms=plain,
            share_of_bound=work["bound_ms"] / ms, traces=traces,
            offset_sets=sets, **work)
    return out


def cons_and_times(data_dev: torch.Tensor, shapes=CONS_SHAPES,
                   length: int = CONS_LENGTH, calls: int = 20
                   ) -> Dict[str, dict]:
    """The constraint AND (``ops/probe.cons_and``) on the card over the
    width-``length`` window statistics of ``data_dev`` at each (name,
    positions, Q) of ``shapes``, with every flag set and constraint rows
    that every window passes (alpha 1e3 about sd 1, beta 1e30): each call
    reads every statistic and clears nothing, the most work the kernel does
    on these positions.  ``device_ms`` (the kernel alone, torch.profiler),
    ``host_us`` (the wrapper's host time a call), the bound
    (``cons_and_work``) and its share, ``plain_ms``: the plain version (the
    torch chain of ops/probe.py:_cons_ok_flags a PROBE_BLOCK) a call
    by CUDA events, and ``cleared``, the flags the calls cleared, which
    stays 0."""
    from ..ops.probe import FLAG, cons_and, cons_and_plain, make_cons_stats
    device = data_dev.device
    if device.type != "cuda":
        raise ValueError("cons_and_times measures the kernel on the card")
    n = int(data_dev.shape[0])
    m = n - length + 1
    stats = tuple(make_cons_stats(data_dev, length))
    out: Dict[str, dict] = {}
    for name, npos, Q in shapes:
        npos = -(-m // FLAG) * FLAG if npos is None else npos
        cons = torch.tensor([[1e3, 1e30, 0.0, 1.0]] * Q, dtype=torch.float32,
                            device=device)
        flags = torch.ones((Q, npos // FLAG), dtype=torch.bool, device=device)

        def fn(_i, f=cons_and):
            f(*stats, cons, 0, npos, m, length, flags)
        work = cons_and_work(npos, Q)
        (ms,), _, traces = device_ms([fn], calls, device, CONS_KERNEL,
                                     floors=[work["bound_ms"] / MAX_SHARE])
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        plain = timed_ms(lambda: fn(0, cons_and_plain), 3, device)
        out[f"{name}_Q{Q}"] = dict(
            npos=npos, Q=Q, device_ms=ms, host_us=host_s / calls * 1e6,
            plain_ms=plain, share_of_bound=work["bound_ms"] / ms,
            traces=traces, cleared=int((~flags).sum()), **work)
    return out


def main(argv=None) -> int:
    """Time K2 on the card (``window_kernel_times``, and its f64 form,
    ``window_f64_times``) and the constraint AND (``cons_and_times``) on
    the n-point series of seed 20260817 (chip_smoke.py's), resident on the
    card; one JSON line with the card's name and power limit."""
    import argparse
    import json
    import sys
    from ..data.generators import generate_series
    ap = argparse.ArgumentParser(
        prog="python -m kvmatch_tpu_torch.utils.kernel_bench",
        description="K2's and the constraint AND's device time at their "
                    "shapes on record.")
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; K2 is timed on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    data = torch.as_tensor(generate_series(args.n, seed=20260817),
                           dtype=torch.float32, device=device)
    times = window_kernel_times(data, calls=args.calls)
    f64 = window_f64_times(data, calls=args.calls)
    cons = cons_and_times(data, calls=args.calls)
    print(json.dumps(dict(card=card_line(),
                          device=torch.cuda.get_device_name(device),
                          n=args.n, calls=args.calls, k2=times, k2_f64=f64,
                          cons_and=cons)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
