#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the CUDA kernels of ``kvmatch_tpu_torch/csrc`` with nvcc (one
nvcc per source, in parallel), then runs these phases, each printing one
JSON line tagged with the card's name and power limit and its seconds
(``phase_s``):

1. env       -- torch/CUDA versions, the card, the kernel build seconds;
   build     -- n=1e8 series upload and the stats-only index build;
2. kernels   -- each kernel against its plain PyTorch version, with both
                times: K1 (dense probe) on the n=1e8 cached bucket stack
                with the 8 north-star cNSM-ED plans, the 8 cNSM-DTW
                envelope plans and the 8 RSM-ED plans of the same queries;
                the constraint AND (cons_and) over the engine's cached
                window statistics on K1's flags of the cNSM-ED and
                cNSM-DTW plans: flags equal to its
                plain version's;
                the region near-set (region_znorm_near_multi: three
                kernels around two cuFFT transforms) on the region rows of
                the main offsets' self-queries at L=4096 against its plain
                chain: counts equal, sets equal but for windows within a
                few f32 ulps of a limit, with both times, kernel_bench's
                section time and its byte bound;
                K2 (window distances, raw and z-norm) at B=16384, L=8192
                with the north-star queries, then at each (B, L) of
                K2_SHAPES: held to its plain version, and timed alone on
                the card (torch.profiler, a trace a shape), beside the
                wrapper's host time and torch.cdist's device time;
                K2's f64 form (window_ed_f64, the exact confirm on the
                card) at each (B, L) of K2_F64_SHAPES, the benchmark cells'
                confirm loads: d2 and std within 1e-12 relative of
                window_ed_plain's f64 mode, the mean within 1e-12 of the
                window's max |x|, timed alone beside the plain version;
                K3 (dtw_diag), K4 (dtw_rows) and the double-single DP
                (dtw_ds) on one bucket of B=1024 windows, L=8192, r=409,
                raw and z-normed, and K3 on a 16,384-row chunk; K3 and DS
                bit for bit against dtw_diag_plain / dtw_ds_diag_plain at
                L=1024, r=51, 409 and 1100 and on 8 rows at L=8192, r=409,
                K4 against dtw_rows_plain in the same cases (bit for bit
                on the one-warp rows, r <= 479);
                each kernel's bound (bytes or f32 operations at the card's
                published peaks; K1's counts the terms its early exit
                leaves and the stack entries they read, ops/probe.py:
                probe_work);
3. fft       -- the cuFFT f32 correlation error at the region shape
                (M=8192, L=8192) against f64, as a share of FFT_ERR_C;
4. exact     -- n=1e6 answer sets against the port's float64 brute-force
                oracle: cNSM-ED self-queries at L=1024 and 8192, and the
                RSM-ED README demo;
   exact_dtw -- n=1e6 RSM-DTW (L=1024, rho=51) and cNSM-DTW (L=1024,
                rho=51; L=8192, rho=409) answer sets against the oracle,
                each with K3 and with the K4 variant (4 self-queries a
                shape);
   wide_band -- K3 and DS in their global form (r > 106,495) on 2 rows
                at (L, r) = (106,600, 106,599), bit for bit against their
                plain versions, with the times of all four; bands past one
                block (r > 13,311): K3 and DS bit for bit
                against their plain versions, K4 within the guard band, at
                (L, r) = (13,313, 13,312) and (26,625, 26,624) (clusters
                of 2 and 3 blocks); then RSM-DTW and cNSM-DTW at n=17,000,
                L=16,384, rho=13,500 (2 self-queries each, with K3 and with
                K4; 44-segment plans, so host phase 1 over a host-built
                index) against the oracle, with the clustered launches;
5. main      -- cNSM-ED at n=1e8, L=8192, 8 self-queries, eps=4,
                alpha=1.2, beta=5 (bench.py's north star): one warm batch,
                3 timed batches, then each query alone through engine.query
                (the latency path), all confirmed on the host (the f64
                series is not f32's); then the same batch on the card's f32
                copy as the shadow, whose exact confirm runs on the card:
                the exactness check's seconds, one warm and 3 timed
                batches with the card confirm, one with the host confirm,
                equal answers, distances within 1e-8; launch counts of K1,
                K2 and K2's f64 form over all of it, and the (B, L) of each
                path's K2 calls;
   main_dtw  -- cNSM-DTW at n=1e8, L=8192, rho=409 on the same series,
                index and the 8 queries (MAIN_DTW_QUERIES): one warm batch,
                MAIN_DTW_REPS timed batches with their stage counts and
                kernel launches, one more with host spans of the cascade;
                then
                RSM-DTW (L=1024, rho=51, eps=6)
                on the same offsets, each query alone through engine.query;
                launch counts of K1, K3, K4 and DS;
6. routing   -- the cNSM-ED batch with phase 2 routed as a whole (the
                engine's policy) against routed per query, in turns;
7. profile   -- host spans of the cNSM-ED engine's phases and a
                torch.profiler device trace of one batch: kernel time by
                name, idle share;
   single    -- the single-query ops of the JAX package's names on the
                resident n=1e8 series at L=8192, r=409: ed_distances and
                znorm_ed_distances (K2) on 1,024 offsets, the region
                functions on 16 regions of M=8192, dtw_banded_batch and
                dtw_banded_batch_multi on 256 z-normed windows with K3 and
                with K4, dtw_banded_batch_ds_multi (DS), lb_kim and
                lb_keogh, each bit-equal to its _multi form and within its
                f64 tolerance; oracle.dtw_banded against the f64 batch DP;
                each call's launch counted, and K2, K3, K4 and DS must
                launch;
8. build_full -- the full device build (index/device_build.py) at n=1e8
                (spill mode) and at n=1e7 with its pieces kept on the
                card, then copied to the host; the device bucket pass with
                host grouping (index/build.py, the engines' default) at
                n=1e8 beside the host build; every index's pieces tile the
                window starts in pieces of at most the cap, its keys
                ascend; the chunked bucket pass equals one pass over the
                whole resident series, bit for bit;
9. stream    -- device_data="stream" over the n=1e8 full index: the 8
                cNSM-ED north-star queries as a batch and each alone, equal
                to a resident engine's answers (host phase 1 both); at
                n=1e6 the four engines streamed (one of them in several
                staged groups) against the oracle, and device_data="host"
                on the RSM-ED README demo and one RSM-DTW query with no
                device memory allocated; launch counts of the streamed
                engines' queries alone, each counted from 0 just before the
                streamed engine runs and read just after (K2, K3 and DS
                must each launch);
10. persist  -- the n=1e8 device-bucket index saved and loaded with
                IndexNpzStore and IndexFileStore (the reference layout, at
                FILE_STORE_N points), every array equal; the cNSM-ED north
                star over the loaded index equal to the saved one's (and
                query_batch_device); the n=1e7 keep_device index saves equal
                to its host form; a stats-only index raises on save;
11. append   -- StreamingIndexBuilder over the n=1e8 series in 100 chunks,
                build() after 99 and 100, each equal to build_index_host
                over the prefix bit for bit;
12. cli      -- python -m kvmatch_tpu_torch.cli as subprocesses: at n=1e8
                generate-data, build-index, and query --index on a selective
                cNSM-ED north-star offset (K2) and an RSM-DTW single (K3,
                DS), equal to the in-process engine; at n=1e6 the four
                engines and four twins against the CLI's oracle, workload
                (missed=0) and export-queries; fit_cost_model for both
                families (each query alone) and the north star under
                QueryConfig.h100_tuned equal to the default;
13. baselines -- UcrScanner at n=1e8 (scan_nsm_ed on the 8 north-star
                queries, scan_ed on the RSM-ED README demo, scan_dtw on the
                RSM-DTW singles) and the scalar twins (the selective cNSM-ED
                queries, the RSM-DTW singles), each equal to the index
                engine, with both times (medians of 3 after a warm run).
                The launches of the cli, baselines and append paths are
                counted as the stream phase's are;
14. bench    -- python -m kvmatch_tpu_torch.bench in process (bench.run) at
                n=1e6 with --quick --no-northstar: every quick section
                runs with no error, the demo is exact, every self-query
                found; then utils/kernel_bench's measure_kernel_efficiency
                and compare_window_kernel (K2 timed as in kernels) on the
                n=1e8 series;
15. selectivity -- the calibrated selectivity matrix (selectivity.py) of
                RSM-ED and cNSM-ED at n=1e8, L=8192 over the resident
                series and stats-only index, SELECTIVITY_PER_DECADE
                queries a decade: no false dismissal; the launches of
                both paths counted as above;
16. sharded  -- parallel/ on a mesh of SHARDS shards (cuda:0 repeated, or
                SHARDS cards when visible): build_index_sharded at n=1e8,
                its stack bit-equal to the single-device stack and its
                index to build_index_device_buckets's; the five sharded
                steps through run_sharded_step_with_recovery (the RSM-ED
                README demo, the 8 north-star windows as RSM-ED queries,
                the cNSM-ED north star, whose floods must escalate top_k,
                RSM-DTW on the selective singles with K3 and with K4, and
                cNSM-DTW at n=1e6), every answer set after the f64 confirm
                equal to the resident engine's (the oracle's at n=1e6),
                each step's seconds beside the engine's (and the (B, L) of
                the cNSM-ED step's K2 calls); the halo bytes;
                dryrun_multichip(SHARDS); launches counted as above.

The plain DP versions the kernels are held to (ops/dtw.py: dtw_diag_plain,
dtw_ds_diag_plain, dtw_rows_plain, dtw_banded_ds_plain) run their steps in
blocks, each full block a replayed CUDA graph, bit-equal to their eager
loop (tests/test_torch_plain_blocks.py); each call here must replay one.

Then the time line ({"phase": "time", ...}: the seconds of each phase, of
each plain DP call and of the whole run), the kernel table
({"kernels": [...]}), the nvidia-smi name/power line and, last,
{"ok": true, "device": {...}}.  The env line carries each
kernel's registers and spill bytes (cuobjdump -res-usage).  A failing
phase raises and the script exits non-zero without the last line; so does a run that loaded jax
or a module of the JAX package kvmatch_tpu (the port stands alone), a
machine without a CUDA device, or a directory without the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

START = time.perf_counter()
REPO = Path(__file__).resolve().parent
if not (REPO / "kvmatch_tpu_torch" / "csrc").is_dir():
    print(f"chip_smoke: {REPO} is not a checkout of the repository",
          file=sys.stderr)
    sys.exit(2)
sys.path.insert(0, str(REPO))
# The one roofline of the port (bound_ms, bound_by) and its timer.
from kvmatch_tpu_torch.utils.kernel_bench import (  # noqa: E402
    CONS_OPS_PAIR, CONS_OPS_POS, DP_OPS, DS_OPS, K1_OPS, K1_OPS_FULL,
    K1_TRACK_OPS, K2_F64_SHAPES, K2_QUERIES, K2_SHAPES, band_cells, bound,
    card_line, cons_and_work, k2_work, near_work, region_near, timed_ms,
    window_f64_times, window_kernel_times, _timed)

# Seconds of each phase, and of each plain DP call (plain_call), for the
# time line.
PHASE_S: dict = {}
PLAIN_S: dict = {}
L_MAIN = 8192
N_MAIN = 100_000_000
ALPHA, BETA, EPS = 1.2, 5.0, 4.0
K2_BATCH = 16384  # verify.bucket_size's cap for rows of width 8192
RHO_MAIN = 409    # 0.05 L, bench.py:328
DTW_BATCH = 1024  # one DP bucket of the kernels phase
L_RSM_DTW, RHO_RSM, EPS_RSM = 1024, 51, 6.0  # bench.py:257-265
# cNSM-DTW batches of main_dtw send all 8 north-star queries (five of them
# flood: 2.8M-9.4M candidates).  n and L are not cut.
MAIN_DTW_QUERIES = 8
# Timed cNSM-DTW batches of main_dtw, between its warm batch and its spanned
# one.  A depth cut from 2: with 2 the script ran 1,243 s, past its limit
# (64.7 and 68.5 s a batch; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §4).
MAIN_DTW_REPS = 1
# K3 bit for bit against its twin, as (L, r, rows): one warp per row at
# r = 51 and r = 409 (the main path's instantiation, C = 26), several warps
# at r = 1100 (clamped to L - 1), and a few rows at the main path's shape.
# DS is held against dtw_ds_diag_plain in the same cases.
K3_BITWISE_CASES = ((1024, 51, 256), (1024, 409, 256), (1024, 1100, 256),
                    (L_MAIN, RHO_MAIN, 8))
# Bands wider than one block of K3 holds, as (L, r, rows): the first past
# the one-block limit (K3_BLOCK_MAX_R + 1, a cluster of 2 blocks) and the
# first of a cluster of 3 blocks (r = 26,624, 65 warps).  K4's carries are
# in its global workspace at both.
WIDE_BAND_CASES = ((13_313, 13_312, 2), (26_625, 26_624, 2))
# The engines on such a band, 2 self-queries each: (engine, n, L, rho, eps).
# A query of more than 12,024 points needs more than the default 30 plan
# segments (44 at L = 16,384: segments of 1-16 units of 25 points); K1 packs
# at most 30, so these plans take host phase 1 over a host-built index.
WIDE_ENGINE_SHAPES = (("rsm_dtw", 17_000, 16_384, 13_500, EPS_RSM),
                      ("cnsm_dtw", 17_000, 16_384, 13_500, EPS))
WIDE_MAX_SEGMENTS = 64
# K3's and DS's global form: the first band past a cluster of 8 blocks
# (ops/dtw.py:K3_MAX_R = 106,495), as (L, r, rows).
GLOBAL_CASE = (106_600, 106_599, 2)
# build_full: the full device build at N_MAIN (spill mode, above
# index/device_build.py:SPILL_N) and at N_KEEP with its pieces kept on the
# card.
N_KEEP = 10_000_000
# stream at n=1e6 (the exact phases' series and their self-queries): each
# engine streamed, as (engine, L, rho, eps); the first with its staging
# budget lowered to STREAM_SMALL_STAGE points so that it stages several
# groups.  RSM-ED takes RSM-DTW's eps.
STREAM_SMALL_SHAPES = (("rsm_ed", 1024, 0, EPS_RSM),
                       ("cnsm_ed", 1024, 0, EPS),
                       ("rsm_dtw", L_RSM_DTW, RHO_RSM, EPS_RSM),
                       ("cnsm_dtw", 1024, 51, EPS))
STREAM_SMALL_STAGE = 1 << 14
# persist: the reference-layout IndexFileStore round trip at this many
# points.  A depth cut: its loader decodes codec groups one by one in Python;
# at n=1e8 (1.5e8 pieces) the load took 455.6 s on the card's host, at n=1e7
# 38.8 s in a run of 1,243 s, past the script's limit (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §4).
FILE_STORE_N = 1_000_000

# exact_dtw: (engine, n, L, rho, eps)
DTW_EXACT_SHAPES = (("rsm_dtw", 1_000_000, L_RSM_DTW, RHO_RSM, EPS_RSM),
                    ("cnsm_dtw", 1_000_000, 1024, 51, EPS),
                    ("cnsm_dtw", 1_000_000, L_MAIN, RHO_MAIN, EPS))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def plain_call(plain, args, what: str):
    """One synchronized call of a plain DP version of ops/dtw.py: (its
    result, ms).  Its seconds add to PLAIN_S under ``what`` and its name;
    a version that runs its steps as CUDA graphs (``graph_replays``) must
    have replayed one."""
    import torch
    replays = getattr(plain, "graph_replays", None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = plain(*args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if replays is not None and plain.graph_replays <= replays:
        raise AssertionError(f"{plain.__name__} ({what}): no CUDA graph "
                             f"replayed")
    key = f"{what}: {plain.__name__}"
    PLAIN_S[key] = PLAIN_S.get(key, 0.0) + sec
    return out, sec * 1e3


def self_queries(data, n_queries: int, length: int, seed: int):
    import numpy as np
    offs = np.random.default_rng(seed).integers(0, data.size - length,
                                                n_queries)
    return offs, np.stack([data[o:o + length] for o in offs])


def norm_ctxs(queries, eps: float, **params):
    from kvmatch_tpu_torch.engine.base import QueryStats, _Ctx
    return [_Ctx(query=q, length=q.size, epsilon=eps, eps2=eps * eps,
                 params={"alpha": ALPHA, "beta": BETA, **params},
                 stats=QueryStats())
            for q in queries]


# ------------------------------------------------------------- phase 2 ----
def check_probe_kernel(eng, bstack, queries, device, norm: bool = True,
                       **params) -> dict:
    """K1 over the cached bucket stack ``bstack`` with the plans ``eng``
    makes for the batch, against the plain version: counts and flags must
    be equal.  A cNSM-DTW engine (``rho=``) plans envelope segments
    (mean_lo < mean_hi); a raw engine with ``norm=False`` RSM-ED plans.
    The bound counts the work this data needs (ops/probe.py:probe_work):
    the open terms' operations and the distinct stack entries they read."""
    import torch
    from kvmatch_tpu_torch.ops.probe import (FLAG, pack_segments_batch,
                                             probe_flags, probe_flags_plain,
                                             probe_work)
    if bstack is None:
        raise RuntimeError("bucket stack does not fit the device budget")
    L = queries.shape[1]
    ctxs = norm_ctxs(queries, EPS, **params)
    plans = eng._plan_batch(ctxs)
    icfg = eng.icfg
    segs = pack_segments_batch(plans, tuple(icfg.scales), device)
    eps2 = torch.full((len(ctxs),), EPS * EPS, dtype=torch.float32,
                      device=device)
    cons = torch.tensor([[ALPHA, BETA, c.params["_mu_q"], c.params["_sd_q"]]
                         if norm else [0.0] * 4 for c in ctxs],
                        dtype=torch.float32, device=device)
    m = eng.n - L + 1
    npos = -(-m // FLAG) * FLAG
    Q = len(ctxs)

    def run(fn):
        flags = torch.zeros((Q, npos // FLAG), dtype=torch.bool, device=device)
        counts = torch.zeros(Q, dtype=torch.int32, device=device)
        fn(bstack, 0, segs, eps2, cons, 0, npos, m, flags, counts, length=L,
           unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard, norm=norm)
        return counts, flags

    got, want = run(probe_flags), run(probe_flags_plain)
    count_err = int((got[0].long() - want[0].long()).abs().max())
    flag_diff = int((got[1] != want[1]).sum())
    if count_err or flag_diff:
        raise AssertionError(f"K1 (norm={norm}) disagrees with its plain "
                             f"version: count error {count_err}, {flag_diff} "
                             f"flags differ")
    terms, reads = probe_work(bstack, segs, eps2, cons, m, unit=icfg.unit,
                              d=icfg.d, slack=icfg.probe_guard, norm=norm)
    n_segs = sum(len(p) for p in plans)
    open_terms = sum(sum(t[:-1]) for t in terms)
    ops = K1_OPS[norm] * open_terms
    if norm:
        ops += K1_TRACK_OPS * sum(t[-1] * len(p) for t, p in zip(terms, plans))
    out_bytes = Q * (npos // FLAG + 4)
    res = dict(counts=got[0].tolist(), flagged_blocks=int(got[1].sum()),
               max_abs_err=count_err, flags_differ=flag_diff,
               ms=timed_ms(lambda: run(probe_flags), 5, device),
               plain_ms=timed_ms(lambda: run(probe_flags_plain), 1, device),
               segments=[len(p) for p in plans], open_terms=open_terms,
               full_terms=n_segs * npos, stack_rows_read=reads,
               bound_full_ms=bound(bstack.shape[0] * npos * 4 + out_bytes,
                                   K1_OPS_FULL * n_segs * npos)["bound_ms"],
               envelope_segments=sum(s.mean_lo < s.mean_hi
                                     for p in plans for s in p),
               **bound(4 * sum(reads) + out_bytes, ops))
    return res


def check_cons_kernel(eng, queries, device, **params) -> dict:
    """The constraint AND (``cons_and``) over the engine's cached window
    statistics at the batch's length, on K1's flags of the plans ``eng``
    makes for the batch (the serving path's inputs), against the plain
    version: the flags must be
    equal.  Each timed call starts from a copy of K1's flags (``copy_ms``,
    included).  The bound counts the work these flags need: the kernel
    reads the statistics of a column only where K1 flagged it for some
    query, every flag byte, CONS_OPS_POS a position read and CONS_OPS_PAIR
    a position of a flagged (query, column); ``bound_full_ms`` is every
    column's (kernel_bench.cons_and_work)."""
    import torch
    from kvmatch_tpu_torch.ops.probe import (FLAG, cons_and, cons_and_plain,
                                             pack_segments_batch, probe_flags)
    L = queries.shape[1]
    stats3 = eng.probe.cons_stats(L, eng.CACHE_MEM_FRACTION)
    bstack = eng.probe.bucket_stack(L, eng.CACHE_MEM_FRACTION)
    if stats3 is None or bstack is None:
        raise RuntimeError("cached statistics do not fit the device budget")
    ctxs = norm_ctxs(queries, EPS, **params)
    plans = eng._plan_batch(ctxs)
    icfg = eng.icfg
    segs = pack_segments_batch(plans, tuple(icfg.scales), device)
    eps2 = torch.full((len(ctxs),), EPS * EPS, dtype=torch.float32,
                      device=device)
    cons = torch.tensor([[ALPHA, BETA, c.params["_mu_q"], c.params["_sd_q"]]
                         for c in ctxs], dtype=torch.float32, device=device)
    m = eng.n - L + 1
    npos = -(-m // FLAG) * FLAG
    Q = len(ctxs)
    k1 = torch.zeros((Q, npos // FLAG), dtype=torch.bool, device=device)
    probe_flags(bstack, 0, segs, eps2, cons, 0, npos, m, k1,
                torch.zeros(Q, dtype=torch.int32, device=device), length=L,
                unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard, norm=True)
    flags = torch.empty_like(k1)

    def run(fn):
        flags.copy_(k1)
        fn(*stats3, cons, 0, npos, m, L, flags)
        return flags

    got = run(cons_and).clone()
    want = run(cons_and_plain)
    flag_diff = int((got != want).sum())
    if flag_diff:
        raise AssertionError(f"the constraint AND disagrees with its plain "
                             f"version: {flag_diff} flags differ")
    k1_set = k1.sum(1)
    cleared = (k1 & ~got).sum(1)
    cols_read = int(k1.any(0).sum())
    pairs = int(k1_set.sum())
    res = dict(k1_flagged=k1_set.tolist(), cleared=cleared.tolist(),
               cleared_share=float(cleared.sum()) / max(pairs, 1),
               columns=npos // FLAG, columns_read=cols_read,
               flags_differ=flag_diff,
               ms=timed_ms(lambda: run(cons_and), 5, device),
               plain_ms=timed_ms(lambda: run(cons_and_plain), 1, device),
               copy_ms=timed_ms(lambda: flags.copy_(k1), 5, device),
               bound_full_ms=cons_and_work(npos, Q)["bound_ms"],
               **bound(12 * FLAG * cols_read + Q * npos / FLAG,
                       FLAG * (CONS_OPS_POS * cols_read
                               + CONS_OPS_PAIR * pairs)))
    return res


#: The region near-set check (check_region_near_kernel): the benchmark
#: cells' length and constraint (alpha 1.5, beta 5 x BETA_BASE[4]), and the
#: eps it widens until the main batch's candidates fill NEAR_MIN_ROWS rows.
NEAR_L, NEAR_ALPHA, NEAR_BETA = 4096, 1.5, 282.65
NEAR_EPS = (8.0, 16.0, 32.0)
NEAR_MIN_ROWS = 1024
#: The f32 ulps of a limit within which the kernels and the plain chain may
#: decide a window differently (tests/test_torch_kernels_cuda.py).
NEAR_ULPS = 16


def check_region_near_kernel(eng, data, offs, device) -> dict:
    """The region near-set kernels (``ops/regions.region_znorm_near_multi``,
    csrc/regions.cu) on the main batch's region rows at L = NEAR_L: the
    batch's self-queries at the main offsets, probed by the engine (K1 and
    the AND) and packed as ``_verify_regions`` packs them (coalesced runs,
    rows of M = ``_region_m``), the first ``verify.bucket_size`` chunk with
    the engine's guarded thresholds and constraint rows, against the plain
    chain (``region_znorm_near_plain``): the counts, and the sets equal but
    for windows within NEAR_ULPS f32 ulps of a limit.  Times: the kernels'
    call and the plain chain's (CUDA events), and ``kernel_bench``'s
    ``region_near`` section (``section_ms``: the same rows shifted a point a
    call); the bound is ``near_work`` over the chunk's rows that are not
    padding."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch import verify as vf
    from kvmatch_tpu_torch.ops.regions import (coalesce_intervals,
                                               pack_regions,
                                               region_znorm_distances_multi,
                                               region_znorm_near_multi,
                                               region_znorm_near_plain)
    L = NEAR_L
    queries = np.stack([data[o:o + L] for o in offs])
    for eps in NEAR_EPS:
        ctxs = norm_ctxs(queries, eps, alpha=NEAR_ALPHA, beta=NEAR_BETA)
        cand = eng._probe_dense(ctxs, eng._plan_batch(ctxs))
        runs = sum(int(np.sum(r - l + 1)) for l, r in cand if l.size)
        n_runs = sum(l.size for l, _ in cand)
        M = eng._region_m(L, runs / max(n_runs, 1))
        merged = [coalesce_intervals(l, r, M) for l, r in cand]
        packed = [pack_regions(l, r, eng.n, L, M) + (qi,)
                  for qi, (l, r) in enumerate(merged) if l.size]
        if sum(p[0].size for p in packed) >= NEAR_MIN_ROWS:
            break
    if not packed:
        raise AssertionError("the main batch has no candidates at L = "
                             f"{L}, eps up to {NEAR_EPS[-1]}")
    starts, vfrom, vto = (np.concatenate([p[k] for p in packed])
                          for k in range(3))
    qids = np.concatenate([np.full(p[0].size, p[3], np.int32)
                           for p in packed])
    rows = starts.size
    B = vf.bucket_size(rows, lo=32, hi=8192, width=M + L - 1)
    real = min(rows, B)
    pad = B - real

    def dev(a, dt):
        a = np.concatenate([a[:real], np.zeros(pad, a.dtype)])
        return torch.as_tensor(a, dtype=dt, device=device)
    qm = torch.as_tensor(np.stack([eng._qhat(c) for c in ctxs]),
                         dtype=torch.float32, device=device)
    th = torch.as_tensor(eng._guarded_threshs(ctxs), dtype=torch.float32,
                         device=device)
    cons_np = np.stack([[c.params["alpha"], c.params["beta"],
                         c.params["_mu_q"], c.params["_sd_q"],
                         1e-3 * (1.0 + abs(c.params["_mu_q"])
                                 + c.params["_sd_q"])]
                        for c in ctxs]).astype(np.float32)
    cons = torch.as_tensor(cons_np, device=device)
    args = (eng.data_dev, qm, dev(starts, torch.int64),
            dev(qids, torch.int32), dev(vfrom, torch.int64),
            dev(vto, torch.int64), th, cons, L, M)
    near_k = B * M

    def pairs(res):
        cnt = int(res[0])
        k = min(cnt, near_k)
        return cnt, set(zip(res[1][:k].tolist(), res[2][:k].tolist()))
    before = region_znorm_near_multi.launches
    cnt, got = pairs(region_znorm_near_multi(*args, near_k))
    if region_znorm_near_multi.launches != before + 1:
        raise AssertionError("region_znorm_near_multi launched no kernel")
    want_cnt, want = pairs(region_znorm_near_plain(*args, near_k))
    diff = sorted(got ^ want)
    far = []
    if diff:
        d2, mean, std, err = (t.cpu().numpy() for t in
                              region_znorm_distances_multi(*args[:4], L, M))
        thn = th.cpu().numpy()
        qn = args[3].cpu().numpy()
        eps32 = float(np.finfo(np.float32).eps)
        for r, c in diff:
            a, b, mq, sq, cg = cons_np[qn[r]]
            lim = thn[qn[r]] + err[r, c]
            ratio = std[r, c] / sq
            gap = min(abs(lim - d2[r, c]) / (eps32 * (2 * L + abs(lim))),
                      abs(b + cg - abs(mean[r, c] - mq))
                      / (eps32 * (abs(mean[r, c]) + abs(mq) + b)),
                      abs(a + cg - ratio) / (eps32 * (a + ratio)),
                      abs(ratio - (1 / a - cg)) / (eps32 * (a + ratio)))
            if gap > NEAR_ULPS:
                far.append((int(r), int(c), float(gap)))
    if cnt != len(got) or far:
        raise AssertionError(f"the near-set kernels disagree with the plain "
                             f"chain: count {cnt} for {len(got)} pairs, "
                             f"{len(far)} of {len(diff)} differing pairs "
                             f"beyond {NEAR_ULPS} ulps: {far[:10]}")
    work = near_work(real, L, M)
    ms = timed_ms(lambda: region_znorm_near_multi(*args, near_k), 10, device)
    sec = region_near(*args, near_k)
    return dict(eps=eps, L=L, M=M, rows=rows, chunk_rows=B, real_rows=real,
                count=cnt, count_plain=want_cnt, sets_equal=not diff,
                differ=len(diff), ms=ms,
                plain_ms=timed_ms(lambda: region_znorm_near_plain(
                    *args, near_k), 3, device),
                section_ms=_timed(sec.fn, 10, device, 3),
                share_of_bound=work["bound_ms"] / ms, **work)


def k2_held(args, what: str) -> dict:
    """K2 (``window_ed``) against its plain version on ``args`` within
    |dd2| <= 1e-5 L + 1e-5 d2 and |dmean|, |dstd| <= 1e-5 max|x|; raises
    beyond them.  Returns the errors and the plain call's ms."""
    import torch
    from kvmatch_tpu_torch.ops.ed import _gather, window_ed, window_ed_plain
    data_dev, _qm, offs, _qids, L, znorm = args
    got = window_ed(*args)
    torch.cuda.synchronize(data_dev.device)
    t0 = time.perf_counter()
    want = window_ed_plain(*args)
    torch.cuda.synchronize(data_dev.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    g = got if znorm else (got,)
    w = want if znorm else (want,)
    finite = torch.isfinite(w[0])
    if not torch.equal(torch.isfinite(g[0]), finite):
        raise AssertionError(f"K2 {what}: infinite rows differ")
    err = (g[0] - w[0]).abs()[finite]
    tol = 1e-5 * L + 1e-5 * w[0].abs()[finite]
    if bool((err > tol).any()):
        raise AssertionError(f"K2 {what}: d2 error {float(err.max())} "
                             f"beyond 1e-5 L + 1e-5 d2")
    scale = _gather(data_dev, offs, L).abs().amax(dim=1)
    stat_err = max([float(((a - b).abs() / scale).max())
                    for a, b in zip(g[1:], w[1:])], default=0.0)
    if stat_err > 1e-5:
        raise AssertionError(f"K2 {what}: mean/std error {stat_err} of "
                             f"max|x| beyond 1e-5")
    return dict(max_abs_err=float(err.max()),
                max_err_over_bound=float((err / tol).max()),
                stat_err_rel=stat_err, plain_ms=plain_ms)


def check_window_kernel(data_dev, queries, device, batch: int) -> dict:
    """K2 raw and z-norm against the plain version (``k2_held``): at
    (batch, L) with the north-star queries, then at each (B, L) of
    K2_SHAPES on rows of K2_QUERIES series windows; then K2's times at
    K2_SHAPES by ``window_kernel_times`` (the kernel's device time alone,
    the wrapper's host time, torch.cdist's device time for the raw form),
    the one timer of K2."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch.ops.ed import _gather
    Q, L = queries.shape
    n = data_dev.shape[0]
    rng = np.random.default_rng(5)
    offs = torch.as_tensor(rng.integers(0, n - L + 1, batch), device=device)
    qids = torch.as_tensor(rng.integers(0, Q, batch).astype(np.int32),
                           device=device)
    qraw = torch.as_tensor(queries, dtype=torch.float32, device=device)
    mu = queries.mean(axis=1, keepdims=True)
    sd = queries.std(axis=1, keepdims=True)
    qhat = torch.as_tensor((queries - mu) / sd, dtype=torch.float32,
                           device=device)
    out = {name: dict(k2_held((data_dev, qm, offs, qids, L, znorm), name),
                      **k2_work(batch, L, Q, znorm))
           for name, qm, znorm in (("raw", qraw, False),
                                   ("znorm", qhat, True))}
    held = {}
    for B, Ls in K2_SHAPES:
        offs = torch.as_tensor(rng.integers(0, n - Ls + 1, B), device=device)
        qids = torch.as_tensor(np.sort(rng.integers(0, K2_QUERIES, B))
                               .astype(np.int32), device=device)
        qr = _gather(data_dev, torch.as_tensor(rng.integers(
            0, n - Ls + 1, K2_QUERIES), device=device), Ls).contiguous()
        qh = ((qr - qr.mean(1, keepdim=True))
              / qr.std(1, unbiased=False, keepdim=True)).contiguous()
        held[f"B{B}_L{Ls}"] = {
            name: k2_held((data_dev, qm, offs, qids, Ls, name == "znorm"),
                          f"{name} B={B} L={Ls}")
            for name, qm in (("raw", qr), ("znorm", qh))}
    t0 = time.perf_counter()
    out["shapes"] = window_kernel_times(data_dev)
    out["times_s"] = time.perf_counter() - t0
    for tag, entry in out["shapes"].items():
        for name in ("raw", "znorm"):
            entry[name].update(held[tag][name])
    return out


def check_window_f64(data_dev, device) -> dict:
    """K2's f64 form (``window_ed_f64``, the card's exact confirm) against
    window_ed_plain's f64 mode at each (B, L) of K2_F64_SHAPES, the cells'
    confirm loads, on rows of K2_QUERIES z-normalized series windows: d2 and
    std within 1e-12 relative (d2 within 1e-12 L near 0), the mean within
    1e-12 of the window's max |x|; raises beyond them.  Then its times by
    ``window_f64_times`` (the kernel alone, the wrapper's host time, the
    plain version's, the bound)."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch.ops.ed import _gather, window_ed_f64, window_ed_plain
    n = data_dev.shape[0]
    rng = np.random.default_rng(17)
    held = {}
    for B, L in K2_F64_SHAPES:
        offs = torch.as_tensor(rng.integers(0, n - L + 1, B), device=device)
        qids = torch.as_tensor(np.sort(rng.integers(0, K2_QUERIES, B))
                               .astype(np.int32), device=device)
        q = _gather(data_dev, torch.as_tensor(rng.integers(
            0, n - L + 1, K2_QUERIES), device=device), L).double()
        qh = ((q - q.mean(1, keepdim=True))
              / q.std(1, unbiased=False, keepdim=True)).contiguous()
        got = window_ed_f64(data_dev, qh, offs, qids, L)
        want = torch.stack(window_ed_plain(data_dev, qh, offs, qids, L,
                                           znorm=True))
        if got.dtype != torch.float64:
            raise AssertionError(f"K2 f64 B={B} L={L}: {got.dtype} out")
        finite = torch.isfinite(want[0])
        if not torch.equal(torch.isfinite(got[0]), finite):
            raise AssertionError(f"K2 f64 B={B} L={L}: infinite rows differ")
        d2_err = ((got[0] - want[0]).abs()
                  / torch.clamp(want[0].abs(), min=L))[finite]
        std_err = (got[2] - want[2]).abs() / want[2].abs().clamp(
            min=torch.finfo(torch.float64).tiny)
        scale = _gather(data_dev, offs, L).abs().amax(dim=1).double()
        mean_err = (got[1] - want[1]).abs() / scale
        errs = dict(d2_err_rel=float(d2_err.max()),
                    std_err_rel=float(std_err.max()),
                    mean_err_rel=float(mean_err.max()))
        if max(errs.values()) > 1e-12:
            raise AssertionError(f"K2 f64 B={B} L={L}: {errs} beyond 1e-12")
        held[f"B{B}_L{L}"] = errs
    t0 = time.perf_counter()
    shapes = window_f64_times(data_dev)
    for tag, entry in shapes.items():
        entry.update(held[tag])
    return dict(shapes=shapes, times_s=time.perf_counter() - t0)


def znormed_windows(data_dev, device, rng, L: int, batch: int):
    """z-normed windows of the series at random offsets, (batch, L) f32."""
    import torch
    from kvmatch_tpu_torch.ops import dtw as td
    from kvmatch_tpu_torch.ops.ed import _gather
    offs = torch.as_tensor(rng.integers(0, data_dev.shape[0] - L + 1, batch),
                           device=device)
    return td._znorm_rows(_gather(data_dev, offs, L), L)[0]


def check_bitwise(data_dev, queries, device, kernel: str = "K3",
                  cases=K3_BITWISE_CASES) -> dict:
    """A DP kernel against its plain version in its own order, bit for bit,
    on z-normed windows of the series against the z-normed first L points
    of the north-star queries, for each (L, r, rows) of ``cases``: K3
    against dtw_diag_plain, DS against dtw_ds_diag_plain (hi and lo), K4
    against dtw_rows_plain on rows one warp holds; K4's block form (2r + 1
    > K4_WARP_LANES) within guard_threshold(d, L, 1e-2) of
    dtw_banded_plain."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch import verify
    from kvmatch_tpu_torch.ops import dtw as td
    fn, own = {"K3": (td.dtw_diag, td.dtw_diag_plain),
               "DS": (td.dtw_ds, td.dtw_ds_diag_plain),
               "K4": (td.dtw_rows, td.dtw_rows_plain)}[kernel]
    Q = queries.shape[0]
    rng = np.random.default_rng(8)
    out = {}
    for L, r, batch in cases:
        z = znormed_windows(data_dev, device, rng, L, batch)
        qids = torch.as_tensor(rng.integers(0, Q, batch).astype(np.int32),
                               device=device)
        qs = queries[:, :L]
        qhat = torch.as_tensor((qs - qs.mean(1, keepdims=True))
                               / qs.std(1, keepdims=True),
                               dtype=torch.float32, device=device)
        bitwise = not (kernel == "K4"
                       and 2 * min(r, L - 1) + 1 > td.K4_WARP_LANES)
        plain = own if bitwise else td.dtw_banded_plain
        got = fn(z, qhat, qids, r)
        want, plain_ms = plain_call(plain, (z, qhat, qids, r),
                                    f"{kernel} bitwise L{L}_r{r}")
        got, want = ((got, want) if kernel == "DS" else ((got,), (want,)))
        res = dict(rows=batch, bit_equal=bitwise, finite=bool(
            torch.isfinite(got[0]).all()), plain=plain.__name__,
            plain_ms=plain_ms, ms=timed_ms(lambda: fn(z, qhat, qids, r), 3,
                                           device))
        if bitwise:
            differ = sum(int((g != w).sum()) for g, w in zip(got, want))
            if differ:
                raise AssertionError(
                    f"{kernel} L={L} r={r}: {differ} of {batch} rows (x "
                    f"{len(got)} outputs) differ from {plain.__name__}")
        else:
            w = want[0].double()
            ratio = float(((got[0].double() - w).abs()
                           / verify.guard_threshold(w, L, 1e-2)).max())
            if not ratio <= 1.0:
                raise AssertionError(f"K4 L={L} r={r}: error {ratio} of the "
                                     f"guard band of dtw_banded_plain")
            res["max_err_over_bound"] = ratio
        out[f"L{L}_r{r}"] = res
    return out


def check_dtw_kernels(data_dev, queries, device, batch: int = DTW_BATCH,
                      r: int = RHO_MAIN, chunk: int = 16384) -> dict:
    """K3 (dtw_diag), K4 (dtw_rows) and the DS kernel on one DP bucket of
    ``batch`` windows of the series against the north-star queries, raw and
    z-normed.  K3 and K4: |d - d_plain| <= verify.guard_threshold(d_plain, L,
    1e-2), and K3 within the same band of K4.  DS: hi + lo within
    8 eps32 (d64 + 1) of the f64 DP of the same f32 inputs (the plain
    version run in float64 on the card).  K3 and K4 are also timed on
    ``chunk`` z-normed rows, the engine's largest launch at this L (16
    times the warps of a bucket: how far each is held by latency)."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch import verify
    from kvmatch_tpu_torch.ops import dtw as td
    from kvmatch_tpu_torch.ops.ed import _gather
    Q, L = queries.shape
    rng = np.random.default_rng(7)
    offs = torch.as_tensor(rng.integers(0, data_dev.shape[0] - L + 1, batch),
                           device=device)
    qids = torch.as_tensor(rng.integers(0, Q, batch).astype(np.int32),
                           device=device)
    x = _gather(data_dev, offs, L)
    z, _, _ = td._znorm_rows(x, L)
    mu = queries.mean(axis=1, keepdims=True)
    sd = queries.std(axis=1, keepdims=True)
    eps32 = float(np.finfo(np.float32).eps)
    qraw = torch.as_tensor(queries, dtype=torch.float32, device=device)
    qhat = torch.as_tensor((queries - mu) / sd, dtype=torch.float32,
                           device=device)
    out = {}
    for name, rows, qm in (("raw", x, qraw), ("znorm", z, qhat)):
        args = (rows, qm, qids, r)
        plain, plain_ms = plain_call(td.dtw_banded_plain, args,
                                     f"dtw {name}")
        plain = plain.double()
        res = dict(plain_ms=plain_ms)
        band = verify.guard_threshold(plain, L, 1e-2)
        got = {}
        for fn in (td.dtw_diag, td.dtw_rows):
            got[fn.__name__] = d = fn(*args).double()
            ratio = float(((d - plain).abs() / band).max())
            if not ratio <= 1.0:
                raise AssertionError(f"{fn.__name__} {name}: error "
                                     f"{ratio} of the guard band")
            res[fn.__name__] = dict(
                max_abs_err=float((d - plain).abs().max()),
                max_err_over_bound=ratio,
                ms=timed_ms(lambda fn=fn: fn(*args), 3, device))
        cross = float(((got["dtw_diag"] - got["dtw_rows"]).abs()
                       / band).max())
        if not cross <= 1.0:
            raise AssertionError(f"K3 vs K4 {name}: {cross} of the band")
        d64, _ = plain_call(td.dtw_banded_plain,
                            (rows.double(), qm.double(), qids, r),
                            f"dtw {name} f64")
        tol = 8.0 * eps32 * (d64 + 1.0)
        hi, lo = td.dtw_ds(*args)
        err = (hi.double() + lo.double() - d64).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"dtw_ds {name}: error {float(err.max())} "
                                 f"beyond 8 eps32 (d64 + 1)")
        res.update(k3_vs_k4_over_bound=cross, dtw_ds=dict(
            max_abs_err=float(err.max()),
            max_err_over_bound=float((err / tol).max()),
            ms=timed_ms(lambda: td.dtw_ds(*args), 3, device)),
            d2_median=float(plain.median()))
        out[name] = res
        if name == "raw":
            # The DS plain version: L rows of log-step pair scans, about 2M
            # small launches; timed once, on the raw rows.
            (hi, lo), plain_ms = plain_call(td.dtw_banded_ds_plain, args,
                                            f"dtw {name}")
            err = (hi.double() + lo.double() - d64).abs()
            res["dtw_ds"].update(
                plain_ms=plain_ms,
                plain_max_err_over_bound=float((err / tol).max()))
    cells = batch * band_cells(L, r)
    io = batch * L * 4 + Q * L * 4 + batch * 8
    offs = torch.as_tensor(rng.integers(0, data_dev.shape[0] - L + 1, chunk),
                           device=device)
    qids = torch.as_tensor(rng.integers(0, Q, chunk).astype(np.int32),
                           device=device)
    z, _, _ = td._znorm_rows(_gather(data_dev, offs, L), L)
    chunk_bound = bound(io * chunk / batch, DP_OPS * cells * chunk / batch)
    return dict(batch=batch, L=L, r=r, cells=cells,
                dp_bound=bound(io, DP_OPS * cells),
                ds_bound=bound(io + batch * 4, DS_OPS * cells),
                **{f"{k}_chunk": dict(rows=chunk, ms=timed_ms(
                    lambda fn=fn: fn(z, qhat, qids, r), 3, device),
                    **chunk_bound)
                   for k, fn in (("k3", td.dtw_diag), ("k4", td.dtw_rows))},
                **out)


# ------------------------------------------------------------- phase 3 ----
def fft_error(data_dev, queries, device, m_region: int = 8192,
              rows: int = 64) -> dict:
    """max |corr_f32 - corr_f64| / (||x_window|| ||q_hat||) of the batched
    f32 FFT correlation at the region shape, against FFT_ERR_C."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch.ops.ed import _gather
    from kvmatch_tpu_torch.ops.regions import (FFT_ERR_C, _correlate_grouped,
                                               _sliding_sum_rows)
    Q, L = queries.shape
    r_len = m_region + L - 1
    rng = np.random.default_rng(6)
    starts = torch.as_tensor(rng.integers(0, data_dev.shape[0] - r_len, rows),
                             device=device)
    x32 = _gather(data_dev, starts, r_len)
    mu = queries.mean(axis=1, keepdims=True)
    sd = queries.std(axis=1, keepdims=True)
    q32 = torch.as_tensor((queries - mu) / sd, dtype=torch.float32,
                          device=device)[torch.arange(rows, device=device) % Q]
    x64, q64 = x32.double(), q32.double()
    c32 = _correlate_grouped(x32, q32).double()
    c64 = _correlate_grouped(x64, q64)
    norms = torch.sqrt(_sliding_sum_rows(x64 * x64, L)) * \
        torch.linalg.vector_norm(q64, dim=1)[:, None]
    ratio = float(((c32 - c64).abs() / norms).max())
    if not ratio <= FFT_ERR_C:
        raise AssertionError(f"cuFFT correlation error ratio {ratio} exceeds "
                             f"FFT_ERR_C={FFT_ERR_C}")
    return dict(err_ratio_max=ratio, fft_err_c=FFT_ERR_C,
                share_of_bound=ratio / FFT_ERR_C, rows=rows, M=m_region, L=L)


# ------------------------------------------------------------- phase 4 ----
def oracle_key(name: str, L: int, rho: int, eps: float) -> tuple:
    return (name, int(L), int(rho), float(eps))


def oracle_sets(name: str, data, queries, eps: float, rho: int,
                device) -> list:
    """The port's float64 oracle's answer set of each query (on the card)."""
    from kvmatch_tpu_torch import oracle
    out = []
    for q in queries:
        if name == "rsm_ed":
            w = oracle.rsm_ed(data, q, eps, device=device)
        elif name == "cnsm_ed":
            w = oracle.nsm_ed(data, q, eps, alpha=ALPHA, beta=BETA,
                              device=device)
        elif name == "rsm_dtw":
            w = oracle.rsm_dtw(data, q, eps, rho, device=device)
        else:
            w = oracle.cnsm_dtw(data, q, eps, rho, ALPHA, BETA, device=device)
        out.append(set(w[0].tolist()))
    return out


def exact_small(device, oracles: dict, n: int = 1_000_000,
                seed: int = 20260816, cnsm_lengths=(1024, 8192),
                cnsm_queries: int = 4, demo_offset: int = 123456,
                demo_length: int = 8192) -> dict:
    """Answer sets at n=1e6 EQUAL the port's float64 brute-force oracle
    (run on the card): cNSM-ED self-queries through query_batch_device, and
    the RSM-ED README demo with phase 2 forced onto the device (its
    scattered candidates go through K2).  The oracle's sets go into
    ``oracles`` (``oracle_key``) for the streamed engines."""
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngine, QueryConfig,
                                   QueryEngine, generate_series, oracle)
    from kvmatch_tpu_torch.index.device_build import build_index_device_stats
    from kvmatch_tpu_torch.ops.ed import window_ed
    from kvmatch_tpu_torch.state import series_to_device
    icfg = IndexConfig()
    qcfg = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
    data, dev = series_to_device(generate_series(n, seed=seed), device)
    index = build_index_device_stats(data, icfg, data_dev=dev)
    out = dict(n=n)
    t0 = time.perf_counter()
    norm = NormQueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                           device_data=dev)
    answers = {}
    for length in cnsm_lengths:
        offs, qs = self_queries(data, cnsm_queries, length, seed=1)
        res = norm.query_batch_device(qs, EPS, alpha=ALPHA, beta=BETA)
        answers[length] = []
        sets = oracles.setdefault(oracle_key("cnsm_ed", length, 0, EPS), [])
        for o, q, r in zip(offs, qs, res):
            want, _ = oracle.nsm_ed(data, q, EPS, alpha=ALPHA, beta=BETA,
                                    device=device)
            sets.append(set(want.tolist()))
            if set(r.offsets.tolist()) != set(want.tolist()):
                raise AssertionError(f"cNSM-ED n={n} L={length} offset {o}: "
                                     f"answer set differs from the oracle")
            if int(o) not in r.offsets.tolist():
                raise AssertionError(f"cNSM-ED self-query {o} not found")
            answers[length].append(len(want))
    out.update(cnsm_answers=answers, cnsm_equal=True)
    raw = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                      device_data=dev)
    k2_before = window_ed.launches
    q = data[demo_offset:demo_offset + demo_length]
    r = raw.query(q, 10.0)
    want, _ = oracle.rsm_ed(data, q, 10.0, device=device)
    oracles["demo"] = set(want.tolist())
    if set(r.offsets.tolist()) != set(want.tolist()):
        raise AssertionError("RSM-ED README demo: answer set differs from "
                             "the oracle")
    out.update(demo_answers=r.offsets.tolist(),
               demo_k2_launches=window_ed.launches - k2_before,
               demo_candidates=r.stats.n_candidates, demo_equal=True,
               seconds=time.perf_counter() - t0)
    return out


def exact_dtw(device, shapes=DTW_EXACT_SHAPES, seed: int = 20260816,
              n_queries: int = 4, max_segments: int | None = None,
              oracles: dict | None = None) -> dict:
    """DTW answer sets EQUAL the port's float64 oracle (on the card), each
    shape run twice through ``query_batch``: with K3 (``dtw_diag``) and
    with the K4 variant (``dtw_rows``) as the f32 DP.  Phase 1 is the dense
    probe (K1) over the stats-only index, or, with ``max_segments`` (plans
    longer than K1's 30 segments), host phase 1 over a host-built index.
    The oracle's sets go into ``oracles`` (``oracle_key``) when given."""
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngineDtw,
                                   QueryConfig, QueryEngineDtw,
                                   generate_series, oracle)
    from kvmatch_tpu_torch.index.build import build_index_host
    from kvmatch_tpu_torch.index.device_build import build_index_device_stats
    from kvmatch_tpu_torch.ops import dtw as td
    from kvmatch_tpu_torch.state import series_to_device
    icfg = IndexConfig()
    qcfg = (QueryConfig(dense_probe_min_count=0) if max_segments is None
            else QueryConfig(dense_probe_min_count=None,
                             max_segments=max_segments))
    series = {}
    out = []
    for name, n, L, rho, eps in shapes:
        if n not in series:
            data, dev = series_to_device(generate_series(n, seed=seed),
                                         device)
            series[n] = (data, dev, build_index_device_stats(
                data, icfg, data_dev=dev) if max_segments is None
                else build_index_host(data, icfg))
        data, dev, index = series[n]
        offs, qs = self_queries(data, n_queries, L, seed=1)
        norm = name == "cnsm_dtw"
        kw = dict(rho=rho, alpha=ALPHA, beta=BETA) if norm else dict(rho=rho)
        t0 = time.perf_counter()
        want = [oracle.cnsm_dtw(data, q, eps, rho, ALPHA, BETA, device=device)
                if norm else oracle.rsm_dtw(data, q, eps, rho, device=device)
                for q in qs]
        row = dict(engine=name, n=n, L=L, rho=rho, eps=eps,
                   oracle_s=time.perf_counter() - t0,
                   answers=[int(w[0].size) for w in want])
        if oracles is not None:
            oracles[oracle_key(name, L, rho, eps)] = [set(w[0].tolist())
                                                      for w in want]
        eng = (NormQueryEngineDtw if norm else QueryEngineDtw)(
            data, index=index, icfg=icfg, qcfg=qcfg, device_data=dev)
        for variant in ("diag", "rows"):
            td.DTW_STATE["variant"] = variant
            try:
                t0 = time.perf_counter()
                res = eng.query_batch(qs, eps, **kw)
                row[f"{variant}_s"] = time.perf_counter() - t0
            finally:
                td.DTW_STATE["variant"] = "diag"
            for o, r, (w, _) in zip(offs, res, want):
                if set(r.offsets.tolist()) != set(w.tolist()):
                    raise AssertionError(
                        f"{name} n={n} L={L} offset {o} ({variant}): answer "
                        f"set differs from the oracle")
                if int(o) not in r.offsets.tolist():
                    raise AssertionError(f"{name} self-query {o} not found")
            row[f"{variant}_stages"] = dict(eng.stage_counts)
        out.append(row)
    return dict(shapes=out, equal=True)


def global_form(data_dev, device, case=GLOBAL_CASE) -> dict:
    """K3 and DS in their global form (r > K3_MAX_R), one launch each on
    ``case``'s (L, r, rows) of z-normed windows against two z-normed
    windows as queries: bit for bit against dtw_diag_plain and
    dtw_ds_diag_plain, the ms of the checked launch and of the plain
    version, and the bound of the work."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch.ops import dtw as td
    L, r, batch = case
    rng = np.random.default_rng(10)
    args = (znormed_windows(data_dev, device, rng, L, batch),
            znormed_windows(data_dev, device, rng, L, 2),
            torch.as_tensor(np.arange(batch) % 2, dtype=torch.int32,
                            device=device), r)
    if td.k3_form(args[0], r) != "global":
        raise AssertionError(f"L={L} r={r} does not take the global form")
    io = batch * L * 4 + 2 * L * 4 + batch * 4
    cells = batch * band_cells(L, r)
    out = dict(L=L, r=r, rows=batch)
    for fn, plain, work in ((td.dtw_diag, td.dtw_diag_plain,
                             bound(io, DP_OPS * cells)),
                            (td.dtw_ds, td.dtw_ds_diag_plain,
                             bound(io + batch * 4, DS_OPS * cells))):
        before = fn.global_launches
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        if fn.global_launches - before != 1:
            raise AssertionError(f"{fn.__name__} L={L} r={r}: no launch in "
                                 f"the global form")
        want, plain_ms = plain_call(plain, args, f"global L{L}_r{r}")
        got, want = ((got, want) if fn is td.dtw_ds else ((got,), (want,)))
        differ = sum(int((g != w).sum()) for g, w in zip(got, want))
        if differ:
            raise AssertionError(f"{fn.__name__} L={L} r={r}: {differ} "
                                 f"values differ from {plain.__name__}")
        if not bool((want[0] < td.BIG).all()):
            raise AssertionError(f"{plain.__name__} L={L} r={r}: a row "
                                 f"found no path")
        out[fn.__name__] = dict(bit_equal=True, ms=ms, plain_ms=plain_ms,
                                d2=want[0].tolist(), **work)
    return out


def wide_band(data_dev, device, cases=WIDE_BAND_CASES,
              shapes=WIDE_ENGINE_SHAPES) -> dict:
    """Bands past one block of K3 (r > K3_BLOCK_MAX_R), on z-normed windows
    of the series against two z-normed windows as queries, for each
    (L, r, rows) of ``cases``: K3 and DS bit for bit against dtw_diag_plain
    and dtw_ds_diag_plain, each launch in the cluster form; K4 within
    guard_threshold(d, L, 1e-2) of dtw_banded_plain and of K3; the times
    of all three.  Then the DTW engines at ``shapes`` through ``exact_dtw``
    (answer sets equal to the oracle with K3 and with K4) and the clustered
    launches of K3 and DS they made.  First the global form past a cluster
    (``global_form``), with the global-form launches of the whole phase
    beside the clustered ones."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch import verify
    from kvmatch_tpu_torch.ops import dtw as td
    rng = np.random.default_rng(9)
    clustered = (td.dtw_diag, td.dtw_ds)
    global_before = [fn.global_launches for fn in clustered]
    glob = global_form(data_dev, device)
    out = {}
    for L, r, batch in cases:
        args = (znormed_windows(data_dev, device, rng, L, batch),
                znormed_windows(data_dev, device, rng, L, 2),
                torch.as_tensor(np.arange(batch) % 2, dtype=torch.int32,
                                device=device), r)
        before = [fn.cluster_launches for fn in clustered]
        got = {td.dtw_diag: (td.dtw_diag(*args),), td.dtw_ds: td.dtw_ds(*args)}
        if [fn.cluster_launches - b for fn, b in zip(clustered, before)] \
                != [1, 1]:
            raise AssertionError(f"L={L} r={r}: K3 and DS did not take the "
                                 f"cluster form")
        res = dict(rows=batch)
        for fn, plain in ((td.dtw_diag, td.dtw_diag_plain),
                          (td.dtw_ds, td.dtw_ds_diag_plain)):
            want, plain_ms = plain_call(plain, args, f"wide L{L}_r{r}")
            want = want if isinstance(want, tuple) else (want,)
            differ = sum(int((g != w).sum()) for g, w in zip(got[fn], want))
            if differ:
                raise AssertionError(f"{fn.__name__} L={L} r={r}: {differ} "
                                     f"values differ from {plain.__name__}")
            res[fn.__name__] = dict(bit_equal=True, plain_ms=plain_ms,
                                    ms=timed_ms(lambda fn=fn: fn(*args), 1,
                                                device))
        want, plain_ms = plain_call(td.dtw_banded_plain, args,
                                    f"wide L{L}_r{r}")
        want = want.double()
        band = verify.guard_threshold(want, L, 1e-2)
        k4 = td.dtw_rows(*args).double()
        ratio = float(((k4 - want).abs() / band).max())
        cross = float(((k4 - got[td.dtw_diag][0].double()).abs()
                       / band).max())
        if not (ratio <= 1.0 and cross <= 1.0):
            raise AssertionError(f"dtw_rows L={L} r={r}: {ratio} of the "
                                 f"guard band of dtw_banded_plain, {cross} "
                                 f"of K3's")
        res["dtw_rows"] = dict(
            max_err_over_bound=ratio, vs_k3_over_bound=cross,
            plain_ms=plain_ms,
            ms=timed_ms(lambda: td.dtw_rows(*args), 1, device))
        res.update(d2=want.tolist(), finite=bool(torch.isfinite(k4).all()))
        out[f"L{L}_r{r}"] = res
    before = [fn.cluster_launches for fn in clustered]
    rows_before = td.dtw_rows.launches
    engines = exact_dtw(device, shapes=shapes, n_queries=2,
                        max_segments=WIDE_MAX_SEGMENTS)
    launches = {fn.__name__: fn.cluster_launches - b
                for fn, b in zip(clustered, before)}
    if launches["dtw_diag"] < 1:
        raise AssertionError("the wide-band engines made no clustered K3 "
                             "launch")
    return dict(global_form=glob, kernels=out, engines=engines["shapes"],
                engines_equal=engines["equal"],
                engine_cluster_launches=launches,
                global_launches={fn.__name__: fn.global_launches - b
                                 for fn, b in zip(clustered, global_before)},
                engine_k4_launches=td.dtw_rows.launches - rows_before)


# ------------------------------------------------------------- phase 5 ----
def main_path(eng, offs, queries, reps: int = 3):
    """The serving batch: one warm run, then ``reps`` timed runs.  Returns
    the summary and the last run's results."""
    import torch
    device = eng.device
    t0 = time.perf_counter()
    eng.query_batch(queries, EPS, alpha=ALPHA, beta=BETA)
    warm_s = time.perf_counter() - t0
    qps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = eng.query_batch(queries, EPS, alpha=ALPHA, beta=BETA)
        torch.cuda.synchronize(device)
        qps.append(len(queries) / (time.perf_counter() - t0))
    found = sum(int(o) in r.offsets.tolist() for o, r in zip(offs, res))
    return dict(
        qps_median=statistics.median(qps), qps_reps=qps, warm_s=warm_s,
        p1_ms_per_query=statistics.fmean(r.stats.t_phase1_ms for r in res),
        p2_ms_per_query=statistics.fmean(r.stats.t_phase2_ms for r in res),
        cands_per_query=statistics.fmean(r.stats.n_candidates for r in res),
        host_rechecks=sum(r.stats.n_host_rechecked for r in res),
        device_confirmed=sum(r.stats.n_device_confirmed for r in res),
        answers=[int(r.offsets.size) for r in res], self_found=found,
        n_queries=len(queries)), res


def card_confirm(eng, offs, queries) -> dict:
    """The serving batch on an f32-exact series, whose exact f64 confirm
    runs on the card (K2's f64 form): the cost of the engine's exactness
    check (``confirm_on_device``, the first ask), ``main_path`` with the
    card confirm, then one batch with the host confirm; the answer sets
    equal and the distances within 1e-8 of each other (z-normalized, at
    most EPS).  Raises beyond that, or if the card confirmed no row, the
    host rechecked one, or the two confirms took different rows."""
    import numpy as np
    import torch
    torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    on = eng.confirm_on_device
    torch.cuda.synchronize(eng.device)
    check_s = time.perf_counter() - t0
    if not on:
        raise AssertionError("the f32-exact engine does not confirm on the "
                             "card")
    card, res = main_path(eng, offs, queries)
    eng.confirm_on_device = False
    try:
        t0 = time.perf_counter()
        host = eng.query_batch(queries, EPS, alpha=ALPHA, beta=BETA)
        host_s = time.perf_counter() - t0
    finally:
        eng.confirm_on_device = True
    dist_gap = 0.0
    for qi, (a, b) in enumerate(zip(res, host)):
        ia, ib = np.argsort(a.offsets), np.argsort(b.offsets)
        if not np.array_equal(a.offsets[ia], b.offsets[ib]):
            raise AssertionError(f"query {qi}: the card confirm's answers "
                                 f"differ from the host confirm's")
        if a.offsets.size:
            dist_gap = max(dist_gap, float(np.max(
                np.abs(a.distances[ia] - b.distances[ib]))))
    host_rows = sum(r.stats.n_host_rechecked for r in host)
    if (card["host_rechecks"] or not card["device_confirmed"]
            or host_rows != card["device_confirmed"] or dist_gap > 1e-8):
        raise AssertionError(
            f"card confirm: {card['device_confirmed']} rows on the card, "
            f"{card['host_rechecks']} on the host, {host_rows} host rows "
            f"with the host confirm, dist gap {dist_gap}")
    return dict(card, check_s=check_s, host_confirm_qps=len(queries) / host_s,
                host_confirm_rows=host_rows, dist_gap=dist_gap)


def single_queries(eng, queries, batch_res) -> dict:
    """The latency path: each query alone through ``engine.query`` (one
    warm pass, one timed pass).  Its answer sets must equal the batch's."""
    import torch
    for q in queries:
        eng.query(q, EPS, alpha=ALPHA, beta=BETA)
    lat = []
    for q, want in zip(queries, batch_res):
        t0 = time.perf_counter()
        r = eng.query(q, EPS, alpha=ALPHA, beta=BETA)
        torch.cuda.synchronize(eng.device)
        lat.append((time.perf_counter() - t0) * 1e3)
        if set(r.offsets.tolist()) != set(want.offsets.tolist()):
            raise AssertionError("engine.query and query_batch answer sets "
                                 "differ")
    return dict(latency_ms_median=statistics.median(lat), latency_ms=lat)


# Host spans of the cNSM-DTW cascade (engine/norm_dtw.py): the host
# prefilters are engine methods, the device stages module functions.
DTW_SPANS = (("engine", "_plan_batch"), ("engine", "_dense_probe_retry"),
             ("engine", "_constraint_prefilter"), ("engine", "_paa_z_prefilter"),
             ("module", "lb_stage_znorm_multi"),
             ("module", "dtw_stage_znorm_multi"),
             ("module", "dtw_stage_znorm_ds_multi"),
             ("engine", "_confirm_dtw"))


def spanned(pairs, device, fn):
    """Run ``fn()`` with each ``(owner, name)`` of ``pairs`` (an engine's
    method or a module's function) timed between two ``synchronize()``
    calls; spans are inclusive, so a nested span is also inside its
    parent's.  Returns (fn's result, {name: [ms, calls]})."""
    import torch
    spans = {name: [0.0, 0] for _, name in pairs}
    saved = []
    for owner, name in pairs:
        orig = getattr(owner, name)

        def timed(*a, _fn=orig, _span=spans[name], **kw):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = _fn(*a, **kw)
            torch.cuda.synchronize(device)
            _span[0] += (time.perf_counter() - t0) * 1e3
            _span[1] += 1
            return res
        saved.append((owner, name, orig, name in vars(owner)))
        setattr(owner, name, timed)
    try:
        return fn(), spans
    finally:
        for owner, name, orig, own in reversed(saved):
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)


def main_dtw(eng, offs, queries, reps: int = MAIN_DTW_REPS) -> dict:
    """cNSM-DTW serving batches: one warm batch, then ``reps`` timed ones
    through ``query_batch``, each with its stage counts and kernel launches,
    then one more batch with the host spans of DTW_SPANS, timed apart (its
    synchronize() calls slow it) and held to the same answer sets."""
    import torch
    from kvmatch_tpu_torch.engine import norm_dtw
    from kvmatch_tpu_torch.ops.dtw import dtw_diag, dtw_ds, dtw_rows
    from kvmatch_tpu_torch.ops.ed import window_ed
    from kvmatch_tpu_torch.ops.probe import cons_and, probe_flags
    kernels = (probe_flags, cons_and, window_ed, dtw_diag, dtw_rows, dtw_ds)
    kw = dict(rho=RHO_MAIN, alpha=ALPHA, beta=BETA)
    t0 = time.perf_counter()
    eng.query_batch(queries, EPS, **kw)
    warm_s = time.perf_counter() - t0
    qps, stages, batch_s, launches = [], [], [], []
    for _ in range(reps):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        res = eng.query_batch(queries, EPS, **kw)
        torch.cuda.synchronize(eng.device)
        batch_s.append(time.perf_counter() - t0)
        qps.append(len(queries) / batch_s[-1])
        stages.append(dict(eng.stage_counts))
        launches.append({k.__name__: k.launches - b
                         for k, b in zip(kernels, before)})
    pairs = [(eng if where == "engine" else norm_dtw, name)
             for where, name in DTW_SPANS]
    t0 = time.perf_counter()
    sres, spans = spanned(pairs, eng.device,
                          lambda: eng.query_batch(queries, EPS, **kw))
    spanned_s = time.perf_counter() - t0
    if any(set(a.offsets.tolist()) != set(b.offsets.tolist())
           for a, b in zip(sres, res)):
        raise AssertionError("the spanned cNSM-DTW batch found other answer "
                             "sets")
    return dict(
        qps_median=statistics.median(qps), qps_reps=qps, batch_s=batch_s,
        warm_s=warm_s,
        p1_ms_per_query=statistics.fmean(r.stats.t_phase1_ms for r in res),
        p2_ms_per_query=statistics.fmean(r.stats.t_phase2_ms for r in res),
        stages_per_batch=stages, launches_per_batch=launches[-1],
        launches_per_rep=launches, spanned_batch_s=spanned_s,
        span_ms={k: v[0] for k, v in spans.items()},
        span_calls={k: v[1] for k, v in spans.items()},
        host_rechecks=sum(r.stats.n_host_rechecked for r in res),
        answers=[int(r.offsets.size) for r in res],
        self_found=sum(int(o) in r.offsets.tolist()
                       for o, r in zip(offs, res)),
        n_queries=len(queries))


def rsm_dtw_singles(eng, data, offs, L: int = L_RSM_DTW, rho: int = RHO_RSM,
                    eps: float = EPS_RSM) -> dict:
    """RSM-DTW: each query alone through ``engine.query`` (the first one
    once more before, as a warm-up)."""
    import torch
    queries = [data[o:o + L] for o in offs]
    eng.query(queries[0], eps, rho=rho)
    lat, found, stages = [], 0, []
    for o, q in zip(offs, queries):
        t0 = time.perf_counter()
        r = eng.query(q, eps, rho=rho)
        torch.cuda.synchronize(eng.device)
        lat.append((time.perf_counter() - t0) * 1e3)
        found += int(o) in r.offsets.tolist()
        stages.append(dict(eng.stage_counts))
    return dict(L=L, rho=rho, eps=eps, latency_ms_median=statistics.median(lat),
                latency_ms=lat, self_found=found, n_queries=len(offs),
                stages=stages)


# ------------------------------------------------------------- phase 6 ----
def routing_ab(eng, offs, queries, reps: int = 3) -> dict:
    """Phase-2 routing of the serving batch as a whole (the engine's, as in
    the JAX package) against routing each query by its own candidates (a
    query whose candidates ``_region_plan`` finds clustered joins the
    region route, the rest take K2), in turns whole, per-query, per-query,
    whole: q/s, phase-2 ms and K2 launches per turn."""
    from kvmatch_tpu_torch.ops.ed import window_ed
    whole_batch = eng._verify_routed

    def per_query(cand_ivs, ctxs):
        L = ctxs[0].length
        clustered = [eng._region_plan([ivs], L) is not None
                     for ivs in cand_ivs]
        groups = {True: [i for i, c in enumerate(clustered) if c],
                  False: [i for i, c in enumerate(clustered) if not c]}
        if groups[True] and groups[False]:
            out = [None] * len(ctxs)
            for qis in groups.values():
                sub = whole_batch([cand_ivs[i] for i in qis],
                                  [ctxs[i] for i in qis])
                for qi, r in zip(qis, sub):
                    out[qi] = r
            return out
        return whole_batch(cand_ivs, ctxs)

    turns = []
    for policy in ("whole", "per_query", "per_query", "whole"):
        eng._verify_routed = whole_batch if policy == "whole" else per_query
        k2 = window_ed.launches
        r, _ = main_path(eng, offs, queries, reps)
        if r["self_found"] != r["n_queries"]:
            raise AssertionError(f"routing {policy}: self-queries found "
                                 f"{r['self_found']}/{r['n_queries']}")
        turns.append(dict(policy=policy, qps_median=r["qps_median"],
                          qps_reps=r["qps_reps"],
                          p1_ms_per_query=r["p1_ms_per_query"],
                          p2_ms_per_query=r["p2_ms_per_query"],
                          k2_launches=window_ed.launches - k2))
    del eng._verify_routed
    summary = {p: dict(
        qps_median=statistics.median(q for t in turns if t["policy"] == p
                                     for q in t["qps_reps"]),
        p2_ms_per_query=statistics.fmean(t["p2_ms_per_query"] for t in turns
                                         if t["policy"] == p))
        for p in ("whole", "per_query")}
    return dict(turns=turns, summary=summary)


# ------------------------------------------------------------- phase 7 ----
SPANS = ("_plan_batch", "_dense_probe_retry", "_flags_to_intervals",
         "_verify_multi", "_verify_regions", "_verify_gather",
         "_guarded_near", "_confirm_znorm_device", "_confirm_znorm_exact")


def profile_batch(eng, queries) -> dict:
    """Where the time goes in one serving batch.

    Host spans: each engine method of SPANS, timed by ``spanned`` on one
    batch after three unspanned ones.  Device trace: utils/profiling.trace
    (torch.profiler, its Chrome trace written under build/profile and
    deleted) over one more, unspanned batch; the idle share is 1 - |union
    of the device-event intervals inside the batch| / the batch's wall
    time, both on the profiler's clock (``device_sum_ms`` sums the same
    events, overlaps counted twice).  Kernel time by name sums event durations."""
    import shutil
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from kvmatch_tpu_torch.utils.profiling import trace
    device = eng.device

    def batch():
        eng.query_batch(queries, EPS, alpha=ALPHA, beta=BETA)
        torch.cuda.synchronize(device)

    unspanned_ms = timed_ms(batch, 3, device)
    t0 = time.perf_counter()
    _, spans = spanned([(eng, name) for name in SPANS], device, batch)
    spanned_ms = (time.perf_counter() - t0) * 1e3

    log_dir = work_dir("profile")
    with trace(log_dir) as prof:
        with record_function("serving_batch"):
            batch()
    trace_bytes = prof.trace_file.stat().st_size
    shutil.rmtree(log_dir)
    events = prof.events()
    (outer,) = [e for e in events if e.name == "serving_batch"
                and e.device_type == DeviceType.CPU]
    b0, b1 = outer.time_range.start, outer.time_range.end
    # The annotation has a twin on the device timeline; it is not work.
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "serving_batch"]
    if not dev:
        raise AssertionError("the traced batch ran no operation on the card")
    busy, end = 0.0, b0
    for lo, hi in sorted((max(e.time_range.start, b0),
                          min(e.time_range.end, b1)) for e in dev):
        if hi > max(lo, end):
            busy += hi - max(lo, end)
            end = hi
    by_name: dict = {}
    for e in dev:
        k = by_name.setdefault(e.name[:60], [0.0, 0])
        k[0] += e.time_range.elapsed_us() / 1e3
        k[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        unspanned_batch_ms=unspanned_ms, spanned_batch_ms=spanned_ms,
        host_spans_ms={k: v[0] for k, v in spans.items() if v[1]},
        span_calls={k: v[1] for k, v in spans.items() if v[1]},
        traced_batch_ms=(b1 - b0) / 1e3, device_busy_ms=busy / 1e3,
        device_sum_ms=sum(e.time_range.elapsed_us() for e in dev) / 1e3,
        idle_share=1.0 - busy / (b1 - b0), n_device_events=len(dev),
        chrome_trace_bytes=trace_bytes,
        device_ms_by_name=[[k, v[0], v[1]] for k, v in top])


# ------------------------------------------------------------ phase 7b ----
# single: the JAX package's single-query ops on the resident n=1e8 series at
# the north star's width: (ED offsets, regions of SINGLE_M offsets, DP rows,
# rows held against the host f64 DP).
SINGLE_SHAPE = (1024, 16, 256, 16)
SINGLE_M = 8192
# oracle.dtw_banded (a Python loop over the band) against the f64 batch DP:
# (L, r, rows).
SINGLE_ORACLE = (1024, 51, 2)


def single_phase(data8, dev8, queries, device, kernels, launches: dict,
                 L: int = L_MAIN, r: int = RHO_MAIN) -> dict:
    """The single-query device ops through the kernels of their ``_multi``
    forms, each call counted (it must launch its kernel: a CUDA tensor is
    never sent to a plain version), each result bit-equal to its ``_multi``
    form called outside the count:

    * ed_distances / znorm_ed_distances (K2) on random offsets against the
      first north-star query; 16 rows within guard_threshold(d64, L, 1e-2)
      of the host float64 distance;
    * region_ed_distances (centred by the query's own mean) and
      region_znorm_distances on regions of SINGLE_M offsets;
    * dtw_banded_batch (the z-normed query) and dtw_banded_batch_multi (a
      north-star query per row) on z-normed windows, with K3 and with K4;
      16 rows within the guard band of the native f64 DP;
    * dtw_banded_batch_ds_multi (DS): every row within 8 eps32 (d64 + 1)
      of the f64 DP (the plain version in float64 on the card);
    * lb_kim and lb_keogh at or below the f64 DTW plus the guard band;
    * oracle.dtw_banded (SINGLE_ORACLE) within rtol 1e-12 of the port's
      f64 batch DP."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch import oracle, verify
    from kvmatch_tpu_torch.ops import dtw as td
    from kvmatch_tpu_torch.ops import ed as ted
    from kvmatch_tpu_torch.ops import regions as treg
    from kvmatch_tpu_torch.plan import envelope
    n_ed, n_reg, n_dp, n_f64 = SINGLE_SHAPE
    rng = np.random.default_rng(12)
    eps32 = float(np.finfo(np.float32).eps)
    out: dict = {}

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    def znorm64(x):
        x = np.asarray(x, np.float64)
        return (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)

    def launched(kernel, fn):
        """``fn()`` under the count; its kernel must launch once."""
        res = counted(kernels, launches, fn)
        if kernel.launches != 1:
            raise AssertionError(f"{kernel.__name__} launched "
                                 f"{kernel.launches} times for one call")
        return res

    def equal(got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want) or not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{what} differs from its _multi form")

    def within(got, want, tol, what):
        ratio = float(np.max(np.abs(np.asarray(got, np.float64) - want)
                             / tol))
        if not ratio <= 1.0:
            raise AssertionError(f"{what}: error {ratio} of its bound")
        return ratio

    # ED: K2 raw and z-norm against the first north-star query.
    q = np.asarray(queries[0], np.float64)
    q32, qh32 = dev(q), dev(znorm64(q))
    offs_np = rng.integers(0, dev8.shape[0] - L + 1, n_ed)
    offs = dev(offs_np, torch.int64)
    zeros = ted._one_query(offs)
    raw = launched(ted.window_ed, lambda: ted.ed_distances(dev8, q32, offs,
                                                            L))
    zn = launched(ted.window_ed, lambda: ted.znorm_ed_distances(
        dev8, qh32, offs, L))
    equal(raw, ted.ed_distances_multi(dev8, q32[None], offs, zeros, L),
          "ed_distances")
    equal(zn, ted.znorm_ed_distances_multi(dev8, qh32[None], offs, zeros, L),
          "znorm_ed_distances")
    win = np.stack([data8[o:o + L] for o in offs_np[:n_f64]])
    d64 = ((win - q) ** 2).sum(1)
    z64 = ((znorm64(win) - znorm64(q)) ** 2).sum(1)
    out["ed"] = dict(
        rows=n_ed, raw_over_guard=within(
            raw[:n_f64].cpu().numpy(), d64, verify.guard_threshold(d64, L,
                                                                   1e-2),
            "ed_distances"),
        znorm_over_guard=within(
            zn[0][:n_f64].cpu().numpy(), z64,
            verify.guard_threshold(z64, L, 1e-2), "znorm_ed_distances"),
        d2_median=float(np.median(d64)), znorm_d2_median=float(
            np.median(z64)))

    # Regions: the FFT route (torch ops), one query for every region.
    starts = dev(rng.integers(0, dev8.shape[0] - (SINGLE_M + L - 1) + 1,
                              n_reg), torch.int64)
    zeros_r = ted._one_query(starts)
    center = float(np.float32(q.mean()))
    qc32 = dev(q - center)
    reg = counted(kernels, launches, lambda: (
        treg.region_ed_distances(dev8, qc32, starts, L, SINGLE_M, center),
        treg.region_znorm_distances(dev8, qh32, starts, L, SINGLE_M)))
    equal(reg[0], treg.region_ed_distances_multi(
        dev8, qc32[None], starts, zeros_r, L, SINGLE_M, center),
        "region_ed_distances")
    equal(reg[1], treg.region_znorm_distances_multi(
        dev8, qh32[None], starts, zeros_r, L, SINGLE_M)[:3],
        "region_znorm_distances")
    out["regions"] = dict(rows=n_reg, m=SINGLE_M, finite=bool(
        torch.isfinite(reg[1][0]).all()))

    # DP: z-normed windows against the z-normed query, and against a
    # north-star query per row; K3, then K4.
    z = znormed_windows(dev8, device, rng, L, n_dp)
    qb = dev(znorm64(np.asarray(queries, np.float64)[
        rng.integers(0, len(queries), n_dp)]))
    one_ids = ted._one_query(z)
    row_ids = torch.arange(n_dp, dtype=torch.int32, device=device)
    z64_rows = z.double()
    d_one, _ = plain_call(td.dtw_banded_plain,
                          (z64_rows, qh32[None].double(), one_ids, r),
                          "single one query f64")
    d_row, _ = plain_call(td.dtw_banded_plain,
                          (z64_rows, qb.double(), row_ids, r),
                          "single query per row f64")
    zn_np, qh_np, qb_np = (t.cpu().numpy().astype(np.float64)
                           for t in (z, qh32, qb))
    nat_one = td.dtw_banded_batch_f64(zn_np[:n_f64], qh_np, r)
    nat_row = np.array([td.dtw_banded_batch_f64(zn_np[i:i + 1], qb_np[i],
                                                r)[0] for i in range(n_f64)])
    saved = td.DTW_STATE["variant"]
    dp = {}
    try:
        for variant, kernel in (("diag", td.dtw_diag), ("rows", td.dtw_rows)):
            td.DTW_STATE["variant"] = variant
            one = launched(kernel, lambda: td.dtw_banded_batch(z, qh32, r))
            per = launched(kernel, lambda: td.dtw_banded_batch_multi(z, qb,
                                                                     r))
            equal(one, td._dtw_f32(z, qh32[None], one_ids, r),
                  f"dtw_banded_batch ({variant})")
            equal(per, td._dtw_f32(z, qb, row_ids, r),
                  f"dtw_banded_batch_multi ({variant})")
            dp["k3" if variant == "diag" else "k4"] = {
                name: within(got[:n_f64].cpu().numpy(), want,
                             verify.guard_threshold(want, L, 1e-2),
                             f"{name} ({variant})")
                for name, got, want in (("one_over_guard", one, nat_one),
                                        ("multi_over_guard", per, nat_row))}
    finally:
        td.DTW_STATE["variant"] = saved
    out["dp"] = dict(rows=n_dp, L=L, r=r, **dp, native_vs_plain=float(
        np.max(np.abs(nat_one - d_one[:n_f64].cpu().numpy())
               / (nat_one + 1.0))))

    # DS on the same rows, a query per row.
    hi, lo = launched(td.dtw_ds, lambda: td.dtw_banded_batch_ds_multi(
        z, qb, r))
    equal((hi, lo), td.dtw_ds(z, qb, row_ids, r), "dtw_banded_batch_ds_multi")
    ds = td.ds_value(hi.cpu().numpy(), lo.cpu().numpy())
    want = d_row.cpu().numpy()
    out["ds"] = dict(rows=n_dp, over_bound=within(
        ds, want, 8.0 * eps32 * (want + 1.0), "dtw_banded_batch_ds_multi"),
        native_over_bound=within(ds[:n_f64], nat_row,
                                 8.0 * eps32 * (nat_row + 1.0),
                                 "dtw_banded_batch_ds_multi (native)"))

    # Lower bounds against the f64 DTW of the one query.
    lo_env, hi_env = (dev(x) for x in envelope(qh_np, r))
    kim, keogh = counted(kernels, launches, lambda: (
        td.lb_kim(z, qh32), td.lb_keogh(z, lo_env, hi_env)))
    d_one = d_one.cpu().numpy()
    band = verify.guard_threshold(d_one, L, 1e-2)
    lbs = {}
    for name, lb in (("lb_kim", kim), ("lb_keogh", keogh)):
        lb = lb.cpu().numpy().astype(np.float64)
        if not np.all(lb <= d_one + band):
            raise AssertionError(f"{name} above the f64 DTW")
        lbs[name] = float(np.median(lb / d_one))
    out["lb_median_share_of_dtw"] = lbs

    # The scalar f64 DP of the oracle against the port's f64 batch DP.
    Lo, ro, rows = SINGLE_ORACLE
    a = znorm64(np.stack([data8[o:o + Lo] for o in rng.integers(
        0, data8.size - Lo + 1, rows)]))
    b = znorm64(np.asarray(queries[0][:Lo], np.float64))
    t0 = time.perf_counter()
    scalar = np.array([oracle.dtw_banded(x, b, ro) for x in a])
    scalar_s = time.perf_counter() - t0
    batch = td.dtw_banded_batch_f64(a, b, ro)
    np.testing.assert_allclose(scalar, batch, rtol=1e-12)
    out["oracle"] = dict(L=Lo, r=ro, rows=rows, seconds=scalar_s,
                         max_rel=float(np.max(np.abs(scalar - batch)
                                              / batch)))
    for name in ("window_ed", "dtw_diag", "dtw_rows", "dtw_ds"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"single path")
    return out


# ------------------------------------------------------------- phase 8 ----
def check_full_index(index, n: int, cap: int) -> dict:
    """Every scale of a full index: its pieces are disjoint, hold 1 to
    ``cap`` offsets each and together cover the window starts
    [0, n - w + 1) exactly; its row keys ascend; cum_offsets[-1] and
    row_ptr[-1] count those starts and pieces.  Returns the pieces a
    scale."""
    import numpy as np
    out = {}
    for w, sc in index.items():
        left, right, _ = sc.pos_sorted()
        size = right - left + 1
        m = n - w + 1
        if not (left.size and left[0] == 0 and right[-1] == m - 1
                and bool((size >= 1).all()) and int(size.max()) <= cap
                and bool((left[1:] == right[:-1] + 1).all())):
            raise AssertionError(f"w={w}: the pieces do not tile [0, {m}) "
                                 f"in pieces of at most {cap} offsets")
        if not bool((np.diff(sc.keys) > 0).all()):
            raise AssertionError(f"w={w}: row keys do not ascend")
        if int(sc.cum_offsets[-1]) != m or int(sc.row_ptr[-1]) != left.size:
            raise AssertionError(f"w={w}: cum_offsets[-1] = "
                                 f"{int(sc.cum_offsets[-1])}, not {m}")
        out[w] = int(left.size)
    return out


def build_full(data8, dev8, device):
    """The full index family on the card: build_index_device at N_MAIN
    (spill mode), at N_KEEP with its pieces kept on the card and then
    copied by materialize_host, and build_index_device_buckets (the device
    bucket pass with host grouping, the engines' default) at N_MAIN beside
    build_index_host, its yardstick, each index checked by
    ``check_full_index``; then the chunked device bucket pass against
    build_buckets over the whole resident series, bit for bit.  A piece of
    the device build holds at most maximum_diff - 1 offsets (the run cap of
    its stages); the host grouping's merge re-splits unions at
    maximum_diff (index/build.py:_group_and_merge).  Returns (the summary,
    the N_MAIN full device index, device-bucket index and host index)."""
    import torch
    from kvmatch_tpu_torch import IndexConfig
    from kvmatch_tpu_torch.index.build import (build_index_device_buckets,
                                               build_index_host,
                                               compute_buckets_device)
    from kvmatch_tpu_torch.index.device_build import (SPILL_N,
                                                      build_index_device)
    from kvmatch_tpu_torch.ops.sliding import build_buckets
    icfg = IndexConfig()
    cap = icfg.maximum_diff - 1
    n = data8.size
    out = dict(n=n, spill_n=SPILL_N, cap=cap, host_cap=cap + 1)
    st: dict = {}
    full8 = build_index_device(data8, icfg, stats=st, data_dev=dev8)
    if not st["spilled"]:
        raise AssertionError(f"n={n} did not take the spill mode")
    out["device"] = dict(st, pieces=check_full_index(full8, n, cap))
    st = {}
    keep = build_index_device(data8[:N_KEEP], icfg, stats=st,
                              data_dev=dev8[:N_KEEP])
    if not all(sc.dev_pos_view is not None and sc.dev_pos_view[0].is_cuda
               and sc._left is None for sc in keep.values()):
        raise AssertionError("keep_device left no scale's pieces on the card")
    t0 = time.perf_counter()
    for sc in keep.values():
        sc.materialize_host()
    st["materialize_host_s"] = time.perf_counter() - t0
    out["device_keep"] = dict(st, n=N_KEEP,
                              pieces=check_full_index(keep, N_KEEP, cap))
    del keep
    st = {}
    buckets8 = build_index_device_buckets(data8, icfg, stats=st,
                                          device=device)
    out["device_buckets"] = dict(st, pieces=check_full_index(buckets8, n,
                                                             cap + 1))
    st = {}
    host8 = build_index_host(data8, icfg, stats=st)
    out["host"] = dict(st, pieces=check_full_index(host8, n, cap + 1))
    chunked = compute_buckets_device(data8, icfg, device=device)
    whole = build_buckets(dev8, tuple(icfg.scales), icfg.pos_of_d)
    differ = {w: int((torch.as_tensor(chunked[w], device=device)
                      != whole[w]).sum()) for w in icfg.scales}
    if any(differ.values()):
        raise AssertionError(f"chunked bucket pass differs from the whole "
                             f"series' pass: {differ}")
    del chunked, whole
    out.update(build_chunk=icfg.build_chunk, chunks_equal_whole=True)
    return out, full8, buckets8, host8


# ------------------------------------------------------------- phase 9 ----
def same_answers(got, want, what: str) -> float:
    """Answer sets of ``got`` equal ``want``'s query by query; returns the
    largest distance difference, which must be within 1e-9."""
    err = 0.0
    for g, w in zip(got, want):
        if set(g.offsets.tolist()) != set(w.offsets.tolist()):
            raise AssertionError(f"{what}: answer sets differ")
        dg = dict(zip(g.offsets.tolist(), g.distances.tolist()))
        err = max([err] + [abs(dg[o] - d) for o, d in
                           zip(w.offsets.tolist(), w.distances.tolist())])
    if err > 1e-9:
        raise AssertionError(f"{what}: distances differ by {err}")
    return err


def counted(kernels, launches: dict, fn):
    """Run ``fn`` with each kernel's launch count set to 0 just before it,
    and add the counts read just after it to ``launches``."""
    for k in kernels:
        k.launches = 0
    out = fn()
    for k in kernels:
        launches[k.__name__] = launches.get(k.__name__, 0) + k.launches
    return out


def stream_main(data8, dev8, full8, offs8, q8, device, kernels,
                launches: dict) -> dict:
    """The cNSM-ED north star with device_data="stream" over the N_MAIN
    full device index: host phase 1, the candidate runs staged to the card.
    The 8 queries as one batch and each alone; both must equal a resident
    engine's batch over the same index, with host phase 1 too, and find
    every self-query.  Reports q/s, the staged groups and bytes and the
    seconds of host staging, the copy to the card and the verification.
    The streamed engine's launches of ``kernels`` go into ``launches``."""
    import torch
    from kvmatch_tpu_torch import IndexConfig, NormQueryEngine, QueryConfig
    icfg, qcfg = IndexConfig(), QueryConfig()
    kw = dict(alpha=ALPHA, beta=BETA)
    resident = NormQueryEngine(data8, index=full8, icfg=icfg, qcfg=qcfg,
                               device_data=dev8)
    t0 = time.perf_counter()
    want = resident.query_batch(q8, EPS, **kw)
    torch.cuda.synchronize(device)
    resident_s = time.perf_counter() - t0
    del resident
    streamed = NormQueryEngine(data8, index=full8, icfg=icfg, qcfg=qcfg,
                               device_data="stream", device=device)
    streamed.stream_counts = {}
    t0 = time.perf_counter()
    got = counted(kernels, launches,
                  lambda: streamed.query_batch(q8, EPS, **kw))
    torch.cuda.synchronize(device)
    batch_s = time.perf_counter() - t0
    batch_counts = dict(streamed.stream_counts)
    err = same_answers(got, want, "streamed cNSM-ED batch")
    lat, single_counts, singles = [], [], []
    for q in q8:
        streamed.stream_counts = {}
        t0 = time.perf_counter()
        singles.append(counted(kernels, launches,
                               lambda: streamed.query(q, EPS, **kw)))
        torch.cuda.synchronize(device)
        lat.append((time.perf_counter() - t0) * 1e3)
        single_counts.append(dict(streamed.stream_counts))
    err = max(err, same_answers(singles, want, "streamed cNSM-ED singles"))
    found = sum(int(o) in r.offsets.tolist() for o, r in zip(offs8, got))
    if found != len(q8):
        raise AssertionError(f"streamed self-queries found {found}/{len(q8)}")
    return dict(
        n=data8.size, L=q8.shape[1], n_queries=len(q8), self_found=found,
        answers=[int(r.offsets.size) for r in got], max_dist_diff=err,
        resident_batch_s=resident_s, batch_s=batch_s,
        batch_qps=len(q8) / batch_s, batch_stream=batch_counts,
        p1_ms_per_query=statistics.fmean(r.stats.t_phase1_ms for r in got),
        p2_ms_per_query=statistics.fmean(r.stats.t_phase2_ms for r in got),
        single_latency_ms=lat, single_qps=len(q8) / (sum(lat) / 1e3),
        single_stream=single_counts)


def stream_small(device, oracles: dict, kernels, launches: dict,
                 n: int = 1_000_000, seed: int = 20260816) -> dict:
    """At n=1e6 (the exact phases' series) over its full device index:
    the four engines streamed on 4 self-queries each, answer sets equal to
    the oracle (the exact phases' where they computed it), the first engine
    with STREAM_MAX_STAGE lowered on the instance so that it stages at least
    2 groups; then device_data="host" on the RSM-ED README demo and on the
    RSM-DTW query with the fewest answers, with torch.cuda.memory_allocated
    unchanged across them.  The streamed engines' launches of ``kernels``
    go into ``launches``."""
    import torch
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngine,
                                   NormQueryEngineDtw, QueryConfig,
                                   QueryEngine, QueryEngineDtw,
                                   generate_series)
    from kvmatch_tpu_torch.index.device_build import build_index_device
    icfg = IndexConfig()
    data = generate_series(n, seed=seed)
    index = build_index_device(data, icfg, device=device)
    qcfg = QueryConfig(host_verify_max_points=0)  # phase 2 on the card
    classes = dict(rsm_ed=QueryEngine, cnsm_ed=NormQueryEngine,
                   rsm_dtw=QueryEngineDtw, cnsm_dtw=NormQueryEngineDtw)
    rows = []
    for i, (name, L, rho, eps) in enumerate(STREAM_SMALL_SHAPES):
        kw = dict(rho=rho) if "dtw" in name else {}
        if name.startswith("cnsm"):
            kw.update(alpha=ALPHA, beta=BETA)
        offs, qs = self_queries(data, 4, L, seed=1)
        key = oracle_key(name, L, rho, eps)
        if key not in oracles:
            oracles[key] = oracle_sets(name, data, qs, eps, rho, device)
        want = oracles[key]
        eng = classes[name](data, index=index, icfg=icfg, qcfg=qcfg,
                            device_data="stream", device=device)
        if i == 0:
            eng.STREAM_MAX_STAGE = STREAM_SMALL_STAGE
        t0 = time.perf_counter()
        res = counted(kernels, launches,
                      lambda: eng.query_batch(qs, eps, **kw))
        torch.cuda.synchronize(device)
        row = dict(engine=name, L=L, rho=rho, eps=eps,
                   batch_s=time.perf_counter() - t0,
                   answers=[int(r.offsets.size) for r in res],
                   stream=dict(eng.stream_counts))
        for o, r, w in zip(offs, res, want):
            if set(r.offsets.tolist()) != w:
                raise AssertionError(f"streamed {name} n={n} offset {o}: "
                                     f"answer set differs from the oracle")
            if int(o) not in r.offsets.tolist():
                raise AssertionError(f"streamed {name} self-query {o} not "
                                     f"found")
        if i == 0 and eng.stream_counts["groups"] < 2:
            raise AssertionError(f"streamed {name}: a lowered staging budget "
                                 f"staged one group")
        rows.append(row)
    torch.cuda.synchronize(device)
    mem = torch.cuda.memory_allocated(device)
    host = {}
    q = data[123_456:123_456 + 8192]
    if "demo" not in oracles:
        (oracles["demo"],) = oracle_sets("rsm_ed", data, [q], 10.0, 0, device)
    r = QueryEngine(data, index=index, icfg=icfg,
                    device_data="host").query(q, 10.0)
    if set(r.offsets.tolist()) != oracles["demo"]:
        raise AssertionError("host-only RSM-ED README demo: answer set "
                             "differs from the oracle")
    host["rsm_ed_demo"] = dict(answers=int(r.offsets.size),
                               host_checked=r.stats.n_host_checked)
    _, L, rho, eps = STREAM_SMALL_SHAPES[2]
    offs, qs = self_queries(data, 4, L, seed=1)
    want = oracles[oracle_key("rsm_dtw", L, rho, eps)]
    k = min(range(len(qs)), key=lambda j: len(want[j]))
    r = QueryEngineDtw(data, index=index, icfg=icfg,
                       device_data="host").query(qs[k], eps, rho=rho)
    if set(r.offsets.tolist()) != want[k] or int(offs[k]) not in want[k]:
        raise AssertionError("host-only RSM-DTW: answer set differs from the "
                             "oracle")
    host["rsm_dtw"] = dict(offset=int(offs[k]), answers=int(r.offsets.size),
                           host_checked=r.stats.n_host_checked)
    torch.cuda.synchronize(device)
    if torch.cuda.memory_allocated(device) != mem:
        raise AssertionError("host-only queries allocated device memory")
    return dict(n=n, engines=rows, host_only=host,
                host_only_device_bytes_delta=0)


# ------------------------------------------------------------ phase 10 ----
INDEX_FIELDS = ("keys", "row_ptr", "left", "right", "cum_intervals",
                "cum_offsets")


def same_index(got, want, what: str, upper: bool = True) -> None:
    """Every scale of ``got`` equals ``want``'s, array for array (and the
    mean upper bound, which the reference file layout does not carry)."""
    import numpy as np
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: scales {sorted(got)} != {sorted(want)}")
    for w in want:
        g, e = got[w], want[w]
        if (g.w, g.n) != (e.w, e.n) or (upper and g.mean_upper_bound
                                        != e.mean_upper_bound):
            raise AssertionError(f"{what}: w={w} metadata differs")
        for f in INDEX_FIELDS:
            if not np.array_equal(getattr(g, f), getattr(e, f)):
                raise AssertionError(f"{what}: w={w} {f} differs")


def disk_bytes(path: Path) -> int:
    if path.is_dir():
        return sum(p.stat().st_size for p in path.iterdir())
    return path.stat().st_size


def work_dir(name: str) -> Path:
    import shutil
    d = REPO / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def persist(data8, dev8, buckets8, stats8, q8, device,
            file_n: int = FILE_STORE_N) -> dict:
    """Index persistence at n=1e8: the device-bucket index saved and loaded
    with IndexNpzStore and with IndexFileStore (the reference's per-scale
    layout; at ``file_n`` points), every array equal after the round trip;
    the cNSM-ED north-star batch over the loaded npz index equal to the
    batch over the saved one (host phase 1 over the full index, as a user
    who loads an index serves it), and query_batch_device equal too; the
    n=1e7 full device build with its pieces kept on the card saves equal to
    its materialize_host form; a stats-only index raises on save.  Files
    go under build/persist and are deleted at the end."""
    import shutil
    import torch
    from kvmatch_tpu_torch import (IndexConfig, IndexFileStore,
                                   IndexNpzStore, NormQueryEngine,
                                   QueryConfig, build_index_device_buckets)
    from kvmatch_tpu_torch.index.device_build import build_index_device
    icfg = IndexConfig()
    d = work_dir("persist")
    out = dict(n=data8.size, pieces=sum(s.num_intervals
                                        for s in buckets8.values()))
    try:
        npz = d / "index.npz"
        t0 = time.perf_counter()
        IndexNpzStore(npz).save(buckets8)
        out["npz_save_s"] = time.perf_counter() - t0
        out["npz_bytes"] = disk_bytes(npz)
        t0 = time.perf_counter()
        loaded = IndexNpzStore(npz).load()
        out["npz_load_s"] = time.perf_counter() - t0
        same_index(loaded, buckets8, "npz round trip")
        npz.unlink()

        if file_n == data8.size:
            index_f = buckets8
        else:  # a depth cut: the reference layout at a prefix
            index_f = build_index_device_buckets(data8[:file_n], icfg,
                                                 device=device)
        t0 = time.perf_counter()
        IndexFileStore(d / "files", n=file_n).save(index_f)
        out["file_save_s"] = time.perf_counter() - t0
        out["file_bytes"] = disk_bytes(d / "files")
        t0 = time.perf_counter()
        loaded_f = IndexFileStore(d / "files", n=file_n).load()
        out["file_load_s"] = time.perf_counter() - t0
        out["file_n"] = file_n
        same_index(loaded_f, index_f, "file store round trip", upper=False)
        del loaded_f, index_f
        shutil.rmtree(d / "files")

        kw = dict(alpha=ALPHA, beta=BETA)
        answers = {}
        for name, index in (("saved", buckets8), ("loaded", loaded)):
            eng = NormQueryEngine(data8, index=index, icfg=icfg,
                                  qcfg=QueryConfig(), device_data=dev8)
            t0 = time.perf_counter()
            answers[name] = eng.query_batch(q8, EPS, **kw)
            torch.cuda.synchronize(device)
            out[f"{name}_batch_s"] = time.perf_counter() - t0
            if name == "loaded":
                dev_res = eng.query_batch_device(q8, EPS, **kw)
            del eng
        out["max_dist_diff"] = max(
            same_answers(answers["loaded"], answers["saved"],
                         "north star over the loaded npz index"),
            same_answers(dev_res, answers["saved"],
                         "query_batch_device over the loaded npz index"))
        out["answers"] = [int(r.offsets.size) for r in answers["saved"]]
        del loaded, answers, dev_res

        keep = build_index_device(data8[:N_KEEP], icfg,
                                  data_dev=dev8[:N_KEEP])
        host = build_index_device(data8[:N_KEEP], icfg, keep_device=False,
                                  data_dev=dev8[:N_KEEP])
        if not all(sc._left is None and sc.dev_pos_view is not None
                   for sc in keep.values()):
            raise AssertionError("keep_device left no scale's pieces on the "
                                 "card")
        t0 = time.perf_counter()
        IndexNpzStore(d / "keep.npz").save(keep)
        out["keep_save_s"] = time.perf_counter() - t0
        same_index(IndexNpzStore(d / "keep.npz").load(), host,
                   "keep_device index saved")
        out["keep_equal_host_form"] = True
        del keep, host

        try:
            IndexNpzStore(d / "stats.npz").save(stats8)
        except ValueError as e:
            out["stats_only_raises"] = str(e)[:60]
        else:
            raise AssertionError("saving a stats-only index did not raise")
        if (d / "stats.npz").exists():
            raise AssertionError("a stats-only save wrote a file")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


# ------------------------------------------------------------ phase 11 ----
def append_build(data8, host8, host8_s: float, chunks: int = 100) -> dict:
    """StreamingIndexBuilder over the n=1e8 series in ``chunks`` appends;
    build() after the last but one and after the last, each equal to
    build_index_host over the same prefix, bit for bit (keys, row_ptr,
    left, right and both cum arrays): over the whole series that is
    ``host8``, build_full's host build (``host8_s`` seconds).  Append
    Mpts/s, the refresh seconds and the host build's seconds beside
    them."""
    from kvmatch_tpu_torch import (IndexConfig, StreamingIndexBuilder,
                                   build_index_host)
    icfg = IndexConfig()
    n = data8.size
    step = n // chunks
    b = StreamingIndexBuilder(icfg)
    append_s, out = 0.0, dict(n=n, chunks=chunks, chunk=step)
    for i in range(chunks):
        t0 = time.perf_counter()
        b.append(data8[i * step:(i + 1) * step])
        append_s += time.perf_counter() - t0
        if i >= chunks - 2:
            t0 = time.perf_counter()
            got = b.build()
            refresh_s = time.perf_counter() - t0
            prefix = (i + 1) * step
            if prefix == n:
                want, host_s = host8, host8_s
            else:
                st: dict = {}
                want = build_index_host(data8[:prefix], icfg, stats=st)
                host_s = st["build_seconds"]
            same_index(got, want, f"append build after {i + 1} chunks")
            out[f"after_{i + 1}"] = dict(
                n=prefix, refresh_s=refresh_s, host_build_s=host_s,
                equal=True, pieces=sum(s.num_intervals for s in got.values()))
            del got, want
    out.update(append_s=append_s, append_mpts_per_s=n / append_s / 1e6)
    return out


# ------------------------------------------------------------ phase 12 ----
def run_cli(args, cwd: Path, timeout: int = 600, threads: int | None = None):
    """``python -m kvmatch_tpu_torch.cli args`` as a user runs it, with
    ``threads`` intra-op threads (OMP_NUM_THREADS) when given; returns
    (stdout lines, launch counts from --count-launches or None, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(REPO))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "kvmatch_tpu_torch.cli",
                        *map(str, args)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"cli {args[:2]} exited {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    launches = None
    for line in p.stderr.splitlines():
        if line.startswith("{"):
            launches = json.loads(line)
    return p.stdout.splitlines(), launches, secs


def answer_lines(lines, one_based: bool = False) -> dict:
    """{0-based offset: distance} of a query's or the oracle's answer
    lines."""
    out = {}
    for line in lines:
        head, sep, tail = line.partition(",")
        if sep and head.strip().isdigit():
            out[int(head) - (1 if one_based else 0)] = float(tail)
    return out


def dedup(answers: dict, length: int) -> set:
    import numpy as np
    from kvmatch_tpu_torch.oracle import dedup_overlapping
    offs = np.array(sorted(answers), np.int64)
    dists = np.array([answers[o] for o in offs])
    return set(dedup_overlapping(offs, dists, length)[0].tolist())


# The n=1e6 CLI set: (engine, L, rho, eps), one self-query each; each engine
# and its twin against the CLI's oracle.
CLI_SMALL_SHAPES = (("rsm-ed", 1024, 0, EPS_RSM), ("cnsm-ed", 1024, 0, EPS),
                    ("rsm-dtw", L_RSM_DTW, RHO_RSM, EPS_RSM),
                    ("cnsm-dtw", 1024, 51, EPS))
# Processes of the n=1e6 set run at once (beside the n=1e8 part's).
CLI_SMALL_WORKERS = 6
# The DTW family's cost-model fit: these RSM-DTW singles of main_dtw, each
# alone, four rows for the fit's three unknowns (15,744, 55,424 and 3,968
# candidates and a flood).  The other four singles take 3.6-18.5 s each
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §5).
CLI_FIT_DTW_SINGLES = (0, 1, 2, 4)


def cli_small(d: Path, dev_arg: list, n: int, seed: int) -> dict:
    """The n=``n`` part of the ``cli`` phase: the four engines and the
    four twins against the CLI's own ``oracle`` output (dedup_overlapping
    of both), ``workload`` with missed=0 in every bin, ``export-queries``
    files equal to the series.  CLI_SMALL_WORKERS processes run side by
    side, each with one intra-op thread, so that together they do not
    oversubscribe the host's cores."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from kvmatch_tpu_torch import generate_series
    data = generate_series(n, seed=seed)
    run_cli(["generate-data", n, "--seed", seed, "--out", "data-small"], d)
    run_cli(["build-index", "data-small", "--out", "small.npz", *dev_arg], d)
    jobs = []
    for name, L, rho, eps in CLI_SMALL_SHAPES:
        (o,), _ = self_queries(data, 1, L, seed=1)
        extra = []
        if "dtw" in name:
            extra += ["--rho", rho]
        if name.startswith("cnsm"):
            extra += ["--alpha", ALPHA, "--beta", BETA]
        for eng in (name, f"twin-{name}"):
            jobs.append((eng, ["query", "data-small", "--index", "small.npz",
                               "--engine", eng, "--offset", o, "--length", L,
                               "--epsilon", eps, *extra, *dev_arg]))
        measure = "DTW" if "dtw" in name else "ED"
        problem = "RSM" if name.startswith("rsm") else "cNSM"
        args = ["oracle", measure, problem, "data-small", o + 1, o + L, eps]
        if problem == "cNSM":
            args += [ALPHA, BETA]
        jobs.append((f"oracle-{name}",
                     [*args, "--rho", rho if rho else 0.05, *dev_arg]))
    jobs.append(("workload", ["workload", "data-small", "--index",
                              "small.npz", "--per-cell", 3, *dev_arg]))
    jobs.append(("export", ["export-queries", "data-small", "--out",
                            "queries", "--lengths", 256, 1024, "--count", 3]))
    with ThreadPoolExecutor(CLI_SMALL_WORKERS) as pool:
        res = dict(zip([j[0] for j in jobs],
                       pool.map(lambda j: run_cli(j[1], d, threads=1),
                                jobs)))
    out = dict(n=n)
    for name, L, rho, eps in CLI_SMALL_SHAPES:
        want = set(answer_lines(res[f"oracle-{name}"][0], one_based=True))
        for eng in (name, f"twin-{name}"):
            got = answer_lines(res[eng][0])
            if dedup(got, L) != want:
                raise AssertionError(f"cli {eng} n={n}: answers differ from "
                                     f"the cli oracle")
            out[eng] = dict(answers=len(got), s=res[eng][2])
        out[f"oracle-{name}"] = dict(answers=len(want),
                                     s=res[f"oracle-{name}"][2])
    lines, _, s = res["workload"]
    bins = [x for x in lines if x.startswith("bin ")]
    if not bins or any("missed=0" not in x for x in bins):
        raise AssertionError(f"cli workload: {lines}")
    out["workload"] = dict(lines=lines, s=s)
    files = sorted((d / "queries").iterdir())
    for f in files:
        L, _, off = (int(x) for x in f.name.split("-")[1:])
        if not np.array_equal(np.fromfile(f, ">f8"), data[off:off + L]):
            raise AssertionError(f"export-queries {f.name} differs")
    out["export_queries"] = len(files)
    return out


def cli_phase(data8, dev8, offs8, q8, rsm_offs, device, kernels,
              launches: dict, fit_engines: dict, small_n: int = 1_000_000,
              small_seed: int = 20260816) -> dict:
    """The command line, as a user runs it (subprocesses in build/cli).

    n=1e8: generate-data (equal to the in-process series), build-index
    (npz, device bucket pass), then ``query --index`` on a selective cNSM-ED
    north-star offset (the gather route: K2 must launch) and on an RSM-DTW
    single (K3 and DS must launch), each chosen by running the in-process
    engine over the same loaded index first; the CLI's answer lines must
    equal the in-process engine's.  The CLI queries' launch counts
    (``--count-launches``) go into ``launches``.  Beside generate-data and
    build-index, in a thread, ``cli_small`` at n=``small_n``; the two
    query processes run after it, one at a time.

    Then fit_cost_model, each query alone, on the cNSM-ED north star
    (``fit_engines["ed"]``, twice over) and on the CLI_FIT_DTW_SINGLES
    RSM-DTW singles (``fit_engines["dtw"]``), and the north-star batch
    under QueryConfig.h100_tuned equal to the default config's (host
    phase 1 over the loaded full index, where the constants steer early
    termination): default, tuned, tuned, default."""
    import dataclasses
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from kvmatch_tpu_torch import (IndexConfig, IndexNpzStore,
                                   NormQueryEngine, QueryConfig,
                                   QueryEngineDtw, TimeSeriesFileStore, native)
    from kvmatch_tpu_torch.utils.profiling import fit_cost_model
    if native.get_lib() is None or native.get_baseline_lib() is None:
        raise AssertionError("the native host libraries did not build (cc)")
    icfg = IndexConfig()
    d = work_dir("cli")
    out = dict(n=data8.size)
    dev_arg = ["--device", str(device)]
    background = ThreadPoolExecutor(1)
    small = background.submit(cli_small, d, dev_arg, small_n, small_seed)
    try:
        _, _, s = run_cli(["generate-data", data8.size, "--seed", 20260817,
                           "--out", "data-big"], d)
        out["generate_s"] = s
        if not np.array_equal(TimeSeriesFileStore(d / "data-big").read_all(),
                              data8):
            raise AssertionError("generate-data wrote another series")
        lines, _, s = run_cli(["build-index", "data-big", "--out", "big.npz",
                               *dev_arg], d)
        out.update(build_index_s=s, build_index_line=lines[-1][:160])
        t0 = time.perf_counter()
        index = IndexNpzStore(d / "big.npz").load()
        out["npz_load_s"] = time.perf_counter() - t0

        def counted_query(eng, q, eps, **kw):
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            r = eng.query(q, eps, **kw)
            torch.cuda.synchronize(device)
            return r, (time.perf_counter() - t0) * 1e3, {
                k.__name__: k.launches for k in kernels}

        big, runs = {}, []
        ceng = NormQueryEngine(data8, index=index, icfg=icfg,
                               qcfg=QueryConfig(), device_data=dev8)
        deng = QueryEngineDtw(data8, index=index, icfg=icfg,
                              qcfg=QueryConfig(), device_data=dev8)
        cases = (("cnsm-ed", ceng, offs8, L_MAIN, EPS,
                  dict(alpha=ALPHA, beta=BETA), ("window_ed",)),
                 ("rsm-dtw", deng, rsm_offs, L_RSM_DTW, EPS_RSM,
                  dict(rho=RHO_RSM), ("dtw_diag", "dtw_ds")))
        for name, eng, offs, L, eps, kw, need in cases:
            tried = []
            for o in offs:
                r, ms, cnt = counted_query(eng, data8[o:o + L], eps, **kw)
                tried.append(dict(offset=int(o), ms=ms, launches=cnt))
                if all(cnt[k] > 0 for k in need):
                    break
            else:
                raise AssertionError(f"no {name} offset launched {need}: "
                                     f"{tried}")
            args = ["query", "data-big", "--index", "big.npz", "--engine",
                    name, "--offset", o, "--length", L, "--epsilon", eps,
                    "--count-launches", *dev_arg]
            for k, v in kw.items():
                args += [f"--{k}", v]
            big[name] = dict(offset=int(o), in_process=tried)
            runs.append((name, args, r, need))
        t0 = time.perf_counter()
        out["small"] = small.result()
        out["small_wait_s"] = time.perf_counter() - t0
        for name, args, r, need in runs:
            lines, cnt, s = run_cli(args, d)
            for k, v in cnt.items():
                launches[k] = launches.get(k, 0) + v
            got = answer_lines(lines)
            want = dict(zip(r.offsets.tolist(), r.distances.tolist()))
            if got.keys() != want.keys() or any(
                    abs(got[k] - want[k]) > 1e-9 for k in want):
                raise AssertionError(f"cli query {name}: answer lines differ "
                                     f"from the in-process engine's")
            if any(cnt[k] < 1 for k in need):
                raise AssertionError(f"cli query {name}: {need} not launched "
                                     f"({cnt})")
            big[name].update(answers=len(got), cli_s=s,
                             cli_line=lines[-1][:160], launches=cnt)
        out["big"] = big
        (d / "data-big").unlink()
        (d / "big.npz").unlink()

        # The cost model fitted on the card, each query alone, and
        # h100_tuned's answers.
        rsm_q = np.stack([data8[rsm_offs[i]:rsm_offs[i] + L_RSM_DTW]
                          for i in CLI_FIT_DTW_SINGLES])
        fits = {}
        for family, qs, eps, kw, repeats in (
                ("ed", q8, EPS, dict(alpha=ALPHA, beta=BETA), 2),
                ("dtw", rsm_q, EPS_RSM, dict(rho=RHO_RSM), 1)):
            eng = fit_engines[family]
            t0 = time.perf_counter()
            qc = fit_cost_model(eng, qs, eps, repeats=repeats, **kw)
            sfx = "_dtw" if eng.use_dtw_cost_model else ""
            fits[family] = dict(a=getattr(qc, f"phase2_cost_a{sfx}"),
                                b=getattr(qc, f"phase2_cost_b{sfx}"),
                                intercept=qc.phase2_cost_intercept,
                                fields=f"phase2_cost_a{sfx}, _b{sfx}",
                                fitted_on=type(eng).__name__,
                                queries=len(qs), repeats=repeats,
                                s=time.perf_counter() - t0)
        out["fit"] = fits
        tuned = QueryConfig.h100_tuned()
        out["h100_tuned"] = {k: v for k, v in
                             dataclasses.asdict(tuned).items()
                             if k.startswith("phase2_cost")}
        kw = dict(alpha=ALPHA, beta=BETA)
        engs = dict(default=ceng, tuned=NormQueryEngine(
            data8, index=index, icfg=icfg, qcfg=tuned, device_data=dev8))
        res, batch_s = {}, {"default": [], "tuned": []}
        for name in ("default", "tuned", "tuned", "default"):
            t0 = time.perf_counter()
            res[name] = engs[name].query_batch(q8, EPS, **kw)
            torch.cuda.synchronize(device)
            batch_s[name].append(time.perf_counter() - t0)
        want, got = res["default"], res["tuned"]
        same_answers(got, want, "north star under h100_tuned")
        out.update(tuned_equal=True, default_batch_s=batch_s["default"],
                   tuned_batch_s=batch_s["tuned"],
                   default_segments=[r.stats.n_segments_used for r in want],
                   tuned_segments=[r.stats.n_segments_used for r in got])
    finally:
        background.shutdown(wait=True)
        shutil.rmtree(d, ignore_errors=True)
    return out


# ------------------------------------------------------------ phase 13 ----
# UcrScanner.scan_dtw and the RSM-DTW twin on the first this many RSM-DTW
# singles (a depth cut: with all 8 singles this phase did not finish in
# 1,800 s, and with 2 the script ran 1,243 s, past its limit, 6.5 and 5.5 s
# a scan; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §4).
BASELINE_DTW_SINGLES = 1
# Each time of the baselines phase is the median of this many runs, after
# one warm run of the engine, scanner or twin.
BASELINE_REPS = 3


def baselines(data8, dev8, q8, rsm_offs, eng8, raw8, reng8, index8, device,
              kernels, launches: dict) -> dict:
    """The index-free full scan and the scalar twins at n=1e8, each held to
    the index engine's answer sets (the engines: the resident cNSM-ED,
    RSM-ED and RSM-DTW engines over the stats-only index, dense phase 1).

    UcrScanner (over an HbmStore of the series): scan_nsm_ed on the 8
    cNSM-ED north-star queries, scan_ed
    on the RSM-ED README demo query (offset 123,456, L=8192, eps=10) and
    scan_dtw on the first BASELINE_DTW_SINGLES RSM-DTW singles; each scan's ms
    beside the engine's ms for the same query (the index's speedup over a
    full scan).  The twins (phase 2 in the scalar C loops) on the selective
    cNSM-ED queries (those whose engine query launched K2, the gather
    route) and on the same RSM-DTW singles, with their ms: the scalar
    yardstick.  Every ms is the median of BASELINE_REPS runs: an engine
    runs each query once untimed first, a scanner and a twin run one warm
    call of each method first.  The engine's phase times and candidates
    for the README demo stand beside its ms.  The scans' and twins'
    launches go into ``launches``."""
    import dataclasses
    import torch
    from kvmatch_tpu_torch import HbmStore, QueryConfig, UcrScanner, native
    from kvmatch_tpu_torch.baselines import ScanStats
    from kvmatch_tpu_torch.baseline_twin import (ScalarTwinDtw,
                                                 ScalarTwinNormEd)
    if native.get_baseline_lib() is None:
        raise AssertionError("the scalar baseline library did not build (cc)")

    def timed(fn, reps: int = BASELINE_REPS):
        """(fn's last result, the median ms of ``reps`` runs, each ms)."""
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return r, statistics.median(ms), ms

    def engine(eng, q, eps, **kw):
        """The engine's answer set, median ms and stats (one untimed run
        first), and the launches of one query."""
        for k in kernels:
            k.launches = 0
        eng.query(q, eps, **kw)
        cnt = {k.__name__: k.launches for k in kernels}
        r, ms, _ = timed(lambda: eng.query(q, eps, **kw))
        return set(r.offsets.tolist()), ms, cnt, r.stats

    def counted_timed(fn):
        return timed(lambda: counted(kernels, launches, fn))

    def check(got, want, what):
        if set(got.tolist()) != want:
            raise AssertionError(f"{what}: answer set differs from the index "
                                 f"engine's")
        return len(want)

    store = HbmStore(data8, device=device)  # the series' own copy on the card
    scanner = UcrScanner(store.host, device_data=store.device)
    out = dict(n=data8.size, reps=BASELINE_REPS)
    norm_kw = dict(alpha=ALPHA, beta=BETA)
    counted(kernels, launches, lambda: scanner.scan_nsm_ed(q8[0], EPS,
                                                           **norm_kw))
    rows, selective = [], []
    for i, q in enumerate(q8):
        want, ems, cnt, _ = engine(eng8, q, EPS, **norm_kw)
        if cnt["window_ed"]:
            selective.append(i)
        (got, _), sms, sall = counted_timed(
            lambda: scanner.scan_nsm_ed(q, EPS, **norm_kw))
        rows.append(dict(answers=check(got, want, f"scan_nsm_ed query {i}"),
                         scan_ms=sms, scan_ms_runs=sall, engine_ms=ems,
                         speedup=sms / ems))
    out["scan_nsm_ed"] = rows
    q = data8[123_456:123_456 + L_MAIN]
    want, ems, _, est = engine(raw8, q, 10.0)
    counted(kernels, launches, lambda: scanner.scan_ed(q, 10.0))
    (got, _), sms, sall = counted_timed(lambda: scanner.scan_ed(q, 10.0))
    out["scan_ed"] = dict(answers=check(got, want, "scan_ed README demo"),
                          scan_ms=sms, scan_ms_runs=sall, engine_ms=ems,
                          speedup=sms / ems,
                          engine_stats=dataclasses.asdict(est))
    rsm_q = [data8[o:o + L_RSM_DTW] for o in rsm_offs[:BASELINE_DTW_SINGLES]]
    counted(kernels, launches, lambda: scanner.scan_dtw(rsm_q[0], EPS_RSM,
                                                        RHO_RSM))
    dtw_want, rows = [], []
    for i, q in enumerate(rsm_q):
        want, ems, _, _ = engine(reng8, q, EPS_RSM, rho=RHO_RSM)
        dtw_want.append((want, ems))
        st = ScanStats()
        (got, _), sms, sall = counted_timed(
            lambda: scanner.scan_dtw(q, EPS_RSM, RHO_RSM, stats=st))
        rows.append(dict(answers=check(got, want, f"scan_dtw single {i}"),
                         scan_ms=sms, scan_ms_runs=sall, engine_ms=ems,
                         speedup=sms / ems, stats=dataclasses.asdict(st)))
    out["scan_dtw"] = rows
    del scanner, store
    if not selective:
        raise AssertionError("no cNSM-ED north-star query took the gather "
                             "route alone")

    qcfg = QueryConfig(dense_probe_min_count=0)
    twin = ScalarTwinNormEd(data8, index=index8, qcfg=qcfg, device_data=dev8)
    counted(kernels, launches, lambda: twin.query(q8[selective[0]], EPS,
                                                  **norm_kw))
    rows = []
    for i in selective:
        want, ems, _, _ = engine(eng8, q8[i], EPS, **norm_kw)
        r, tms, tall = counted_timed(lambda: twin.query(q8[i], EPS,
                                                        **norm_kw))
        rows.append(dict(query=i, answers=check(r.offsets, want,
                                                f"twin cNSM-ED query {i}"),
                         twin_ms=tms, twin_ms_runs=tall, engine_ms=ems,
                         twin_over_engine=tms / ems,
                         candidates=r.stats.n_candidates))
    out["twin_cnsm_ed"] = rows
    twin = ScalarTwinDtw(data8, index=index8, qcfg=qcfg, device_data=dev8)
    counted(kernels, launches, lambda: twin.query(rsm_q[0], EPS_RSM,
                                                  rho=RHO_RSM))
    rows = []
    for i, (q, (want, ems)) in enumerate(zip(rsm_q, dtw_want)):
        r, tms, tall = counted_timed(lambda: twin.query(q, EPS_RSM,
                                                        rho=RHO_RSM))
        rows.append(dict(answers=check(r.offsets, want,
                                       f"twin RSM-DTW single {i}"),
                         twin_ms=tms, twin_ms_runs=tall, engine_ms=ems,
                         twin_over_engine=tms / ems,
                         candidates=r.stats.n_candidates))
    out["twin_rsm_dtw"] = rows
    return out


# ------------------------------------------------------------ phase 14 ----
# bench: the port's bench at BENCH_N with --quick --no-northstar (main
# already serves the north star at n=1e8), then kernel_bench on the n=1e8
# series.
BENCH_N = 1_000_000


def bench_phase(dev8, kernels, launches: dict) -> dict:
    """``kvmatch_tpu_torch.bench.run`` in process: every quick section runs
    with no error, the demo is exact and every self-query is found; its
    launches are counted over the run alone.  Then
    ``measure_kernel_efficiency`` and ``compare_window_kernel`` on the
    resident n=1e8 series at their default (the JAX package's) shapes."""
    import shutil
    from kvmatch_tpu_torch import bench
    from kvmatch_tpu_torch.utils.kernel_bench import (
        compare_window_kernel, measure_kernel_efficiency)
    d = work_dir("smoke_bench")
    args = bench.parse_args(["--n", str(BENCH_N), "--quick",
                             "--no-northstar", "--log-dir", str(d)])
    t0 = time.perf_counter()
    line = counted(kernels, launches, lambda: bench.run(args))
    run_s = time.perf_counter() - t0
    ext = line["extras"]
    if ext["section_errors"]:
        raise AssertionError(f"bench sections failed: {ext['section_errors']}")
    if tuple(ext["sections_run"]) != bench.QUICK_SECTIONS:
        raise AssertionError(f"bench ran {ext['sections_run']}, skipped "
                             f"{ext['sections_skipped']}")
    corr = ext["correctness"]
    short = {k: v for k, v in corr.items() if k.endswith("_self_found")
             and isinstance(v, str) and len(set(v.split("/"))) != 1}
    if corr.get("demo_exact") is not True or not corr.get("dtw_self_found") \
            or short:
        raise AssertionError(f"bench correctness: {corr}")
    shutil.rmtree(d)
    t0 = time.perf_counter()
    eff = measure_kernel_efficiency(dev8)
    eff_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    window = compare_window_kernel(dev8)
    return dict(run_s=run_s, value=line["value"],
                vs_baseline=line["vs_baseline"], extras=ext,
                kernel_efficiency=eff, kernel_efficiency_s=eff_s,
                window_kernel=window,
                window_kernel_s=time.perf_counter() - t0)


# ------------------------------------------------------------ phase 15 ----
# selectivity: the calibrated matrix of both ED engines at n=1e8, L=8192,
# on SELECTIVITY_PER_DECADE self-queries a decade.  A depth cut from 4: the
# matrix at 4 took 164.1 s, most of it RSM-ED's phase 2 (7.1-9.8 s a
# query; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §4), past the two new
# phases' share of the script's limit.
SELECTIVITY_PER_DECADE = 2


def selectivity_phase(data8, dev8, index8, kernels, launches: dict,
                      per_decade: int = SELECTIVITY_PER_DECADE) -> dict:
    """``selectivity.run_matrix`` over the resident series and its
    stats-only index: no false dismissal on any decade line; the
    calibration seconds a query, and each decade's queries in the decade
    and at the target exactly."""
    from kvmatch_tpu_torch import IndexConfig, selectivity
    lines = counted(kernels, launches, lambda: selectivity.run_matrix(
        data8, dev8, index8, IndexConfig(), per_decade, L_MAIN))
    decades = [ln for ln in lines if ln["section"].endswith("_decade")]
    if len(decades) != 2 * len(selectivity.DECADES):
        raise AssertionError(f"{len(decades)} decade lines")
    missed = {(ln["section"], ln["decade"]): ln["false_dismissals"]
              for ln in decades if ln["false_dismissals"]}
    if missed:
        raise AssertionError(f"false dismissals: {missed}")
    keep = ("section", "decade", "target", "in_decade", "exact_count",
            "false_dismissals", "qps", "mean_t1_ms", "mean_t2_ms",
            "mean_candidates", "mean_host_rechecked", "mean_answers",
            "median_answers")
    return dict(per_decade=per_decade,
                calibrate_s_per_query={ln["section"]: ln["sec_per_query"]
                                       for ln in lines
                                       if "sec_per_query" in ln},
                decades=[{k: ln[k] for k in keep} for ln in decades])


# ------------------------------------------------------------ phase 16 ----
# sharded: the mesh's shards (on cuda:0 repeated, or on SHARDS cards when
# that many are visible); the RSM-DTW singles whose K1 count (over the whole
# series) is at most SHARDED_DTW_MAX_COUNT, up to SHARDED_DTW_SINGLES of them
# (the sharded steps have no LB cascade: every candidate takes a DP row);
# the first top_k of each recovery ladder.
SHARDS = 4
SHARDED_DTW_MAX_COUNT = 2_000_000
SHARDED_DTW_SINGLES = 4
SHARDED_TOP_K = {"ed": 1024, "ed_batched": 256, "norm": 256, "dtw": 256,
                 "norm_dtw": 64}


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def exact_sets(kind: str, data64, queries, ctxs, offsets, d2, eps: float,
               rho: int = 0) -> tuple:
    """Float64 confirm of a sharded step's candidates: per query, the
    offsets whose f32 d2 lies within eps^2 + guard_threshold (the engines'
    guard band, verify_guard 1e-2), checked exactly -- ED and cNSM-ED on the
    card over ``data64`` (the f64 series there), DTW on the host (the
    native f64 DP).  cNSM uses the engines' window statistics
    (engine/norm_ed.py:_confirm_znorm_exact).  Returns (sets, near rows)."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch import verify
    from kvmatch_tpu_torch.ops.dtw import dtw_banded_batch_f64
    eps2 = eps * eps
    L = queries.shape[1]
    thresh = eps2 + verify.guard_threshold(eps2, L, 1e-2)
    if offsets.dim() == 2:  # the single-query step: (n_sh, K)
        offsets, d2 = offsets[:, None], d2[:, None]
    sets, near_rows = [], 0
    cols = torch.arange(L, device=data64.device)
    for qi, q in enumerate(queries):
        near = torch.unique(offsets[:, qi][d2[:, qi] <= thresh])
        near_rows += int(near.numel())
        norm = kind.startswith("cnsm")
        if norm:
            mu_q, sd_q = ctxs[qi].params["_mu_q"], ctxs[qi].params["_sd_q"]
            qv = (q - mu_q) / sd_q
        else:
            qv = q
        keep = []
        for s in range(0, int(near.numel()), 4096):
            o = near[s:s + 4096]
            x = data64[o[:, None] + cols[None, :]]
            ok = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
            if norm:
                mu = x.mean(1)
                sd = torch.sqrt(torch.clamp_min((x * x).mean(1) - mu * mu, 0))
                ratio = sd / sd_q
                ok = ((torch.abs(mu - mu_q) <= BETA) & (ratio <= ALPHA)
                      & (ratio >= 1.0 / ALPHA) & (sd > 0))
                x = (x - mu[:, None]) / torch.where(sd > 0, sd, 1.0)[:, None]
            if kind.endswith("dtw"):
                dd = torch.as_tensor(dtw_banded_batch_f64(
                    x.cpu().numpy(), np.asarray(qv, np.float64), rho, eps2),
                    device=o.device)
            else:
                ref = torch.as_tensor(qv, dtype=torch.float64,
                                      device=o.device)
                dd = ((x - ref[None, :]) ** 2).sum(1)
            keep.append(o[ok & (dd <= eps2)])
        sets.append(set(torch.cat(keep).tolist()) if keep else set())
    return sets, near_rows


def sharded_phase(data8, stack8, buckets8, q8, offs8, raw8, eng8, reng8,
                  oracles: dict, device, kernels, launches: dict) -> dict:
    """The sharded build and the five sharded steps (parallel/) on a mesh of
    SHARDS shards, each answer set held to a resident engine's (or, at
    n=1e6, the float64 oracle's) after the f64 confirm; the steps'
    launches of ``kernels`` go into ``launches`` (the resident engines and
    the confirms run outside ``counted``).

    build: build_index_sharded at N_MAIN; its stack bit-equal to the
    single-device stack ``stack8`` over the valid starts, its index equal
    to ``buckets8`` (build_index_device_buckets).  Then, each through
    run_sharded_step_with_recovery from SHARDED_TOP_K: the single RSM-ED
    step on the README demo (offset 123,456, L=8192, eps=10); the batched
    RSM-ED step on the 8 north-star windows (eps=4, the kernels phase's
    RSM-ED plans); the cNSM-ED step on the north star (floods: the ladder
    must escalate); the RSM-DTW step (L=1024, rho=51, eps=6) on the
    selective singles, with K3 and again with K4; the cNSM-DTW step at
    n=1e6 (L=1024, rho=51, the exact_dtw series and queries) against the
    oracle.  Probe counts summed over the shards equal the resident ED
    engines'.  Last, dryrun_multichip(SHARDS)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngineDtw,
                                   generate_series)
    from kvmatch_tpu_torch.ops import dtw as td
    from kvmatch_tpu_torch.ops.ed import window_ed
    from kvmatch_tpu_torch.ops.probe import pack_segments_batch
    from kvmatch_tpu_torch.parallel import query as pq
    from kvmatch_tpu_torch.parallel.build import build_index_sharded
    from kvmatch_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                   norm_inputs, plan_group)
    from kvmatch_tpu_torch.parallel.mesh import make_mesh
    from kvmatch_tpu_torch.storage.memory import HbmStore
    icfg = IndexConfig()
    scales = tuple(icfg.scales)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    mesh = make_mesh([torch.device("cuda", i if cards >= SHARDS else 0)
                      if cards else device for i in range(SHARDS)])
    out = dict(mesh=[str(d) for d in mesh.devices])

    t0 = time.perf_counter()
    index_sh, stack_sh = counted(kernels, launches, lambda: build_index_sharded(
        data8, mesh, icfg))
    sync_all()
    out["build_s"] = time.perf_counter() - t0
    per, n = stack_sh.per, data8.size
    differ = 0
    for s, part in enumerate(stack_sh):
        for i, w in enumerate(scales):
            hi = min(per, n - w + 1 - s * per)
            if hi > 0:
                differ += int((part[i, :hi] != stack8[i, s * per:s * per + hi]
                               .to(part.device)).sum())
    if differ:
        raise AssertionError(f"sharded stack: {differ} bucket ids differ from "
                             f"the single-device stack")
    same_index(index_sh, buckets8, "build_index_sharded")
    out.update(stack_bit_equal=True, index_equal=True, per_shard=per)
    del index_sh
    data_sh = HbmStore(data8, sharding=mesh).device
    data64 = torch.as_tensor(data8, dtype=torch.float64, device=device)
    k_cap = per

    def step_run(name, factory, inputs):
        """The step through the ladder twice: the first run (it also makes
        the haloed views of a new L) and a warm one."""
        times = []
        for _ in range(2):
            rounds = []

            def fac(k):
                rounds.append(k)
                return factory(k)
            sync_all()
            t0 = time.perf_counter()
            res, used_k = counted(kernels, launches, lambda: (
                pq.run_sharded_step_with_recovery(
                    fac, inputs, top_k=SHARDED_TOP_K[name], k_cap=k_cap)))
            sync_all()
            times.append(time.perf_counter() - t0)
        return res, dict(s=times[1], s_first=times[0], rounds=rounds,
                         used_k=used_k, counts=res[0].tolist())

    def resident_run(fn):
        """The resident engine, timed after one untimed run."""
        fn()
        sync_all()
        t0 = time.perf_counter()
        res = fn()
        sync_all()
        return res, time.perf_counter() - t0

    def held(name, sets, want, near):
        for qi, (g, w) in enumerate(zip(sets, want)):
            if g != w:
                raise AssertionError(f"sharded {name} query {qi}: answer set "
                                     f"differs from the resident engine's "
                                     f"({len(g)} against {len(w)})")
        return dict(answers=[len(w) for w in want], near_rows=near,
                    equal=True)

    # The single RSM-ED step: the README demo.
    demo_off, demo_L, demo_eps = 123_456, 8192, 10.0
    qd = data8[demo_off:demo_off + demo_L][None]
    (seg,), ctx = plan_group(raw8, qd, demo_eps)
    (rd,), rd_s = resident_run(lambda: raw8.query_batch_device(qd,
                                                              demo_eps))
    res, info = step_run("ed", lambda k: pq.make_sharded_query_step(
        mesh, icfg, demo_L, top_k=k), (data_sh, stack_sh, qd[0],
                                       pq.pack_segments(seg, scales, device),
                                       demo_eps ** 2, n))
    sets, near = exact_sets("rsm_ed", data64, qd, ctx, res[1], res[2],
                            demo_eps)
    out["ed"] = dict(info, resident_s=rd_s, resident_candidates=int(
        rd.stats.n_candidates), **held("ed", sets, [set(
            rd.offsets.tolist())], near))
    if sum(info["counts"]) != rd.stats.n_candidates:
        raise AssertionError("sharded README demo: probe counts differ from "
                             "the resident engine's")

    # The batched RSM-ED step: the north-star windows as raw queries.
    segs, ctxs = plan_group(raw8, q8, EPS)
    rb, rb_s = resident_run(lambda: raw8.query_batch_device(q8, EPS))
    res, info = step_run("ed_batched", lambda k: (
        pq.make_sharded_query_step_batched(mesh, icfg, L_MAIN, top_k=k)), (
        data_sh, stack_sh, q8, pack_segments_batch(segs, scales, device),
        torch.full((len(q8),), EPS * EPS, device=device), n))
    sets, near = exact_sets("rsm_ed", data64, q8, ctxs, res[1], res[2],
                            EPS)
    out["ed_batched"] = dict(info, resident_s=rb_s, **held(
        "ed_batched", sets, [set(r.offsets.tolist()) for r in rb],
        near))
    if info["counts"] != [r.stats.n_candidates for r in rb]:
        raise AssertionError("sharded RSM-ED batch: probe counts differ from "
                             "the resident engine's")

    # The cNSM-ED step: the north star, through the recovery ladder.
    segs, ctxs = plan_group(eng8, q8, EPS, alpha=ALPHA, beta=BETA)
    cons, qhat = norm_inputs(ctxs, q8, device)
    rn, rn_s = resident_run(lambda: eng8.query_batch_device(
        q8, EPS, alpha=ALPHA, beta=BETA))
    window_ed.shapes.clear()
    res, info = step_run("norm", lambda k: (
        pq.make_sharded_query_step_norm_batched(mesh, icfg, L_MAIN, top_k=k)),
        (data_sh, stack_sh, qhat, pack_segments_batch(segs, scales, device),
         torch.full((len(q8),), EPS * EPS, device=device), cons, n))
    info["k2_shapes"] = dict(window_ed.shapes)
    if len(info["rounds"]) < 2:
        raise AssertionError("the north star did not escalate top_k")
    sets, near = exact_sets("cnsm_ed", data64, q8, ctxs, res[1],
                            res[2], EPS)
    counts = res[0].sum(0).tolist()
    out["norm"] = dict(info, resident_s=rn_s, counts_total=counts, **held(
        "norm", sets, [set(r.offsets.tolist()) for r in rn], near))
    if counts != [r.stats.n_candidates for r in rn]:
        raise AssertionError("sharded north star: probe counts differ from "
                             "the resident engine's")
    del res

    # The RSM-DTW step: the selective singles, with K3 and with K4.
    qs = np.stack([data8[o:o + L_RSM_DTW] for o in offs8])
    segs, ctxs = plan_group(reng8, qs, EPS_RSM, rho=RHO_RSM)
    # top_k = 0: the probe alone (every list empty), to pick the singles.
    probe_only = counted(kernels, launches, lambda: (
        pq.make_sharded_query_step_dtw_batched(
            mesh, icfg, L_RSM_DTW, RHO_RSM, top_k=0)(
            data_sh, stack_sh, qs,
            pack_segments_batch(segs, scales, device),
            torch.full((len(qs),), EPS_RSM ** 2, device=device), n)))
    totals = probe_only[0].sum(0).tolist()
    pick = [i for i, c in enumerate(totals)
            if c <= SHARDED_DTW_MAX_COUNT][:SHARDED_DTW_SINGLES]
    if not pick:
        raise AssertionError(f"no RSM-DTW single under "
                             f"{SHARDED_DTW_MAX_COUNT} candidates: {totals}")
    want, rs_s = [], 0.0
    for i in pick:
        r, t = resident_run(lambda i=i: reng8.query(qs[i], EPS_RSM,
                                                    rho=RHO_RSM))
        want.append(set(r.offsets.tolist()))
        rs_s += t
    inputs = (data_sh, stack_sh, qs[pick],
              pack_segments_batch([segs[i] for i in pick], scales, device),
              torch.full((len(pick),), EPS_RSM ** 2, device=device), n)
    res, info = step_run("dtw", lambda k: pq.make_sharded_query_step_dtw_batched(
        mesh, icfg, L_RSM_DTW, RHO_RSM, top_k=k), inputs)
    sets, near = exact_sets("rsm_dtw", data64, qs[pick], None, res[1],
                            res[2], EPS_RSM, RHO_RSM)
    out["dtw"] = dict(info, offsets=[int(offs8[i]) for i in pick],
                      probe_totals=totals, resident_s=rs_s,
                      **held("dtw", sets, want, near))
    td.DTW_STATE["variant"] = "rows"
    try:
        sync_all()
        t0 = time.perf_counter()
        res = counted(kernels, launches, lambda: (
            pq.make_sharded_query_step_dtw_batched(
                mesh, icfg, L_RSM_DTW, RHO_RSM, top_k=info["used_k"])(
                *inputs)))
        sync_all()
        k4_s = time.perf_counter() - t0
    finally:
        td.DTW_STATE["variant"] = "diag"
    sets, near = exact_sets("rsm_dtw", data64, qs[pick], None, res[1],
                            res[2], EPS_RSM, RHO_RSM)
    out["dtw_k4"] = dict(s=k4_s, **held("dtw_k4", sets, want, near))
    del res, data64

    # The cNSM-DTW step at n=1e6 against the oracle, through the ladder.
    L_n, rho_n = 1024, 51
    small = generate_series(1_000_000, seed=20260816)
    offs_n, qn = self_queries(small, 4, L_n, seed=1)
    small_index, small_stack = build_index_sharded(small, mesh, icfg)
    eng_n = NormQueryEngineDtw(small, index=small_index, icfg=icfg,
                               device_data="host")
    segs, ctxs = plan_group(eng_n, qn, EPS, alpha=ALPHA, beta=BETA,
                            rho=rho_n)
    cons, qhat = norm_inputs(ctxs, qn, device)
    k_cap = small_stack.per
    res, info = step_run("norm_dtw", lambda k: (
        pq.make_sharded_query_step_norm_dtw_batched(
            mesh, icfg, L_n, rho_n, top_k=k)), (
        HbmStore(small, sharding=mesh).device, small_stack, qhat,
        pack_segments_batch(segs, scales, device),
        torch.full((len(qn),), EPS * EPS, device=device), cons, small.size))
    small64 = torch.as_tensor(small, dtype=torch.float64, device=device)
    sets, near = exact_sets("cnsm_dtw", small64, qn, ctxs, res[1],
                            res[2], EPS, rho_n)
    want = oracles[oracle_key("cnsm_dtw", L_n, rho_n, EPS)]
    out["norm_dtw"] = dict(info, n=small.size, **held(
        "norm_dtw", sets, want, near))
    for o, got in zip(offs_n, sets):
        if int(o) not in got:
            raise AssertionError(f"sharded cNSM-DTW self-query {o} not found")
    out["halo_bytes"] = dict(series=data_sh.halo_bytes,
                             stack=stack_sh.halo_bytes)
    # The haloed copies the steps read, as allocated (one a Shards).
    out["haloed_bytes"] = dict(series=data_sh.haloed_bytes,
                               stack=stack_sh.haloed_bytes)
    del res, small64, data_sh, stack_sh

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        counted(kernels, launches, lambda: dryrun_multichip(
            SHARDS, mesh.devices))
    out["dryrun"] = dict(line=buf.getvalue().strip(),
                         s=time.perf_counter() - t0)
    return out


def kernel_registers(so) -> dict:
    """Registers, and local memory (spills) in bytes, of each kernel of the
    library, from ``cuobjdump -res-usage``; empty where the toolkit has no
    cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-res-usage", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            f = dict(kv.split(":", 1) for kv in line.split() if ":" in kv)
            out[name] = [int(f["REG"]), int(f.get("LOCAL", 0))]
            name = None
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), text=True,
                               capture_output=True, timeout=60,
                               check=True).stdout.splitlines()
        out = {n.split("(")[0]: v for n, v in zip(names, out.values())}
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the GPU and has no CPU mode",
              file=sys.stderr)
        return 2
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngine,
                                   NormQueryEngineDtw, QueryConfig,
                                   QueryEngine, QueryEngineDtw,
                                   generate_series, kernels)
    from kvmatch_tpu_torch.index.device_build import build_index_device_stats
    from kvmatch_tpu_torch.ops.dtw import dtw_diag, dtw_ds, dtw_rows
    from kvmatch_tpu_torch.ops.ed import window_ed, window_ed_f64
    from kvmatch_tpu_torch.ops.probe import cons_and, probe_flags
    from kvmatch_tpu_torch.ops.regions import region_znorm_near_multi
    from kvmatch_tpu_torch.state import series_to_device

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    build_s = PHASE_S["kernel_build"] = time.perf_counter() - t0
    emit(dict(phase="env", card=card, device=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              kernel_library=so.name, kernel_build_s=build_s,
              kernel_registers=kernel_registers(so)))

    # The n=1e8 serving state: one upload, the stats-only build, the engine.
    icfg = IndexConfig()
    t0 = t_build = time.perf_counter()
    data8 = generate_series(N_MAIN, seed=20260817)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data8, dev8 = series_to_device(data8, device)
    torch.cuda.synchronize(device)
    h2d_s = time.perf_counter() - t0
    builds = []
    for _ in range(2):  # cold, then warm
        st: dict = {}
        index8 = build_index_device_stats(data8, icfg, stats=st, data_dev=dev8)
        builds.append(st)
    eng8 = NormQueryEngine(data8, index=index8, icfg=icfg,
                           qcfg=QueryConfig(dense_probe_min_count=0),
                           device_data=dev8)
    offs8, q8 = self_queries(data8, 8, L_MAIN, seed=2)
    # The same engine over the card's f32 copy as its shadow: f32-exact, so
    # its exact confirm runs on the card (K2's f64 form), as the benchmark's
    # f32 series does; eng8's f64 series confirms on the host.
    data8f = dev8.cpu().numpy().astype(np.float64)
    eng8f = NormQueryEngine(data8f, index=index8, icfg=icfg,
                            qcfg=QueryConfig(dense_probe_min_count=0),
                            device_data=dev8)
    q8f = self_queries(data8f, 8, L_MAIN, seed=2)[1]
    PHASE_S["build"] = time.perf_counter() - t_build
    emit(dict(phase="build", card=card, n=N_MAIN, generate_s=gen_s,
              h2d_s=h2d_s, build_s_cold=builds[0]["build_seconds"],
              build_s=builds[1]["build_seconds"],
              build_mpts_per_s=builds[1]["mpts_per_second"],
              device_s=builds[1]["device_seconds"]))

    def phase(name, fn, **tags):
        t0 = time.perf_counter()
        res = fn()
        line = dict(phase=name, card=card, **tags)
        line.update(res)
        line["phase_s"] = PHASE_S[name] = time.perf_counter() - t0
        emit(line)
        return res

    # The cNSM-DTW engine shares the resident series and the stats-only
    # index (one index family serves all four engines, bench.py:325-326).
    eng8d = NormQueryEngineDtw(data8, index=index8, icfg=icfg,
                               qcfg=QueryConfig(dense_probe_min_count=0),
                               device_data=dev8)
    # RSM-ED plans of the same queries, probed over the same bucket stack.
    raw8 = QueryEngine(data8, index=index8, icfg=icfg,
                       qcfg=QueryConfig(dense_probe_min_count=0),
                       device_data=dev8)
    stack8 = eng8.probe.bucket_stack(L_MAIN, eng8.CACHE_MEM_FRACTION)
    kern = phase("kernels", lambda: dict(
        k1=check_probe_kernel(eng8, stack8, q8, device),
        k1_dtw_plans=check_probe_kernel(
            eng8d, eng8d.probe.bucket_stack(L_MAIN, eng8d.CACHE_MEM_FRACTION),
            q8, device, rho=RHO_MAIN),
        k1_raw_plans=check_probe_kernel(raw8, stack8, q8, device,
                                        norm=False),
        cons=check_cons_kernel(eng8, q8, device),
        cons_dtw_plans=check_cons_kernel(eng8d, q8, device, rho=RHO_MAIN),
        near=check_region_near_kernel(eng8, data8, offs8, device),
        k2=check_window_kernel(dev8, q8, device, K2_BATCH),
        k2_f64=check_window_f64(dev8, device),
        dtw=check_dtw_kernels(dev8, q8, device),
        k3_bitwise=check_bitwise(dev8, q8, device),
        ds_bitwise=check_bitwise(dev8, q8, device, "DS"),
        k4_bitwise=check_bitwise(dev8, q8, device, "K4")))
    k1, k1d, k1r, ca, cad, k2, k2f, kd, near = (kern[k] for k in (
        "k1", "k1_dtw_plans", "k1_raw_plans", "cons", "cons_dtw_plans", "k2",
        "k2_f64", "dtw", "near"))
    k2_main = k2["shapes"][f"B{K2_BATCH}_L{L_MAIN}"]
    phase("fft", lambda: fft_error(dev8, q8, device))
    oracles: dict = {}  # the n=1e6 oracle's sets, for the streamed engines
    phase("exact", lambda: exact_small(device, oracles))
    dtw_rows.launches = 0
    phase("exact_dtw", lambda: exact_dtw(device, oracles=oracles))
    rows_launches = dtw_rows.launches
    wide = phase("wide_band", lambda: wide_band(dev8, device))

    torch.cuda.reset_peak_memory_stats(device)
    probe_flags.launches = 0
    cons_and.launches = 0
    region_znorm_near_multi.launches = 0
    window_ed.launches = 0
    window_ed_f64.launches = 0

    def ed_main():
        window_ed.shapes.clear()
        main, batch_res = main_path(eng8, offs8, q8)
        if eng8.confirm_on_device or main["device_confirmed"]:
            raise AssertionError("the f64 series confirmed on the card")
        shapes = dict(batch=dict(window_ed.shapes))
        window_ed.shapes.clear()
        main.update(single_queries(eng8, q8, batch_res))
        main["k2_shapes"] = dict(shapes, singles=dict(window_ed.shapes))
        window_ed_f64.shapes.clear()
        main["card_confirm"] = card_confirm(eng8f, offs8, q8f)
        main["card_confirm"]["k2_f64_shapes"] = dict(window_ed_f64.shapes)
        return main
    main = phase("main", ed_main, n=N_MAIN, L=L_MAIN, eps=EPS, alpha=ALPHA,
                 beta=BETA)
    launches = dict(probe_flags=probe_flags.launches,
                    cons_and=cons_and.launches,
                    region_znorm_near_multi=region_znorm_near_multi.launches,
                    window_ed=window_ed.launches,
                    window_ed_f64=window_ed_f64.launches)
    emit(dict(phase="main_launches", card=card, launches=launches,
              peak_device_bytes=torch.cuda.max_memory_allocated(device)))
    if main["self_found"] != main["n_queries"]:
        raise AssertionError(f"self-queries found {main['self_found']}/"
                             f"{main['n_queries']}")

    torch.cuda.reset_peak_memory_stats(device)
    for fn in (probe_flags, cons_and, dtw_diag, dtw_rows, dtw_ds):
        fn.launches = 0
    reng8 = QueryEngineDtw(data8, index=index8, icfg=icfg,
                           qcfg=QueryConfig(dense_probe_min_count=0),
                           device_data=dev8)
    mdtw = phase("main_dtw", lambda: dict(
        cnsm=main_dtw(eng8d, offs8[:MAIN_DTW_QUERIES],
                      q8[:MAIN_DTW_QUERIES]),
        rsm=rsm_dtw_singles(reng8, data8, offs8)),
        n=N_MAIN, L=L_MAIN, rho=RHO_MAIN, eps=EPS, alpha=ALPHA, beta=BETA)
    dtw_launches = dict(probe_flags=probe_flags.launches,
                        cons_and=cons_and.launches,
                        dtw_diag=dtw_diag.launches, dtw_rows=dtw_rows.launches,
                        dtw_ds=dtw_ds.launches)
    emit(dict(phase="main_dtw_launches", card=card, launches=dtw_launches,
              peak_device_bytes=torch.cuda.max_memory_allocated(device)))
    for part in ("cnsm", "rsm"):
        r = mdtw[part]
        if r["self_found"] != r["n_queries"]:
            raise AssertionError(f"{part}-DTW self-queries found "
                                 f"{r['self_found']}/{r['n_queries']}")
    need = dict(probe_flags=launches["probe_flags"],
                cons_and=min(launches["cons_and"],
                             dtw_launches["cons_and"]),
                window_ed=launches["window_ed"],
                window_ed_f64=launches["window_ed_f64"],
                dtw_diag=dtw_launches["dtw_diag"],
                dtw_ds=dtw_launches["dtw_ds"], dtw_rows=rows_launches)
    for name, count in need.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on its "
                                 f"path")
    phase("routing", lambda: routing_ab(eng8, offs8, q8), n=N_MAIN, L=L_MAIN)
    phase("profile", lambda: profile_batch(eng8, q8), n=N_MAIN, L=L_MAIN)
    # The single-query ops of the JAX package's names, each call counted
    # (launches made to compare with the _multi forms are not).
    path_kernels = (probe_flags, cons_and, region_znorm_near_multi,
                    window_ed, dtw_diag, dtw_rows, dtw_ds)
    single_launches = {fn.__name__: 0 for fn in path_kernels}
    phase("single", lambda: single_phase(data8, dev8, q8, device,
                                         path_kernels, single_launches),
          n=N_MAIN, L=L_MAIN, rho=RHO_MAIN)
    emit(dict(phase="single_launches", card=card, launches=single_launches))

    # This slice's path: the full device build, then the streamed engines.
    full: dict = {}

    def run_build_full():
        res, full["index"], full["buckets"], full["host"] = build_full(
            data8, dev8, device)
        return res
    full_res = phase("build_full", run_build_full)
    # Only the streamed engines' queries count: the resident yardstick and
    # the oracle run outside ``counted``.
    stream_launches = {fn.__name__: 0 for fn in path_kernels}
    phase("stream", lambda: dict(
        main=stream_main(data8, dev8, full.pop("index"), offs8, q8, device,
                         path_kernels, stream_launches),
        small=stream_small(device, oracles, path_kernels, stream_launches)))
    emit(dict(phase="stream_launches", card=card, launches=stream_launches))
    for name in ("window_ed", "dtw_diag", "dtw_ds"):
        if stream_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"streamed path")
    # This slice's paths: persistence, the append build, the command line
    # and the baselines, each path's launches counted from 0 over it alone.
    phase("persist", lambda: persist(data8, dev8, full["buckets"], index8,
                                     q8, device))
    append_launches = {fn.__name__: 0 for fn in path_kernels}
    phase("append", lambda: counted(path_kernels, append_launches,
                                    lambda: append_build(
                                        data8, full.pop("host"),
                                        full_res["host"]["build_seconds"])))
    cli_launches = {fn.__name__: 0 for fn in path_kernels}
    phase("cli", lambda: cli_phase(data8, dev8, offs8, q8, offs8, device,
                                   path_kernels, cli_launches,
                                   fit_engines=dict(ed=eng8, dtw=reng8)))
    base_launches = {fn.__name__: 0 for fn in path_kernels}
    phase("baselines", lambda: baselines(data8, dev8, q8, offs8, eng8, raw8,
                                         reng8, index8, device, path_kernels,
                                         base_launches))
    emit(dict(phase="slice_launches", card=card, cli=cli_launches,
              baselines=base_launches, append=append_launches))
    if base_launches["dtw_diag"] < 1:
        raise AssertionError("K3 was not launched by UcrScanner.scan_dtw")
    # This slice's paths: the bench and the selectivity matrix, each
    # path's launches counted from 0 over it alone (kernel_bench's timed
    # launches are measurements and are not counted).
    bench_launches = {fn.__name__: 0 for fn in path_kernels}
    eff = phase("bench", lambda: bench_phase(dev8, path_kernels,
                                             bench_launches),
                n=BENCH_N)["kernel_efficiency"]
    sel_launches = {fn.__name__: 0 for fn in path_kernels}
    phase("selectivity", lambda: selectivity_phase(
        data8, dev8, index8, path_kernels, sel_launches), n=N_MAIN,
        L=L_MAIN)
    emit(dict(phase="measure_launches", card=card, bench=bench_launches,
              selectivity=sel_launches))
    for name, got in (("probe_flags", bench_launches),
                      ("dtw_diag", bench_launches),
                      ("dtw_ds", bench_launches),
                      ("probe_flags", sel_launches)):
        if got[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"bench or selectivity path")
    # This slice's path: the sharded build and steps, counted over it alone.
    shard_launches = {fn.__name__: 0 for fn in path_kernels}
    shard = phase("sharded", lambda: sharded_phase(
        data8, stack8, full.pop("buckets"), q8, offs8, raw8, eng8, reng8,
        oracles, device, path_kernels, shard_launches), n=N_MAIN,
        shards=SHARDS)
    emit(dict(phase="sharded_launches", card=card, launches=shard_launches))
    for name in ("probe_flags", "window_ed", "dtw_diag", "dtw_rows"):
        if shard_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"sharded path")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "kvmatch_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded jax or the JAX package: "
                             f"{loaded[:5]}")
    per_batch = mdtw["cnsm"]["launches_per_batch"]
    k2f_shapes = k2f["shapes"]
    k2f_tag = "B{}_L{}".format(*max(K2_F64_SHAPES))
    k2f_big = k2f_shapes[k2f_tag]

    def with_bound(entry, work, per_batch_launches):
        return dict(entry, bound_ms=work["bound_ms"],
                    bound_by=work["bound_by"],
                    share_of_bound=work["bound_ms"] / entry["ms"],
                    launches_per_main_dtw_batch=per_batch_launches)

    def dp_entry(name, replaces, key, launches_, launched_on, work):
        return with_bound(dict(
            name=name, route="cuda", source="kvmatch_tpu_torch/csrc/dtw.cu",
            replaces=replaces, launches=launches_, launched_on=launched_on,
            max_abs_err=max(kd[v][key]["max_abs_err"] for v in
                            ("raw", "znorm")),
            max_err_over_bound=max(kd[v][key]["max_err_over_bound"]
                                   for v in ("raw", "znorm")),
            ms=kd["znorm"][key]["ms"], library_ms=None,
            wide_band_ms={case: v[name]["ms"]
                          for case, v in wide["kernels"].items()}), work,
            per_batch[name])

    rows = [
        with_bound(dict(
            name="probe_flags", route="cuda",
            source="kvmatch_tpu_torch/csrc/probe.cu",
            replaces="kvmatch_tpu/ops/probe_pallas.py:63",
            launches=launches["probe_flags"], launched_on="main",
            max_abs_err=max(k["max_abs_err"] for k in (k1, k1d, k1r)),
            tolerance="counts and flags equal (cNSM-ED, cNSM-DTW and RSM-ED "
                      "plans)",
            ms=k1["ms"], plain_ms=k1["plain_ms"], library_ms=None,
            bound_full_ms=k1["bound_full_ms"],
            dtw_plans_ms=k1d["ms"], dtw_plans_plain_ms=k1d["plain_ms"],
            dtw_plans_bound_ms=k1d["bound_ms"],
            raw_plans_ms=k1r["ms"], raw_plans_plain_ms=k1r["plain_ms"],
            raw_plans_bound_ms=k1r["bound_ms"],
            raw_plans_bound_by=k1r["bound_by"],
            raw_plans_stack_rows_read=k1r["stack_rows_read"]), k1,
            per_batch["probe_flags"]),
        with_bound(dict(
            name="cons_and", route="cuda",
            source="kvmatch_tpu_torch/csrc/probe.cu",
            replaces="kvmatch_tpu/parallel/query.py:762 (XLA, not Pallas)",
            launches=launches["cons_and"], launched_on="main",
            max_abs_err=max(c["flags_differ"] for c in (ca, cad)),
            tolerance="flags equal (cNSM-ED and cNSM-DTW plans)",
            ms=ca["ms"], plain_ms=ca["plain_ms"], copy_ms=ca["copy_ms"],
            library_ms=None, bound_full_ms=ca["bound_full_ms"],
            cleared_share=ca["cleared_share"],
            columns_read=ca["columns_read"], columns=ca["columns"],
            dtw_plans_ms=cad["ms"], dtw_plans_plain_ms=cad["plain_ms"],
            dtw_plans_bound_ms=cad["bound_ms"],
            dtw_plans_cleared_share=cad["cleared_share"]), ca,
            per_batch["cons_and"]),
        dict(name="region_near", route="cuda",
             source="kvmatch_tpu_torch/csrc/regions.cu",
             replaces="kvmatch_tpu/ops/regions.py:242 (XLA, not Pallas)",
             launches=launches["region_znorm_near_multi"],
             launched_on="main", count=near["count"],
             count_plain=near["count_plain"], differ=near["differ"],
             tolerance=f"counts equal; sets equal but for windows within "
                       f"{NEAR_ULPS} f32 ulps of a limit",
             ms=near["ms"], plain_ms=near["plain_ms"],
             section_ms=near["section_ms"], library_ms=None,
             bound_ms=near["bound_ms"], bound_by=near["bound_by"],
             share_of_bound=near["share_of_bound"],
             timing=f"the call (three kernels, two cuFFT transforms) by "
                    f"CUDA events, B={near['chunk_rows']} "
                    f"({near['real_rows']} rows), L={near['L']}, "
                    f"M={near['M']}"),
        with_bound(dict(
            name="window_ed", route="cuda",
            source="kvmatch_tpu_torch/csrc/window_ed.cu",
            replaces="kvmatch_tpu/ops/pallas_ed.py:60",
            launches=launches["window_ed"], launched_on="main",
            max_abs_err=max(k2[v]["max_abs_err"] for v in ("raw", "znorm")),
            max_err_over_bound=max(k2[v]["max_err_over_bound"]
                                   for v in ("raw", "znorm")),
            tolerance="|d2 - d2_plain| <= 1e-5 L + 1e-5 d2",
            ms=k2_main["znorm"]["device_ms"],
            plain_ms=k2["znorm"]["plain_ms"],
            raw_ms=k2_main["raw"]["device_ms"],
            raw_plain_ms=k2["raw"]["plain_ms"],
            library_ms=k2_main["raw"]["library_ms"],
            timing="device time alone (torch.profiler), B=16384, L=8192",
            library="torch.cdist of the pre-gathered raw windows, gather "
                    "excluded (compare with raw_ms)",
            device_ms_by_shape={
                tag: dict({name: {k: e[name][k] for k in (
                    "device_ms", "host_us", "bound_ms", "share_of_bound",
                    "library_ms", "max_err_over_bound", "plain_ms")}
                           for name in ("raw", "znorm")}, traces=e["traces"])
                for tag, e in k2["shapes"].items()},
            launched_shapes=dict(main["k2_shapes"],
                                 sharded_north_star=shard["norm"][
                                     "k2_shapes"])), k2["znorm"],
            per_batch["window_ed"]),
        dict(name="window_ed_f64", route="cuda",
             source="kvmatch_tpu_torch/csrc/window_ed.cu",
             replaces=None, launches=launches["window_ed_f64"],
             launched_on="main",
             max_err_rel=max(max(e[k] for k in ("d2_err_rel", "std_err_rel",
                                                "mean_err_rel"))
                             for e in k2f_shapes.values()),
             tolerance="d2 and std within 1e-12 relative of the plain f64 "
                       "mode (d2 1e-12 L near 0), mean within 1e-12 max|x|",
             ms=k2f_big["device_ms"], plain_ms=k2f_big["plain_ms"],
             library_ms=None, bound_ms=k2f_big["bound_ms"],
             bound_by=k2f_big["bound_by"],
             share_of_bound=k2f_big["share_of_bound"],
             timing=f"device time alone (torch.profiler), {k2f_tag}",
             device_ms_by_shape={
                 tag: {k: e[k] for k in (
                     "device_ms", "host_us", "plain_ms", "bound_ms",
                     "bound_by", "share_of_bound", "traces")}
                 for tag, e in k2f_shapes.items()},
             launched_shapes=main["card_confirm"]["k2_f64_shapes"]),
        dict(dp_entry("dtw_diag", "kvmatch_tpu/ops/dtw_pallas.py:176",
                      "dtw_diag", dtw_launches["dtw_diag"], "main_dtw",
                      kd["dp_bound"]),
             tolerance="|d - d_plain| <= guard_threshold(d_plain, L, 1e-2); "
                       "bit-equal to dtw_diag_plain (K3_BITWISE_CASES)",
             plain_ms=kd["znorm"]["plain_ms"],
             chunk_rows=kd["k3_chunk"]["rows"], chunk_ms=kd["k3_chunk"]["ms"],
             chunk_bound_ms=kd["k3_chunk"]["bound_ms"]),
        dict(dp_entry("dtw_rows", "kvmatch_tpu/ops/dtw_pallas.py:52",
                      "dtw_rows", rows_launches, "exact_dtw",
                      kd["dp_bound"]),
             tolerance="|d - d_plain| <= guard_threshold(d_plain, L, 1e-2); "
                       "bit-equal to dtw_rows_plain (the one-warp rows of "
                       "K3_BITWISE_CASES)",
             plain_ms=kd["znorm"]["plain_ms"],
             chunk_rows=kd["k4_chunk"]["rows"], chunk_ms=kd["k4_chunk"]["ms"],
             chunk_bound_ms=kd["k4_chunk"]["bound_ms"],
             rows_plain_ms_8_rows=kern["k4_bitwise"][
                 f"L{L_MAIN}_r{RHO_MAIN}"]["plain_ms"],
             k4_over_k3=kd["znorm"]["dtw_rows"]["ms"]
             / kd["znorm"]["dtw_diag"]["ms"]),
        dict(dp_entry("dtw_ds", "kvmatch_tpu/ops/dtw.py:190", "dtw_ds",
                      dtw_launches["dtw_ds"], "main_dtw", kd["ds_bound"]),
             tolerance="|hi + lo - d64| <= 8 eps32 (d64 + 1); bit-equal "
                       "to dtw_ds_diag_plain (K3_BITWISE_CASES)",
             plain_ms=kd["raw"]["dtw_ds"]["plain_ms"]),
    ]
    # Each path's launches, counted from 0 over that path alone.
    paths = dict(main=launches, main_dtw=dtw_launches,
                 exact_dtw=dict(dtw_rows=rows_launches),
                 single=single_launches, stream=stream_launches, cli=cli_launches,
                 baselines=base_launches, append=append_launches,
                 bench=bench_launches, selectivity=sel_launches,
                 sharded=shard_launches)
    glob = wide["global_form"]
    # kernel_bench's section of each kernel, at the JAX package's shapes.
    sections = dict(window_ed="gather_ed", dtw_diag="banded_dtw",
                    dtw_rows="banded_dtw_rows", dtw_ds="ds_dtw")
    for row in rows:
        sec = sections.get(row["name"])
        if sec is not None:
            row["kernel_bench"] = {
                k: eff[f"{sec}_{k}"] for k in ("ms", "gbps", "bound_ms",
                                               "share")}
            row["kernel_bench"]["shape"] = eff[
                f"{'banded_dtw' if sec.startswith('banded') else sec}_shape"]
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items()
                                   if row["name"] in c}
        if row["name"] in glob:
            g = glob[row["name"]]
            row["global_form"] = dict(
                L=glob["L"], r=glob["r"], rows=glob["rows"], ms=g["ms"],
                plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
                bound_by=g["bound_by"])
    emit(dict(phase="time", card=card, phase_s=PHASE_S, plain_s=PLAIN_S,
              plain_total_s=sum(PLAIN_S.values()),
              total_s=time.perf_counter() - START))
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
