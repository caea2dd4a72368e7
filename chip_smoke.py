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
                with the 8 north-star cNSM-ED plans and the 8 cNSM-DTW
                envelope plans; K2 (window distances, raw and z-norm) at
                B=16384, L=8192; K3 (dtw_diag), K4 (dtw_rows) and the
                double-single DP (dtw_ds) on one bucket of B=1024 windows,
                L=8192, r=409, raw and z-normed;
3. fft       -- the cuFFT f32 correlation error at the region shape
                (M=8192, L=8192) against f64, as a share of FFT_ERR_C;
4. exact     -- n=1e6 answer sets against the port's float64 brute-force
                oracle: cNSM-ED self-queries at L=1024 and 8192, and the
                RSM-ED README demo;
   exact_dtw -- n=1e6 RSM-DTW (L=1024, rho=51) and cNSM-DTW (L=1024,
                rho=51; L=8192, rho=409) answer sets against the oracle,
                each with K3 and with the K4 variant;
5. main      -- cNSM-ED at n=1e8, L=8192, 8 self-queries, eps=4,
                alpha=1.2, beta=5 (bench.py's north star): one warm batch,
                3 timed batches, then each query alone through engine.query
                (the latency path); launch counts of K1 and K2 over both;
   main_dtw  -- cNSM-DTW at n=1e8, L=8192, rho=409 on the same series,
                index and the first 4 queries (MAIN_DTW_QUERIES): one warm
                batch, 2 timed batches with their stage counts; then RSM-DTW (L=1024, rho=51, eps=6)
                on the same offsets, each query alone through engine.query;
                launch counts of K1, K3, K4 and DS;
6. routing   -- the cNSM-ED batch with phase 2 routed as a whole (the
                engine's policy) against routed per query, in turns;
7. profile   -- host spans of the cNSM-ED engine's phases and a
                torch.profiler device trace of one batch: kernel time by
                name, idle share.

Then the kernel table ({"kernels": [...]}), the nvidia-smi name/power line
and, last, {"ok": true, "device": {...}}.  A failing phase raises and the
script exits non-zero without the last line; so does a run that loaded jax
(the port and the jax-free host modules it shares must not), a machine
without a CUDA device, or a directory without the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

L_MAIN = 8192
N_MAIN = 100_000_000
ALPHA, BETA, EPS = 1.2, 5.0, 4.0
K2_BATCH = 16384  # verify.bucket_size's cap for rows of width 8192
RHO_MAIN = 409    # 0.05 L, bench.py:328
DTW_BATCH = 1024  # one DP bucket of the kernels phase
L_RSM_DTW, RHO_RSM, EPS_RSM = 1024, 51, 6.0  # bench.py:257-265
# cNSM-DTW batches of main_dtw take the first 4 of the 8 north-star queries:
# five of the eight flood (2.8M-9.4M candidates, up to 6.9M DP rows at
# ~62K rows/s on an H100), and all eight cost 195 s one by one -- over
# the 2-minute budget of one batch; the first four (one flood) take about
# 112 s.  n and L are not cut.
MAIN_DTW_QUERIES = 4
# exact_dtw: (engine, n, L, rho, eps)
DTW_EXACT_SHAPES = (("rsm_dtw", 1_000_000, L_RSM_DTW, RHO_RSM, EPS_RSM),
                    ("cnsm_dtw", 1_000_000, 1024, 51, EPS),
                    ("cnsm_dtw", 1_000_000, L_MAIN, RHO_MAIN, EPS))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, synchronized."""
    import torch
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


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
def check_probe_kernel(eng, queries, device, **params) -> dict:
    """K1 over the engine's cached bucket stack with the batch's plans,
    against the plain version: counts and flags must be equal.  A cNSM-DTW
    engine (``rho=``) plans envelope segments (mean_lo < mean_hi)."""
    import torch
    from kvmatch_tpu_torch.ops.probe import FLAG, probe_flags, probe_flags_plain
    from kvmatch_tpu_torch.parallel.query import pack_segments_batch
    L = queries.shape[1]
    ctxs = norm_ctxs(queries, EPS, **params)
    plans = eng._plan_batch(ctxs)
    bstack = eng._fly_bucket_stack(L)
    if bstack is None:
        raise RuntimeError("bucket stack does not fit the device budget")
    icfg = eng.icfg
    segs = pack_segments_batch(plans, tuple(icfg.scales), device)
    eps2 = torch.full((len(ctxs),), EPS * EPS, dtype=torch.float32,
                      device=device)
    cons = torch.tensor([[ALPHA, BETA, c.params["_mu_q"], c.params["_sd_q"]]
                         for c in ctxs], dtype=torch.float32, device=device)
    m = eng.n - L + 1
    npos = -(-m // FLAG) * FLAG
    Q = len(ctxs)

    def run(fn):
        flags = torch.zeros((Q, npos // FLAG), dtype=torch.bool, device=device)
        counts = torch.zeros(Q, dtype=torch.int32, device=device)
        fn(bstack, 0, segs, eps2, cons, 0, npos, m, flags, counts, length=L,
           unit=icfg.unit, d=icfg.d, slack=icfg.probe_guard, norm=True)
        return counts, flags

    got, want = run(probe_flags), run(probe_flags_plain)
    count_err = int((got[0].long() - want[0].long()).abs().max())
    flag_diff = int((got[1] != want[1]).sum())
    if count_err or flag_diff:
        raise AssertionError(f"K1 disagrees with its plain version: count "
                             f"error {count_err}, {flag_diff} flags differ")
    return dict(counts=got[0].tolist(), flagged_blocks=int(got[1].sum()),
                max_abs_err=count_err, flags_differ=flag_diff,
                ms=timed_ms(lambda: run(probe_flags), 5, device),
                plain_ms=timed_ms(lambda: run(probe_flags_plain), 1, device),
                segments=[len(p) for p in plans],
                envelope_segments=sum(s.mean_lo < s.mean_hi
                                      for p in plans for s in p))


def check_window_kernel(data_dev, queries, device, batch: int) -> dict:
    """K2 raw and z-norm at (batch, L) against the plain version within
    |dd2| <= 1e-5 L + 1e-5 d2 and |dmean|, |dstd| <= 1e-5 max|x|."""
    import numpy as np
    import torch
    from kvmatch_tpu_torch.ops.ed import _gather, window_ed, window_ed_plain
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
    scale = _gather(data_dev, offs, L).abs().amax(dim=1)
    out = {}
    for name, qm, znorm in (("raw", qraw, False), ("znorm", qhat, True)):
        args = (data_dev, qm, offs, qids, L, znorm)
        got, want = window_ed(*args), window_ed_plain(*args)
        g = got if znorm else (got,)
        w = want if znorm else (want,)
        finite = torch.isfinite(w[0])
        if not torch.equal(torch.isfinite(g[0]), finite):
            raise AssertionError(f"K2 {name}: infinite rows differ")
        err = (g[0] - w[0]).abs()[finite]
        bound = 1e-5 * L + 1e-5 * w[0].abs()[finite]
        if bool((err > bound).any()):
            raise AssertionError(f"K2 {name}: d2 error {float(err.max())} "
                                 f"beyond 1e-5 L + 1e-5 d2")
        stat_err = max([float(((a - b).abs() / scale).max())
                        for a, b in zip(g[1:], w[1:])], default=0.0)
        if stat_err > 1e-5:
            raise AssertionError(f"K2 {name}: mean/std error {stat_err} of "
                                 f"max|x| beyond 1e-5")
        out[name] = dict(
            max_abs_err=float(err.max()),
            max_err_over_bound=float((err / bound).max()),
            stat_err_rel=stat_err,
            ms=timed_ms(lambda: window_ed(*args), 20, device),
            plain_ms=timed_ms(lambda: window_ed_plain(*args), 5, device))
    return out


def check_dtw_kernels(data_dev, queries, device, batch: int = DTW_BATCH,
                      r: int = RHO_MAIN) -> dict:
    """K3 (dtw_diag), K4 (dtw_rows) and the DS kernel on one DP bucket of
    ``batch`` windows of the series against the north-star queries, raw and
    z-normed.  K3 and K4: |d - d_plain| <= verify.guard_threshold(d_plain, L,
    1e-2), and K3 within the same band of K4.  DS: hi + lo within
    8 eps32 (d64 + 1) of the f64 DP of the same f32 inputs (the plain
    version run in float64 on the card)."""
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
        t0 = time.perf_counter()
        plain = td.dtw_banded_plain(*args).double()
        torch.cuda.synchronize(device)
        res = dict(plain_ms=(time.perf_counter() - t0) * 1e3)
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
        d64 = td.dtw_banded_plain(rows.double(), qm.double(), qids, r)
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
            t0 = time.perf_counter()
            hi, lo = td.dtw_banded_ds_plain(*args)
            torch.cuda.synchronize(device)
            err = (hi.double() + lo.double() - d64).abs()
            res["dtw_ds"].update(
                plain_ms=(time.perf_counter() - t0) * 1e3,
                plain_max_err_over_bound=float((err / tol).max()))
    return dict(batch=batch, L=L, r=r, **out)


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
def exact_small(device, n: int = 1_000_000, seed: int = 20260816,
                cnsm_lengths=(1024, 8192), cnsm_queries: int = 4,
                demo_offset: int = 123456, demo_length: int = 8192) -> dict:
    """Answer sets at n=1e6 EQUAL the port's float64 brute-force oracle
    (run on the card): cNSM-ED self-queries through query_batch_device, and
    the RSM-ED README demo with phase 2 forced onto the device (its
    scattered candidates go through K2)."""
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
        for o, q, r in zip(offs, qs, res):
            want, _ = oracle.nsm_ed(data, q, EPS, alpha=ALPHA, beta=BETA,
                                    device=device)
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
    if set(r.offsets.tolist()) != set(want.tolist()):
        raise AssertionError("RSM-ED README demo: answer set differs from "
                             "the oracle")
    out.update(demo_answers=r.offsets.tolist(),
               demo_k2_launches=window_ed.launches - k2_before,
               demo_candidates=r.stats.n_candidates, demo_equal=True,
               seconds=time.perf_counter() - t0)
    return out


def exact_dtw(device, shapes=DTW_EXACT_SHAPES, seed: int = 20260816,
              n_queries: int = 4) -> dict:
    """DTW answer sets EQUAL the port's float64 oracle (on the card), each
    shape run twice through ``query_batch``: with K3 (``dtw_diag``) and
    with the K4 variant (``dtw_rows``) as the f32 DP."""
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngineDtw,
                                   QueryConfig, QueryEngineDtw,
                                   generate_series, oracle)
    from kvmatch_tpu_torch.index.device_build import build_index_device_stats
    from kvmatch_tpu_torch.ops import dtw as td
    from kvmatch_tpu_torch.state import series_to_device
    icfg = IndexConfig()
    qcfg = QueryConfig(dense_probe_min_count=0)
    series = {}
    out = []
    for name, n, L, rho, eps in shapes:
        if n not in series:
            data, dev = series_to_device(generate_series(n, seed=seed),
                                         device)
            series[n] = (data, dev, build_index_device_stats(
                data, icfg, data_dev=dev))
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
        answers=[int(r.offsets.size) for r in res], self_found=found,
        n_queries=len(queries)), res


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


def main_dtw(eng, offs, queries, reps: int = 2) -> dict:
    """cNSM-DTW serving batches: one warm batch, then ``reps`` timed ones
    through ``query_batch``, with each batch's stage counts."""
    import torch
    kw = dict(rho=RHO_MAIN, alpha=ALPHA, beta=BETA)
    t0 = time.perf_counter()
    eng.query_batch(queries, EPS, **kw)
    warm_s = time.perf_counter() - t0
    qps, stages = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = eng.query_batch(queries, EPS, **kw)
        torch.cuda.synchronize(eng.device)
        qps.append(len(queries) / (time.perf_counter() - t0))
        stages.append(dict(eng.stage_counts))
    return dict(
        qps_median=statistics.median(qps), qps_reps=qps, warm_s=warm_s,
        p1_ms_per_query=statistics.fmean(r.stats.t_phase1_ms for r in res),
        p2_ms_per_query=statistics.fmean(r.stats.t_phase2_ms for r in res),
        stages_per_batch=stages,
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
SPANS = ("_plan_batch", "_device_dense_phase1_flags", "_flags_to_intervals",
         "_verify_multi", "_verify_regions", "_verify_gather",
         "_confirm_znorm_exact", "_confirm_znorm")


def profile_batch(eng, queries) -> dict:
    """Where the time goes in one serving batch.

    Host spans: each engine method of SPANS, timed between two
    ``synchronize()`` calls; spans are inclusive, so a nested span is also
    inside its parent's.  Device trace: ``torch.profiler`` over one more,
    unspanned batch; the idle share is 1 - |union of the device-event
    intervals inside the batch| / the batch's wall time, both on the
    profiler's clock (``device_sum_ms`` sums the same events, overlaps
    counted twice).  Kernel time by name sums event durations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    device = eng.device

    def batch():
        eng.query_batch(queries, EPS, alpha=ALPHA, beta=BETA)
        torch.cuda.synchronize(device)

    unspanned_ms = timed_ms(batch, 3, device)
    spans = {name: [0.0, 0] for name in SPANS}
    for name in SPANS:
        def timed(*a, _fn=getattr(eng, name), _span=spans[name], **kw):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = _fn(*a, **kw)
            torch.cuda.synchronize(device)
            _span[0] += (time.perf_counter() - t0) * 1e3
            _span[1] += 1
            return res
        setattr(eng, name, timed)
    t0 = time.perf_counter()
    batch()
    spanned_ms = (time.perf_counter() - t0) * 1e3
    for name in SPANS:
        delattr(eng, name)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("serving_batch"):
            batch()
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
        device_ms_by_name=[[k, v[0], v[1]] for k, v in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the GPU and has no CPU mode",
              file=sys.stderr)
        return 2
    if not (REPO / "kvmatch_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from kvmatch_tpu_torch import (IndexConfig, NormQueryEngine,
                                   NormQueryEngineDtw, QueryConfig,
                                   QueryEngineDtw, generate_series, kernels)
    from kvmatch_tpu_torch.index.device_build import build_index_device_stats
    from kvmatch_tpu_torch.ops.dtw import dtw_diag, dtw_ds, dtw_rows
    from kvmatch_tpu_torch.ops.ed import window_ed
    from kvmatch_tpu_torch.ops.probe import probe_flags
    from kvmatch_tpu_torch.state import series_to_device

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    emit(dict(phase="env", card=card, device=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              kernel_library=so.name,
              kernel_build_s=time.perf_counter() - t0))

    # The n=1e8 serving state: one upload, the stats-only build, the engine.
    icfg = IndexConfig()
    t0 = time.perf_counter()
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
        line["phase_s"] = time.perf_counter() - t0
        emit(line)
        return res

    # The cNSM-DTW engine shares the resident series and the stats-only
    # index (one index family serves all four engines, bench.py:325-326).
    eng8d = NormQueryEngineDtw(data8, index=index8, icfg=icfg,
                               qcfg=QueryConfig(dense_probe_min_count=0),
                               device_data=dev8)
    kern = phase("kernels", lambda: dict(
        k1=check_probe_kernel(eng8, q8, device),
        k1_dtw_plans=check_probe_kernel(eng8d, q8, device, rho=RHO_MAIN),
        k2=check_window_kernel(dev8, q8, device, K2_BATCH),
        dtw=check_dtw_kernels(dev8, q8, device)))
    k1, k1d, k2, kd = (kern[k] for k in ("k1", "k1_dtw_plans", "k2", "dtw"))
    phase("fft", lambda: fft_error(dev8, q8, device))
    phase("exact", lambda: exact_small(device))
    dtw_rows.launches = 0
    phase("exact_dtw", lambda: exact_dtw(device))
    rows_launches = dtw_rows.launches

    torch.cuda.reset_peak_memory_stats(device)
    probe_flags.launches = 0
    window_ed.launches = 0

    def ed_main():
        main, batch_res = main_path(eng8, offs8, q8)
        main.update(single_queries(eng8, q8, batch_res))
        return main
    main = phase("main", ed_main, n=N_MAIN, L=L_MAIN, eps=EPS, alpha=ALPHA,
                 beta=BETA)
    launches = dict(probe_flags=probe_flags.launches,
                    window_ed=window_ed.launches)
    emit(dict(phase="main_launches", card=card, launches=launches,
              peak_device_bytes=torch.cuda.max_memory_allocated(device)))
    if main["self_found"] != main["n_queries"]:
        raise AssertionError(f"self-queries found {main['self_found']}/"
                             f"{main['n_queries']}")

    torch.cuda.reset_peak_memory_stats(device)
    for fn in (probe_flags, dtw_diag, dtw_rows, dtw_ds):
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
                window_ed=launches["window_ed"],
                dtw_diag=dtw_launches["dtw_diag"],
                dtw_ds=dtw_launches["dtw_ds"], dtw_rows=rows_launches)
    for name, count in need.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on its "
                                 f"path")
    phase("routing", lambda: routing_ab(eng8, offs8, q8), n=N_MAIN, L=L_MAIN)
    phase("profile", lambda: profile_batch(eng8, q8), n=N_MAIN, L=L_MAIN)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    if loaded:
        raise AssertionError(f"the port loaded jax: {loaded[:5]}")

    def dp_entry(name, replaces, key, launches_, launched_on):
        return dict(
            name=name, route="cuda", source="kvmatch_tpu_torch/csrc/dtw.cu",
            replaces=replaces, launches=launches_, launched_on=launched_on,
            max_abs_err=max(kd[v][key]["max_abs_err"] for v in
                            ("raw", "znorm")),
            max_err_over_bound=max(kd[v][key]["max_err_over_bound"]
                                   for v in ("raw", "znorm")),
            ms=kd["znorm"][key]["ms"])

    emit({"kernels": [
        dict(name="probe_flags", route="cuda",
             source="kvmatch_tpu_torch/csrc/probe.cu",
             replaces="kvmatch_tpu/ops/probe_pallas.py:63",
             launches=launches["probe_flags"], launched_on="main",
             max_abs_err=max(k1["max_abs_err"], k1d["max_abs_err"]),
             tolerance="counts and flags equal (ED and DTW plans)",
             ms=k1["ms"], plain_ms=k1["plain_ms"],
             dtw_plans_ms=k1d["ms"], dtw_plans_plain_ms=k1d["plain_ms"]),
        dict(name="window_ed", route="cuda",
             source="kvmatch_tpu_torch/csrc/window_ed.cu",
             replaces="kvmatch_tpu/ops/pallas_ed.py:60",
             launches=launches["window_ed"], launched_on="main",
             max_abs_err=max(v["max_abs_err"] for v in k2.values()),
             max_err_over_bound=max(v["max_err_over_bound"]
                                    for v in k2.values()),
             tolerance="|d2 - d2_plain| <= 1e-5 L + 1e-5 d2",
             ms=k2["znorm"]["ms"], plain_ms=k2["znorm"]["plain_ms"]),
        dict(dp_entry("dtw_diag", "kvmatch_tpu/ops/dtw_pallas.py:176",
                      "dtw_diag", dtw_launches["dtw_diag"], "main_dtw"),
             tolerance="|d - d_plain| <= guard_threshold(d_plain, L, 1e-2)",
             plain_ms=kd["znorm"]["plain_ms"]),
        dict(dp_entry("dtw_rows", "kvmatch_tpu/ops/dtw_pallas.py:52",
                      "dtw_rows", rows_launches, "exact_dtw"),
             tolerance="|d - d_plain| <= guard_threshold(d_plain, L, 1e-2)",
             plain_ms=kd["znorm"]["plain_ms"]),
        dict(dp_entry("dtw_ds", "kvmatch_tpu/ops/dtw.py:190", "dtw_ds",
                      dtw_launches["dtw_ds"], "main_dtw"),
             tolerance="|hi + lo - d64| <= 8 eps32 (d64 + 1)",
             plain_ms=kd["raw"]["dtw_ds"]["plain_ms"]),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
