"""Calibrated selectivity matrix (port of scripts/selectivity_r5b.py).

The reference evaluates 100 queries per answer-selectivity decade
(QueryTestGroupBySelectivity.java:36-44).  Random (offset, eps) sweeps
cannot fill the upper decades of a smooth random walk (answer counts jump
from 1, the self-match, to millions as eps crosses the local density), so
the workload is constructed: for each random offset the query's distance
profile against every window is computed on the device (region FFT rows
and a running top-K, ``topk_profile``), and eps is set per decade at the
mid-gap of the target rank, ``round(3 * 10^d * n)`` answers (``calibrate``).
Each decade is then replayed as one timed batch through the serving engine
(the stats-only device index, every query on the device probe) with
T/T1/T2/#candidates/#answers, the queries in the decade, those that hit the
target exactly, and the false dismissals: a query whose own offset is not
among its answers (``replay``).

The targets and decade bounds follow n (``decade_targets``,
``decade_bounds``): at n = 1e8 they are the JAX script's 3, 30, 300, 3000.
A false dismissal fails the run (exit 1).  ``exact_count`` is reported, not
held: eps sits at the mid-gap of the f32 profile, and the engine confirms in
f64, so a query misses its target only where the f64 gap at the target rank
is narrower than the profile's f32 error (regions.py's ERR_C / FFT_ERR_C
bound).  The RSM-ED profile centres each query and its windows by that
query's own mean (distances do not change under a common shift): a
centre far from the query's level, such as the series mean, makes near
windows' energies large and their d2 a difference of f32 values whose ulp
is wider than the gaps between ranks.

  python -m kvmatch_tpu_torch.selectivity [--n N] [--length L]
      [--per-decade P] [--engines rsm_ed,cnsm_ed] [--out FILE]
      [--device cuda|cpu]

One JSON line per step goes to stdout and to the run's own file (default
``build/selectivity/selectivity_torch_run{k}.jsonl`` at the repository
root, k the first free); an existing ``--out`` is refused, so two runs never
share a file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from fractions import Fraction
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

DECADES = (-8, -7, -6, -5)
SERIES_SEED, OFFSET_SEED = 20260817, 7
ALPHA, BETA = 1.2, 5.0
#: Windows per region row, as the JAX script.
M_ROWS = 4096
#: Region rows per chunk of the sweep.  The JAX script's 64 was set for the
#: TPU.  At L = 8192 a row's temporaries (the gathered region, three FFTs
#: of 16,384 points, the doubling sliding sums) are about 1.5 MB, so 1024
#: rows hold about 1.5 GB beside the resident series, and the 24 chunks of
#: an n = 1e8 sweep leave the launches (a few dozen a chunk) far below the
#: work.
CHUNK_ROWS = 1024
#: Least top-K size; it grows past the largest target (``topk_size``).
K_MIN = 4096
ENGINES = ("rsm_ed", "cnsm_ed")
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "selectivity"


def decade_targets(n: int) -> Dict[int, int]:
    """Answers aimed at in each decade d: max(1, round(3 * 10^d * n)), the
    middle of the decade [10^d n, 10^(d+1) n)."""
    return {d: max(1, round(3 * n * Fraction(10) ** d)) for d in DECADES}


def decade_bounds(n: int, d: int) -> Tuple[Fraction, Fraction]:
    """The answer counts of decade d: [10^d n, 10^(d+1) n), exact."""
    return n * Fraction(10) ** d, n * Fraction(10) ** (d + 1)


def topk_size(n: int) -> int:
    """The top-K kept by a profile: K_MIN, or the power of two above the
    largest target (calibration reads rank target + 1)."""
    k = max(K_MIN, 1 << max(decade_targets(n).values()).bit_length())
    assert k > max(decade_targets(n).values())
    return k


def _constraint(mean, std, mu_q: float, sd_q: float):
    """cNSM's ALPHA/BETA constraint on the windows' f32 mean and std, in
    f32 as the JAX script evaluates it."""
    f = np.float32
    a, b, m, s = f(ALPHA), f(BETA), f(mu_q), f(sd_q)
    return ((torch.abs(mean - float(m)) <= float(b))
            & (std <= float(a * s)) & (std >= float(s / a)))


def topk_profile(kind: str, data_dev: torch.Tensor, q: np.ndarray, k: int,
                 chunk: int = CHUNK_ROWS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest squared distances of query ``q`` (host, length L)
    to every window of the series ``data_dev`` and their window offsets,
    ascending, on the series' device.  ``kind`` "rsm": raw ED, the query
    and every window centred by the query's own mean (f64, rounded to f32);
    "cnsm":
    z-normalised ED, +inf where the window breaks the ALPHA/BETA
    constraint.  One sweep over the m = n - L + 1 windows in region rows of
    M_ROWS (row g owns offsets [g M, min((g + 1) M, m)); a row clamped at
    the end repeats windows it does not own, which are masked), ``chunk``
    rows a step, with a running top-k."""
    from .ops.regions import (region_ed_distances_multi,
                              region_znorm_distances_multi)
    if kind not in ("rsm", "cnsm"):
        raise ValueError(f"kind {kind!r}: 'rsm' or 'cnsm'")
    dev = data_dev.device
    n, L, M = int(data_dev.shape[0]), q.size, M_ROWS
    m = n - L + 1
    nrows = -(-m // M)
    starts = np.clip(np.arange(nrows, dtype=np.int64) * M, 0,
                     max(n - (M + L - 1), 0))
    if kind == "rsm":
        # The query's f64 mean, rounded to f32: the f32 windows and the
        # query are shifted by the same value.
        center = float(np.float32(q.mean()))
        qv = torch.as_tensor((q - center)[None], dtype=torch.float32,
                             device=dev)
    else:
        mu_q = q.mean()
        sd_q = np.sqrt(max(np.mean(q * q) - mu_q * mu_q, 0.0))
        qv = torch.as_tensor(((q - mu_q) / sd_q)[None], dtype=torch.float32,
                             device=dev)
    col = torch.arange(M, dtype=torch.int64, device=dev)
    best_v = torch.empty(0, dtype=torch.float32, device=dev)
    best_p = torch.empty(0, dtype=torch.int64, device=dev)
    for g0 in range(0, nrows, chunk):
        g = torch.arange(g0, min(g0 + chunk, nrows), device=dev)
        s = torch.as_tensor(starts[g0:g0 + chunk], device=dev)
        qids = torch.zeros(s.shape[0], dtype=torch.int32, device=dev)
        if kind == "rsm":
            d2, _ = region_ed_distances_multi(data_dev, qv, s, qids, L, M,
                                              center)
        else:
            d2, mean, std, _ = region_znorm_distances_multi(
                data_dev, qv, s, qids, L, M)
            d2 = torch.where(_constraint(mean, std, mu_q, sd_q), d2,
                             torch.inf)
        pos = s[:, None] + col[None, :]
        keep = (pos >= g[:, None] * M) & (pos < torch.clamp(
            (g[:, None] + 1) * M, max=m))
        d2 = torch.where(keep, d2, torch.inf)
        cand_v = torch.cat([best_v, d2.reshape(-1)])
        cand_p = torch.cat([best_p, pos.reshape(-1)])
        best_v, idx = torch.topk(cand_v, min(k, cand_v.numel()),
                                 largest=False)
        best_p = cand_p[idx]
    return best_v, best_p


def calibrate(kind: str, data: np.ndarray, data_dev: torch.Tensor, offs,
              length: int, targets: Dict[int, int], k: int,
              log: Callable = None
              ) -> Tuple[Dict[int, List[float]], float]:
    """eps per decade for each self-query ``data[o:o + length]``: the
    square root of the middle of the gap between the target-th and the
    next smallest squared distance of its profile (a flat 2% past the last
    finite one when the constrained set is smaller).  Returns (eps by
    decade, seconds)."""
    eps: Dict[int, List[float]] = {d: [] for d in targets}
    sync = (lambda: torch.cuda.synchronize(data_dev.device)) \
        if data_dev.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for j, o in enumerate(offs):
        vals, _ = topk_profile(kind, data_dev, data[o:o + length], k)
        ds = vals.cpu().numpy()
        fin = ds[np.isfinite(ds)]
        for d, target in targets.items():
            kk = min(target, fin.size)
            lo = fin[kk - 1]
            hi = fin[kk] if kk < fin.size else lo * 1.02 + 1e-3
            eps[d].append(float(np.sqrt((lo + hi) / 2.0)))
        if log is not None and (j + 1) % 25 == 0:
            log(section=f"{kind}_calibrate", done=j + 1,
                sec=time.perf_counter() - t0)
    return eps, time.perf_counter() - t0


def replay(eng, name: str, data: np.ndarray, offs, length: int,
           eps_by_decade: Dict[int, List[float]], params: dict,
           targets: Dict[int, int]) -> List[dict]:
    """One timed batch of the self-queries per decade through ``eng``; a
    line per decade."""
    n = data.size
    queries = np.stack([data[o:o + length] for o in offs])
    lines = []
    for d, target in targets.items():
        t0 = time.perf_counter()
        res = eng.query_batch(queries, np.asarray(eps_by_decade[d]), **params)
        wall = time.perf_counter() - t0
        ans = np.array([r.stats.n_answers for r in res], dtype=np.int64)
        lo, hi = decade_bounds(n, d)
        lines.append(dict(
            section=f"{name}_decade", decade=f"1e{d}", n_queries=len(offs),
            target=target, qps=len(offs) / wall,
            mean_t_ms=wall * 1e3 / len(offs),
            mean_t1_ms=float(np.mean([r.stats.t_phase1_ms for r in res])),
            mean_t2_ms=float(np.mean([r.stats.t_phase2_ms for r in res])),
            mean_candidates=float(np.mean([r.stats.n_candidates
                                           for r in res])),
            mean_host_rechecked=float(np.mean([r.stats.n_host_rechecked
                                               for r in res])),
            mean_answers=float(ans.mean()),
            median_answers=float(np.median(ans)),
            in_decade=int(np.sum((ans >= lo) & (ans < hi))),
            exact_count=int(np.sum(ans == target)),
            false_dismissals=sum(1 for o, r in zip(offs, res)
                                 if int(o) not in r.offsets.tolist()),
            answers=ans.tolist()))
    return lines


def run_matrix(data: np.ndarray, data_dev: torch.Tensor, index, icfg,
               per_decade: int, length: int, engines=ENGINES,
               emit: Callable = None) -> List[dict]:
    """Calibrate and replay each engine of ``engines`` on ``per_decade``
    self-queries of ``data`` (resident as ``data_dev``, with its stats-only
    ``index``), every query on the device probe
    (``QueryConfig.h100_tuned(dense_probe_min_count=0)``).  Every line is
    passed to ``emit(**line)`` and returned."""
    from .config import QueryConfig
    from .engine.norm_ed import NormQueryEngine
    from .engine.rsm_ed import QueryEngine
    qcfg = QueryConfig.h100_tuned(dense_probe_min_count=0)
    lines: List[dict] = []

    def log(**line):
        lines.append(line)
        if emit is not None:
            emit(**line)

    n = data.size
    targets, k = decade_targets(n), topk_size(n)
    offs = np.sort(np.random.default_rng(OFFSET_SEED).integers(
        0, n - length, per_decade))
    for name in engines:
        if name not in ENGINES:
            raise ValueError(f"engine {name!r}: one of {ENGINES}")
        kind = name.split("_")[0]
        cls, params = ((QueryEngine, {}) if kind == "rsm" else
                       (NormQueryEngine, dict(alpha=ALPHA, beta=BETA)))
        log(section="engine", name=name)
        eng = cls(data, index=index, icfg=icfg, qcfg=qcfg,
                  device_data=data_dev)
        eps, sec = calibrate(kind, data, data_dev, offs, length, targets, k,
                             log=log)
        log(section=f"{kind}_calibrate", done=len(offs), sec=sec,
            sec_per_query=sec / len(offs), topk=k, chunk_rows=CHUNK_ROWS)
        for line in replay(eng, name, data, offs, length, eps, params,
                           targets):
            log(**line)
    return lines


def _out_path(out) -> Path:
    if out is not None:
        return Path(out)
    k = 1
    while (OUT_DIR / f"selectivity_torch_run{k}.jsonl").exists():
        k += 1
    return OUT_DIR / f"selectivity_torch_run{k}.jsonl"


def main(argv=None) -> int:
    from .backend import resolve_device
    from .config import IndexConfig
    from .data.generators import generate_series
    from .index.device_build import build_index_device_stats
    from .state import series_to_device
    from .utils.kernel_bench import card_line
    ap = argparse.ArgumentParser(
        prog="python -m kvmatch_tpu_torch.selectivity",
        description="Calibrated selectivity matrix of the ED engines.")
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--length", type=int, default=8192)
    ap.add_argument("--per-decade", type=int, default=100)
    ap.add_argument("--engines", default=",".join(ENGINES))
    ap.add_argument("--out", default=None,
                    help="the run's file (refused if it exists)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    engines = tuple(args.engines.split(","))
    if torch.device(args.device or "cuda").type == "cuda" \
            and not torch.cuda.is_available():
        print("selectivity: no CUDA device (torch.cuda.is_available() is "
              "false); pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    path = _out_path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "x") as fh:
        def emit(**line):
            text = json.dumps(line)
            fh.write(text + "\n")
            fh.flush()
            print(text, flush=True)

        t0 = time.perf_counter()
        icfg = IndexConfig()
        data, data_dev = series_to_device(
            generate_series(args.n, seed=SERIES_SEED), device)
        index = build_index_device_stats(data, icfg, data_dev=data_dev)
        emit(section="setup", sec=time.perf_counter() - t0, n=args.n,
             length=args.length, per_decade=args.per_decade,
             engines=list(engines), targets=decade_targets(args.n),
             device=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
             card=card_line() if device.type == "cuda" else None)
        lines = run_matrix(data, data_dev, index, icfg, args.per_decade,
                           args.length, engines, emit=emit)
        missed = sum(ln.get("false_dismissals", 0) for ln in lines)
        emit(section="done", sec=time.perf_counter() - t0,
             false_dismissals=missed)
    print(f"[selectivity] lines in {path}", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
