"""Command-line entry points of the PyTorch port, mirroring the reference's
interactive mains (a port of kvmatch_tpu/cli.py; the output lines keep its
format).

  python -m kvmatch_tpu_torch.cli generate-data N [--seed S] [--out PATH]
      DataGenerator.main (DataGenerator.java:56-78)
  python -m kvmatch_tpu_torch.cli build-index DATA [--out DIR] [--fmt npz|file]
      [--backend device|host] [--device DEV]
      IndexBuilder.main (IndexBuilder.java:88-96)
  python -m kvmatch_tpu_torch.cli query DATA --offset O --length L --epsilon E
      [--engine rsm-ed|rsm-dtw|cnsm-ed|cnsm-dtw|twin-...] [--rho R]
      [--alpha A] [--beta B] [--index PATH] [--one-based] [--device DEV]
      [--count-launches]
      QueryEngine.main and siblings (QueryEngine.java:100-152)
  python -m kvmatch_tpu_torch.cli oracle MEASURE PROBLEM DATA BEGIN END EPS
      [ALPHA BETA] [--rho R] [--device DEV]
      CsvTester.main (CsvTester.java:27-141), extended with the DTW cases the
      reference leaves unimplemented
  python -m kvmatch_tpu_torch.cli workload DATA [...] [--device DEV]
  python -m kvmatch_tpu_torch.cli export-queries DATA [...]

``--device`` is the torch device of the commands that compute: the current
CUDA device by default, ``--device cpu`` on a machine without a card (the
command exits with an error when it asks for a card that is not there).
``build-index --backend device`` runs the device bucket pass
(index/build.build_index_device_buckets, the engines' default index),
``--backend host`` the host build (index/build.build_index_host).
``query --count-launches`` prints the kernels' launch counts of the query
as one JSON line on stderr.

Offsets are 0-based by default; ``--one-based`` matches the reference's REPL
convention (README demo: Offset=123456 -> data[123455:...]).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np


def _load_data(path: str) -> np.ndarray:
    from .storage.file import TimeSeriesFileStore
    p = Path(path)
    if p.suffix == ".csv" or p.suffix == ".txt":
        return np.loadtxt(p, dtype=np.float64).ravel()
    return TimeSeriesFileStore(p).read_all()


def cmd_generate_data(args) -> int:
    from .data.generators import generate_series
    from .storage.file import TimeSeriesFileStore
    data = generate_series(args.n, seed=args.seed)
    out = args.out or f"files/data-{args.n}"
    TimeSeriesFileStore.write(out, data)
    print(f"wrote {args.n} points to {out} (seed={args.seed})")
    return 0


def cmd_build_index(args) -> int:
    from .config import IndexConfig
    from .index.build import build_index_device_buckets, build_index_host
    from .index.structure import total_memory_bytes
    from .storage.file import IndexFileStore, IndexNpzStore
    data = _load_data(args.data)
    stats: dict = {}
    if args.backend == "host":
        index = build_index_host(data, IndexConfig(), stats=stats)
    else:
        index = build_index_device_buckets(data, IndexConfig(), stats=stats,
                                           device=args.device)
    if args.fmt == "npz":
        out = args.out or f"files/index-{data.size}.npz"
        IndexNpzStore(out).save(index)
    else:
        out = args.out or "files"
        IndexFileStore(out, n=data.size).save(index)
    print(f"built index for n={data.size}: "
          f"{ {w: s.num_rows for w, s in index.items()} } rows, "
          f"{total_memory_bytes(index) / 1e6:.1f} MB in RAM, "
          f"{stats.get('mpts_per_second', 0):.2f} Mpts/s -> {out}")
    return 0


_ENGINES = {
    "rsm-ed": ("engine.rsm_ed", "QueryEngine"),
    "rsm-dtw": ("engine.rsm_dtw", "QueryEngineDtw"),
    "cnsm-ed": ("engine.norm_ed", "NormQueryEngine"),
    "cnsm-dtw": ("engine.norm_dtw", "NormQueryEngineDtw"),
    # measured single-thread scalar baselines (reference phase-2 loops in C;
    # baseline_twin.py) — for apples-to-apples timing comparisons
    "twin-rsm-ed": ("baseline_twin", "ScalarTwinEd"),
    "twin-rsm-dtw": ("baseline_twin", "ScalarTwinDtw"),
    "twin-cnsm-ed": ("baseline_twin", "ScalarTwinNormEd"),
    "twin-cnsm-dtw": ("baseline_twin", "ScalarTwinNormDtw"),
}

# The kernel wrappers whose launch counts ``query --count-launches`` prints.
_KERNELS = (("ops.probe", "probe_flags"), ("ops.ed", "window_ed"),
            ("ops.dtw", "dtw_diag"), ("ops.dtw", "dtw_rows"),
            ("ops.dtw", "dtw_ds"))


def _engine(args):
    from .config import IndexConfig
    from .storage.file import IndexNpzStore
    data = _load_data(args.data)
    mod, cls = _ENGINES[args.engine]
    Engine = getattr(importlib.import_module(f"{__package__}.{mod}"), cls)
    index = IndexNpzStore(args.index).load() if args.index else None
    return Engine(data, index=index, icfg=IndexConfig(), device=args.device)


def _kernels():
    return [getattr(importlib.import_module(f"{__package__}.{mod}"), name)
            for mod, name in _KERNELS]


def cmd_query(args) -> int:
    engine = _engine(args)
    params = {}
    if "dtw" in args.engine:
        rho = args.rho if args.rho is not None else 0.05
        params["rho"] = int(rho * args.length) if rho <= 1 else int(rho)
    if "cnsm" in args.engine:
        params["alpha"] = args.alpha
        params["beta"] = args.beta
    offset = args.offset - 1 if args.one_based else args.offset
    kernels = _kernels()
    before = [k.launches for k in kernels]
    res = engine.query_at(offset, args.length, args.epsilon, **params)
    if args.count_launches:
        print(json.dumps({k.__name__: k.launches - b
                          for k, b in zip(kernels, before)}), file=sys.stderr)
    s = res.stats
    base = 1 if args.one_based else 0
    for off, dist in zip(res.offsets, res.distances):
        print(f"{int(off) + base},{dist}")
    if res.found:
        print(f"Best: {int(res.offsets[0]) + base}, distance: {res.distances[0]}")
    print(f"T: {s.t_total_ms:.1f} ms, T_1: {s.t_phase1_ms:.1f} ms, "
          f"T_2: {s.t_phase2_ms:.1f} ms, #candidates: {s.n_candidates}, "
          f"#answers: {s.n_answers}")
    return 0


def cmd_oracle(args) -> int:
    from . import oracle
    data = _load_data(args.data)
    q = data[args.begin - 1: args.end]  # CsvTester is 1-based inclusive
    measure, problem = args.measure.upper(), args.problem.upper()
    dev = args.device
    if measure == "ED":
        if problem == "RSM":
            offs, dists = oracle.rsm_ed(data, q, args.epsilon, device=dev)
        elif problem == "NSM":
            offs, dists = oracle.nsm_ed(data, q, args.epsilon, device=dev)
        else:
            offs, dists = oracle.nsm_ed(data, q, args.epsilon, args.alpha,
                                        args.beta, device=dev)
    else:
        rho = int(args.rho * q.size) if args.rho <= 1 else int(args.rho)
        if problem == "RSM":
            offs, dists = oracle.rsm_dtw(data, q, args.epsilon, rho,
                                         device=dev)
        elif problem == "CNSM":
            offs, dists = oracle.cnsm_dtw(data, q, args.epsilon, rho,
                                          args.alpha, args.beta, device=dev)
        else:
            print("NSM-DTW: pass alpha/beta=inf bounds via cNSM instead",
                  file=sys.stderr)
            return 2
    offs, dists = oracle.dedup_overlapping(offs, dists, q.size)
    for o, d in zip(offs, dists):
        print(f"{int(o) + 1},{d}")
    return 0


def cmd_workload(args) -> int:
    """Generate and replay a selectivity-binned workload
    (the *GroupBySelectivity experiment programs)."""
    from .experiments import generate_workload, run_workload, save_workload
    engine = _engine(args)
    grid = [{}]
    if "cnsm" in args.engine:
        grid = [{"alpha": args.alpha, "beta": args.beta}]
    if "dtw" in args.engine:
        for g in grid:
            g["rho"] = int(0.05 * max(args.lengths))
    wl = generate_workload(engine, args.lengths, args.epsilons,
                           queries_per_cell=args.per_cell, seed=args.seed,
                           param_grid=grid)
    if args.save:
        save_workload(wl, args.save)
    print(f"workload: {len(wl)} selective queries")
    for r in run_workload(engine, wl):
        print(f"bin {r.bin_label}: n={r.n_queries} T={r.mean_t_ms:.1f}ms "
              f"T1={r.mean_t1_ms:.1f} T2={r.mean_t2_ms:.1f} "
              f"cand={r.mean_candidates:.0f} ans={r.mean_answers:.1f} "
              f"missed={r.false_dismissals}")
    return 0


def cmd_export_queries(args) -> int:
    """Export query subsequences as raw binary files for external baselines
    (GMatchQueryDataExtractor equivalent, experiments/GMatchQueryDataExtractor.java:32-89)."""
    data = _load_data(args.data)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for L in args.lengths:
        for i in range(args.count):
            off = int(rng.integers(0, data.size - L))
            q = np.asarray(data[off:off + L], ">f8")
            q.tofile(outdir / f"query-{L}-{i}-{off}")
    print(f"exported {args.count * len(args.lengths)} queries to {outdir}")
    return 0


def _device_arg(sub) -> None:
    sub.add_argument("--device", default=None,
                     help="torch device (default: the current CUDA device; "
                          "'cpu' on a machine without a card)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kvmatch_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate-data")
    g.add_argument("n", type=int)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out")
    g.set_defaults(fn=cmd_generate_data)

    b = sub.add_parser("build-index")
    b.add_argument("data")
    b.add_argument("--out")
    b.add_argument("--fmt", choices=["npz", "file"], default="npz")
    b.add_argument("--backend", choices=["device", "host"], default="device",
                   help="bucket pass on the device (default) or the fused C "
                        "host kernel")
    _device_arg(b)
    b.set_defaults(fn=cmd_build_index)

    q = sub.add_parser("query")
    q.add_argument("data")
    q.add_argument("--engine", choices=sorted(_ENGINES), default="rsm-ed")
    q.add_argument("--offset", type=int, required=True)
    q.add_argument("--length", type=int, required=True)
    q.add_argument("--epsilon", type=float, required=True)
    q.add_argument("--rho", type=float)
    q.add_argument("--alpha", type=float, default=1.0)
    q.add_argument("--beta", type=float, default=0.0)
    q.add_argument("--index")
    q.add_argument("--one-based", action="store_true")
    q.add_argument("--count-launches", action="store_true",
                   help="print the query's kernel launch counts (JSON) on "
                        "stderr")
    _device_arg(q)
    q.set_defaults(fn=cmd_query)

    o = sub.add_parser("oracle")
    o.add_argument("measure", choices=["ED", "DTW", "ed", "dtw"])
    o.add_argument("problem", choices=["RSM", "NSM", "cNSM", "rsm", "nsm", "cnsm", "CNSM"])
    o.add_argument("data")
    o.add_argument("begin", type=int)
    o.add_argument("end", type=int)
    o.add_argument("epsilon", type=float)
    o.add_argument("alpha", type=float, nargs="?", default=1.0)
    o.add_argument("beta", type=float, nargs="?", default=0.0)
    o.add_argument("--rho", type=float, default=0.05)
    _device_arg(o)
    o.set_defaults(fn=cmd_oracle)

    w = sub.add_parser("workload")
    w.add_argument("data")
    w.add_argument("--engine", choices=sorted(_ENGINES), default="rsm-ed")
    w.add_argument("--lengths", type=int, nargs="+", default=[256, 1024])
    w.add_argument("--epsilons", type=float, nargs="+", default=[2.0, 8.0])
    w.add_argument("--per-cell", type=int, default=5)
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--alpha", type=float, default=1.5)
    w.add_argument("--beta", type=float, default=10.0)
    w.add_argument("--index")
    w.add_argument("--save")
    _device_arg(w)
    w.set_defaults(fn=cmd_workload)

    x = sub.add_parser("export-queries")
    x.add_argument("data")
    x.add_argument("--out", default="queries")
    x.add_argument("--lengths", type=int, nargs="+", default=[256, 1024, 8192])
    x.add_argument("--count", type=int, default=10)
    x.add_argument("--seed", type=int, default=0)
    x.set_defaults(fn=cmd_export_queries)

    args = p.parse_args(argv)
    if hasattr(args, "device"):
        from .backend import resolve_device
        try:
            args.device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            p.error(str(e))
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
