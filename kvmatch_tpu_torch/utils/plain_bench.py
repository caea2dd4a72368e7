"""Wall time and device time of the plain DP versions on the card, at the
calls ``chip_smoke.py`` makes of them.

    python -m kvmatch_tpu_torch.utils.plain_bench [--calls NAME,...]
                                                  [--no-trace]

The plain versions (``ops/dtw.py``, the f64 oracle's anti-diagonal walk)
are the yardsticks the kernels are held to.  Their loops are many small
launches, so a call can be held by the host (its wall time well above the
time its kernels take on the card) or by the card.  For each call this
prints one JSON line: the wall time of one call between two
``synchronize()``; then, unless ``--no-trace``, the device time of a second
call, the summed durations of the device activities (kernels, copies,
fills) in a ``torch.profiler`` trace of it, with their count; the replays
of the function's CUDA graphs where it counts them (``graph_replays``); and
the card's name and power limit.  The inputs are made from seeds as
``chip_smoke.py`` makes them, on a series of ``SERIES_N`` points where
``chip_smoke.py`` uses n=1e8 (the work of a plain call depends on its
shapes only); the oracle calls use ``chip_smoke.py``'s own series and
first self-query.  The card only (exit 2 without one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .kernel_bench import card_line

SERIES_N = 2_000_000
L_MAIN, RHO_MAIN, DTW_BATCH = 8192, 409, 1024
ALPHA, BETA, EPS, EPS_RSM = 1.2, 5.0, 4.0, 6.0


def _znormed(dev_series, rng, L: int, rows: int):
    from ..ops import dtw as td
    from ..ops.ed import _gather
    offs = torch.as_tensor(rng.integers(0, dev_series.shape[0] - L + 1, rows),
                           device=dev_series.device)
    return td._znorm_rows(_gather(dev_series, offs, L), L)[0]


def _self_query(n: int, L: int, count: int, seed: int = 20260816):
    from ..data.generators import generate_series
    data = generate_series(n, seed=seed)
    off = np.random.default_rng(1).integers(0, data.size - L, count)[0]
    return data, data[off:off + L]


def calls(device) -> dict:
    """name -> (function name, shape tag, thunk) for every plain call."""
    from .. import oracle
    from ..data.generators import generate_series
    from ..ops import dtw as td
    from ..ops.ed import _gather
    from ..state import series_to_device
    cache: dict = {}

    def series():
        if "s" not in cache:
            cache["s"] = series_to_device(
                generate_series(SERIES_N, seed=20260817), device)
        return cache["s"]

    def queries(L: int):
        data, _ = series()
        offs = np.random.default_rng(2).integers(0, data.size - L_MAIN, 8)
        q = np.stack([data[o:o + L_MAIN] for o in offs])[:, :L]
        return q

    def qhat(L: int):
        q = queries(L)
        return torch.as_tensor((q - q.mean(1, keepdims=True))
                               / q.std(1, keepdims=True),
                               dtype=torch.float32, device=device)

    def bitwise(L, r, rows, fn):  # chip_smoke.check_bitwise
        def run():
            rng = np.random.default_rng(8)
            z = _znormed(series()[1], rng, L, rows)
            qids = torch.as_tensor(rng.integers(0, 8, rows).astype(np.int32),
                                   device=device)
            return lambda: fn(z, qhat(L), qids, r)
        return run

    def pair(L, r, rows, fn, seed):  # chip_smoke.global_form / wide_band
        def run():
            rng = np.random.default_rng(seed)
            a = _znormed(series()[1], rng, L, rows)
            qm = _znormed(series()[1], rng, L, 2)
            qids = torch.as_tensor(np.arange(rows) % 2, dtype=torch.int32,
                                   device=device)
            return lambda: fn(a, qm, qids, r)
        return run

    def bucket(fn, raw: bool, dtype=torch.float32):  # check_dtw_kernels
        def run():
            rng = np.random.default_rng(7)
            dev = series()[1]
            offs = torch.as_tensor(
                rng.integers(0, dev.shape[0] - L_MAIN + 1, DTW_BATCH),
                device=device)
            qids = torch.as_tensor(rng.integers(0, 8, DTW_BATCH)
                                   .astype(np.int32), device=device)
            x = _gather(dev, offs, L_MAIN)
            rows, qm = ((x, torch.as_tensor(queries(L_MAIN),
                                            dtype=torch.float32,
                                            device=device)) if raw else
                        (td._znorm_rows(x, L_MAIN)[0], qhat(L_MAIN)))
            return lambda: fn(rows.to(dtype), qm.to(dtype), qids, RHO_MAIN)
        return run

    def oracle_call(kind, n, L, rho, count):  # chip_smoke.exact_dtw
        def run():
            data, q = _self_query(n, L, count)
            if kind == "rsm":
                return lambda: oracle.rsm_dtw(data, q, EPS_RSM, rho,
                                              device=device)
            return lambda: oracle.cnsm_dtw(data, q, EPS, rho, ALPHA, BETA,
                                           device=device)
        return run

    out = {}
    for L, r, rows in ((1024, 51, 256), (1024, 409, 256), (1024, 1100, 256),
                       (L_MAIN, RHO_MAIN, 8)):
        tag = f"L{L}_r{r}_rows{rows}"
        out[f"bitwise_diag_{tag}"] = ("dtw_diag_plain", tag,
                                      bitwise(L, r, rows, td.dtw_diag_plain))
        out[f"bitwise_ds_{tag}"] = ("dtw_ds_diag_plain", tag,
                                    bitwise(L, r, rows, td.dtw_ds_diag_plain))
        k4 = (td.dtw_rows_plain if 2 * min(r, L - 1) + 1 <= td.K4_WARP_LANES
              else td.dtw_banded_plain)
        out[f"bitwise_k4_{tag}"] = (k4.__name__, tag, bitwise(L, r, rows, k4))
    tag = f"L{L_MAIN}_r{RHO_MAIN}_rows{DTW_BATCH}"
    for name, raw in (("raw", True), ("znorm", False)):
        out[f"bucket_banded_{name}"] = ("dtw_banded_plain", tag,
                                        bucket(td.dtw_banded_plain, raw))
        out[f"bucket_banded_f64_{name}"] = (
            "dtw_banded_plain", tag + "_f64",
            bucket(td.dtw_banded_plain, raw, torch.float64))
    out["bucket_ds_rows_raw"] = ("dtw_banded_ds_plain", tag,
                                 bucket(td.dtw_banded_ds_plain, True))
    for L, r, rows in ((13_313, 13_312, 2), (26_625, 26_624, 2)):
        tag = f"L{L}_r{r}_rows{rows}"
        for fn in (td.dtw_diag_plain, td.dtw_ds_diag_plain,
                   td.dtw_banded_plain):
            out[f"wide_{fn.__name__}_{tag}"] = (fn.__name__, tag,
                                                pair(L, r, rows, fn, 9))
    for kind, n, L, rho, count in (("rsm", 1_000_000, 1024, 51, 4),
                                   ("cnsm", 1_000_000, 1024, 51, 4),
                                   ("cnsm", 1_000_000, 8192, 409, 4),
                                   ("rsm", 17_000, 16_384, 13_500, 2),
                                   ("cnsm", 17_000, 16_384, 13_500, 2)):
        tag = f"n{n}_L{L}_rho{rho}"
        out[f"oracle_{kind}_dtw_{tag}"] = (f"oracle.{kind}_dtw", tag,
                                           oracle_call(kind, n, L, rho, count))
    L, r, rows = 106_600, 106_599, 2
    tag = f"L{L}_r{r}_rows{rows}"
    for fn in (td.dtw_diag_plain, td.dtw_ds_diag_plain):
        out[f"global_{fn.__name__}"] = (fn.__name__, tag,
                                        pair(L, r, rows, fn, 10))
    return out


def device_seconds(fn, device):
    """(summed device activity seconds, activity count) of one ``fn()``,
    read from the trace's raw events: a loop of millions of launches would
    take the profiler's own event tables an hour to build."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    spans = [e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return sum(spans) / 1e9, len(spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", default=None,
                    help="comma-separated call names (default: all)")
    ap.add_argument("--no-trace", action="store_true",
                    help="wall time only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plain_bench: no CUDA device; it times the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    table = calls(device)
    names = args.calls.split(",") if args.calls else list(table)
    unknown = [n for n in names if n not in table]
    if unknown:
        ap.error(f"unknown calls {unknown}")
    card = card_line()
    from ..ops import dtw as td
    for name in names:
        fn_name, tag, make = table[name]
        call = make()
        counted = getattr(td, fn_name, None)
        replays = getattr(counted, "graph_replays", None)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(device)
        line = dict(call=name, fn=fn_name, shape=tag, card=card,
                    wall_s=time.perf_counter() - t0,
                    graph_replays=(None if replays is None
                                   else counted.graph_replays - replays))
        if not args.no_trace:
            dev_s, count = device_seconds(call, device)
            line.update(device_s=dev_s, device_activities=count,
                        wall_over_device=line["wall_s"] / dev_s)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
