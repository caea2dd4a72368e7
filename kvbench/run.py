"""Run one cell of the benchmark once and print its result as the last line.

    python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout (``BENCHMARK.json`` beside this folder).  The
cell's configuration, traffic and per-layer metrics are files found by
name (``harness.py``).  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics with ``busy_s``, ``window_s`` and a
``breakdown`` of the device trace.  Exits 2, printing no result, without
enough CUDA devices or without the program; exits 3 if jax, jaxlib, flax
or the JAX package was loaded.  The numbers the check compares go last to
standard error and last in the result, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that may not be loaded in the process that prints the
#: result.
FORBIDDEN = ("jax", "jaxlib", "flax", "kvmatch_tpu")


def loaded_forbidden() -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "kvbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kvbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from kvbench import harness
    try:
        spec = harness.load_cell(ROOT, args.workload)
    except harness.CellError as e:
        print(f"kvbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"kvbench: {spec['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    try:
        import kvmatch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"kvbench: the program is not importable: {e}", file=sys.stderr)
        return 2
    card = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=spec["chips"])
    out, info = harness.run_cell(spec, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 T_START, card)
    bad = loaded_forbidden()
    if bad:
        print(f"kvbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"info {json.dumps(info)}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
