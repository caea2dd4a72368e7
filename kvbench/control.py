"""The control of a cell's check: the reference itself, computed in float32
(the precision below the float64 that the configurations state), put in the
program's place and held to the same check as the program.

    python3 kvbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 5]

For each seed it makes the cell's inputs, serves the cell's traffic through
the float32 reference for a short window at the cell's own batch and pool,
and prints one JSON line: whether the check came out correct and each
number compared, beside the readings of the program's runs that the
limits were set from.  The benchmark's own runs never run it.  Exits 2
without a CUDA device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class Float32Reference:
    """An engine that answers with the reference computed in float32."""

    def __init__(self, spec: dict, inputs: dict, device):
        from kvbench import harness
        from kvbench.reference.common import Rows
        cfg = spec["config"]
        self.ref = harness._reference(cfg["semantics"])
        self.rows = Rows(torch.as_tensor(inputs["series"], device=device),
                         int(cfg["L"]), torch.float32)

    def query(self, q, eps, **params):
        return self.query_batch([q], [eps], **params)[0]

    def query_batch(self, qs, eps, **params):
        dev = self.rows.x.device
        out = []
        for offs, dist in self.ref.answers(
                self.rows, [torch.as_tensor(np.asarray(q, np.float32),
                                            device=dev) for q in qs],
                [float(e) for e in eps], **params):
            order = np.argsort(dist, kind="stable")
            out.append(types.SimpleNamespace(offsets=offs[order],
                                             distances=dist[order],
                                             stats=None))
        return out


def build_control(spec: dict, inputs: dict, device) -> dict:
    return dict(engine=Float32Reference(spec, inputs, device),
                index_build_s=0.0)


def run(spec: dict, seed: int, seconds: float, device) -> dict:
    """One control run: the check's numbers and verdict."""
    from kvbench import harness
    out, info = harness.run_cell(spec, seed, seconds, False, device,
                                 time.perf_counter(), build=build_control)
    return dict(workload=spec["name"], seed=seed, correct=out["correct"],
                checks=out["checks"], requests=info["requests"],
                compared_responses=info["compared_responses"],
                mismatches=info["mismatches"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kvbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kvbench control: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from kvbench import harness
    spec = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(spec, seed, args.seconds,
                             torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
