"""Selectivity-binned workloads and their replay.

A copy of kvmatch_tpu/experiments.py; it drives any engine of the port
through ``engine.query_at`` (the CLI's ``workload`` command calls it).

Equivalent of the reference's experiment layer (SURVEY.md section 2.5 #55-56):

* ``generate_workload`` sweeps (L, epsilon[, rho, alpha, beta]) over random query
  offsets, measures each query's true selectivity (answers/n) with the engine,
  and bins queries by selectivity decade — the *SelectivityGenerate programs
  (QueryDtwSelectivityGenerate.java:34-97, NormQueryDtwSelectivityGenerate.java:34-136).
* ``run_workload`` replays a workload and reports per-bin mean T/T1/T2/
  #candidates/#answers, flagging any false dismissal of the query's own origin —
  the *QueryTestGroupBySelectivity programs (QueryTestGroupBySelectivity.java:21-80).

Workloads serialize to JSON so the same queries can be replayed across engines,
configs and rounds.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class WorkloadEntry:
    offset: int
    length: int
    epsilon: float
    params: dict
    selectivity: float
    n_answers: int


@dataclasses.dataclass
class BinReport:
    bin_label: str
    n_queries: int
    mean_t_ms: float
    mean_t1_ms: float
    mean_t2_ms: float
    mean_candidates: float
    mean_answers: float
    false_dismissals: int


def _bin_label(selectivity: float) -> str:
    if selectivity <= 0:
        return "0"
    decade = int(np.floor(np.log10(selectivity)))
    return f"1e{decade}"


def generate_workload(engine, lengths: Sequence[int], epsilons: Sequence[float],
                      queries_per_cell: int = 5, seed: int = 0,
                      param_grid: Optional[List[dict]] = None,
                      max_selectivity: float = 1e-3) -> List[WorkloadEntry]:
    """Sweep the grid, keep queries whose selectivity is below the cap
    (LongRandomQueryTest.java:93 applies the same cap)."""
    rng = np.random.default_rng(seed)
    n = engine.n
    out: List[WorkloadEntry] = []
    for L in lengths:
        for eps in epsilons:
            for params in (param_grid or [{}]):
                for _ in range(queries_per_cell):
                    off = int(rng.integers(0, n - L))
                    res = engine.query_at(off, L, eps, **params)
                    sel = res.stats.n_answers / n
                    if 0 < sel <= max_selectivity:
                        out.append(WorkloadEntry(off, L, eps, dict(params),
                                                 sel, res.stats.n_answers))
    return out


def run_workload(engine, workload: Sequence[WorkloadEntry]) -> List[BinReport]:
    bins: Dict[str, list] = {}
    for entry in workload:
        res = engine.query_at(entry.offset, entry.length, entry.epsilon,
                              **entry.params)
        missed = int(entry.offset not in res.offsets.tolist())
        bins.setdefault(_bin_label(entry.selectivity), []).append((res.stats, missed))
    reports = []
    for label in sorted(bins):
        rows = bins[label]
        stats = [s for s, _ in rows]
        reports.append(BinReport(
            bin_label=label,
            n_queries=len(rows),
            mean_t_ms=float(np.mean([s.t_total_ms for s in stats])),
            mean_t1_ms=float(np.mean([s.t_phase1_ms for s in stats])),
            mean_t2_ms=float(np.mean([s.t_phase2_ms for s in stats])),
            mean_candidates=float(np.mean([s.n_candidates for s in stats])),
            mean_answers=float(np.mean([s.n_answers for s in stats])),
            false_dismissals=sum(m for _, m in rows),
        ))
    return reports


def save_workload(workload: Sequence[WorkloadEntry], path) -> None:
    Path(path).write_text(json.dumps([dataclasses.asdict(e) for e in workload]))


def load_workload(path) -> List[WorkloadEntry]:
    return [WorkloadEntry(**e) for e in json.loads(Path(path).read_text())]
