"""The benchmark's harness on the CPU, at a tiny size.

    python -m pytest kvbench/tests

A tiny copy of the benchmark (``tiny_root``: the same files, each
configuration cut to a short series and query, each traffic to a small
pool) runs through ``harness.run_cell`` with the program's plain CPU
kernels.  These tests hold: ``BENCHMARK.json`` to the contract's names,
units and keys; that a new configuration, traffic and metric are found by
name with no edit to a file that is there; the keys of the result line;
the references to a brute-force float64 scan; which modules the harness
and the references load; and that the check comes out false for the
float32 control and for a program broken underneath.
"""

import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from kvbench import control, harness  # noqa: E402
from kvbench.frozen.calibrate import eps_for_target  # noqa: E402
from kvbench.reference import cnsm_ed  # noqa: E402
from kvbench.reference.common import Rows  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import per_query_reference  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "breakdown", "checks"]
SEED = 2 ** 40 + 12345
#: The tiny sizes (n, L) by semantics: at n = 1e6 the float32 control
#: already reads a dist_gap over the limit.
TINY = {"cnsm_ed": (1_000_000, 256)}


def tiny_root(dest: Path) -> Path:
    """A copy of the benchmark at ``dest`` with every configuration and
    traffic cut to a tiny size."""
    shutil.copytree(ROOT / "kvbench", dest / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for c in BENCH["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["n"], cfg["L"] = TINY[cfg["semantics"]]
        path.write_text(json.dumps(cfg))
    for path in (dest / "kvbench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(pool=16, check_queries=4, warmup=1)
        path.write_text(json.dumps(tr))
    (dest / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return dest


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run_tiny(root, cell, trace=False, build=harness.build_program,
             seconds=0.5, seed=SEED):
    spec = harness.load_cell(root, cell)
    return harness.run_cell(spec, seed, seconds, trace, "cpu", 0.0,
                            build=build)


# ------------------------------------------------------------ the contract
def test_benchmark_json_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "kvbench/run.py"]
    assert BENCH["paths"] == ["kvbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for k in ("end_to_end", "per_layer")
                   for n in (x["name"] for x in BENCH[k]))) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kvbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (ROOT / "kvbench" / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (ROOT / "kvbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "kvbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        spec = harness.load_cell(ROOT, cell)
        assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


# ------------------------------------------------------- found by its name
def test_new_config_traffic_and_metric_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "kvbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "kvbench/configs/cnsm_ed_n1e8_L4096.json")
                     .read_text())
    cfg.update(name="cnsm_ed_new", n=150_000, L=192)
    (root / "kvbench/configs/cnsm_ed_new.json").write_text(json.dumps(cfg))
    (root / "kvbench/traffic/b2.sel2.json").write_text(json.dumps(dict(
        entry="query_batch", batch=2, answers=2, pool=6, pool_seed=3,
        check_queries=2, warmup=1)))
    (root / "kvbench/metrics/engine.total_ms.py").write_text(
        "def read(run):\n"
        "    return sum(s.t_total_ms for s in run.stats) / len(run.stats)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="cnsm_ed_new", source="new",
                                 file="kvbench/configs/cnsm_ed_new.json",
                                 reduced=["n"], why="a new configuration"))
    bench["workloads"].append(dict(name="cnsm_ed_new.b2", chips=1,
                                   config="cnsm_ed_new", traffic="b2.sel2",
                                   why="a new cell"))
    bench["per_layer"].append(dict(name="engine.total_ms", unit="ms/query",
                                   better="lower", source="program_span",
                                   layer="engine", moves="qps",
                                   workloads=["cnsm_ed_new.b2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    out, info = run_tiny(root, "cnsm_ed_new.b2", trace=True)
    assert out["metrics"]["engine.total_ms"]["value"] > 0
    assert info["requests"] > 0 and info["compared_responses"] > 0
    other, _ = run_tiny(root, CELLS[0], trace=True)
    assert "engine.total_ms" not in other["metrics"]
    with pytest.raises(harness.CellError):
        harness.load_cell(root, "no.such.cell")


# ------------------------------------------------------------- the result
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_only_the_contracts_keys(tiny, cell, trace):
    out, info = run_tiny(tiny, cell, trace=trace)
    keys = list(out)
    assert keys == [k for k in RESULT_KEYS if k in out]
    assert keys[-1] == "checks" and "breakdown" not in keys or trace
    spec = harness.load_cell(tiny, cell)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in want}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    assert set(out["checks"]) == {"failed", "missing", "extra", "dist_gap"}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert out["attempted"] >= info["requests"] > 0
    json.loads(json.dumps(out))


# ---------------------------------------------------------------- inputs
def test_pool_is_fixed_and_checked_queries_drawn_from_the_seed(tiny):
    spec = harness.load_cell(tiny, CELLS[0])
    n, L = spec["config"]["n"], spec["config"]["L"]
    tr = spec["traffic"]
    pool, k = tr["pool"], tr["check_queries"]
    a, b, a2 = (harness.make_inputs(spec, s, "cpu")
                for s in (SEED, SEED + 1, SEED))
    for inp in (a, b):
        for offs in (inp["offs"][:pool], inp["offs"][pool:]):
            edges = np.linspace(0, n - L + 1, offs.size + 1).astype(np.int64)
            assert np.all((offs >= edges[:-1]) & (offs < edges[1:]))
        np.testing.assert_array_equal(
            inp["queries"], np.stack([inp["series"][o:o + L]
                                      for o in inp["offs"]]))
        np.testing.assert_array_equal(inp["extra"], np.arange(pool, pool + k))
    np.testing.assert_array_equal(a["offs"], a2["offs"])
    np.testing.assert_array_equal(a["eps"], a2["eps"])
    np.testing.assert_array_equal(a["offs"][:pool], b["offs"][:pool])
    np.testing.assert_array_equal(a["batches"], b["batches"])
    assert not np.array_equal(a["offs"][pool:], b["offs"][pool:])
    np.testing.assert_array_equal(harness.request_plan(a, 5),
                                  harness.request_plan(a2, 5))


def test_series_generator_is_picked_by_the_configuration(tiny):
    from kvbench.frozen import segments
    from kvbench.frozen.generators import generate_series
    cfg = dict(harness.load_cell(tiny, CELLS[0])["config"], n=20_000)
    assert "generator" not in cfg
    np.testing.assert_array_equal(
        harness.make_series(cfg),
        generate_series(20_000, cfg["series_seed"], dtype=np.float32))
    np.testing.assert_array_equal(
        harness.make_series(dict(cfg, generator="segments")),
        segments.generate(20_000, cfg["series_seed"]))
    with pytest.raises(harness.CellError):
        harness.make_series(dict(cfg, generator="no_such_generator"))


def test_setup_s_leaves_out_generation_and_calibration(tiny, monkeypatch):
    """setup_s is the time to the first timed request less the harness's
    own generation and calibration, which take most of make_inputs."""
    seen = {}
    make_inputs, serve = harness.make_inputs, harness.serve

    def timed_inputs(*a, **kw):
        t0 = time.perf_counter()
        out = make_inputs(*a, **kw)
        seen["make_inputs_s"] = time.perf_counter() - t0
        return out

    def kept_serve(*a, **kw):
        served = serve(*a, **kw)
        seen.update(served)
        return served
    monkeypatch.setattr(harness, "make_inputs", timed_inputs)
    monkeypatch.setattr(harness, "serve", kept_serve)
    spec = harness.load_cell(tiny, CELLS[0])
    t_start = time.perf_counter()
    out, info = harness.run_cell(spec, SEED, 0.3, False, "cpu", t_start)
    own = info["generate_s"] + info["calibration_s"]
    assert own >= 0.9 * seen["make_inputs_s"] > 0
    assert info["setup_s"] == (seen["t_window_start"] - t_start
                               - info["generate_s"] - info["calibration_s"])
    assert out["metrics"]["setup_s"]["value"] == info["setup_s"] > 0
    assert info["setup_s"] < seen["t_window_start"] - t_start - own * 0.99


def _scan_breakdown_gaps(spans, gaps):
    """The idle-gap labels as the breakdown took them before its sweep: for
    each gap, a scan of the spans sorted by length."""
    spans = sorted(spans, key=lambda x: x[2] - x[1])
    by_label = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        label = next((n for n, s, t in spans if s <= mid <= t), "client")
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e9
    return by_label


@pytest.mark.parametrize("seed", range(4))
def test_breakdown_sweep_equals_the_scan(seed):
    """The sweep labels every idle gap as the scan over the spans sorted by
    length did, on a run with nested, overlapping, touching and equally
    long spans."""
    rng = np.random.default_rng(seed)
    spans = []
    for r0 in range(0, 10_000_000, 50_000):        # requests, each nested
        spans.append(("request", r0, r0 + 40_000))
        for lo in sorted(rng.integers(r0, r0 + 30_000, 3)):
            spans.append((str(rng.choice(["engine.plan", "probe",
                                          "verify"])),
                          int(lo), int(lo + rng.integers(1, 10_000))))
    for _ in range(300):                            # overlapping anywhere
        lo = int(rng.integers(0, 10_000_000))
        spans.append(("verify", lo, lo + int(rng.integers(0, 200_000))))
    spans += [("probe", 5_000, 9_000), ("verify", 5_000, 9_000),
              ("probe", 9_000, 9_500)]              # equal, touching
    rng.shuffle(spans)
    spans = [(n, int(s), int(t)) for n, s, t in spans]
    dev = []
    for lo in np.sort(rng.integers(0, 10_000_000, 4_000)):
        dev.append(("k", int(lo), int(lo + rng.integers(1, 3_000))))
    run = types.SimpleNamespace(device_events=dev, spans=spans,
                                window_ns=(1_000, 9_990_000))
    out = harness.breakdown(run)
    b0, b1 = run.window_ns
    gaps, end = [], b0
    for lo, hi in sorted((max(s, b0), min(t, b1)) for _, s, t in dev
                         if t > b0 and s < b1):
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    gaps.append((end, b1))
    want = sorted(_scan_breakdown_gaps(spans, gaps).items(),
                  key=lambda kv: -kv[1])[:harness.TOP]
    assert out["idle_gaps"] == [[k, v] for k, v in want]
    assert {k for k, _ in want} >= {"client", "request", "verify"}


def test_breakdown_counts_a_span_that_ends_at_a_gaps_middle():
    run = types.SimpleNamespace(
        device_events=[("k", 100, 200), ("k", 300, 400)], window_ns=(100, 400),
        spans=[("request", 0, 1000), ("verify", 250, 262), ("probe", 245, 250)])
    assert harness.breakdown(run)["idle_gaps"] == [["probe", 100 / 1e9]]


# ------------------------------------------------------------ the reference
def _brute_ed(x, q, eps, alpha, beta):
    L = q.size
    w = np.lib.stride_tricks.sliding_window_view(x, L)
    mu, mq = w.mean(1), q.mean()
    sd = np.sqrt(np.maximum((w * w).mean(1) - mu * mu, 0))
    sq = np.sqrt(max((q * q).mean() - mq * mq, 0))
    ok = ((np.abs(mu - mq) <= beta) & (sd / sq <= alpha)
          & (sd / sq >= 1 / alpha) & (sd > 0))
    z = (w - mu[:, None]) / np.where(sd > 0, sd, 1)[:, None]
    d2 = ((z - (q - mq) / sq) ** 2).sum(1)
    hit = np.flatnonzero(ok & (d2 <= eps * eps))
    return hit, np.sqrt(d2[hit])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ed_reference_equals_brute_force(seed):
    from kvbench.frozen.generators import generate_series
    x = generate_series(30_000, seed, dtype=np.float32).astype(np.float64)
    rows = Rows(torch.as_tensor(x), 200)
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, x.size - 200, 3)
    qs = [torch.as_tensor(x[o:o + 200]) for o in offs]
    eps = [eps_for_target(d, 5)
           for d in cnsm_ed.topk(rows, qs, 5, 1.2, 5.0)]
    for o, e, (got, gd) in zip(offs, eps,
                               cnsm_ed.answers(rows, qs, eps, 1.2, 5.0)):
        want, wd = _brute_ed(x, x[o:o + 200], e, 1.2, 5.0)
        assert got.size >= 5
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(gd, wd, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("rows,finite", [(2048, 1.0), (300, 0.02),
                                         (5, 0.5), (40, 0.0)])
def test_smallest_equals_topk_of_the_flattened_rows(rows, finite):
    rng = np.random.default_rng(rows)
    d2 = torch.as_tensor(rng.uniform(0, 100, (rows, 97)))
    d2[torch.as_tensor(rng.random((rows, 97)) >= finite)] = torch.inf
    v, i = cnsm_ed.smallest(d2, 11)
    w, j = torch.topk(d2.reshape(-1), 11, largest=False)
    assert torch.equal(v, w)
    fin = torch.isfinite(w)
    assert torch.equal(i[fin], j[fin])
    assert torch.equal(d2.reshape(-1)[i], v)


def _chunk_elems(monkeypatch, elems):
    from kvbench.reference import common
    monkeypatch.setattr(common, "CHUNK_ELEMS", elems)
    monkeypatch.setattr(per_query_reference, "CHUNK_ELEMS", elems)


@pytest.mark.parametrize("n,chunk_elems,chunks", [(60_000, 1 << 24, 1),
                                                  (60_000, 3 * 4096, 6),
                                                  (1_000_000, 4096, 257)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_pass_reference_equals_per_query_form(monkeypatch, n,
                                                  chunk_elems, chunks,
                                                  dtype):
    """One walk for every query gives the per-query walks' bits: the eps'
    profile and every answer with its distance, in f64 and in the
    control's f32, over one chunk of rows, over many, and over chunks
    short enough against the segments that the walk skips some."""
    from kvbench.frozen.generators import generate_series
    from kvbench.reference.common import Chunk
    _chunk_elems(monkeypatch, chunk_elems)
    skipped = []
    may_admit = Chunk.may_admit

    def counted(self, *a):
        ok = may_admit(self, *a)
        skipped.append(not ok)
        return ok
    monkeypatch.setattr(Chunk, "may_admit", counted)
    L, k = 200, 5
    x = torch.as_tensor(generate_series(n, 4, dtype=np.float32))
    old = per_query_reference.Rows(x, L, dtype)
    new = Rows(x, L, dtype)
    assert -(-new.R // new.chunk) == chunks
    offs = harness._strata(np.random.default_rng(9), new.m, 6)
    ds = cnsm_ed.topk(new, [new.x[o:o + L] for o in offs], k, 1.2, 5.0)
    for o, d in zip(offs, ds):
        np.testing.assert_array_equal(
            d, per_query_reference.topk(old, old.x[o:o + L], k, 1.2, 5.0))
    eps = [eps_for_target(d, k) * 1.5 for d in ds]
    got = cnsm_ed.answers(new, [new.x[o:o + L] for o in offs], eps, 1.2,
                          5.0)
    for o, e, (g_off, g_d) in zip(offs, eps, got):
        w_off, w_d = per_query_reference.answers(old, old.x[o:o + L], e,
                                                 1.2, 5.0)
        assert w_off.size >= k
        np.testing.assert_array_equal(g_off, w_off)
        np.testing.assert_array_equal(g_d, w_d)
    assert any(skipped) == (chunks > 6)


# ---------------------------------------------------------------- imports
def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax_and_reference_no_program(tmp_path):
    root = tiny_root(tmp_path)
    tops = _modules(
        "import sys, json; sys.path.insert(0, '.'); "
        "from kvbench import harness, run; "
        f"spec = harness.load_cell({str(root)!r}, {CELLS[0]!r}); "
        "harness.run_cell(spec, 5, 0.3, True, 'cpu', 0.0); "
        "print(json.dumps(run.loaded_forbidden() + "
        "sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & set(("jax", "jaxlib", "flax", "kvmatch_tpu"))
    assert "kvmatch_tpu_torch" in tops   # the program did run
    tops = _modules(
        "import sys, json, torch, numpy as np; sys.path.insert(0, '.'); "
        "from kvbench.reference import cnsm_ed; "
        "from kvbench.reference.common import Rows; "
        "x = torch.as_tensor(np.cumsum(np.random.default_rng(0)"
        ".standard_normal(5000))); r = Rows(x, 64); "
        "cnsm_ed.answers(r, [x[:64]], [3.0], 1.5, 5.0); "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "kvmatch_tpu_torch" not in tops and "kvmatch_tpu" not in tops


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    from kvbench import run
    monkeypatch.setitem(sys.modules, "kvmatch_tpu_torch.fake", object())
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert run.loaded_forbidden() == ["jaxlib.fake"]


def test_run_exits_without_a_card_or_the_program(tmp_path):
    shutil.copytree(ROOT / "kvbench", tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "kvbench/run.py", "--workload", CELLS[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------- the check can say false
@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(tiny, cell):
    out, info = run_tiny(tiny, cell, build=control.build_control,
                         seconds=0.3)
    assert info["compared_responses"] > 0
    assert not out["correct"]
    sound, _ = run_tiny(tiny, cell, seconds=0.3)
    assert (out["checks"]["dist_gap"]["value"]
            > 3 * sound["checks"]["dist_gap"]["value"])


def _broken(fault):
    """The program's build with its timed path broken underneath."""
    def build(spec, inputs, device):
        state = harness.build_program(spec, inputs, device)
        eng = state["engine"]
        for name in ("query", "query_batch"):
            setattr(eng, name, fault(getattr(eng, name)))
        return state
    return build


def _altered(call):
    def wrapped(*a, **kw):
        res = call(*a, **kw)
        for r in (res if isinstance(res, list) else [res]):
            if r.distances.size:
                r.distances = r.distances.copy()
                r.distances[-1] = r.distances[-1] * (1 + 1e-3) + 1e-3
        return res
    return wrapped


def _half_left_out(call):
    def wrapped(*a, **kw):
        res = call(*a, **kw)
        if isinstance(res, list):
            for r in res[len(res) // 2:]:
                r.offsets, r.distances = r.offsets[:0], r.distances[:0]
        return res
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(tiny, cell):
    out, _ = run_tiny(tiny, cell, build=_broken(_altered), seconds=0.3)
    assert not out["correct"]
    assert out["checks"]["dist_gap"]["value"] > 5e-4


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_after_the_window_is_not_correct(tiny, cell,
                                                           monkeypatch):
    sound, _ = run_tiny(tiny, cell, seconds=0.3)
    assert sound["correct"]
    pool = harness.load_cell(tiny, cell)["traffic"]["pool"]
    send = harness.send

    def altered_after_the_window(spec, eng, inputs, idx):
        def call():
            return send(spec, eng, inputs, idx)
        return _altered(call)() if idx.min() >= pool else call()
    monkeypatch.setattr(harness, "send", altered_after_the_window)
    out, info = run_tiny(tiny, cell, seconds=0.3)
    assert info["extra_requests"] > 0
    assert not out["correct"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if json.loads((ROOT / "kvbench/traffic"
                                                 / f"{w['traffic']}.json")
                                                .read_text())["batch"] > 1])
def test_half_the_batch_left_out_is_not_correct(tiny, cell):
    out, _ = run_tiny(tiny, cell, build=_broken(_half_left_out),
                      seconds=0.3)
    sound, _ = run_tiny(tiny, cell, seconds=0.3)
    assert not out["correct"]
    assert (out["checks"]["missing"]["value"]
            > sound["checks"]["missing"]["value"])
