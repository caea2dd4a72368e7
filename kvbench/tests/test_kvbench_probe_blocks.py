"""The readers of the per-block probe's metrics, ``probe.rebuild_ms`` and
``probe.blocks``, and the n = 1.4e9 cell that reports them.

    python -m pytest kvbench/tests                      # the CPU
    python -m pytest -p no:cacheprovider -m cuda kvbench/tests   # the card

On a synthetic run each reader gives the number worked out by hand, and
None over a program without the span or the counter.  The tiny copy of
``cnsm_ed.n1_4e9.b8.sel2e-9`` (``test_kvbench_harness.tiny_root``) runs
traced with the engine's cache budget at 0 and ``PROBE_BLOCK`` cut small,
so that the probe takes its per-block path, as it does at n = 1.4e9: the
block count comes out on the CPU, and on the card the rebuild time too.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kvbench import harness  # noqa: E402
from test_kvbench_harness import tiny_root  # noqa: E402

CELL = "cnsm_ed.n1_4e9.b8.sel2e-9"
NEW = ("probe.rebuild_ms", "probe.blocks")
MS = 1_000_000  # ns


def rec(name, parent, device_ms=None):
    return dict(name=name, parent=parent, start_ns=0, end_ns=MS,
                device_ms=device_ms)


#: A request of 3 queries whose probe rebuilt two blocks of each table,
#: and a single query on the cached path.
REQ_A = [rec("kv.query", -1), rec("kv.probe", 0),
         rec("kv.probe.k1", 1, 4.0), rec("kv.probe.rebuild", 2, 1.5),
         rec("kv.probe.rebuild", 2, 2.5), rec("kv.probe.cons", 1, 3.0),
         rec("kv.probe.rebuild", 5, 0.5), rec("kv.probe.rebuild", 5, 0.5)]
REQ_B = [rec("kv.query", -1), rec("kv.probe", 0),
         rec("kv.probe.k1", 1, 1.0)]


def _run(counts=(4, 4, 4, 0), traces=(REQ_A, REQ_B), sizes=(3, 1)):
    stats = [SimpleNamespace(n_probe_blocks=c) if c is not None
             else SimpleNamespace() for c in counts]
    reqs, k = [], 0
    for t, n in zip(traces, sizes):
        res = []
        for s in stats[k:k + n]:
            s.trace = t
            res.append(SimpleNamespace(stats=s))
        reqs.append(dict(res=res))
        k += n
    return SimpleNamespace(requests=reqs, stats=stats, n_queries=len(stats))


def _read(name, run):
    return harness._reader(ROOT, name)(run)


def test_readers_on_a_synthetic_run():
    run = _run()
    assert _read("probe.rebuild_ms", run) == pytest.approx(5.0 / 4)
    assert _read("probe.blocks", run) == pytest.approx(12 / 4)


def test_readers_without_the_span_or_the_counter_give_none():
    cached = [[s for s in t if s["name"] != "kv.probe.rebuild"]
              for t in (REQ_A, REQ_B)]
    assert _read("probe.rebuild_ms", _run(traces=cached)) is None
    assert _read("probe.rebuild_ms", _run(traces=(None, None))) is None
    cpu = [[dict(s, device_ms=None) for s in t] for t in (REQ_A, REQ_B)]
    assert _read("probe.rebuild_ms", _run(traces=cpu)) is None
    assert _read("probe.blocks", _run(counts=(None,) * 4)) is None
    empty = SimpleNamespace(requests=[], stats=[], n_queries=0)
    for name in NEW:
        assert _read(name, empty) is None


def test_metrics_list_the_new_cell_alone():
    spec = harness.load_cell(ROOT, CELL)
    assert NEW == tuple(m["name"] for m in spec["per_layer"]
                        if m["name"] in NEW)
    assert "p95_ms" not in {m["name"] for m in spec["end_to_end"]}
    for cell in ("cnsm_ed.b8.sel3e-8", "cnsm_ed.b1.sel3e-7"):
        names = {m["name"] for m in harness.load_cell(ROOT, cell)
                 ["per_layer"]}
        assert not names & set(NEW)


def _blocked(spec, inputs, device):
    """The program's build with the engine's cache budget at 0: the probe
    rebuilds its tables block by block."""
    state = harness.build_program(spec, inputs, device)
    state["engine"].CACHE_MEM_FRACTION = 0
    return state


def _traced_tiny(tmp_path, device, monkeypatch):
    from kvmatch_tpu_torch.parallel import query as pq
    monkeypatch.setattr(pq, "PROBE_BLOCK", 1 << 16)
    spec = harness.load_cell(tiny_root(tmp_path), CELL)
    out, info = harness.run_cell(spec, 2 ** 40 + 7, 1.0, True, device, 0.0,
                                 build=_blocked)
    assert out["correct"] and info["compared_responses"] > 0
    n, L = spec["config"]["n"], spec["config"]["L"]
    npos = -(-(n - L + 1) // 128) * 128
    blocks = -(-npos // (1 << 16))
    return out, blocks


def test_tiny_cell_reports_the_block_count(tmp_path, monkeypatch):
    out, blocks = _traced_tiny(tmp_path, "cpu", monkeypatch)
    assert out["metrics"]["probe.blocks"]["value"] == 2 * blocks
    assert "probe.rebuild_ms" not in out["metrics"]  # no device time


@pytest.mark.cuda
def test_tiny_cell_reports_both_metrics_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels have no "
                    "CPU mode")
    out, blocks = _traced_tiny(tmp_path, torch.device("cuda", 0),
                               monkeypatch)
    assert out["metrics"]["probe.blocks"]["value"] == 2 * blocks
    assert out["metrics"]["probe.rebuild_ms"]["value"] > 0
    assert out["device"]["busy_s"] > 0
