"""The readers of the program's span records (``kvbench/spans.py`` and the
seven ``kv.*`` metrics) on a synthetic traced run.

    python -m pytest kvbench/tests

Two requests: a batch of three queries and a single query, each with its
list of span records, and device activity with known gaps.  Each reader
gives the number worked out by hand; over a program that keeps no records
(its ``QueryStats`` have no ``trace``, or ``trace`` is None) each gives
None and raises nothing.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from kvbench import harness, spans  # noqa: E402

MS = 1_000_000  # ns


def rec(name, parent, t0, t1, device_ms=None):
    return dict(name=name, parent=parent, start_ns=t0 * MS, end_ns=t1 * MS,
                device_ms=device_ms)


#: Request A (3 queries) over [0, 100] ms, request B (1 query) over
#: [200, 260] ms.
REQ_A = [rec("kv.query", -1, 0, 100),
         rec("kv.plan", 0, 1, 3),
         rec("kv.probe", 0, 3, 30),
         rec("kv.probe.k1", 2, 4, 5, device_ms=2.0),
         rec("kv.probe.cons", 2, 5, 6, device_ms=6.0),
         rec("kv.probe.wait", 2, 6, 20),
         rec("kv.probe.intervals", 2, 20, 29),
         rec("kv.verify", 0, 30, 95),
         rec("kv.verify.plan", 7, 31, 41),
         rec("kv.verify.near", 7, 41, 60, device_ms=9.0),
         rec("kv.verify.wait", 9, 45, 50),
         rec("kv.verify.wait", 9, 55, 60),
         rec("kv.verify.confirm", 7, 60, 90)]
REQ_B = [rec("kv.query", -1, 200, 260),
         rec("kv.probe", 0, 200, 210),
         rec("kv.probe.cons", 1, 201, 202, device_ms=3.0),
         rec("kv.probe.wait", 1, 202, 206),
         rec("kv.verify", 0, 210, 250),
         rec("kv.verify.plan", 4, 210, 215),
         rec("kv.verify.plan", 4, 215, 218),
         rec("kv.verify.near", 4, 218, 220, device_ms=1.0),
         rec("kv.verify.wait", 7, 219, 220),
         rec("kv.verify.confirm", 4, 220, 250)]


def _res(trace, missing=False):
    stats = SimpleNamespace() if missing else SimpleNamespace(trace=trace)
    return SimpleNamespace(stats=stats)


def _run(traces=(REQ_A, REQ_B), sizes=(3, 1), missing=False):
    reqs = [dict(res=[_res(t, missing) for _ in range(k)])
            for t, k in zip(traces, sizes)]
    # Device busy over [0, 4], [6, 20], [45, 50], [96, 200], [260, 300]
    # of the window [0, 300] ms: idle 2 + 25 + 46 + 60 = 133 ms.
    dev = [("k", a * MS, b * MS) for a, b in ((0, 4), (6, 20), (45, 50),
                                             (96, 200), (260, 300))]
    return SimpleNamespace(requests=reqs, n_queries=sum(sizes),
                           device_events=dev, window_ns=(0, 300 * MS))


def _read(name, run):
    return harness._reader(ROOT, name)(run)


WANT = {
    "probe.cons_ms": (6.0 + 3.0) / 4,
    "probe.host_ms": ((27 - 14) + (10 - 4)) / 4,
    "verify.plan_ms": (10 + 5 + 3) / 4,
    "verify.near_ms": (9.0 + 1.0) / 4,
    "verify.confirm_ms": (30 + 30) / 4,
    "engine.syncs": (3 + 2) / 4,
    # Idle [4, 6] is under kv.probe, [20, 45] under kv.probe.intervals
    # (20-29) and kv.verify (30-45), [50, 96] under kv.verify up to 95
    # (1 ms unnamed), [200, 260] under spans in request B up to 250 (10 ms
    # under the root alone).
    "device.idle_unspanned": 100.0 * (1 + 10) / 133,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_run(name):
    assert _read(name, _run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("missing", [True, False])
def test_reader_without_records_gives_none(name, missing):
    run = _run(traces=(None, None), missing=missing)
    assert _read(name, run) is None


def test_device_readers_without_device_numbers_give_none():
    cpu = [[dict(s, device_ms=None) for s in t] for t in (REQ_A, REQ_B)]
    run = _run(traces=cpu)
    for name in ("probe.cons_ms", "verify.near_ms"):
        assert _read(name, run) is None
    run.device_events = None
    assert _read("device.idle_unspanned", run) is None
    assert _read("verify.confirm_ms", run) == WANT["verify.confirm_ms"]


def test_each_request_is_read_once():
    """A batch's queries share one list: it counts once, and the sum is
    split over the window's queries."""
    run = _run(traces=(REQ_A,), sizes=(3,))
    assert _read("verify.confirm_ms", run) == pytest.approx(30 / 3)
    assert spans.records(run) == [REQ_A]


def test_union_and_overlap():
    u = spans.union([(5, 7), (0, 2), (1, 3), (7, 9), (4, 4)])
    assert u == [[0, 3], [5, 9]]
    assert spans.overlap(u, [[2, 6], [8, 20]]) == 1 + 1 + 1
    assert spans.overlap([], u) == 0
