"""The benchmark's frozen copies equal their sources at a small size.

    python -m pytest kvbench/tests

Each copy in ``kvbench/frozen/`` names the file it was copied from; this
holds it equal to that file as it stands, so a change to either shows.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from kvbench.frozen import calibrate, idle  # noqa: E402
from kvbench.frozen.generators import generate_series  # noqa: E402


@pytest.mark.parametrize("n,seed", [(5_000, 0), (50_000, 7),
                                    (120_000, 2 ** 40 + 3)])
def test_generator_equals_source(n, seed):
    from kvmatch_tpu_torch.data.generators import \
        generate_series as source
    for dtype in (np.float64, np.float32):
        np.testing.assert_array_equal(generate_series(n, seed, dtype=dtype),
                                      source(n, seed, dtype=dtype))


def _source_union():
    """The busy-union lines of chip_smoke.py's profile_batch, as a
    function of (dev, b0, b1) with dev's events carrying time_range."""
    text = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r"\n( +)busy, end = 0\.0, b0\n(?:\1.*\n)+?\1 +end = hi\n",
                  text)
    assert m, "the busy union is no longer in chip_smoke.py:profile_batch"
    body = "\n".join(line[len(m.group(1)):] for line in
                     m.group(0).strip("\n").splitlines())
    ns: dict = {}
    exec("def union(dev, b0, b1):\n"
         + "\n".join("    " + line for line in body.splitlines())
         + "\n    return busy\n", ns)
    return ns["union"]


class _Ev:
    def __init__(self, lo, hi):
        self.time_range = type("R", (), dict(start=lo, end=hi))()


def test_idle_union_equals_source():
    union = _source_union()
    rng = np.random.default_rng(3)
    for _ in range(20):
        lo = rng.uniform(0, 100, 30)
        iv = list(zip(lo, lo + rng.uniform(0, 10, 30)))
        b0, b1 = 10.0, 90.0
        assert idle.busy_union(iv, b0, b1) == pytest.approx(
            union([_Ev(a, b) for a, b in iv], b0, b1), abs=0)


def test_eps_rule_equals_source(monkeypatch):
    from kvmatch_tpu_torch import selectivity
    rng = np.random.default_rng(5)
    profiles = [np.sort(rng.uniform(0, 50, 40)).astype(np.float32),
                np.concatenate([np.sort(rng.uniform(0, 5, 12)),
                                np.full(28, np.inf)]).astype(np.float32)]
    it = iter(profiles)
    monkeypatch.setattr(selectivity, "topk_profile",
                        lambda *a, **k: (torch.as_tensor(next(it)), None))
    targets = {-8: 3, -7: 30}
    data = np.zeros(100)
    eps, _ = selectivity.calibrate("cnsm", data, torch.zeros(100), [0, 1],
                                   10, targets, 40)
    for j, ds in enumerate(profiles):
        for d, t in targets.items():
            assert calibrate.eps_for_target(ds, t) == eps[d][j]
