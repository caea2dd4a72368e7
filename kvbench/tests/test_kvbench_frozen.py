"""The benchmark's frozen copies equal their sources at a small size, and
the generator for large configurations keeps their segment law.

    python -m pytest kvbench/tests

Each copy in ``kvbench/frozen/`` names the file it was copied from; this
holds it equal to that file as it stands, so a change to either shows.
``frozen/segments.py`` has no source: this holds it to the law of
``generate_series`` and to bits that the number of threads cannot move.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from kvbench.frozen import calibrate, idle, segments  # noqa: E402
from kvbench.frozen.generators import generate_series  # noqa: E402


@pytest.mark.parametrize("n,seed", [(5_000, 0), (50_000, 7),
                                    (120_000, 2 ** 40 + 3)])
def test_generator_equals_source(n, seed):
    from kvmatch_tpu_torch.data.generators import \
        generate_series as source
    for dtype in (np.float64, np.float32):
        np.testing.assert_array_equal(generate_series(n, seed, dtype=dtype),
                                      source(n, seed, dtype=dtype))


@pytest.mark.parametrize("n,seed", [(100_000, 0), (1_234_567, 2 ** 40 + 9)])
def test_segments_bits_do_not_depend_on_threads(n, seed):
    one = segments.generate(n, seed, threads=1)
    assert one.dtype == np.float32 and one.shape == (n,)
    assert np.isfinite(one).all()
    for threads in (2, 5):
        np.testing.assert_array_equal(segments.generate(n, seed, threads),
                                      one)
    assert not np.array_equal(segments.generate(n, seed + 1, 3), one)


def test_segments_keep_the_segment_law():
    """Lengths uniform in [min(1000, 0.01 n), 0.01 n] that tile the series,
    kinds uniform over the three, and each kind's values inside what its
    parameters' ranges allow."""
    lengths, kinds = [], []
    for seed in range(40):
        starts, ln, kd = segments.segment_table(1_000_000, seed)
        assert starts[0] == 0 and sum(ln) == 1_000_000
        assert np.array_equal(np.diff(starts), ln[:-1])
        lengths += ln[:-1]
        kinds += kd
    assert min(lengths) >= 1000 and max(lengths) <= 10_000
    assert abs(np.mean(lengths) - 5500) < 300
    share = np.bincount(kinds, minlength=3) / len(kinds)
    assert share.size == 3 and np.all(np.abs(share - 1 / 3) < 0.05)
    assert segments.segment_table(50_000, 1)[1][0] <= 500
    n, seed = 400_000, 11
    x = segments.generate(n, seed).astype(np.float64)
    starts, ln, kd = segments.segment_table(n, seed)
    for s0, m, k in zip(starts, ln, kd):
        seg = x[s0:s0 + m]
        if k == 0:      # random walk: start in [-5, 5), steps in [-1, 1)
            assert abs(seg[0]) <= 5 and np.abs(np.diff(seg)).max() <= 1.0001
            assert np.abs(np.diff(seg)).mean() == pytest.approx(0.5, 0.1)
        elif k == 1:    # Gaussian: mean in [-5, 5), sd in [0, 2)
            assert abs(seg.mean()) <= 5.1 and seg.std() <= 2.05
        else:           # sine: mean + amp sin + noise, amp in [2, 10)
            amp, mid = (seg.max() - seg.min()) / 2, (seg.max() + seg.min()) / 2
            assert 1.9 <= amp <= 10.5 and abs(mid) <= 5.5
    assert set(kd) == {0, 1, 2}


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
