"""The benchmark's harness on the card, at a tiny size.

Every test here needs a CUDA device and skips without one:

    python -m pytest -p no:cacheprovider -m cuda kvbench/tests

Each cell of the tiny copy (``test_kvbench_harness.tiny_root``) runs once
traced on the card: the trace has device activity inside the window, the
device metrics of the cell come out, a share of a roofline stays at or under
105%, and the device block names the card.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kvbench import harness  # noqa: E402
from test_kvbench_harness import BENCH, CELLS, tiny_root  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_the_card(tmp_path, card, cell):
    root = tiny_root(tmp_path)
    spec = harness.load_cell(root, cell)
    out, info = harness.run_cell(spec, 7, 1.0, True, card, 0.0,
                                 dict(platform="gpu", count=1,
                                      kind=torch.cuda.get_device_name(0)))
    assert info["compared_responses"] > 0
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["memory_peak_bytes"] > 0
    want = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", [cell])}
    device_metrics = {m["name"] for m in BENCH["per_layer"]
                      if m["source"] == "device_trace"} & want
    assert device_metrics <= set(out["metrics"])
    for name, m in out["metrics"].items():
        if m["unit"] == "%" and name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
    assert out["breakdown"]["device_ops"]
    json.dumps(out)
