"""The port never loads JAX: importing kvmatch_tpu_torch and answering a
query on the CPU leaves ``jax`` out of ``sys.modules`` (checked in a fresh
interpreter, since this test process imports jax for the parity tests).
One probe runs the ED engines, one the DTW engines."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import sys
preloaded = "jax" in sys.modules
import numpy as np
import torch
torch.set_num_threads(1)
from kvmatch_tpu_torch import (IndexConfig, NormQueryEngine, QueryConfig,
                               QueryEngine, generate_series, oracle)
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
data = generate_series(8_000, seed=3)
icfg = IndexConfig()
qcfg = QueryConfig(dense_probe_min_count=0, host_verify_max_points=0)
index = build_index_device_stats(data, icfg)
q = data[1000:1300]
(a,) = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg).query_batch(
    q[None], 2.0)
(b,) = NormQueryEngine(data, index=index, icfg=icfg, qcfg=qcfg).query_batch(
    q[None], 2.0, alpha=1.5, beta=5.0)
assert set(a.offsets.tolist()) == set(oracle.rsm_ed(data, q, 2.0)[0].tolist())
assert set(b.offsets.tolist()) == set(
    oracle.nsm_ed(data, q, 2.0, alpha=1.5, beta=5.0)[0].tolist())
assert 1000 in a.offsets.tolist() and 1000 in b.offsets.tolist()
print("PRELOADED" if preloaded else "JAX_LOADED" if "jax" in sys.modules
      else "NO_JAX")
"""


DTW_PROBE = r"""
import sys
preloaded = "jax" in sys.modules
import numpy as np
import torch
torch.set_num_threads(1)
from kvmatch_tpu_torch import (IndexConfig, NormQueryEngineDtw, QueryConfig,
                               QueryEngineDtw, generate_series, oracle)
from kvmatch_tpu_torch.index.device_build import build_index_device_stats
data = generate_series(8_000, seed=3)
icfg = IndexConfig()
index = build_index_device_stats(data, icfg)
q = data[1000:1200]
for skip in (0, 1 << 30):  # with and without the LB stage
    qcfg = QueryConfig(dense_probe_min_count=0, dtw_skip_lb_max=skip)
    (a,) = QueryEngineDtw(data, index=index, icfg=icfg,
                          qcfg=qcfg).query_batch(q[None], 3.0, rho=10)
    b = NormQueryEngineDtw(data, index=index, icfg=icfg, qcfg=qcfg).query(
        q, 3.0, rho=10, alpha=1.5, beta=5.0)
    assert set(a.offsets.tolist()) == set(
        oracle.rsm_dtw(data, q, 3.0, 10)[0].tolist())
    assert set(b.offsets.tolist()) == set(
        oracle.cnsm_dtw(data, q, 3.0, 10, 1.5, 5.0)[0].tolist())
    assert 1000 in a.offsets.tolist() and 1000 in b.offsets.tolist()
print("PRELOADED" if preloaded else "JAX_LOADED" if "jax" in sys.modules
      else "NO_JAX")
"""


@pytest.mark.parametrize("probe", [PROBE, DTW_PROBE], ids=["ed", "dtw"])
def test_port_runs_without_jax(probe):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    verdict = out.stdout.strip().splitlines()[-1]
    if verdict == "PRELOADED":
        pytest.skip("this interpreter loads jax at start-up")
    assert verdict == "NO_JAX"
