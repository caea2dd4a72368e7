"""The port stands alone: importing kvmatch_tpu_torch and answering a
query on the CPU leaves ``jax`` and every module of the JAX package
``kvmatch_tpu`` out of ``sys.modules`` (checked in a fresh interpreter,
since this test process imports both for the parity tests).  One probe runs
the ED engines, one the DTW engines; every entry point is asked for the CPU
explicitly, as the card is the port's default; a third builds the full
device index and the device-bucket index and serves them streamed and
host-only; a fourth runs this slice's modules (the append build,
persistence, the command line, the twins and the full scan, codec,
storage, experiments, profiling); a fifth the sharded build, the
sharded steps and their recovery (``parallel.dryrun``) and the sharded
``HbmStore``.  A static check finds no
import of ``kvmatch_tpu`` in the port's sources or in chip_smoke.py."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# The probes' last line: the jax and kvmatch_tpu modules loaded after the
# query (PRELOADED when jax was there before the port was imported).
VERDICT = r"""
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "kvmatch_tpu"
                or m.startswith("kvmatch_tpu."))
print("PRELOADED" if preloaded else "LOADED " + " ".join(loaded) if loaded
      else "STANDS_ALONE")
"""

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
index = build_index_device_stats(data, icfg, device="cpu")
q = data[1000:1300]
(a,) = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                   device="cpu").query_batch(q[None], 2.0)
(b,) = NormQueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                       device="cpu").query_batch(q[None], 2.0, alpha=1.5,
                                                 beta=5.0)
assert set(a.offsets.tolist()) == set(
    oracle.rsm_ed(data, q, 2.0, device="cpu")[0].tolist())
assert set(b.offsets.tolist()) == set(
    oracle.nsm_ed(data, q, 2.0, alpha=1.5, beta=5.0, device="cpu")[0].tolist())
assert 1000 in a.offsets.tolist() and 1000 in b.offsets.tolist()
""" + VERDICT


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
index = build_index_device_stats(data, icfg, device="cpu")
q = data[1000:1200]
for skip in (0, 1 << 30):  # with and without the LB stage
    qcfg = QueryConfig(dense_probe_min_count=0, dtw_skip_lb_max=skip)
    (a,) = QueryEngineDtw(data, index=index, icfg=icfg, qcfg=qcfg,
                          device="cpu").query_batch(q[None], 3.0, rho=10)
    b = NormQueryEngineDtw(data, index=index, icfg=icfg, qcfg=qcfg,
                           device="cpu").query(q, 3.0, rho=10, alpha=1.5,
                                               beta=5.0)
    assert set(a.offsets.tolist()) == set(
        oracle.rsm_dtw(data, q, 3.0, 10, device="cpu")[0].tolist())
    assert set(b.offsets.tolist()) == set(
        oracle.cnsm_dtw(data, q, 3.0, 10, 1.5, 5.0, device="cpu")[0].tolist())
    assert 1000 in a.offsets.tolist() and 1000 in b.offsets.tolist()
""" + VERDICT


STREAM_PROBE = r"""
import sys
preloaded = "jax" in sys.modules
import numpy as np
import torch
torch.set_num_threads(1)
from kvmatch_tpu_torch import (QueryConfig, QueryEngine, QueryEngineDtw,
                               generate_series, oracle)
from kvmatch_tpu_torch.index.build import build_index_device_buckets
from kvmatch_tpu_torch.index.device_build import build_index_device
data = generate_series(8_000, seed=3)
full = build_index_device(data, device="cpu")
buckets = build_index_device_buckets(data, device="cpu")
q = data[1000:1200]
want = set(oracle.rsm_ed(data, q, 2.0, device="cpu")[0].tolist())
for index in (full, buckets):
    a = QueryEngine(data, index=index, device_data="stream", device="cpu",
                    qcfg=QueryConfig(host_verify_max_points=0)).query(q, 2.0)
    b = QueryEngine(data, index=index, device_data="host").query(q, 2.0)
    assert set(a.offsets.tolist()) == set(b.offsets.tolist()) == want
c = QueryEngineDtw(data, index=full, device_data="stream", device="cpu",
                   qcfg=QueryConfig(host_verify_max_points=0)).query(
                       q, 3.0, rho=10)
assert set(c.offsets.tolist()) == set(
    oracle.rsm_dtw(data, q, 3.0, 10, device="cpu")[0].tolist())
assert 1000 in c.offsets.tolist()
""" + VERDICT


SLICE_PROBE = r"""
import sys
preloaded = "jax" in sys.modules
import contextlib, io, tempfile
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from kvmatch_tpu_torch import (IndexNpzStore, QueryEngine, StreamingIndexBuilder,
                               TWINS, UcrScanner, build_index_host, cli,
                               experiments, generate_series, oracle)
from kvmatch_tpu_torch.storage import base, file, memory
from kvmatch_tpu_torch.utils import codec, profiling
data = generate_series(8_000, seed=3)
b = StreamingIndexBuilder()
b.append(data[:3_000])
b.append(data[3_000:])
index = b.build()
q = data[1000:1200]
want = set(oracle.rsm_ed(data, q, 2.0, device="cpu")[0].tolist())
with tempfile.TemporaryDirectory() as d:
    IndexNpzStore(Path(d) / "i.npz").save(index)
    loaded = IndexNpzStore(Path(d) / "i.npz").load()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["generate-data", "8000", "--seed", "3", "--out",
                  str(Path(d) / "data")])
        cli.main(["query", str(Path(d) / "data"), "--offset", "1000",
                  "--length", "200", "--epsilon", "2", "--device", "cpu"])
    assert "Best: 1000, distance: 0.0" in out.getvalue()
a = QueryEngine(data, index=loaded, device="cpu").query(q, 2.0)
c = TWINS["rsm-ed"](data, index=loaded, device="cpu").query(q, 2.0)
s = UcrScanner(data, device="cpu").scan_ed(q, 2.0)
assert set(a.offsets.tolist()) == set(c.offsets.tolist()) == \
    set(s[0].tolist()) == want
assert index.keys() == build_index_host(data).keys()
""" + VERDICT


SHARDED_PROBE = r"""
import sys
preloaded = "jax" in sys.modules
import numpy as np
import torch
torch.set_num_threads(1)
from kvmatch_tpu_torch import generate_series
from kvmatch_tpu_torch.parallel.dryrun import dryrun_multichip
from kvmatch_tpu_torch.parallel.mesh import make_mesh
from kvmatch_tpu_torch.storage.memory import HbmStore
dryrun_multichip(2, ["cpu"] * 2)
store = HbmStore(generate_series(1_001, seed=3), sharding=make_mesh(["cpu"] * 2))
assert [t.shape[0] for t in store.device] == [501, 501]
""" + VERDICT


@pytest.mark.parametrize("probe", [PROBE, DTW_PROBE, STREAM_PROBE,
                                   SLICE_PROBE, SHARDED_PROBE],
                         ids=["ed", "dtw", "stream", "slice", "sharded"])
def test_port_runs_without_jax(probe):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    verdict = out.stdout.strip().splitlines()[-1]
    if verdict == "PRELOADED":
        pytest.skip("this interpreter loads jax at start-up")
    assert verdict == "STANDS_ALONE"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_do_not_import_the_jax_package():
    """No module of kvmatch_tpu_torch, and not chip_smoke.py, imports
    kvmatch_tpu or one of its modules (citations in comments are fine)."""
    files = sorted((REPO / "kvmatch_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}: {m}" for f in files
           for m in _imported_modules(f)
           if m == "kvmatch_tpu" or m.startswith("kvmatch_tpu.")]
    assert not bad, bad
