"""The baselines of the PyTorch port against the JAX package's and the
float64 oracle: the index-free UCR full scan (baselines.UcrScanner) and the
engines with the reference's scalar phase 2 (baseline_twin.py over
native/baseline_scalar.c).  Answer sets are equal; the scans' window counts
and the PAA prefilter's bound equal the JAX scanner's.  On the CPU
(``device="cpu"``: the plain versions of the kernels).
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import baseline_twin as jtwin
from kvmatch_tpu import oracle
from kvmatch_tpu.baselines import ScanStats as JScanStats
from kvmatch_tpu.baselines import UcrScanner as JUcrScanner
from kvmatch_tpu.config import IndexConfig as JIndexConfig
from kvmatch_tpu.index.build import build_index_numpy
from kvmatch_tpu_torch import baseline_twin, native
from kvmatch_tpu_torch.baselines import ScanStats, UcrScanner
from kvmatch_tpu_torch.config import IndexConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.engine.base import BaseEngine
from kvmatch_tpu_torch.index.build import build_index_host
from kvmatch_tpu_torch.storage.memory import HbmStore
from test_torch_host_parity import jax_native_lib

torch.set_num_threads(2)

N = 30_000


@pytest.fixture(scope="module")
def scanners():
    data = generate_series(N, seed=23)
    return data, UcrScanner(data, device="cpu"), JUcrScanner(data)


def _set(res):
    return set(np.asarray(res[0]).tolist())


@pytest.mark.parametrize("off,L,eps", [(1000, 256, 4.0), (12000, 777, 10.0)])
def test_scan_ed_equals_jax_and_oracle(scanners, off, L, eps):
    data, scanner, jscanner = scanners
    q = data[off:off + L]
    st, jst = ScanStats(), JScanStats()
    got = scanner.scan_ed(q, eps, stats=st)
    assert _set(got) == _set(jscanner.scan_ed(q, eps, stats=jst))
    assert _set(got) == _set(oracle.rsm_ed(data, q, eps))
    assert off in _set(got)
    assert st.n_windows == jst.n_windows == N - L + 1
    assert st.n_answers == len(_set(got))
    np.testing.assert_allclose(np.sort(got[1]),
                               np.sort(oracle.rsm_ed(data, q, eps)[1]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("constrained", [False, True])
def test_scan_nsm_ed_equals_jax_and_oracle(scanners, constrained):
    data, scanner, jscanner = scanners
    q = data[5000:5512]
    kw = dict(alpha=1.3, beta=8.0) if constrained else {}
    got = scanner.scan_nsm_ed(q, 5.0, **kw)
    assert _set(got) == _set(jscanner.scan_nsm_ed(q, 5.0, **kw))
    assert _set(got) == _set(oracle.nsm_ed(data, q, 5.0, **kw))
    assert 5000 in _set(got)


def test_scan_dtw_equals_jax_and_oracle(scanners):
    data, scanner, jscanner = scanners
    off, L, eps, rho = 9000, 128, 2.5, 6
    q = data[off:off + L]
    st, jst = ScanStats(), JScanStats()
    got = scanner.scan_dtw(q, eps, rho, stats=st)
    want = oracle.rsm_dtw(data, q, eps, rho)
    assert _set(got) == _set(jscanner.scan_dtw(q, eps, rho, stats=jst))
    assert _set(got) == _set(want)
    # The PAA prefilter pruned most windows and kept every answer.
    assert st.n_after_paa == jst.n_after_paa < st.n_windows
    assert st.n_answers == want[0].size


def test_paa_prefilter_is_sound_and_equals_jax(scanners):
    """The PAA bound (computed in place) equals the JAX scanner's bit for
    bit; switching the prefilter off does not change the answer set."""
    data, scanner, jscanner = scanners
    off, L, eps, rho = 21000, 128, 3.0, 6
    q = data[off:off + L]
    np.testing.assert_array_equal(scanner._lb_paa_dtw(q, 9.0, rho),
                                  jscanner._lb_paa_dtw(q, 9.0, rho))
    a1 = scanner.scan_dtw(q, eps, rho, paa_prefilter=True)
    a2 = scanner.scan_dtw(q, eps, rho, paa_prefilter=False)
    assert _set(a1) == _set(a2) == _set(oracle.rsm_dtw(data, q, eps, rho))


def test_scanner_takes_a_device_series(scanners):
    """A series already on a device (an HbmStore's tensor) is scanned in
    place; a tensor of another length is refused."""
    data, _, _ = scanners
    store = HbmStore(data, device="cpu")
    scanner = UcrScanner(store.host, device_data=store.device)
    q = data[700:956]
    assert _set(scanner.scan_ed(q, 4.0)) == _set(oracle.rsm_ed(data, q, 4.0))
    with pytest.raises(ValueError, match="length"):
        UcrScanner(data, device_data=store.device[:-1])


@pytest.fixture(scope="module")
def twin_setup():
    jax_native_lib("get_baseline_lib", "_BASE_TRIED")  # the JAX twins
    data = generate_series(60_000, seed=21)
    return (data, build_index_host(data, IndexConfig()),
            build_index_numpy(data, JIndexConfig()))


TWINS = {
    "rsm-ed": (9000, 512, 6.0, {}),
    "cnsm-ed": (14000, 256, 2.0, {"alpha": 1.4, "beta": 6.0}),
    "rsm-dtw": (22000, 256, 4.0, {"rho": 12}),
    "cnsm-dtw": (41000, 256, 2.0, {"rho": 12, "alpha": 1.4, "beta": 6.0}),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_equals_jax_twin_and_oracle(twin_setup, name):
    """Each scalar twin subclasses the port's engine; its answer set equals
    the oracle's and the JAX twin's, its distances the oracle's (float64 end
    to end)."""
    assert native.get_baseline_lib() is not None
    data, index, jindex = twin_setup
    off, L, eps, kw = TWINS[name]
    q = data[off:off + L]
    eng = baseline_twin.TWINS[name](data, index=index, device="cpu")
    assert isinstance(eng, BaseEngine)
    res = eng.query(q, eps, **kw)
    jres = jtwin.TWINS[name](data, index=jindex).query(q, eps, **kw)
    if name == "rsm-ed":
        want = oracle.rsm_ed(data, q, eps)
    elif name == "cnsm-ed":
        want = oracle.nsm_ed(data, q, eps, **kw)
    elif name == "rsm-dtw":
        want = oracle.rsm_dtw(data, q, eps, kw["rho"])
    else:
        want = oracle.cnsm_dtw(data, q, eps, **kw)
    assert set(res.offsets.tolist()) == set(want[0].tolist()) == \
        set(jres.offsets.tolist())
    assert off in res.offsets.tolist()
    got = dict(zip(res.offsets.tolist(), res.distances.tolist()))
    for o, d in zip(want[0].tolist(), want[1].tolist()):
        assert got[o] == pytest.approx(d, rel=1e-9, abs=1e-9)
    np.testing.assert_array_equal(res.distances, jres.distances)
