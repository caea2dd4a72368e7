"""utils/kernel_bench.py: every section at a tiny shape on the CPU, its
output against the JAX op the JAX section times on the same inputs, its
bytes and flops against the JAX formulas, and the fields of
``measure_kernel_efficiency`` and ``compare_window_kernel``.

Tolerances, those of the parity tests of the same pairs:

* gather ED (``ed_distances``): |d2 - d2_jax| <= 1e-5 L + 1e-5 d2
  (tests/test_torch_ed.py);
* region FFT (``region_znorm_distances``): |d2 - d2_jax| <= the f32 error
  bound the port returns beside d2 (the JAX formula), mean and std within
  1e-5 of the series' max |x| (tests/test_torch_regions.py);
* banded DTW (``dtw_banded_batch``): rtol 1e-4; DS (``dtw_stage_ds_multi``):
  hi + lo within 8 eps32 (d + 1), max|x| equal (tests/test_torch_dtw_ops.py);
* the build pass (``build_buckets``): bucket ids bit-identical.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvmatch_tpu.config import DEFAULT_INDEX_CONFIG
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.ops import dtw as jd
from kvmatch_tpu.ops import ed as jed
from kvmatch_tpu.ops import regions as jrg
from kvmatch_tpu.ops import sliding as jsl
from kvmatch_tpu_torch.ops import dtw as td
from kvmatch_tpu_torch.utils import kernel_bench as kb

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N = 60_001
EPS32 = float(np.finfo(np.float32).eps)
TINY = dict(gather_ed=(300, 256), region_fft=(6, 128, 256),
            banded_dtw=(12, 128, 9), ds_dtw=5, build_pass=1 << 13)

# The fields of kvmatch_tpu/utils/kernel_bench.py:measure_kernel_efficiency
# (banded_dtw_xla_* becomes banded_dtw_plain_*, the plain PyTorch DP).
JAX_FIELDS = (
    "gather_ed_gbps", "gather_ed_ms", "gather_ed_shape",
    "region_fft_gbps", "region_fft_ms", "region_fft_shape",
    "region_fft_offsets_per_s",
    "banded_dtw_gbps", "banded_dtw_gflops", "banded_dtw_ms",
    "banded_dtw_cands_per_s", "banded_dtw_shape", "banded_dtw_kernel",
    "banded_dtw_plain_gbps", "banded_dtw_plain_gflops", "banded_dtw_plain_ms",
    "banded_dtw_plain_cands_per_s",
    "banded_dtw_rows_gbps", "banded_dtw_rows_gflops", "banded_dtw_rows_ms",
    "banded_dtw_rows_cands_per_s",
    "ds_dtw_cands_per_s", "ds_dtw_ms",
    "build_pass_gbps", "build_pass_mpts_per_s", "build_pass_ms",
    "build_pass_shape")
TIMED = ("gather_ed", "region_fft", "banded_dtw", "banded_dtw_rows",
         "banded_dtw_plain", "ds_dtw", "build_pass")


@pytest.fixture(scope="module")
def series():
    data = generate_series(N, seed=11).astype(np.float32)
    return data, torch.as_tensor(data), jnp.asarray(data)


def _offs(n, L, B, seed):
    return np.random.default_rng(seed).integers(0, n - L - 64, B)


@pytest.mark.parametrize("i", [0, 3])
def test_gather_ed_equals_jax(series, i):
    data, dt, dj = series
    B, L = TINY["gather_ed"]
    offs = _offs(N, L, B, 1)
    sec = kb.gather_ed(dt, offs, L)
    got = sec.fn(i).numpy()
    want = np.asarray(jed.ed_distances(dj, dj[:L],
                                       jnp.asarray(offs + i, jnp.int32), L))
    assert np.all(np.abs(got - want) <= 1e-5 * L + 1e-5 * np.abs(want))
    assert sec.nbytes == B * L * 4 + L * 4 + B * 4  # kernel_bench.py:94
    assert sec.flops is None
    assert sec.ops == kb.K2_OPS["raw"] * B * L


def test_region_near_section_counts_rows_not_padding(series):
    """The near-set section runs the plain chain on the CPU, its count
    beside the plain version's, and its bound is near_work's over the
    rows that are not padding."""
    from kvmatch_tpu_torch.ops import regions as trg
    data, dt, _ = series
    R, M, L = TINY["region_fft"]
    starts = torch.as_tensor(_offs(N, M + L - 1, R, 2))
    q = dt[:L]
    qh = ((q - q.mean()) / q.std(unbiased=False))[None].contiguous()
    qids = torch.zeros(R, dtype=torch.int32)
    vfrom = torch.zeros(R, dtype=torch.int64)
    vto = torch.full((R,), M, dtype=torch.int64)
    vto[-2:] = 0
    th = torch.tensor([3.0 * L], dtype=torch.float32)
    cons = torch.tensor([[10.0, 1e6, float(q.mean()), float(q.std()), 1e-3]],
                        dtype=torch.float32)
    args = (dt, qh, starts, qids, vfrom, vto, th, cons, L, M)
    sec = kb.region_near(*args, 4096)
    cnt, _, _ = sec.fn(0)
    assert cnt == trg.region_znorm_near_plain(*args, 4096)[0] > 0
    work = kb.near_work(R - 2, L, M)
    r_len, n_fft = M + L - 1, 1 << int(np.ceil(np.log2(M + L - 1)))
    assert sec.nbytes == work["bound_bytes"] == (R - 2) * (
        8 * r_len + 4 * M + 20 * n_fft)
    assert sec.ops == work["bound_ops"] == (R - 2) * 2 * kb.FFT_OPS * \
        n_fft * np.log2(n_fft)
    assert sec.flops is None


def test_region_fft_equals_jax(series):
    data, dt, dj = series
    R, M, L = TINY["region_fft"]
    r_len = M + L - 1
    starts = _offs(N, r_len, R, 2)
    sec = kb.region_fft(dt, starts, L, M)
    d2, mean, std, err = (a.numpy() for a in sec.fn(0))
    q = dj[:L]
    qh = (q - jnp.mean(q)) / (jnp.std(q) + 1e-9)
    want = [np.asarray(a) for a in jrg.region_znorm_distances(
        dj, qh, jnp.asarray(starts, jnp.int32), L, M)]
    assert d2.shape == want[0].shape == (R, M)
    np.testing.assert_array_equal(np.isfinite(d2), np.isfinite(want[0]))
    fin = np.isfinite(want[0])
    assert np.all(np.abs(d2 - want[0])[fin] <= err[fin])
    scale = np.abs(data).max()
    for g, w in ((mean, want[1]), (std, want[2])):
        assert np.all(np.abs(g - w) <= 1e-5 * scale)
    assert sec.nbytes == R * r_len * 4 + L * 4 + 3 * R * M * 4  # :112
    assert sec.flops is None
    N_fft = 1 << int(np.ceil(np.log2(r_len)))
    assert sec.ops == R * 3 * kb.FFT_OPS * N_fft * np.log2(N_fft)


@pytest.mark.parametrize("dp", ["dtw_diag", "dtw_rows", "dtw_banded_plain"])
def test_banded_dtw_equals_jax(series, dp):
    data, dt, dj = series
    B, L, rho = TINY["banded_dtw"]
    offs = _offs(N, L, B, 3)
    sec = kb.banded_dtw(dt, offs, L, rho, getattr(td, dp))
    got = sec.fn(2).numpy()
    w = data[(offs + 2)[:, None] + np.arange(L)]
    want = np.asarray(jd.dtw_banded_batch(jnp.asarray(w), dj[:L], rho))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    W = 2 * rho + 1
    assert sec.nbytes == B * L * 4 + L * 4 + B * 4  # :144
    assert sec.flops == B * L * W * 8                # :145
    assert sec.ops == kb.DP_OPS * B * kb.band_cells(L, rho)


def test_ds_dtw_equals_jax(series):
    data, dt, dj = series
    B, L, rho = TINY["ds_dtw"], 128, 9
    offs = _offs(N, L, B, 4)
    sec = kb.ds_dtw(dt, offs, L, rho)
    hi, lo, amax = (a.numpy() for a in sec.fn(1))
    want = jd.dtw_stage_ds_multi(dj, dj[:L][None],
                                 jnp.asarray(offs + 1, jnp.int32),
                                 jnp.zeros(B, jnp.int32), L, rho)
    d_want = jd.ds_value(want[0], want[1])
    d_got = td.ds_value(hi, lo)
    assert np.all(np.abs(d_got - d_want) <= 8.0 * EPS32 * (d_want + 1.0))
    np.testing.assert_array_equal(amax, np.asarray(want[2]))
    assert sec.nbytes == B * L * 4 + L * 4 + 3 * B * 4
    assert sec.ops == kb.DS_OPS * B * kb.band_cells(L, rho)


def test_build_pass_equals_jax(series):
    data, dt, dj = series
    nb = TINY["build_pass"]
    cfg = DEFAULT_INDEX_CONFIG
    scales = tuple(cfg.scales)
    sec = kb.build_pass(dt, nb, scales, cfg.pos_of_d)
    got = sec.fn(0)
    want = jsl.build_buckets(dj[:nb], scales, cfg.pos_of_d)
    assert set(got) == set(want)
    for w in scales:
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(want[w]))
    assert sec.nbytes == nb * 4 + len(scales) * nb * 4  # :195
    assert sec.ops == nb * (kb.BUILD_OPS_POINT
                            + kb.BUILD_OPS_SCALE * len(scales))


def test_measure_kernel_efficiency_fields(series):
    _, dt, _ = series
    out = kb.measure_kernel_efficiency(dt, reps=1, shapes=TINY)
    missing = [f for f in JAX_FIELDS if f not in out]
    assert not missing, missing
    for p in TIMED:
        assert out[f"{p}_ms"] > 0 and out[f"{p}_bound_ms"] > 0
        assert out[f"{p}_bound_by"] in ("bytes", "operations")
        assert out[f"{p}_share"] is None  # the card's bound, a CPU time
    # A CPU tensor runs the plain versions, named as such.
    assert out["gather_ed_kernel"] == "window_ed_plain"
    assert out["banded_dtw_kernel"] == out["banded_dtw_rows_kernel"] \
        == out["banded_dtw_plain_kernel"] == "dtw_banded_plain"
    assert out["ds_dtw_kernel"] == "dtw_banded_ds_plain"
    assert out["device"] == "cpu"
    B, L, rho = TINY["banded_dtw"]
    assert out["banded_dtw_shape"] == f"B={B} L={L} rho={rho}"


def test_compare_window_kernel_on_cpu_names_the_plain_version(series):
    _, dt, _ = series
    out = kb.compare_window_kernel(dt, reps=1)
    for B, L in kb.WINDOW_SHAPES:
        assert out[f"plain_ms_B{B}_L{L}"] > 0
        assert out[f"library_ms_B{B}_L{L}"] > 0
        assert f"plain_speedup_vs_library_B{B}_L{L}" in out
    assert not [k for k in out if k.startswith("k2")]


def test_timer_calls_distinct_iterations():
    seen = []
    ms = kb._timed(seen.append, reps=4, device=torch.device("cpu"), rounds=3)
    assert ms >= 0
    assert seen[0] == 12 and sorted(seen[1:]) == list(range(12))


def test_roofline():
    b = kb.bound(3.35e9, 1.0)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1.0)
    b = kb.bound(1.0, 67e9)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1.0)
    assert kb.band_cells(8192, 409) == 8192 * 819 - 409 * 410
    assert kb.band_cells(10, 50) == 100  # r clamped to L - 1: the full grid


def test_chip_smoke_takes_the_roofline_from_kernel_bench():
    """The kernel table's bounds and kernel_bench's shares have one
    definition: chip_smoke.py imports them and defines none of its own."""
    used = {"bound", "band_cells", "timed_ms", "card_line", "K1_OPS",
            "K1_TRACK_OPS", "K1_OPS_FULL", "k2_work", "DP_OPS", "DS_OPS"}
    names = used | {"HBM_BYTES_PER_S", "F32_OPS_PER_S", "K2_OPS"}
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    defined = {t.id for node in tree.body if isinstance(node, ast.Assign)
               for t in node.targets if isinstance(t, ast.Name)}
    defined |= {node.name for node in tree.body
                if isinstance(node, ast.FunctionDef)}
    assert not names & defined
    imported = {a.name for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                and node.module == "kvmatch_tpu_torch.utils.kernel_bench"
                for a in node.names}
    assert used <= imported


def test_k2_work_counts_each_byte_once():
    """K2's bound: each window, offset, query id and query row read once,
    d2 (and mean and std) written once; K2_OPS a window element."""
    w = kb.k2_work(16384, 8192, 8, True)
    assert w["bound_bytes"] == (16384 * (4 * 8192 + 12) + 8 * 8192 * 4
                                + 16384 * 12)
    assert w["bound_ops"] == kb.K2_OPS["znorm"] * 16384 * 8192
    assert w["bound_by"] == "bytes"
    assert kb.k2_work(4096, 1024, 8, False)["bound_bytes"] == (
        4096 * (4 * 1024 + 12) + 8 * 1024 * 4 + 4096 * 4)


def test_k2_f64_bound_counts_its_bytes():
    """K2's f64 form: the f32 windows, offsets and query ids, f64 query rows
    and three f64 outputs; its operations at the f64 rate."""
    w = kb.k2_f64_work(1100, 4096, 8)
    assert w["bound_bytes"] == (1100 * (4 * 4096 + 12) + 8 * 4096 * 8
                                + 1100 * 24)
    assert w["bound_ops"] == kb.K2_OPS["znorm"] * 1100 * 4096
    assert w["bound_by"] == "bytes"
    t_ops = w["bound_ops"] / kb.F64_OPS_PER_S * 1e3
    assert t_ops < w["bound_ms"] == w["bound_bytes"] / kb.HBM_BYTES_PER_S * 1e3


def test_cons_and_work_counts_each_byte_once():
    """The AND's bound: three f32 statistics a position and a flag byte a
    (query, 128 positions) read once; at n = 1e8 and Q = 8 it is bytes."""
    npos = 99_996_032
    w = kb.cons_and_work(npos, 8)
    assert w["bound_bytes"] == 12 * npos + 8 * npos // 128
    assert w["bound_ops"] == npos * (kb.CONS_OPS_POS + 8 * kb.CONS_OPS_PAIR)
    assert w["bound_by"] == "bytes"
    assert kb.cons_and_work(1 << 24, 1)["bound_bytes"] == (
        12 * (1 << 24) + (1 << 24) // 128)


def test_k2_device_times_refuse_the_cpu(monkeypatch):
    """K2's and the AND's device times are the card's: on a CPU tensor the
    timers raise, and the command exits 2 without a card."""
    data = torch.zeros(10_000)
    with pytest.raises(ValueError, match="card"):
        kb.window_kernel_times(data, shapes=((4, 100),))
    with pytest.raises(ValueError, match="card"):
        kb.window_f64_times(data, shapes=((4, 100),))
    with pytest.raises(ValueError, match="card"):
        kb.cons_and_times(data, shapes=(("all", None, 1),), length=256)
    with pytest.raises(ValueError, match="CUDA"):
        kb.device_ms([lambda i: None], 2, data.device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kb.main(["--n", "1000"]) == 2


def _trace(kernel_starts, library_starts=(), dur=10.0):
    return ([("void window_ed_kernel<1, false>(float const*)", t, dur)
             for t in kernel_starts]
            + [("cdist_kernel_cuda_impl", t, 2 * dur) for t in library_starts])


@pytest.mark.parametrize("events,library,fault", [
    (_trace(range(6)), False, None),
    (_trace(range(6), (10, 11, 12, 13)), True, None),
    (_trace(range(5)), False, "5 window_ed_kernel"),         # a launch lost
    (_trace(range(7)), False, "7 window_ed_kernel"),         # one too many
    (_trace(range(6), (10,)), False, "besides"),             # not asked for
    (_trace(range(6)), True, "0 library"),                   # library's lost
    (_trace(range(6), (10, 11, 12)), True, "3 library"),     # part of them
    (_trace(range(6), (3, 11, 12, 13)), True, "amid"),       # amid K2's
    (_trace(range(6), dur=1.0), False, "least physical"),    # too fast
])
def test_split_trace_keeps_only_whole_traces(events, library, fault):
    """A trace of 3 blocks of 2 K2 calls (then a library block) splits into
    each block's milliseconds a call; a trace that lost or gained device
    activities, or whose block beats its least physical time, is refused
    with its fault, so device_ms takes it again."""
    args = (events[::-1], 2, 3, kb.K2_KERNEL, library, [0.005] * 3)
    if fault is not None:
        with pytest.raises(ValueError, match=fault):
            kb.split_trace(*args)
        return
    ms, lib = kb.split_trace(*args)
    assert ms == [0.01, 0.01, 0.01]
    assert lib == (0.04 if library else None)
