"""The port is complete: every public function, class and method of the JAX
package has a counterpart in kvmatch_tpu_torch.

Both packages are read with ``ast`` (nothing is imported).  Each public
top-level function and class of a ``kvmatch_tpu`` module, and each public
method of such a class, must have one of:

* a definition of the same name in the port's module at the same relative
  path;
* an entry in ``RENAMED``: its counterpart under another name, or the C
  entry point of ``csrc/`` it was folded into; the target must exist;
* an entry in ``NOT_PORTED``, with the reason it is left out; the port
  must not define it (a stale entry fails).

The three Pallas modules have no module in the port: their kernels are
hand-written CUDA in ``csrc/``, each entry point launched by one wrapper
(``PALLAS``).
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "kvmatch_tpu"
PORT = REPO / "kvmatch_tpu_torch"

#: "path:name" in kvmatch_tpu -> ("path:name" in kvmatch_tpu_torch, or
#: "csrc/<file>.cu:<C entry point>", why the name differs).
RENAMED = {
    "index/build.py:build_index_numpy": (
        "index/build.py:build_index_host", "the C host build"),
    "index/build.py:build_index_tpu": (
        "index/build.py:build_index_device_buckets",
        "the engines' default build, on the card"),
    "index/build.py:compute_buckets_tpu": (
        "index/build.py:compute_buckets_device", "the device bucket pass"),
    "parallel/query.py:DenseSegments": (
        "ops/probe.py:DenseSegments", "the probe's bottom layer"),
    "parallel/query.py:pack_segments_batch": (
        "ops/probe.py:pack_segments_batch", "the probe's bottom layer"),
    "parallel/query.py:fly_pad_for": (
        "ops/probe.py:fly_pad_for", "the probe's bottom layer"),
    "parallel/query.py:make_bucket_stack_prog": (
        "ops/probe.py:make_bucket_stack", "no jit program to make"),
    "parallel/query.py:make_cons_stats_prog": (
        "ops/probe.py:make_cons_stats", "no jit program to make"),
    "parallel/query.py:make_dense_probe_step_flags_pallas": (
        "engine/probe.py:ResidentProbe.run",
        "the resident probe's pass through K1"),
    "ops/probe_pallas.py:probe_flags_tiles": (
        "ops/probe.py:probe_flags", "K1, csrc/probe.cu"),
    "ops/probe_pallas.py:views_for": (
        "csrc/probe.cu:kvm_probe_flags",
        "the Mosaic kernel's tile views; K1 reads the stack at any shift"),
    "ops/probe_pallas.py:pallas_probe_available": (
        "backend.py:route", "the Mosaic lowering probe is the backend gate"),
    "ops/pallas_ed.py:window_distances_pallas": (
        "ops/ed.py:window_ed", "K2, csrc/window_ed.cu"),
    "ops/pallas_ed.py:block_multiple": (
        "csrc/window_ed.cu:kvm_window_ed",
        "the Pallas block offsets were padded to; K2 takes any batch"),
    "ops/pallas_ed.py:pad_to_align": (
        "csrc/window_ed.cu:kvm_window_ed",
        "the aligned-DMA padding of the series; K2 loads any offset"),
    "ops/dtw_pallas.py:dtw_banded_pallas_diag_multi": (
        "ops/dtw.py:dtw_diag", "K3, csrc/dtw.cu"),
    "ops/dtw_pallas.py:dtw_banded_pallas_multi": (
        "ops/dtw.py:dtw_rows", "K4, csrc/dtw.cu"),
    "ops/dtw_pallas.py:dtw_banded_pallas": (
        "ops/dtw.py:_dtw_f32", "picks K3 or K4 (DTW_STATE)"),
    "ops/dtw_pallas.py:pallas_dtw_available": (
        "backend.py:route", "the Mosaic lowering probe is the backend gate"),
}

#: "path:name" in kvmatch_tpu -> why the port leaves it out.
NOT_PORTED = {
    "ops/ed.py:pad_to_tiles": "TPU tile padding of the barrel-shift gather",
    "verify.py:device_distances": "casts offsets to int32; the port's "
                                  "run_bucketed serves",
    "parallel/mesh.py:shard_spec": "a JAX PartitionSpec",
    "parallel/mesh.py:replicated": "a JAX PartitionSpec",
    "parallel/query.py:make_dense_query_step": "its counterpart is the "
        "sharded step on a one-device mesh",
    "parallel/query.py:make_dense_query_step_batched": "its counterpart is "
        "the sharded step on a one-device mesh",
    "parallel/query.py:make_dense_query_step_norm_batched": "its "
        "counterpart is the sharded step on a one-device mesh",
    "parallel/query.py:make_dense_probe_step_fly": "the TPU probe ladder",
    "parallel/query.py:make_dense_probe_step_flags": "the TPU probe ladder",
    "parallel/query.py:make_dense_probe_step_batched": "the TPU probe ladder",
    "parallel/query.py:probe_block_for": "VMEM/HBM sizing of the XLA probe",
    "parallel/query.py:probe_mem_budget": "VMEM/HBM sizing of the XLA probe",
    "parallel/query.py:probe_stack_extra": "VMEM/HBM sizing of the XLA "
                                           "probe",
    "parallel/query.py:pack_bucket_stack": "the graft entry's",
    "utils/kernel_bench.py:compare_pallas_gather": "replaced by "
                                                   "compare_window_kernel",
}

#: Pallas module -> (its csrc/ source, {C entry point: the port's wrapper}).
PALLAS = {
    "ops/probe_pallas.py": ("csrc/probe.cu",
                            {"kvm_probe_flags": "ops/probe.py:probe_flags"}),
    "ops/pallas_ed.py": ("csrc/window_ed.cu",
                         {"kvm_window_ed": "ops/ed.py:window_ed"}),
    "ops/dtw_pallas.py": ("csrc/dtw.cu",
                          {"kvm_dtw_diag": "ops/dtw.py:dtw_diag",
                           "kvm_dtw_rows": "ops/dtw.py:dtw_rows"}),
}

JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _defs(path: Path, public: bool = True) -> dict:
    """name -> ast node of each top-level function and class of ``path``,
    and "Class.method" of each method of its classes (public ones only when
    ``public``)."""
    out = {}
    if not path.is_file():
        return out
    for node in ast.parse(path.read_text(), str(path)).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            continue
        if public and node.name.startswith("_"):
            continue
        out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and not (public and m.name.startswith("_")):
                    out[f"{node.name}.{m.name}"] = m
    return out


def _c_entries(rel: str) -> set:
    return set(re.findall(r'extern "C"\s+\w+\s+(\w+)\s*\(',
                          (PORT / rel).read_text()))


def _port_has(target: str) -> bool:
    rel, name = target.split(":")
    if rel.startswith("csrc/"):
        return name in _c_entries(rel)
    return name in _defs(PORT / rel, public=False)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = _defs(JAX / module)
    port = _defs(PORT / module, public=False)
    if module in PALLAS:
        assert not (PORT / module).exists(), \
            f"{module}: a Pallas module's work lives in csrc/"
    missing = [n for n in names if n not in port
               and f"{module}:{n}" not in RENAMED
               and f"{module}:{n}" not in NOT_PORTED]
    assert not missing, f"kvmatch_tpu/{module}: no counterpart in the port " \
        f"for {missing}"


def test_renamed_targets_exist():
    missing = [f"{k} -> {t}" for k, (t, why) in RENAMED.items()
               if not _port_has(t)]
    assert not missing, missing
    gone = [k for k in RENAMED if k.split(":")[1]
            not in _defs(JAX / k.split(":")[0])]
    assert not gone, f"RENAMED entries the JAX package no longer has: {gone}"
    assert all(why for _, why in RENAMED.values())


def test_not_ported_entries_are_not_stale():
    stale = [k for k in NOT_PORTED if _port_has(k)]
    assert not stale, f"the port defines these NOT_PORTED names: {stale}"
    gone = [k for k in NOT_PORTED if k.split(":")[1]
            not in _defs(JAX / k.split(":")[0])]
    assert not gone, f"NOT_PORTED entries the JAX package lacks: {gone}"
    assert all(why.strip() for why in NOT_PORTED.values())
    assert not set(NOT_PORTED) & set(RENAMED)


@pytest.mark.parametrize("module", sorted(PALLAS))
def test_pallas_modules_map_to_csrc_entry_points(module):
    """Each Pallas module's kernel is a C entry point of its csrc/ source,
    launched by the port's wrapper, and the module's kernel entry functions
    are RENAMED to that wrapper or entry point."""
    source, entries = PALLAS[module]
    assert "pallas_call" in (JAX / module).read_text()
    declared = _c_entries(source)
    for entry, wrapper in entries.items():
        assert entry in declared, f"{source} has no extern \"C\" {entry}"
        rel, name = wrapper.split(":")
        node = _defs(PORT / rel)[name]
        body = ast.get_source_segment((PORT / rel).read_text(), node)
        assert entry.removeprefix("kvm_") in body, \
            f"{wrapper} does not launch {entry}"
    renamed = {k.split(":")[1]: t for k, (t, _) in RENAMED.items()
               if k.startswith(module + ":")}
    assert set(renamed) == set(_defs(JAX / module)), \
        f"{module}: every public name must be RENAMED"
    wrappers = set(entries.values())
    assert wrappers <= set(renamed.values()), \
        f"{module}: a wrapper of its kernel is not the rename of any name"
