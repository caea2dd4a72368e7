"""The command line of the PyTorch port (``kvmatch_tpu_torch.cli``) against
the JAX package's (``kvmatch_tpu.cli``) on the same files.

``generate-data`` and ``export-queries`` write byte-identical files,
``build-index`` equal indexes (npz arrays, and the reference file layout
byte for byte), ``query`` the same answer lines for all eight engines
(the four engines and their scalar twins) and ``oracle`` the same lines;
``workload`` finds the same queries and misses none.  Every port command
runs with ``--device cpu``; without it, on a machine without a card, the
command exits with an error.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kvmatch_tpu import cli as jcli
from kvmatch_tpu_torch import cli
from test_torch_host_parity import jax_native_lib

torch.set_num_threads(2)

N = 20_000
CPU = ["--device", "cpu"]


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([str(a) for a in argv]) == 0
    return buf.getvalue().splitlines()


def answers(lines):
    """{offset: distance} of the answer lines, and the Best line's offset."""
    out, best = {}, None
    for line in lines:
        if line.startswith("Best: "):
            best = int(line.split()[1].rstrip(","))
        head, sep, tail = line.partition(",")
        if sep and head.isdigit():
            out[int(head)] = float(tail)
    return out, best


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    jax_native_lib("get_baseline_lib", "_BASE_TRIED")  # the JAX twins
    d = tmp_path_factory.mktemp("cli")
    run(cli.main, ["generate-data", N, "--seed", 5, "--out", d / "data"])
    run(jcli.main, ["generate-data", N, "--seed", 5, "--out", d / "jdata"])
    run(cli.main, ["build-index", d / "data", "--out", d / "t.npz", *CPU])
    run(jcli.main, ["build-index", d / "data", "--out", d / "j.npz"])
    return d


def test_generate_data_byte_identical(files):
    assert (files / "data").read_bytes() == (files / "jdata").read_bytes()
    assert (files / "data").stat().st_size == 8 * N


@pytest.mark.parametrize("backend", ["device", "host"])
def test_build_index_equals_jax(files, backend):
    """The device bucket pass and the host build both give the JAX CLI's
    index; its reference-layout files are byte-identical."""
    d = files
    out = d / f"{backend}.npz"
    (line,) = run(cli.main, ["build-index", d / "data", "--out", out,
                             "--backend", backend, *CPU])
    assert line.startswith(f"built index for n={N}: ") and str(out) in line
    t, j = np.load(out), np.load(d / "j.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        np.testing.assert_array_equal(t[k], j[k])
    run(cli.main, ["build-index", d / "data", "--out", d / f"tf-{backend}",
                   "--fmt", "file", "--backend", backend, *CPU])
    run(jcli.main, ["build-index", d / "data", "--out", d / "jf", "--fmt",
                    "file", "--backend", "host"])
    mine = sorted((d / f"tf-{backend}").iterdir())
    assert [p.name for p in mine] == \
        sorted(p.name for p in (d / "jf").iterdir())
    for p in mine:
        assert p.read_bytes() == (d / "jf" / p.name).read_bytes()


QUERIES = {
    "rsm-ed": ["--offset", 5432, "--length", 512, "--epsilon", 6],
    "cnsm-ed": ["--offset", 7000, "--length", 512, "--epsilon", 3,
                "--alpha", 1.3, "--beta", 10],
    "rsm-dtw": ["--offset", 3000, "--length", 256, "--epsilon", 4,
                "--rho", 0.05],
    "cnsm-dtw": ["--offset", 7000, "--length", 256, "--epsilon", 3,
                 "--rho", 0.05, "--alpha", 1.3, "--beta", 10],
}


@pytest.mark.parametrize("engine", sorted(QUERIES) + sorted(
    f"twin-{e}" for e in QUERIES))
def test_query_lines_equal_jax(files, engine):
    """Same answer offsets, distances within the f32 confirm's reach of the
    JAX CLI's (the twins' and the ED engines' are float64 end to end and
    equal), the same best answer; --one-based shifts every offset by 1."""
    d = files
    args = QUERIES[engine.removeprefix("twin-")]
    common = ["query", d / "data", "--engine", engine, *args]
    got, best = answers(run(cli.main, [*common, "--index", d / "t.npz",
                                       *CPU]))
    want, jbest = answers(run(jcli.main, [*common, "--index", d / "j.npz"]))
    assert got.keys() == want.keys() and len(got) > 0
    assert best == jbest == args[1]
    for o in want:
        assert got[o] == pytest.approx(want[o], rel=1e-5, abs=1e-5)
    if engine.startswith("twin-"):
        assert got == want
    one, _ = answers(run(cli.main, [*common, "--one-based", *CPU]))
    assert sorted(one) == sorted(o + 1 for o in answers(run(
        cli.main, [*common[:4], "--offset", args[1] - 1, *args[2:],
                   *CPU]))[0])


@pytest.mark.parametrize("case", [
    ["ED", "RSM", 5433, 5433 + 511, 6],
    ["ED", "cNSM", 7001, 7512, 3, 1.3, 10],
    ["ED", "NSM", 7001, 7512, 3],
    ["DTW", "RSM", 3001, 3256, 4, "--rho", 12],
    ["DTW", "cNSM", 7001, 7256, 3, 1.3, 10],
])
def test_oracle_lines_equal_jax(files, case):
    measure, problem, *rest = case
    argv = ["oracle", measure, problem, files / "data", *rest]
    got, _ = answers(run(cli.main, [*argv, *CPU]))
    want, _ = answers(run(jcli.main, argv))
    assert got.keys() == want.keys() and case[2] in got
    for o in want:
        assert got[o] == pytest.approx(want[o], rel=1e-9, abs=1e-9)


def test_workload_misses_nothing(files, tmp_path):
    d = files
    argv = ["workload", d / "data", "--index", d / "t.npz", "--lengths", 128,
            256, "--epsilons", 2, 6, "--per-cell", 2, "--seed", 1]
    lines = run(cli.main, [*argv, "--save", tmp_path / "t.json", *CPU])
    jlines = run(jcli.main, [*argv[:3], d / "j.npz", *argv[4:], "--save",
                             tmp_path / "j.json"])
    assert lines[0] == jlines[0] and lines[0].startswith("workload: ")
    bins = [x for x in lines if x.startswith("bin ")]
    assert bins and all(x.endswith("missed=0") for x in bins)
    assert [x.split(" T=")[0] for x in bins] == \
        [x.split(" T=")[0] for x in jlines if x.startswith("bin ")]
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_export_queries_byte_identical(files):
    d = files
    argv = ["export-queries", d / "data", "--lengths", 64, 256, "--count", 3,
            "--seed", 2]
    (line,) = run(cli.main, [*argv, "--out", d / "tq"])
    run(jcli.main, [*argv, "--out", d / "jq"])
    assert line == f"exported 6 queries to {d / 'tq'}"
    mine = sorted((d / "tq").iterdir())
    assert [p.name for p in mine] == sorted(p.name for p in
                                            (d / "jq").iterdir())
    for p in mine:
        assert p.read_bytes() == (d / "jq" / p.name).read_bytes()


def test_cli_without_a_card_exits_with_an_error(files, monkeypatch, capsys):
    """The port runs on the card unless told otherwise: without one, a
    command that computes exits with an argparse error, not a fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["query", files / "data", "--offset", 1, "--length", 64,
                  "--epsilon", 1],
                 ["build-index", files / "data", "--out", files / "x.npz"],
                 ["oracle", "ED", "RSM", files / "data", 1, 64, 1.0]):
        with pytest.raises(SystemExit) as e:
            cli.main([str(a) for a in argv])
        assert e.value.code == 2
        assert "device='cpu'" in capsys.readouterr().err
    assert not (files / "x.npz").exists()


def test_query_counts_launches(files, capsys):
    """--count-launches prints the kernels' launch counts as one JSON line
    on stderr (all 0 on the CPU, where the plain versions run)."""
    import json
    run(cli.main, ["query", files / "data", "--index", files / "t.npz",
                   *QUERIES["rsm-ed"], "--count-launches", *CPU])
    counts = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(counts) == {"probe_flags", "window_ed", "dtw_diag",
                           "dtw_rows", "dtw_ds"}
    assert not any(counts.values())
