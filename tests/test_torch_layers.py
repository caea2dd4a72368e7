"""The port's layering, read with ``ast``: imports point down.

``ops/`` (the kernels' wrappers and the probe's tables) imports nothing of
``engine/`` or ``parallel/``; ``engine/`` (the engines and their resident
probe) imports nothing of ``parallel/``; ``parallel/query.py`` (the sharded
steps) imports nothing of ``engine/``.  Every import counts, at module level
or inside a function.
"""

import ast
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "kvmatch_tpu_torch"

#: (the importing files, the subpackages they may not import).
RULES = {
    "ops": (sorted((PORT / "ops").glob("*.py")), ("engine", "parallel")),
    "engine": (sorted((PORT / "engine").glob("*.py")), ("parallel",)),
    "parallel/query.py": ([PORT / "parallel" / "query.py"], ("engine",)),
}


def _imported(path: Path, root: Path = PORT) -> set:
    """Dotted names of the port's modules that ``path`` imports, relative to
    the package ``root`` (``ops.probe``, ``parallel``, ...)."""
    pkg = path.relative_to(root).parent.parts
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(pkg[:len(pkg) - node.level + 1])
                mod = base + (node.module.split(".") if node.module else [])
                names = [".".join(mod + [a.name]) for a in node.names]
            else:
                names = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            if name.startswith("kvmatch_tpu_torch."):
                name = name[len("kvmatch_tpu_torch."):]
            elif name.split(".")[0] in ("kvmatch_tpu_torch", "kvmatch_tpu"):
                continue
            out.add(name)
    return out


def _crossings(files, banned, root: Path = PORT) -> list:
    return [f"{p.relative_to(root)}: {name}" for p in files
            for name in sorted(_imported(p, root))
            if name.split(".")[0] in banned]


@pytest.mark.parametrize("layer", sorted(RULES))
def test_imports_point_down(layer):
    files, banned = RULES[layer]
    assert files
    bad = _crossings(files, banned)
    assert not bad, f"{layer} imports from {banned}: {bad}"


def test_the_reader_sees_each_form_of_import(tmp_path):
    """The reader resolves relative imports from the file's own package,
    absolute ones of the port, and imports inside functions."""
    root = tmp_path / "kvmatch_tpu_torch"
    sub = root / "ops"
    sub.mkdir(parents=True)
    f = sub / "x.py"
    f.write_text("from ..engine import probe\n"
                 "from . import sliding\n"
                 "import kvmatch_tpu_torch.parallel.query\n"
                 "def g():\n    from ..parallel.query import pack_segments\n")
    assert _imported(f, root) == {"engine.probe", "ops.sliding",
                                  "parallel.query",
                                  "parallel.query.pack_segments"}
    assert len(_crossings([f], ("engine", "parallel"), root)) == 3
