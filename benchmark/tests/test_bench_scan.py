"""What the benchmark may import: nothing under benchmark/ imports JAX or
the JAX package, and nothing under benchmark/reference/ imports the port.
Modules are compared by their top-level name, whole: the port's name
begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "pgtformer_tpu"}
PORT = "pgtformer_tpu_torch"


def imported_top_levels(path: Path):
    """Top-level names of every module `path` imports, statically or by
    importlib.import_module / __import__ with a constant name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if fname in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not imported_top_levels(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_port(path):
    assert PORT not in imported_top_levels(path)


def test_the_scan_sees_whole_names(tmp_path):
    """A prefix match would count the port as the JAX package; a whole-name
    match does not, and a dynamic import is seen."""
    f = tmp_path / "m.py"
    f.write_text("import pgtformer_tpu_torch.ops\nfrom pgtformer_tpu_torch import x\n")
    assert imported_top_levels(f) == {PORT}
    assert not imported_top_levels(f) & JAX_SIDE
    f.write_text("import importlib\nimportlib.import_module('pgtformer_tpu.models')\n"
                 "from jax import numpy\n")
    assert imported_top_levels(f) & JAX_SIDE == {"pgtformer_tpu", "jax"}


def test_runtime_check_compares_whole_names(monkeypatch):
    import sys
    import types
    import harness
    monkeypatch.setitem(sys.modules, "pgtformer_tpu_torch_like", types.ModuleType("x"))
    assert "pgtformer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pgtformer_tpu.models", types.ModuleType("y"))
    assert "pgtformer_tpu" in harness.forbidden_modules()
