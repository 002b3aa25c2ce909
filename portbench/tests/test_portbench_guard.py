"""The import guard: no module of the benchmark imports JAX, Flax or the
JAX package, and no reference imports the program.  Compared by the whole
top-level name, since the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest
from _tiny import REPO

BENCH = REPO / "portbench"
NEVER = {"jax", "jaxlib", "flax", "spgemm_tpu"}
REFERENCE_NEVER = NEVER | {"spgemm_tpu_torch"}


def imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def _files(root: Path) -> list[Path]:
    return sorted(root.rglob("*.py"))


@pytest.mark.parametrize("path", _files(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imports(path) & NEVER


@pytest.mark.parametrize("path", _files(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_reference_imports_the_program(path):
    assert not imports(path) & REFERENCE_NEVER


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import spgemm_tpu_torch.chain\nfrom spgemm_tpu.ops import x\nimport jaxlib\n")
    assert imports(f) == {"spgemm_tpu_torch", "spgemm_tpu", "jaxlib"}
    assert imports(f) & NEVER == {"spgemm_tpu", "jaxlib"}


def test_the_runs_own_check_compares_whole_names(monkeypatch):
    import sys
    import types

    from portbench import harness
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spgemm_tpu_torch_extra", types.ModuleType("x"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("y"))
    assert "flax.core" in harness.forbidden_modules()
