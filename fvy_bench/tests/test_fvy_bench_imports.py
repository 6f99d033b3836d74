"""No module of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the port (top-level names compared whole: the
port's name begins with the JAX package's)."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "face_vijnana_yolov3_tpu"}
PORT = "face_vijnana_yolov3_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)


def test_a_run_that_loaded_jax_is_caught(monkeypatch):
    """run.py's look at sys.modules after the window, by whole top-level
    names: the port's own name does not count."""
    import types

    from fvy_bench import run

    monkeypatch.setattr(sys, "modules", {PORT: types.ModuleType(PORT),
                                         f"{PORT}.ops": types.ModuleType(f"{PORT}.ops")})
    assert run.forbidden_modules() == []
    sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
    assert run.forbidden_modules() == ["jax"]
