"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
top-level name (before the first dot) whole: the port's name begins with
the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_active_ai_tpu"}
PORT = "multimodal_active_ai_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert PORT not in names and not names & FORBIDDEN
    assert names <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}
    if "benchmark" in names:
        text = path.read_text()
        assert "from benchmark.reference" in text and "from benchmark import" not in text


def test_the_check_compares_whole_names():
    tree = {"multimodal_active_ai_tpu_torch.models"}
    assert {t.split(".")[0] for t in tree} & FORBIDDEN == set()
    assert {"multimodal_active_ai_tpu.ops".split(".")[0]} & FORBIDDEN
