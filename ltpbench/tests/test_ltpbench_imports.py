"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Top-level module
names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(HERE.rglob("*.py"))


def imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def top_level_imports(path: Path) -> set:
    return {m.split(".")[0] for m in imports(path)}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not top_level_imports(path) & (JAX | {"repro_torch"})
    assert not top_level_imports(path) - {"__future__", "bisect",
                                          "dataclasses", "math", "typing",
                                          "numpy", "torch", "ltpbench"}
    ours = {m for m in imports(path) if m.split(".")[0] == "ltpbench"}
    assert all(m.startswith("ltpbench.reference") for m in ours), ours


def test_the_check_compares_whole_names(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import repro_torch.models\nfrom repro_torch import x\n")
    assert top_level_imports(path) == {"repro_torch"}
    assert not top_level_imports(path) & JAX
    path.write_text("import repro.core\n")
    assert top_level_imports(path) & JAX
