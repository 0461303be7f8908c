"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: each import's top-level
name compared whole (the port's name begins with the JAX package's)."""
import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent
JAX_SIDE = {"jax", "jaxlib", "flax", "icra20_hand_object_pose_tpu"}
PORT = "icra20_hand_object_pose_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)


def test_whole_names_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "icra20_hand_object_pose_tpu_torch_fake", object())
    assert "icra20_hand_object_pose_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_modules()
