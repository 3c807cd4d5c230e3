"""No module of the benchmark imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "ray_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ray_tpu_torch" not in set(_imports(path))
