"""The port stands alone: no file of ray_tpu_torch, nor chip_smoke.py,
imports JAX (or its libraries) or anything of the JAX package ray_tpu.

A static check over the source (ast): every process here preloads jax, so
a sys.modules check could not tell."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}
FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield node.lineno, "." * node.level + (node.module or "")
            else:
                yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name) and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.lineno, node.args[0].value


def test_the_port_has_files_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "ray_tpu_torch/serve/llm.py" in names and "ray_tpu_torch/_kernels.py" in names
    assert "ray_tpu_torch/models/vit.py" in names
    assert "ray_tpu_torch/parallel/mesh.py" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.startswith(".") or mod.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_checker_catches_banned_imports():
    src = ("import jax.numpy as jnp\nfrom ray_tpu.ops import rope\n"
           "def f():\n    import optax\n    return __import__('flax')\n"
           "from ray_tpu_torch.ops import rope as ok\n")
    found = {mod for _, mod in _imported_modules(ast.parse(src))}
    assert {"jax.numpy", "ray_tpu.ops", "optax", "flax"} <= found
    assert [m for m in found if m.split(".")[0] in BANNED] and "ray_tpu_torch.ops" in found
