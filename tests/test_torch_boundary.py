"""The port stands alone: no file of ray_tpu_torch, nor chip_smoke.py,
imports JAX (or its libraries) or anything of the JAX package ray_tpu, or
names a module of ray_tpu in a string (a subprocess's ``-m`` argument, a
startup script), which would start the JAX package's code from the port.

A static check over the source (ast): every process here preloads jax, so
a sys.modules check could not tell."""

import ast
import re
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
    assert {"ray_tpu_torch/core/local_runtime.py", "ray_tpu_torch/train/trainer.py",
            "ray_tpu_torch/tune/tuner.py"} <= names
    assert {"ray_tpu_torch/serve/api.py", "ray_tpu_torch/serve/proxy.py",
            "ray_tpu_torch/rl/dqn.py", "ray_tpu_torch/rl/impala.py"} <= names
    assert {"ray_tpu_torch/data/dataset.py", "ray_tpu_torch/data/shuffle/coordinator.py",
            "ray_tpu_torch/bench_data_train.py"} <= names
    assert {"ray_tpu_torch/core/cluster_runtime.py", "ray_tpu_torch/core/node/agent.py",
            "ray_tpu_torch/core/gcs/server.py", "ray_tpu_torch/cluster.py"} <= names
    assert {f"ray_tpu_torch/{m}" for m in (
        "_version.py", "__main__.py", "job/__init__.py", "job/sdk.py", "scripts/__init__.py",
        "scripts/cli.py", "autoscaler/__init__.py", "autoscaler/node_provider.py",
        "autoscaler/autoscaler.py", "autoscaler/instance_manager.py", "autoscaler/launcher.py",
        "autoscaler/gce.py")} <= names


def test_the_rpc_dag_workflow_and_util_modules_are_checked():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"ray_tpu_torch/{m}" for m in (
        "serve/rpc_ingress.py", "util/state.py", "util/actor_pool.py", "util/queue.py",
        "util/multiprocessing.py", "util/joblib.py", "experimental/__init__.py",
        "experimental/channel.py", "experimental/broadcast.py", "dag/__init__.py",
        "dag/compiled.py", "workflow/__init__.py")} <= names


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


# ------------------------------------------- module names inside strings
DOTTED = re.compile(r"(?<![\w.])[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)+")


def _jax_package_module(name: str) -> bool:
    """Whether ``name`` (or a dotted prefix of it) is a module that exists
    under ray_tpu/: ``ray_tpu.core.gcs.server`` is, ``ray_tpu.io`` is not."""
    parts = name.split(".")
    if parts[0] != "ray_tpu":
        return False
    for n in range(2, len(parts) + 1):
        path = ROOT.joinpath(*parts[:n])
        if path.with_suffix(".py").is_file() or (path / "__init__.py").is_file():
            return True
    return False


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                yield body[0].value


def _module_names_in_strings(tree):
    skip = {id(c) for c in _docstrings(tree)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in skip):
            for name in DOTTED.findall(node.value):
                if _jax_package_module(name):
                    yield node.lineno, name


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_package_module_named_in_a_string(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = list(_module_names_in_strings(tree))
    assert not bad, f"{path.relative_to(ROOT)} names modules of ray_tpu in strings: {bad}"


def test_the_checker_catches_module_names_in_strings():
    src = ('"""Copy of ray_tpu.core.node.agent (a docstring: exempt)."""\n'
           'CMD = [sys.executable, "-m", "ray_tpu.core.node.agent"]\n'
           'def f(gcs):\n    """ray_tpu.scripts.cli, exempt too."""\n'
           '    return f"python -m ray_tpu.core.gcs.server --gcs {gcs}"\n'
           'OK = ["ray_tpu_torch.core.node.agent", "ray_tpu.io/slice", "ray_tpu.pyobj"]\n')
    found = [name for _, name in _module_names_in_strings(ast.parse(src))]
    assert found == ["ray_tpu.core.node.agent", "ray_tpu.core.gcs.server"]
