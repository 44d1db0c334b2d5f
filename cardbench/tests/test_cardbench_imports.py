"""No module of the benchmark imports JAX or the JAX package (``repro``),
comparing whole top-level names; the reference imports nothing of the
program (``repro_torch``) either."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    for dirpath, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_walk_finds_the_harness():
    names = {os.path.relpath(p, HERE) for p in modules()}
    assert {"run.py", "harness.py", "reference.py"} <= names


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_or_jax_package(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(HERE, "reference.py")
    found = set(top_level_imports(path))
    assert not found & (FORBIDDEN | {"repro_torch"})
    # and nothing of the benchmark that might reach the program
    assert found <= {"__future__", "warnings", "numpy", "torch"}


def test_the_prefix_is_not_the_name():
    # repro_torch begins with repro, but its top-level name is its own
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_run_refuses_a_process_holding_jax(monkeypatch):
    import sys
    import types
    from cardbench import run
    # a test process may hold JAX already: compare against what it holds
    held = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("y"))
    assert set(run.forbidden_modules()) == held
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert set(run.forbidden_modules()) == held | {"repro"}
