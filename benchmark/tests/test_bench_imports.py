"""No file the benchmark runs imports the JAX stack or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain references import nothing of the program."""

import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "bigdl_tpu", "bigdl"}
PROGRAM = {"bigdl_tpu_torch", "bigdl_torch"}


def _sources(sub=""):
    top = os.path.join(harness.BENCH, sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_anywhere_the_benchmark_runs(path):
    bad = set(_top_names(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_references_import_nothing_of_the_program(path):
    names = set(_top_names(path))
    assert not names & (PROGRAM | FORBIDDEN), f"{path} imports {names}"
    # nor the benchmark's files that reach the program
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith(("benchmark.models",
                                               "benchmark.drivers",
                                               "benchmark.harness"))


def test_the_name_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "bigdl_tpu_torch_like",
                        types.ModuleType("bigdl_tpu_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
