"""Nothing under benchmark/ imports JAX or the JAX package; the reference
imports nothing of the port; nothing reads the JAX package's benchmark
files.  Top-level module names are compared whole (``fm3dgan_torch`` is
not ``fm3dgan``)."""

import ast
import os
import re

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fm3dgan"}
OLD_FILES = re.compile(r"BENCH_(r\d|TRAIN|CAMPAIGN|COMPONENTS)|BASELINE|MULTICHIP_|\bbench\.py|tools/bench_")


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_py_files(spec.BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_jax_imports(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_py_files(os.path.join(spec.BENCH_DIR, "reference"))),
                         ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_reference_imports_nothing_of_the_port(path):
    assert "fm3dgan_torch" not in set(top_level_imports(path))


def test_whole_name_comparison():
    assert "fm3dgan_torch" not in FORBIDDEN and "fm3dgan" in FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _py_files(spec.BENCH_DIR)
                                        if os.sep + "tests" + os.sep not in p),
                         ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_reads_no_old_benchmark_files(path):
    assert not OLD_FILES.search(open(path).read())


def test_run_refuses_jax_in_sys_modules(monkeypatch):
    import sys
    import types

    run = spec.load_module(os.path.join(spec.BENCH_DIR, "run.py"), "bench_run")
    monkeypatch.setitem(sys.modules, "fm3dgan_torch_fake", types.ModuleType("x"))
    assert "fm3dgan" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fm3dgan.ops", types.ModuleType("x"))
    assert run.forbidden_modules() == ["fm3dgan"]
