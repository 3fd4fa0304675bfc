"""Nothing the benchmark runs imports JAX or the JAX package: the reference
imports nothing of the program either, and the run's check compares
top-level module names whole."""

import ast
import os

import pytest

from bench_port import harness as H

PKG = H.PKG


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def sources(folder):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_reference_imports_neither_jax_nor_the_program():
    for path in sources(os.path.join(PKG, "reference")):
        bad = imported_roots(path) & {"jax", "jaxlib", "flax", "desr_tpu", "desr_tpu_torch"}
        assert not bad, (path, bad)


def test_no_file_of_the_benchmark_imports_jax():
    for path in sources(PKG):
        assert not imported_roots(path) & {"jax", "jaxlib", "flax", "desr_tpu"}, path


@pytest.mark.parametrize("name,found", [
    ("desr_tpu_torch", False), ("desr_tpu_torch.models.main_model", False),
    ("desr_tpu", True), ("desr_tpu.models", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True), ("jaxtyping", False),
    ("desr_tpu_extra", False)])
def test_the_run_check_compares_top_level_names_whole(name, found):
    assert bool(H.forbidden_modules({name: None})) is found
