"""Nothing the benchmark runs imports JAX, the JAX package or the top-level
bench.py (top-level module names compared whole), and the reference
imports nothing of the program."""

import ast

import pytest

from conftest import BENCH

BANNED = {"jax", "jaxlib", "flax", "avrecode_tpu", "bench"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not set(_imports(path)) & BANNED


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert "avrecode_tpu_torch" not in set(_imports(path))


def test_top_level_names_are_compared_whole():
    from benchmark.harness import drive
    assert "avrecode_tpu_torch" not in drive.BANNED
    assert "avrecode_tpu" in drive.BANNED
