"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program (whole top-level names)."""

import ast
import os

import pytest

from perfbench.tests.tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "raven_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"raven_tpu_torch"})


def test_whole_names():
    assert "raven_tpu_torch" not in FORBIDDEN and "raven_tpu_torch".split(".")[0] != "raven_tpu"
