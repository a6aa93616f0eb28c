"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Import names are compared by
their whole top-level name (the part before the first dot): the port's
name begins with the JAX package's."""
import ast
import os

import pytest

from lassbench.harness import PKG

JAX = {"jax", "jaxlib", "flax", "orbax", "lass_tpu"}


def _sources(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(PKG)),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize(
    "path", sorted(_sources(os.path.join(PKG, "reference"))),
    ids=lambda p: os.path.relpath(p, PKG))
def test_reference_is_plain(path):
    found = set(_imports(path))
    assert "lass_torch" not in found and not found & JAX


def test_the_check_is_by_whole_names():
    import sys

    from lassbench.harness import forbidden_loaded

    sys.modules.setdefault("lass_tpu_like_but_not", sys)
    try:
        assert "lass_tpu" not in forbidden_loaded()
    finally:
        del sys.modules["lass_tpu_like_but_not"]
