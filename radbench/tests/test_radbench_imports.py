"""Nothing under radbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "rte_rrtmgp_nn_tpu"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "dataclasses", "typing", "numpy", "torch",
                                       "scipy"}


def test_whole_names_are_compared():
    # a prefix is not a match: the port's top-level name is allowed
    assert "rte_rrtmgp_nn_tpu_torch" not in FORBIDDEN
    assert top_level_imports(os.path.join(HERE, "entries", "rfmip.py")) & FORBIDDEN == set()
