"""Nothing under gpubench imports JAX or the JAX package, by whole
top-level names; the reference imports nothing of the program."""

import ast

import pytest

from gpubench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "ray_tpu"}
FILES = sorted((REPO / "gpubench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((REPO / "gpubench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ray_tpu_torch" not in top_level_imports(path)
    assert ".drivers" not in path.read_text()


def test_the_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import jax.numpy as jnp\nfrom ray_tpu.train import x\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "ray_tpu"}
    good = tmp_path / "n.py"
    good.write_text("import ray_tpu_torch\nfrom ray_tpu_torch.models import llama\n")
    assert not top_level_imports(good) & FORBIDDEN
