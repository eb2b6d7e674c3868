"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is not ``repro``); the references
import nothing of the program."""
import ast

import pytest

from bench import core

FILES = sorted(core.BENCH.rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(core.ROOT)))
def test_no_jax(path):
    bad = {m for m in imported(path) if m in core.FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((core.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    mods = set(imported(path))
    assert "repro_torch" not in mods and "bench" not in mods, mods


def test_the_check_compares_whole_names():
    assert core.forbidden_loaded(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert core.forbidden_loaded(["repro.core", "jax.numpy"]) == ["jax", "repro"]
