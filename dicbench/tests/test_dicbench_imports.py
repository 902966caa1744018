"""The harness imports neither JAX nor the JAX package, compared by whole
top-level module names, and its reference nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "correlation_tpu"}


def _top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not _top_names(path) & (FORBIDDEN | {"correlation_tpu_torch"})


def test_names_compared_whole():
    from dicbench.harness import FORBIDDEN as NAMES

    assert "correlation_tpu_torch".split(".")[0] not in NAMES
    assert {"jax", "jaxlib", "flax", "correlation_tpu"} == set(NAMES)


def test_reads_nothing_of_the_jax_benchmarks():
    for path in SOURCES:
        text = path.read_text()
        if path.name == "test_dicbench_imports.py":
            continue
        for word in ("bench.py", "benchmarks/", "BENCH_"):
            assert word not in text, (path, word)
