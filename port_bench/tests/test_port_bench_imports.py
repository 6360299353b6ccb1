"""No file of port_bench/ imports JAX or the JAX package (top-level
module names compared whole: pinot_tpu_torch is not pinot_tpu), and the
reference and the generator import nothing of the program."""
import ast

import pytest

from _tiny import REPO

BENCH = REPO / "port_bench"
FILES = sorted(BENCH.rglob("*.py"))
PLAIN = sorted((BENCH / "reference").rglob("*.py")) + [BENCH / "harness" / "ssbgen.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _top(module: str) -> str:
    return module.split(".")[0]


def test_top_level_names_compared_whole():
    assert _top("pinot_tpu_torch.cluster.broker") == "pinot_tpu_torch" != "pinot_tpu"
    assert _top("jax.numpy") == "jax"


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_or_jax_package(path):
    bad = [m for m in _imports(path) if _top(m) in ("jax", "jaxlib", "flax", "pinot_tpu")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", PLAIN, ids=[str(p.relative_to(BENCH)) for p in PLAIN])
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "functools", "math", "typing", "dataclasses", "numpy", "port_bench"}
    mods = list(_imports(path))
    assert all(_top(m) in allowed for m in mods), mods
    assert all(m in ("port_bench.harness", "port_bench.harness.ssbgen") for m in mods if _top(m) == "port_bench")


def test_scan_sees_the_files():
    assert BENCH / "run.py" in FILES and BENCH / "reference" / "ssb_numpy.py" in PLAIN
