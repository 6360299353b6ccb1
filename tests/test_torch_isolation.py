"""The port stands alone: no file of pinot_tpu_torch/, and none of
chip_smoke.py, funnel_ab.py, funnel_phases.py, gate_ab.py and member_phases.py, imports JAX or anything of
the JAX package pinot_tpu (an AST scan of every import statement)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("chip_smoke.py", "funnel_ab.py", "funnel_phases.py", "gate_ab.py", "member_phases.py")
FILES = sorted((ROOT / "pinot_tpu_torch").rglob("*.py")) + [ROOT / n for n in SCRIPTS]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "pinot_tpu")


def test_port_has_files():
    assert (ROOT / "pinot_tpu_torch" / "__init__.py").exists()
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
