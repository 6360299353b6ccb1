"""The port's interprocedural engine (pinot_tpu_torch.analysis.engine and
callgraph) against the JAX package's, on the JAX tests' own fixtures.

Each test of tests/test_analysis_engine.py runs with its analysis names
swapped for shims (tests/torch_analysis_parity.py): the project model,
call resolution, the call graph, inline suppressions, the baseline and
the finding format are computed by both packages from the same sources
and must be equal.  Then the port-only facts: the default tree, the
baseline path and the relative paths."""
import os

import pytest

from torch_analysis_parity import run_with_parity, jax_test_ids

import pinot_tpu_torch
from pinot_tpu_torch.analysis import engine as port_engine

JAX_TESTS = jax_test_ids("test_analysis_engine.py")


@pytest.mark.parametrize("test_id", JAX_TESTS)
def test_same_model_and_findings_as_jax(test_id, request):
    rec = run_with_parity("test_analysis_engine", test_id, request)
    assert rec.compared, f"{test_id} compared nothing"
    assert not rec.mismatches, "\n".join(rec.mismatches)


def test_defaults_aim_at_the_port_tree():
    root = os.path.dirname(os.path.abspath(pinot_tpu_torch.__file__))
    proj = port_engine.Project.from_tree()
    assert "pinot_tpu_torch.analysis.engine" in proj.modules
    assert all(mi.relpath.startswith("pinot_tpu_torch/") for mi in proj.modules.values())
    assert not any(name.startswith("pinot_tpu.") for name in proj.modules)
    assert port_engine.BASELINE_PATH == os.path.join(root, "analysis", "baseline.json")
    entries = port_engine.load_baseline()
    assert entries and all(e["path"].startswith("pinot_tpu_torch/") and e.get("justification") for e in entries)


def test_seam_import_marks_a_module_threaded():
    proj = port_engine.Project.from_sources({
        "pkg/a.py": "from pinot_tpu_torch.utils import threads\n",
        "pkg/b.py": "import json\n",
    })
    assert proj.modules["pkg.a"].threaded and not proj.modules["pkg.b"].threaded
