"""The port's resource-lifecycle passes (pinot_tpu_torch.analysis.lifecycle,
W023 and W024) against the JAX package's, on the JAX tests' own
fixtures (tests/torch_analysis_parity.py runs each JAX test with both
packages' passes; findings must be equal, rule, line and symbol), and
the port's condition constructor."""
import textwrap

import pytest

from torch_analysis_parity import jax_test_ids, run_with_parity

from pinot_tpu_torch.analysis.engine import Project, run_passes
from pinot_tpu_torch.analysis.lifecycle import ConditionDisciplinePass

JAX_TESTS = jax_test_ids("test_analysis_lifecycle.py")


@pytest.mark.parametrize("test_id", JAX_TESTS)
def test_same_findings_as_jax(test_id, request):
    rec = run_with_parity("test_analysis_lifecycle", test_id, request)
    assert rec.compared, f"{test_id} compared nothing"
    assert not rec.mismatches, "\n".join(rec.mismatches)


@pytest.mark.parametrize("ctor,flagged", [
    ("from pinot_tpu_torch.utils import threads\n", True),
    ("from pinot_tpu.utils import threads\n", False),  # the JAX seam is not the port's
])
def test_port_seam_condition_is_covered(ctor, flagged):
    src = ctor + textwrap.dedent(
        """
        class Q:
            def __init__(self):
                self._cv = threads.Condition()

            def bump(self):
                self._cv.notify()
        """
    )
    found = run_passes(Project.from_sources({"pkg/m.py": src}), [ConditionDisciplinePass()])
    assert [f.rule for f in found] == (["W024"] if flagged else [])
