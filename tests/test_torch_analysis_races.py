"""The port's lock-discipline race detector (pinot_tpu_torch.analysis.races)
against the JAX package's, on the JAX tests' own fixtures, and the
retargeted W012 on torch fixtures.

Each test of tests/test_analysis_races.py runs with both packages'
passes over the same fixture package (tests/torch_analysis_parity.py);
W010 / W011 / W012 findings must be equal, rule, line and symbol.  One
fixture blocks with `block_until_ready`, which W012 names only in the JAX
package: there the port's findings equal the JAX ones less W012, and the
torch twins below hold the port's blockers."""
import textwrap

import pytest

from torch_analysis_parity import jax_test_ids, run_with_parity

from pinot_tpu_torch.analysis.engine import Project, run_passes
from pinot_tpu_torch.analysis.races import RacePass

JAX_TESTS = jax_test_ids("test_analysis_races.py")
# JAX fixtures whose blocker has no torch meaning (jax's block_until_ready)
JAX_ONLY_BLOCKERS = {"TestW012BlockingUnderLock::test_flags_device_sync_method_under_lock"}


@pytest.mark.parametrize("test_id", JAX_TESTS)
def test_same_findings_as_jax(test_id, request):
    drop = ("W012",) if test_id in JAX_ONLY_BLOCKERS else ()
    rec = run_with_parity("test_analysis_races", test_id, request, drop_rules=drop)
    assert rec.compared, f"{test_id} compared nothing"
    assert not rec.mismatches, "\n".join(rec.mismatches)


def _w012(body, imports="import threading\nimport torch\n"):
    src = imports + textwrap.dedent(
        """
        class Holder:
            def __init__(self):
                self._lock = threading.Lock()
                self._out = None

            def publish(self, t, ev, stream, dev):
                with self._lock:
        """
    ) + textwrap.indent(textwrap.dedent(body), " " * 12)
    proj = Project.from_sources({"pkg/m.py": src})
    return [f for f in run_passes(proj, [RacePass()]) if f.rule == "W012"]


@pytest.mark.parametrize("body,blocker", [
    ("torch.cuda.synchronize()\nself._out = t\n", "torch.cuda.synchronize"),
    ("ev.synchronize()\nself._out = t\n", ".synchronize()"),
    ("stream.synchronize()\nself._out = t\n", ".synchronize()"),
    ("self._out = t.sum().item()\n", ".item()"),
    ("self._out = t.tolist()\n", ".tolist()"),
    ("self._out = t.cpu()\n", ".cpu()"),
    ("self._out = t.to(dev)\n", ".to()"),
    ("self._out = t.to(device=dev, non_blocking=True)\n", ".to()"),
    ("self._out = t.to('cuda:0')\n", ".to()"),
])
def test_torch_blocker_under_lock_is_flagged(body, blocker):
    found = _w012(body)
    assert len(found) == 1, found
    assert blocker in found[0].message and found[0].symbol == "Holder.publish"


@pytest.mark.parametrize("body", [
    "self._out = t.to(torch.int64)\n",  # a dtype cast, not a copy
    "self._out = t + 1\n",
    "self._out = t\n",
])
def test_torch_non_blocker_under_lock_is_clean(body):
    assert _w012(body) == []


def test_torch_blocker_reached_through_helper():
    src = """
    import threading
    import torch

    def drain():
        torch.cuda.synchronize()

    class Poller:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

        def wait_turn(self):
            with self._lock:
                self._n += 1
                drain()
    """
    found = [f for f in run_passes(Project.from_sources({"pkg/m.py": textwrap.dedent(src)}), [RacePass()])
             if f.rule == "W012"]
    assert len(found) == 1 and "drain" in found[0].message and "torch.cuda.synchronize" in found[0].message


def test_torch_blocker_hoisted_out_of_the_lock_is_clean():
    src = """
    import threading

    class Holder:
        def __init__(self):
            self._lock = threading.Lock()
            self._out = None

        def publish(self, t):
            host = t.cpu()
            with self._lock:
                self._out = host
    """
    assert run_passes(Project.from_sources({"pkg/m.py": textwrap.dedent(src)}), [RacePass()]) == []


def test_block_until_ready_is_no_port_blocker():
    found = _w012("self._out = t.block_until_ready()\n")
    assert found == []


def test_seam_lock_is_non_reentrant():
    src = """
    from pinot_tpu_torch.utils import threads

    class Reg:
        def __init__(self):
            self._lock = threads.Lock()
            self._n = 0

        def bump(self):
            with self._lock:
                self._helper()

        def _helper(self):
            with self._lock:
                self._n += 1

        def other(self):
            self._helper()
    """
    found = run_passes(Project.from_sources({"pkg/m.py": textwrap.dedent(src)}), [RacePass()])
    assert [f.rule for f in found] == ["W011"] and "self-deadlock" in found[0].message
