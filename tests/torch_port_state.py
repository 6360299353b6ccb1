"""Process-global state of the port that the cluster-tier parity tests
reset around each test, as tests/conftest.py resets the JAX package's:
the METRICS registry, the perf ledger, the autopilot knob registry, the
thread provider, the plan-cache compile audits, the batch audit, the
fused scan's launch counters, the kill-points (utils/crashpoints.py) and the
segment plan cache's host budget, which every Broker attaches to its
governor's ledger (query/planner.py attach_plan_cache_budget)."""
import pytest

from pinot_tpu_torch.analysis import compile_audit
from pinot_tpu_torch.cluster import autopilot
from pinot_tpu_torch.ops import fused_scan
from pinot_tpu_torch.query import executor, planner
from pinot_tpu_torch.utils import crashpoints
from pinot_tpu_torch.utils import threads
from pinot_tpu_torch.utils.metrics import METRICS
from pinot_tpu_torch.utils.perf import PERF_LEDGER


def _reset():
    METRICS.reset()
    PERF_LEDGER.reset()
    autopilot.reset_knobs()
    threads.reset_provider()
    compile_audit.reset_all()
    executor.BATCH_AUDIT.reset()
    fused_scan.reset_counters()
    crashpoints.reset()
    if planner._PLAN_CACHE.budget is not None:  # a Broker attached its ledger
        planner._PLAN_CACHE.clear()
        planner._PLAN_CACHE.budget = None


@pytest.fixture(autouse=True)
def port_state():
    _reset()
    yield
    _reset()
