"""Cluster layer, as far as the port has it: the server and what runs
under it.

Port of pinot_tpu/cluster/ in part: `server.py` (ServerInstance with
execute / execute_batch, crash / boot / restore_segment), `admission.py`
(budgets, admission, the watchdog, degradation, the governor),
`autopilot.py` (the knob registry and the SLO controller), `batcher.py`
(the micro-batcher) and `faults.py` (the fault plan).  The coordinator,
the broker, the journal, the deep store, election and rebalance are later
slices of the port (ROADMAP.md).
"""
from pinot_tpu_torch.cluster.admission import (
    AdmissionController,
    QueryCost,
    QueryKilledError,
    QueryWatchdog,
    ReservationError,
    ResourceBudget,
    ResourceGovernor,
    TooManyRequestsError,
    estimate_query_cost,
)
from pinot_tpu_torch.cluster.batcher import MicroBatcher
from pinot_tpu_torch.cluster.faults import FaultPlan, ServerFaultError
from pinot_tpu_torch.cluster.server import ServerInstance
from pinot_tpu_torch.utils.crashpoints import InjectedCrash

__all__ = [
    "ServerInstance",
    "MicroBatcher",
    "FaultPlan",
    "ServerFaultError",
    "InjectedCrash",
    "AdmissionController",
    "QueryCost",
    "QueryKilledError",
    "QueryWatchdog",
    "ReservationError",
    "ResourceBudget",
    "ResourceGovernor",
    "TooManyRequestsError",
    "estimate_query_cost",
]
