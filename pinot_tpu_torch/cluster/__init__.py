"""Cluster layer: coordinator (controller), servers, broker routing.

Port of pinot_tpu/cluster/ (SURVEY.md §2.3, L6), with the same names:
  coordinator.py - the controller: table CRUD, replica-group segment
                   assignment, the versioned external view, rebalance,
                   retention, liveness and the periodic tasks
  server.py      - ServerInstance: per-server segment ownership and local
                   execution (one fused-scan launch a segment on the card;
                   execute_batch's member-axis launch for coalesced queries)
  broker.py      - routing (balanced / replica-group / adaptive selectors),
                   partition and time pruning, failover scatter-gather,
                   hedging, the result cache, the micro-batch tier, set ops,
                   IN (SELECT ...) and EXPLAIN, and the reduce
  journal.py, deepstore.py, election.py, rebalance.py - the durable and
                   highly available control plane: an fsync'd metadata
                   journal with compacted snapshots, the CRC-verified segment
                   deep store, lease election with fenced epochs and a hot
                   standby, and load-before-drop rebalance
  admission.py, autopilot.py, batcher.py, faults.py - budgets and
                   admission, the knob registry and SLO controller, the
                   micro-batcher and the scripted fault plan

Everything but the servers is host Python: the coordinator and the broker
touch the card only through ServerInstance, and carry no device of their
own.  ``ServerInstance(name)`` means CUDA and raises without it;
``ServerInstance(name, device="cpu")`` runs the plain PyTorch path.  The
journal and the deep store keep the JAX package's on-disk formats.
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
from pinot_tpu_torch.cluster.coordinator import Coordinator
from pinot_tpu_torch.cluster.server import ServerInstance
from pinot_tpu_torch.cluster.broker import (
    Broker,
    HedgeController,
    NoReplicaAvailableError,
    ScatterGatherError,
    ServerHealth,
)
from pinot_tpu_torch.cluster.deepstore import SegmentDeepStore
from pinot_tpu_torch.cluster.election import (
    CoordinatorHandle,
    FencedEpochError,
    JournalFollower,
    LeaseManager,
    NotLeaderError,
)
from pinot_tpu_torch.cluster.faults import FaultPlan, ServerFaultError
from pinot_tpu_torch.cluster.journal import MetaJournal
from pinot_tpu_torch.cluster.rebalance import TableRebalancer
from pinot_tpu_torch.utils.crashpoints import InjectedCrash

__all__ = [
    "Coordinator",
    "ServerInstance",
    "Broker",
    "HedgeController",
    "ServerHealth",
    "MicroBatcher",
    "FaultPlan",
    "ServerFaultError",
    "InjectedCrash",
    "CoordinatorHandle",
    "FencedEpochError",
    "JournalFollower",
    "LeaseManager",
    "NotLeaderError",
    "MetaJournal",
    "SegmentDeepStore",
    "TableRebalancer",
    "NoReplicaAvailableError",
    "ScatterGatherError",
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
