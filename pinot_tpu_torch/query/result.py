"""Result containers flowing segment -> reduce -> client.

Trimmed copy of pinot_tpu/query/result.py: the aggregation, group-by and
selection results of single-table SQL, and ExecutionStats with the analytic
cost model's kernel bytes and flops (utils/perf.py, source "analytic") in
place of the TPU cost model (the device-time metrics of the port come from
chip runs), the trace span tree of a query run with trace=true, and the
broker's scatter-gather surface (servers queried and responded, partial
results and their exceptions, hedging and brownout events).  Results are
columnar numpy end to end.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ExecutionStats:
    """Per-query execution statistics (BrokerResponse stats analog)."""

    num_segments_queried: int = 0
    num_segments_pruned: int = 0
    num_segments_processed: int = 0
    num_docs_scanned: int = 0
    total_docs: int = 0
    num_groups: int = 0
    time_ms: float = 0.0
    # distributed engine: host ms of planning on a plan-cache miss (the
    # port's counterpart of the JAX package's trace + compile), and wall ms
    # of the launch loop (launches through the last drain); segment engine
    # with trace=true: device_ms is the device_wait fence's wall ms
    compile_ms: float = 0.0
    device_ms: float = 0.0
    # bytes the scans stream under the packed-storage model
    # (perf.analytic_bytes_per_row x rows scanned, summed over launches),
    # the analytic flops, and where the model came from ("analytic")
    kernel_bytes: float = 0.0
    kernel_flops: float = 0.0
    kernel_cost_source: Optional[str] = None
    # (column, "sorted"|"range"|"inverted") per index-accelerated predicate
    filter_index_uses: Tuple = ()
    # selection: bytes of matched doc ids copied from the device
    bytes_to_host: int = 0
    query_id: Optional[str] = None
    # span tree dict when the query ran with trace=true (utils/metrics.Trace)
    trace: Optional[dict] = None
    # scatter-gather fault surface (BrokerResponse partialResult /
    # processingExceptions / numServersQueried|Responded analog): a query
    # that lost segments but was allowed to degrade carries
    # partial_result=True plus one exception entry per absorbed failure
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    partial_result: bool = False
    exceptions: List[Dict[str, Any]] = field(default_factory=list)
    # tail-tolerance surface (hedged scatter + brownout router): how many
    # scatter calls hedged a backup, which server won the last hedged call,
    # how long the cancelled loser ran (best-effort: the loser thread stamps
    # it when its cooperative kill lands), and any brownout transitions
    # ("enter:server" / "exit:server") observed this query
    hedged: int = 0
    hedge_winner: Optional[str] = None
    hedge_cancelled_ms: float = 0.0
    brownout_events: List[str] = field(default_factory=list)

    def add_kernel_cost(self, other: "ExecutionStats") -> None:
        """Accumulate the kernel-cost slice of `other` (one launch's stats)."""
        from pinot_tpu_torch.utils.perf import combine_sources

        self.kernel_bytes += other.kernel_bytes
        self.kernel_flops += other.kernel_flops
        self.compile_ms += other.compile_ms
        self.device_ms += other.device_ms
        self.kernel_cost_source = combine_sources(self.kernel_cost_source, other.kernel_cost_source)

    def add_index_uses(self, uses: Tuple) -> None:
        """Order-preserving dedup-union into filter_index_uses."""
        if uses:
            self.filter_index_uses = tuple(dict.fromkeys(self.filter_index_uses + tuple(uses)))


@dataclass
class AggSegmentResult:
    """Scalar aggregation partials: one Partial (dict of np scalars) per agg."""

    partials: List[Dict[str, np.ndarray]]


@dataclass
class DenseGroupData:
    """Full dense group table straight from the device (before presence
    filtering) — kept so segments sharing a key space merge by array
    addition."""

    presence: np.ndarray  # int64[num_groups]
    partials: List[Dict[str, np.ndarray]]  # field arrays [num_groups]
    key_space: Tuple  # hashable id of the decode tables (see reduce.py)
    group_dims: List[Any] = field(default_factory=list)  # planner.GroupDim (decode)


@dataclass
class GroupBySegmentResult:
    """Columnar group-by partials: one decoded key array per dimension,
    partials[i][field] aligned with the keys."""

    keys: List[np.ndarray]
    partials: List[Dict[str, np.ndarray]]
    dense: Optional[DenseGroupData] = None


@dataclass
class SelectionSegmentResult:
    columns: List[str]  # gathered columns (select + order-by + window inputs)
    arrays: Dict[str, np.ndarray]


@dataclass
class ResultTable:
    """Final client-facing result (BrokerResponse resultTable analog)."""

    columns: List[str]
    rows: List[tuple]
    stats: ExecutionStats = field(default_factory=ExecutionStats)
