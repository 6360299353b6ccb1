"""EXPLAIN ANALYZE: join the static operator tree with measured execution.

Reference parity: Pinot 1.1's `EXPLAIN ANALYZE` (multi-stage) returns the
operator tree annotated with actual stats instead of the planned shape.
Re-design: the query executes normally with tracing forced; the static
EXPLAIN rows (engine._explain) join against the finished span tree by
stage, and the full span tree is appended below the operator rows so
per-server / per-launch timing is visible in the same table.

Copy of pinot_tpu/query/analyze.py (host-only; the same ANALYZE_COLUMNS).
The Bytes and Flops of the port's rows are the analytic model's
(utils/perf.analytic_cost, costSource "analytic" on each launch span), and
Roofline_Pct is those bytes over the device_wait fence's ms against the
card's HBM peak.

Stage attribution is approximate by construction — the engine pipelines
launches, so "AGGREGATE time" is the sum of its launch/dispatch spans, not
an exclusive wall-clock slice.  The TRACE rows underneath are the ground
truth; the operator-row ms are the navigation aid.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.query.result import ResultTable

ANALYZE_COLUMNS = [
    "Operator",
    "Operator_Id",
    "Parent_Id",
    "Actual_Ms",
    "Rows",
    # kernel cost accounting (utils/perf.py): cost-model bytes/flops the
    # stage's kernels streamed, and achieved-vs-peak HBM roofline %
    "Bytes",
    "Flops",
    "Roofline_Pct",
]

# span names carrying per-kernel cost attrs (SSE/server `launch:*` spans,
# the dist engine's `launches` section) and the fence spans carrying the
# measured roofline — the two sets never double-count inside one trace
_SCAN_COST_SPANS = ("launch", "launches")
_ROOFLINE_SPANS = ("device_wait", "launches")

# operator-name prefix -> trace span names whose ms sum to that stage
# (a span matches a candidate by exact name or "<candidate>:" prefix)
_STAGE_SPANS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("BROKER_REDUCE", ("reduce",)),
    ("COMBINE", ("collect", "device_wait", "sparse_merge", "scatter", "realtime")),
    ("AGGREGATE", ("launch", "dispatch", "run", "launches")),
    ("GROUP_BY", ("launch", "dispatch", "run", "launches")),
    ("SELECT", ("launch", "dispatch", "run", "launches")),
    ("PROJECT", ()),
    ("FILTER", ()),
)


def _span_ms_index(trace: Optional[Dict[str, Any]]) -> Dict[str, float]:
    """Total ms per span name over the whole tree (grafted subtrees
    included); names like 'launch:seg_3' also accumulate under 'launch'."""
    out: Dict[str, float] = {}

    def walk(node: Optional[Dict[str, Any]]) -> None:
        if not node:
            return
        name = node.get("name", "")
        ms = float(node.get("ms", 0.0))
        out[name] = out.get(name, 0.0) + ms
        base = name.split(":", 1)[0]
        if base != name:
            out[base] = out.get(base, 0.0) + ms
        for c in node.get("children", ()):
            walk(c)

    walk(trace)
    return out


def _stage_ms(op_name: str, index: Dict[str, float]) -> Optional[float]:
    for prefix, candidates in _STAGE_SPANS:
        if not op_name.startswith(prefix):
            continue
        vals = [index[c] for c in candidates if c in index]
        return round(sum(vals), 3) if vals else None
    return None


def _stage_rows(op_name: str, executed: ResultTable) -> Optional[int]:
    s = executed.stats
    if op_name.startswith("BROKER_REDUCE") or op_name.startswith("SELECT"):
        return len(executed.rows)
    if op_name.startswith(("COMBINE", "AGGREGATE", "GROUP_BY")):
        return s.num_groups if s.num_groups else len(executed.rows)
    if op_name.startswith(("PROJECT", "FILTER")):
        return s.num_docs_scanned
    return None


def _attr_summary(attrs: Dict[str, Any]) -> str:
    parts = [f"{k}={v}" for k, v in attrs.items() if not isinstance(v, (dict, list))]
    return ", ".join(parts)


def _span_cost_index(
    trace: Optional[Dict[str, Any]],
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float]]:
    """Per-span-base-name sums of the kernelBytes/kernelFlops attrs and the
    max rooflinePct seen — the cost twin of _span_ms_index."""
    bytes_by: Dict[str, float] = {}
    flops_by: Dict[str, float] = {}
    roof_by: Dict[str, float] = {}

    def walk(node: Optional[Dict[str, Any]]) -> None:
        if not node:
            return
        attrs = node.get("attrs", {})
        base = node.get("name", "").split(":", 1)[0]
        for key, acc in (("kernelBytes", bytes_by), ("kernelFlops", flops_by)):
            v = attrs.get(key)
            if isinstance(v, (int, float)):
                acc[base] = acc.get(base, 0.0) + float(v)
        roof = attrs.get("rooflinePct")
        if isinstance(roof, (int, float)):
            roof_by[base] = max(roof_by.get(base, 0.0), float(roof))
        for c in node.get("children", ()):
            walk(c)

    walk(trace)
    return bytes_by, flops_by, roof_by


def _stage_cost(
    op_name: str,
    executed: ResultTable,
    bytes_by: Dict[str, float],
    flops_by: Dict[str, float],
    roof_by: Dict[str, float],
) -> Tuple[Optional[float], Optional[float], Optional[float]]:
    """(Bytes, Flops, Roofline_Pct) for one operator row: the scan stage
    carries its launch-span cost sums + the fence-measured roofline; the
    root BROKER_REDUCE row carries the query totals from ExecutionStats."""
    s = executed.stats
    if op_name.startswith("BROKER_REDUCE"):
        roof = None
        if s.kernel_bytes and s.device_ms:
            from pinot_tpu_torch.utils.perf import roofline_pct

            r = roofline_pct(s.kernel_bytes, s.device_ms / 1000.0)
            roof = round(r, 2) if r is not None else None
        return (s.kernel_bytes or None, s.kernel_flops or None, roof)
    if op_name.startswith(("AGGREGATE", "GROUP_BY", "SELECT", "COMBINE")):
        b = sum(bytes_by.get(c, 0.0) for c in _SCAN_COST_SPANS)
        f = sum(flops_by.get(c, 0.0) for c in _SCAN_COST_SPANS)
        roofs = [roof_by[c] for c in _ROOFLINE_SPANS if c in roof_by]
        if op_name.startswith("COMBINE"):
            # the combine row owns the fence: show where the device time
            # went (roofline) without re-counting the scan's bytes
            return (None, None, round(max(roofs), 2) if roofs else None)
        return (b or None, f or None, round(max(roofs), 2) if roofs else None)
    return (None, None, None)


def analyze_result(static: ResultTable, executed: ResultTable) -> ResultTable:
    """Static EXPLAIN rows + Actual_Ms/Rows + per-operator kernel cost
    (Bytes/Flops/Roofline_Pct), followed by the measured span tree as
    TRACE(...) rows parented under the operator root."""
    index = _span_ms_index(executed.stats.trace)
    cost_idx = _span_cost_index(executed.stats.trace)
    rows: List[tuple] = []
    for op_name, oid, parent in static.rows:
        b, f, r = _stage_cost(op_name, executed, *cost_idx)
        rows.append(
            (op_name, oid, parent, _stage_ms(op_name, index), _stage_rows(op_name, executed), b, f, r)
        )
    next_id = max((r[1] for r in static.rows), default=0) + 1

    def add_span(node: Dict[str, Any], parent_id: int) -> None:
        nonlocal next_id
        oid = next_id
        next_id += 1
        attrs = node.get("attrs", {})
        label = f"TRACE({node.get('name', '?')})"
        summary = _attr_summary(attrs)
        if summary:
            label += f" [{summary}]"
        docs = attrs.get("docs", attrs.get("docsScanned"))
        rows.append(
            (
                label,
                oid,
                parent_id,
                round(float(node.get("ms", 0.0)), 3),
                docs,
                attrs.get("kernelBytes"),
                attrs.get("kernelFlops"),
                attrs.get("rooflinePct"),
            )
        )
        for c in node.get("children", ()):
            add_span(c, oid)

    if executed.stats.trace:
        add_span(executed.stats.trace, 0)
    return ResultTable(columns=list(ANALYZE_COLUMNS), rows=rows, stats=executed.stats)
