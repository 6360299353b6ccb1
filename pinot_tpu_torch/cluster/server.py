"""Server instance: owns segments, executes per-segment query work.

Reference parity: pinot-server ServerInstance (.../starter/ServerInstance.java
:69-177) + HelixInstanceDataManager / BaseTableDataManager — the process that
holds segment data and runs the single-stage executor over its local
segments when the broker scatters a query.

Port of pinot_tpu/cluster/server.py.  Segments stay the same
ImmutableSegment objects (in one process the "download from deep store" step
is a reference share / mmap re-open); execution reuses the segment
executor with its device tensor cache, so each logical server keeps its own
device-resident working set.  ``ServerInstance(name)`` serves on the card
(``device=None`` means CUDA and raises without it); ``device="cpu"`` runs
the plain PyTorch path.

Fault surface: the broker hands each scatter call a Deadline (its remaining
budget, optionally capped by serverTimeoutMs) — the launch/collect loop
checks it between kernels, and on expiry abandons still-pending launches
(cooperative cancellation: CUDA launches are queued on the stream, so
"cancel" means never collecting — no copy home, no host sync) before
raising QueryTimeoutError.  An attached cluster.faults.FaultPlan can
fail/delay the call or hide segments, driving the broker's failover paths
deterministically.

Tracing: a traced call's `device_wait` span is the wait on a CUDA event
recorded on the server's device after the last launch (the JAX package's
block_until_ready over every pending output); `stats.device_ms` is that
wait, and the span's `deviceMs` the device time from the first launch to
that event.  On the CPU the launches ran eagerly and nothing is waited for.
`restore_segment` fetches from the cluster's deep store
(cluster/deepstore.py: download, CRC check, load) when the coordinator
restarts or rebalances this server.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from pinot_tpu_torch.cluster.admission import QueryKilledError, ResourceBudget
from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.query import executor, planner
from pinot_tpu_torch.query.ir import QueryContext
from pinot_tpu_torch.query.result import ExecutionStats
from pinot_tpu_torch.query.safety import Deadline, QueryTimeoutError, estimate_segment_bytes
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.utils import perf
from pinot_tpu_torch.utils.metrics import METRICS, MetricsRegistry


def _staging_depth() -> int:
    """Scatter staging window: how many consecutive segments must be
    jointly resident while the scan pages through the device cache.  Routed
    through the autopilot KnobRegistry (PINOT_TPU_STAGING_DEPTH initial,
    default 2 = current segment + the one prefetching behind it)."""
    from pinot_tpu_torch.cluster import autopilot

    return max(1, int(autopilot.knobs().get("staging_depth")))


def _segment_bytes(segment: ImmutableSegment) -> int:
    """Host-array bytes of one segment (codes/values/null masks/MV lengths)
    — the per-table residency the segmentBytes gauge tracks."""
    total = 0
    for c in segment.columns.values():
        for arr in (c.codes, c.values, c.nulls, c.mv_lengths):
            if arr is not None:
                total += arr.nbytes
    return total


class ServerInstance:
    def __init__(
        self, name: str, device: DeviceLike = None, fault_plan=None, budget=None, data_dir=None,
        residency=None,
    ):
        self.name = name
        self.device = resolve_device(device)
        # table -> {segment name -> segment}
        self.segments: Dict[str, Dict[str, ImmutableSegment]] = {}
        # cluster.faults.FaultPlan hook (None in production)
        self.fault_plan = fault_plan
        # device-memory reservation ledger (cluster.admission.ResourceBudget): every
        # scatter call reserves its working-set estimate before launching so
        # concurrent queries can't jointly overcommit device memory.  None
        # disables tracking; the coordinator attaches one at registration.
        self.budget: Optional[ResourceBudget] = budget
        # tiered storage (segment/residency.py): when attached, device memory is a
        # byte-budgeted CACHE over the segments' host arrays — scatter
        # calls reserve only the pipeline window (not the full working
        # set), segment columns page through the residency budget with
        # cost-aware eviction, and the next segment's columns prefetch on
        # the staging thread while the current kernel runs.  None keeps
        # the legacy pin-everything path.  The coordinator attaches one
        # at registration (PINOT_TPU_HBM_CACHE_BYTES=0 disables).
        self.residency = residency
        # local segment cache dir for deep-store restores (tempdir fallback)
        self.data_dir = data_dir
        # process-death simulation: True between crash() and boot() — every
        # execute fails like a dead TCP peer until the coordinator restarts
        # and reconciles this server
        self.crashed = False
        # per-SERVER metric registry (ServerMetrics analog): the broker
        # federates these into one labeled cluster exposition
        # (utils.metrics.federate_prometheus) — the process-global METRICS
        # keeps its role as this process's aggregate view
        self.metrics = MetricsRegistry()

    # -- crash / restart (process-death simulation) -----------------------
    def crash(self) -> None:
        """Simulate process death: all in-memory and device segment state is lost
        (gauges zero out with it) and calls fail until boot()."""
        for table in list(self.segments):
            for seg_name in list(self.segments[table]):
                self.drop_segment(table, seg_name)
        self.segments = {}
        self.crashed = True
        METRICS.counter("server.crashes").inc()

    def boot(self) -> None:
        """Come back up EMPTY — recovery is the coordinator reconciling this
        server against ideal state (restart_server), not a local replay."""
        self.crashed = False

    def restore_segment(self, table: str, seg_name: str, deep_store) -> ImmutableSegment:
        """Re-materialize one committed segment from the deep store: download
        to the local cache dir, CRC-verify, load, pin (restart recovery and
        rebalance both land here)."""
        import tempfile

        if self.data_dir is None:
            self.data_dir = tempfile.mkdtemp(prefix=f"pinot-server-{self.name}-")
        local_dir = os.path.join(self.data_dir, table)
        segment = deep_store.fetch_segment(table, seg_name, local_dir)
        self.add_segment(table, segment)
        return segment

    # -- data manager ----------------------------------------------------
    def add_segment(self, table: str, segment: ImmutableSegment) -> None:
        self.segments.setdefault(table, {})[segment.name] = segment
        # device-residency gauge: segment host arrays mirror what the
        # executor's tensor cache pins on the device for this table
        METRICS.gauge(f"server.segmentBytes.{table}").add(_segment_bytes(segment))
        self.metrics.gauge(f"server.segmentBytes.{table}").add(_segment_bytes(segment))

    def drop_segment(self, table: str, seg_name: str) -> None:
        seg = self.segments.get(table, {}).pop(seg_name, None)
        if seg is not None:
            if self.residency is not None:
                # uncharge the cache budget AND drop the device entry;
                # the evict callback clears raw + #packed flavors together
                self.residency.evict(seg.device_group(self.device))
            # idempotent with the residency evict; also clears legacy pins
            seg.evict_device(self.device)
            METRICS.gauge(f"server.segmentBytes.{table}").add(-_segment_bytes(seg))
            self.metrics.gauge(f"server.segmentBytes.{table}").add(-_segment_bytes(seg))

    def get_segment(self, table: str, seg_name: str) -> Optional[ImmutableSegment]:
        return self.segments.get(table, {}).get(seg_name)

    def segment_names(self, table: str) -> List[str]:
        return list(self.segments.get(table, {}))

    # -- query execution (InstanceRequestHandler analog) ------------------
    def execute(
        self,
        ctx: QueryContext,
        seg_names: List[str],
        table_schema=None,
        deadline: Optional[Deadline] = None,
        cancel=None,
        source: str = "broker",
    ):
        """Run one query over the named LOCAL segments; returns
        (segment results, stats) — the DataTable the reference ships back.

        `cancel`: optional zero-arg probe (the broker watchdog's closure)
        returning a kill reason or None — checked between kernels alongside
        the deadline, so a killed query abandons its pending launches the
        same cooperative way a timed-out one does.  When `self.budget` is
        set, the working-set estimate for the named segments is reserved
        before any launch and released on exit (success, timeout, or kill) —
        a ReservationError here means this server is at capacity and the
        broker should fail the segments over to another replica.

        Tracing (ctx option `trace`): builds a per-server span subtree —
        dispatch (host-side plan+ship+async-launch per segment), device_wait
        (ONE block_until_ready over every pending output: the device-compute
        share the async dispatch hides), then per-segment collect spans —
        annotated with segments/docs/backend and any fault-plan events, and
        ships it back via stats.trace for the broker to graft."""
        from pinot_tpu_torch.query.planner import _needed_columns
        from pinot_tpu_torch.utils.metrics import Trace

        if self.crashed:
            from pinot_tpu_torch.cluster.faults import ServerFaultError

            # a dead process looks like a transport error to the broker —
            # exactly the signal that drives its failover/breaker paths
            raise ServerFaultError(f"server {self.name} is down (crashed)")
        trace = Trace(bool(ctx.options.get("trace", False)), root=f"server:{self.name}")
        ticket = None
        if self.budget is not None:
            # working-set estimate for the batch, reserved all-or-nothing
            # BEFORE any kernel launches (host-side arithmetic only — no
            # device values touched, so the warm path stays sync-free)
            est = []
            for name in seg_names:
                seg = self.get_segment(ctx.table, name)
                if seg is not None:
                    est.append(estimate_segment_bytes(ctx, seg, _needed_columns(ctx, seg)))
            if self.residency is not None:
                # tiered storage: device memory is a cache, so a scatter only needs
                # its PIPELINE WINDOW resident at once (current segment +
                # the one prefetching behind it) — the residency manager
                # pages the rest through the budget as the scan advances.
                # Working sets that exceed free-but-not-total budget park
                # as a staged fetch instead of 503ing; a window that
                # exceeds the whole budget cannot fit even transiently
                # and still raises ReservationError.  The window width is
                # the autopilot staging_depth knob (read per decision).
                win = _staging_depth()
                need = max(
                    (sum(est[i : i + win]) for i in range(len(est))), default=0
                )
                ticket = self.budget.reserve_or_wait(
                    need, what=f"scatter to server {self.name}", deadline=deadline
                )
            else:
                ticket = self.budget.reserve(
                    sum(est), what=f"scatter to server {self.name}"
                )
        try:
            plan = self.fault_plan
            if plan is not None:
                fault_n0 = len(plan.log)
                # may sleep, flap liveness, or raise; `source` lets one-way
                # partition rules drop only this caller's direction
                plan.on_execute(self.name, source=source)
                if trace.enabled and len(plan.log) > fault_n0:
                    trace.annotate(faults=[k for (_, _, k, _) in plan.log[fault_n0:]])
            stats = ExecutionStats()
            results = []
            pending = []
            t_dev = self._device_event() if trace.enabled else None
            with trace.span("dispatch") as dsp:
                # host-side pre-filter FIRST: range/bloom metadata prunes
                # cold segments before any staging, so a pruned segment
                # never enters the host->device copy stream
                scan = []
                for name in seg_names:
                    seg = self.get_segment(ctx.table, name)
                    if seg is not None and plan is not None and plan.segment_dropped(self.name, ctx.table, name):
                        seg = None
                    if seg is None:
                        raise KeyError(f"server {self.name} does not serve {ctx.table}/{name}")
                    stats.num_segments_queried += 1
                    stats.total_docs += seg.num_docs
                    if table_schema is not None:
                        seg.ensure_columns(table_schema, _needed_columns(ctx, seg))
                    if executor.prune_segment(ctx, seg):
                        stats.num_segments_pruned += 1
                        continue
                    scan.append(seg)
                for k, seg in enumerate(scan):
                    self._check_budget(deadline, cancelled=len(pending), cancel=cancel)
                    if self.residency is not None and k + 1 < len(scan):
                        # double-buffer: stage segment k+1's columns on the
                        # residency staging thread while k dispatches/runs
                        nxt = scan[k + 1]
                        self.residency.submit(
                            nxt.to_device,
                            device=self.device,
                            columns=_needed_columns(ctx, nxt),
                            packed_codes=True,
                            residency=self.residency,
                            prefetch=True,
                        )
                    # pipelined: dispatch all kernels async, then drain (executor.py)
                    with trace.span(f"launch:{seg.name}") as lsp:
                        st = executor.launch_segment(
                            ctx, seg, device=self.device, residency=self.residency
                        )
                        pending.append(st)
                    lst = executor.launch_stats(st)
                    if lsp is not None and lst is not None:
                        # per-operator cost model for EXPLAIN ANALYZE / traces
                        lsp.annotate(
                            kernelBytes=lst.kernel_bytes,
                            kernelFlops=lst.kernel_flops,
                            costSource=lst.kernel_cost_source,
                        )
                if dsp is not None:
                    dsp.annotate(launches=len(pending))
            if trace.enabled:
                # device/host time split: ONE fence over every pending output
                # (trace-only — the untraced path lets collect's copy home be
                # the fence so cancellation stays responsive between collects)
                pend_bytes = sum(
                    executor.launch_stats(s).kernel_bytes for s in pending if s[0] != "star"
                )
                with trace.span("device_wait", launches=len(pending)) as wsp:
                    wait_s, dev_ms = self._device_wait(t_dev, bool(executor.pending_outputs(pending)))
                stats.device_ms = wait_s * 1000.0
                if wsp is not None:
                    roof = perf.roofline_pct(pend_bytes, dev_ms / 1000.0) if dev_ms else None
                    wsp.annotate(
                        kernelBytes=pend_bytes,
                        **({"deviceMs": round(dev_ms, 3)} if dev_ms is not None else {}),
                        **({"rooflinePct": round(roof, 2)} if roof is not None else {}),
                    )
            for i, st in enumerate(pending):
                self._check_budget(deadline, cancelled=len(pending) - i, cancel=cancel)
                with trace.span("collect") as csp:
                    res, seg_stats = executor.collect_segment(st)
                if csp is not None:
                    csp.annotate(docs=seg_stats.num_docs_scanned)
                stats.num_segments_processed += 1
                stats.num_docs_scanned += seg_stats.num_docs_scanned
                stats.add_index_uses(seg_stats.filter_index_uses)
                stats.add_kernel_cost(seg_stats)
                results.append(res)
            # server-local series the broker federates into the cluster view
            self.metrics.counter("server.queries").inc()
            self.metrics.counter("server.docsScanned").inc(stats.num_docs_scanned)
            self.metrics.counter("server.kernelBytes").inc(int(stats.kernel_bytes))
            if stats.compile_ms > 0:
                self.metrics.timer("server.compileMs").update(stats.compile_ms)
            if trace.enabled:
                trace.annotate(
                    server=self.name,
                    segments=len(seg_names),
                    segmentsPruned=stats.num_segments_pruned,
                    docsScanned=stats.num_docs_scanned,
                    backend=planner.backend_tag(self.device),
                )
                stats.trace = trace.finish()
            return results, stats
        finally:
            if ticket is not None:
                self.budget.release(ticket)

    def execute_batch(
        self,
        ctxs: List[QueryContext],
        seg_names: List[str],
        table_schema=None,
        deadlines: Optional[List[Optional[Deadline]]] = None,
        cancels: Optional[List] = None,
        batch_id: Optional[str] = None,
        trace_enabled: bool = False,
        source: str = "broker",
    ):
        """Run N same-shape queries over the named LOCAL segments as ONE
        member-axis launch per segment (executor.launch_segment_batch); returns
        ``(results, stats, errors, batch_trace)`` with one slot per member.

        Per-member isolation: a member whose deadline expires or whose kill
        probe fires gets its error recorded in ``errors[i]`` and detaches —
        its remaining lanes are computed but discarded, and its siblings'
        results stay bit-exact.  Only BATCH-level faults raise out of this
        call (crashed server, fault-plan failure, missing segment,
        reservation exhaustion): the broker reacts by falling back to
        per-member execution through the normal failover machinery.

        Stats attribution: each segment's scanned docs and kernel
        bytes/flops divide across the members that actually scanned it
        (pruned members are excluded from the division), so summing member
        stats reproduces one unbatched run — never N duplicated copies.

        A per-member prune divergence within a uniform-segment batch is
        handled lane-wise: an all-pruned segment is skipped entirely, a
        partially-pruned one still launches with every live member's lane
        but credits pruned members with num_segments_pruned instead of
        docs."""
        from pinot_tpu_torch.query.planner import _needed_columns
        from pinot_tpu_torch.utils.metrics import Trace

        if self.crashed:
            from pinot_tpu_torch.cluster.faults import ServerFaultError

            raise ServerFaultError(f"server {self.name} is down (crashed)")
        n = len(ctxs)
        deadlines = list(deadlines) if deadlines else [None] * n
        cancels = list(cancels) if cancels else [None] * n
        trace = Trace(trace_enabled, root=f"server:{self.name}")
        ticket = None
        if self.budget is not None:
            # members share one plan shape, so the working set is the
            # SHARED columns — reserved once, not once per member
            est = []
            for name in seg_names:
                seg = self.get_segment(ctxs[0].table, name)
                if seg is not None:
                    est.append(
                        estimate_segment_bytes(
                            ctxs[0], seg, _needed_columns(ctxs[0], seg)
                        )
                    )
            if self.residency is not None:
                # pipeline-window reservation (see execute): the cache
                # pages segments through the budget, so only the window
                # must be jointly resident
                win = _staging_depth()
                need = max(
                    (sum(est[i : i + win]) for i in range(len(est))), default=0
                )
                ticket = self.budget.reserve_or_wait(
                    need, what=f"batched scatter to server {self.name}"
                )
            else:
                ticket = self.budget.reserve(
                    sum(est), what=f"batched scatter to server {self.name}"
                )
        try:
            plan = self.fault_plan
            if plan is not None:
                fault_n0 = len(plan.log)
                plan.on_execute(self.name, source=source)  # may sleep, flap liveness, or raise
                if trace.enabled and len(plan.log) > fault_n0:
                    trace.annotate(faults=[k for (_, _, k, _) in plan.log[fault_n0:]])
            stats = [ExecutionStats() for _ in range(n)]
            results: List[list] = [[] for _ in range(n)]
            errors: List[Optional[Exception]] = [None] * n
            pending = []  # (launch state, member indices it carries)
            t_dev = self._device_event() if trace.enabled else None
            with trace.span("dispatch", batchId=batch_id, batchSize=n) as dsp:
                for name in seg_names:
                    self._probe_members(deadlines, cancels, errors)
                    live = [i for i in range(n) if errors[i] is None]
                    if not live:
                        break
                    seg = self.get_segment(ctxs[0].table, name)
                    if seg is not None and plan is not None and plan.segment_dropped(
                        self.name, ctxs[0].table, name
                    ):
                        seg = None
                    if seg is None:
                        raise KeyError(
                            f"server {self.name} does not serve {ctxs[0].table}/{name}"
                        )
                    for i in live:
                        stats[i].num_segments_queried += 1
                        stats[i].total_docs += seg.num_docs
                    if table_schema is not None:
                        seg.ensure_columns(table_schema, _needed_columns(ctxs[0], seg))
                    scan = []
                    for i in live:
                        if executor.prune_segment(ctxs[i], seg):
                            stats[i].num_segments_pruned += 1
                        else:
                            scan.append(i)
                    if not scan:
                        continue
                    with trace.span(f"launch:{seg.name}", members=len(scan)):
                        if len(scan) == 1:
                            st = executor.launch_segment(
                                ctxs[scan[0]], seg, device=self.device,
                                residency=self.residency,
                            )
                            pending.append((st, scan))
                        else:
                            try:
                                st = executor.launch_segment_batch(
                                    [ctxs[i] for i in scan], seg, device=self.device,
                                    residency=self.residency,
                                )
                                pending.append((st, scan))
                            except executor.BatchShapeError:
                                # vetted batches shouldn't land here; stay
                                # correct with per-member launches if one does
                                for i in scan:
                                    pending.append(
                                        (
                                            executor.launch_segment(
                                                ctxs[i], seg, device=self.device,
                                                residency=self.residency,
                                            ),
                                            [i],
                                        )
                                    )
                if dsp is not None:
                    dsp.annotate(launches=len(pending))
            if trace.enabled:
                with trace.span("device_wait", launches=len(pending)) as wsp:
                    wait_s, dev_ms = self._device_wait(
                        t_dev, bool(executor.pending_outputs([p[0] for p in pending]))
                    )
                if wsp is not None and dev_ms is not None:
                    wsp.annotate(deviceMs=round(dev_ms, 3))
                wait_ms = wait_s * 1000.0
                live = [i for i in range(n) if errors[i] is None]
                for i in live:
                    stats[i].device_ms = wait_ms / max(1, len(live))
            for st, members in pending:
                self._probe_members(deadlines, cancels, errors, only=members)
                alive = [i for i in members if errors[i] is None]
                if not alive:
                    continue  # every rider died — abandon uncollected
                with trace.span("collect", members=len(alive)) as csp:
                    if st[0] == "batch":
                        collected = executor.collect_segment_batch(st)
                    else:
                        collected = [executor.collect_segment(st)]
                docs = 0
                for (res, seg_st), i in zip(collected, members):
                    if errors[i] is not None:
                        continue  # killed member's lane computed but discarded
                    stats[i].num_segments_processed += 1
                    stats[i].num_docs_scanned += seg_st.num_docs_scanned
                    stats[i].add_index_uses(seg_st.filter_index_uses)
                    stats[i].add_kernel_cost(seg_st)
                    results[i].append(res)
                    docs += seg_st.num_docs_scanned
                if csp is not None:
                    csp.annotate(docs=docs)
            served = sum(1 for e in errors if e is None)
            self.metrics.counter("server.queries").inc(served)
            self.metrics.counter("server.batches").inc()
            self.metrics.histogram("server.batchSize").update(n)
            METRICS.counter("server.batches").inc()
            METRICS.histogram("server.batchSize").update(n)
            docs_total = sum(s.num_docs_scanned for s in stats)
            self.metrics.counter("server.docsScanned").inc(docs_total)
            self.metrics.counter("server.kernelBytes").inc(
                int(sum(s.kernel_bytes for s in stats))
            )
            killed = sum(
                1 for e in errors if isinstance(e, QueryKilledError)
            )
            if killed:
                METRICS.counter("server.queriesKilled").inc(killed)
            batch_trace = None
            if trace.enabled:
                trace.annotate(
                    server=self.name,
                    batchId=batch_id,
                    batchSize=n,
                    segments=len(seg_names),
                    docsScanned=docs_total,
                    backend=planner.backend_tag(self.device),
                )
                batch_trace = trace.finish()
            return results, stats, errors, batch_trace
        finally:
            if ticket is not None:
                self.budget.release(ticket)

    def _device_event(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the server's device now (None on the
        CPU, where launches run eagerly)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _device_wait(self, t_dev, pending: bool):
        """The trace's fence: record an event after the last launch and wait
        on it.  Returns (seconds waited, device ms from `t_dev` to the
        event; None on the CPU or with nothing pending)."""
        tw = time.perf_counter()
        end = self._device_event() if pending else None
        if end is not None:
            end.synchronize()
        wait_s = time.perf_counter() - tw
        return wait_s, (t_dev.elapsed_time(end) if t_dev is not None and end is not None else None)

    def _probe_members(
        self,
        deadlines: List[Optional[Deadline]],
        cancels: List,
        errors: List[Optional[Exception]],
        only: Optional[List[int]] = None,
    ) -> None:
        """Per-member deadline + kill probes for a batched call.  A firing
        probe records the member's error (detaching it from the batch)
        instead of raising — siblings keep their lanes and their results."""
        idx = only if only is not None else range(len(errors))
        for i in idx:
            if errors[i] is not None:
                continue
            cancel = cancels[i]
            if cancel is not None:
                reason = cancel()
                if reason:
                    errors[i] = QueryKilledError(
                        f"server {self.name}: query killed ({reason}); "
                        "batch member detached",
                        reason=reason,
                    )
                    continue
            deadline = deadlines[i]
            if deadline is not None and deadline.expired():
                errors[i] = QueryTimeoutError(
                    f"server {self.name} ran out of query budget "
                    f"(timeoutMs={deadline.timeout_ms:g}); batch member detached"
                )

    def _check_budget(
        self, deadline: Optional[Deadline], cancelled: int, cancel=None
    ) -> None:
        """Between-kernel deadline + kill probe.  On expiry or kill the
        still-pending launches are abandoned uncollected (their references
        die with this frame — the async dispatches finish on device but
        never sync back)."""
        if cancel is not None:
            reason = cancel()
            if reason:
                if cancelled:
                    METRICS.counter("server.launchesCancelled").inc(cancelled)
                METRICS.counter("server.queriesKilled").inc()
                raise QueryKilledError(
                    f"server {self.name}: query killed ({reason}); "
                    f"{cancelled} pending launch(es) abandoned",
                    reason=reason,
                )
        if deadline is not None and deadline.expired():
            if cancelled:
                METRICS.counter("server.launchesCancelled").inc(cancelled)
            raise QueryTimeoutError(
                f"server {self.name} ran out of query budget "
                f"(timeoutMs={deadline.timeout_ms:g}); "
                f"{cancelled} pending launch(es) abandoned"
            )
