"""Checked concurrency models for the serving-tier protocols.

Port of pinot_tpu/analysis/models.py: the five models run over the port's
real protocol classes (segment/residency.py, cluster/admission.py,
cluster/batcher.py, cluster/election.py, cluster/autopilot.py), each
constructing its primitives through `pinot_tpu_torch.utils.threads`.

Each model wraps the REAL protocol class (not a re-implementation) in a
small closed-world scenario: a handful of threads exercising the exact
code paths production takes, with the threading primitives supplied by the
deterministic scheduler through the `utils/threads` seam.  The model
declares the protocol's correctness argument as executable invariants:

  residency — single staging owner per group; the raw and `#packed`
      flavors of a group publish/evict atomically (never observably
      mixed); the ResourceBudget ledger balances on EVERY path including
      `abort_stage` (a mid-stage crash leaves no leaked charge).
  admission — `ResourceBudget.reserve_or_wait` never overcommits the
      byte budget, and parked staged-fetch waiters are always woken or
      timed out (no lost wakeups).
  batcher — every submitted future settles exactly once (no lost and no
      double-settled futures across the flush / full-group / runner-crash
      races).
  lease — at most one epoch appends to the journal at a time: epochs in
      the journal never decrease, and a deposed writer is always fenced
      before its stale append lands.
  knobs — the autopilot KnobRegistry's one-tick-one-swap contract: a
      query reading `view()` concurrently with a controller `set_many`
      tick sees either the whole tick or none of it, never a mid-tick
      mix of old and new knob values.

Every model also ships MUTATIONS: deliberately broken twins (the bug the
invariant exists to catch, reintroduced surgically).  `check_all(...,
mutations=True)` must catch every one within the gate's schedule budget —
that is the checker's own regression test, in the TP/clean-negative style
of test_analysis_races.py.

Model-thread code may use provider primitives freely; invariant callbacks
run on the harness thread between steps and read protocol state RAW
(plain attribute reads, no locks — every model thread is parked when they
run).
"""
from __future__ import annotations

import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

from pinot_tpu_torch.utils import threads


class _InjectedCrash(RuntimeError):
    """The fault a crash-path scenario injects into its owner thread."""


class BaseModel:
    name = "base"
    MUTATIONS: Tuple[str, ...] = ()

    def __init__(self, mutation: Optional[str] = None):
        if mutation is not None and mutation not in self.MUTATIONS:
            raise ValueError(f"{self.name}: unknown mutation {mutation!r}")
        self.mutation = mutation

    def setup(self) -> None:  # pragma: no cover - interface default
        pass

    def teardown(self) -> None:
        pass

    def threads(self) -> List[Tuple[str, Callable[[], None]]]:
        raise NotImplementedError

    def invariants(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        return []

    def at_quiescence(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        return []


# ---------------------------------------------------------------------------
# residency: single staging owner, atomic flavor publish/evict, ledger balance
# ---------------------------------------------------------------------------
class _Device:
    """Stand-in for a segment cache's device table: both flavors of a group
    live and die together under ONE critical section of `lock` — exactly
    the contract segment/residency.py keeps for the raw and `#packed` flavors."""

    def __init__(self, broken_evict: bool = False):
        self.lock = threads.Lock()
        self.slots: Dict[Tuple, int] = {}  # (group, flavor) -> nbytes
        self.broken_evict = broken_evict

    def put(self, group: Tuple, nbytes: int) -> None:
        with self.lock:
            self.slots[(group, "raw")] = nbytes // 2
            self.slots[(group, "packed")] = nbytes - nbytes // 2

    def drop(self, group: Tuple) -> None:
        if self.broken_evict:
            # MUTATION: flavors cleared one at a time with no lock — a
            # reader between the pops observes half a group
            self.slots.pop((group, "raw"), None)  # pinot-lint: disable=W010
            threads.checkpoint()
            self.slots.pop((group, "packed"), None)
        else:
            with self.lock:
                self.slots.pop((group, "raw"), None)
                self.slots.pop((group, "packed"), None)

    def group_bytes(self) -> int:
        return sum(self.slots.values())  # pinot-lint: disable=W010


class ResidencyModel(BaseModel):
    name = "residency"
    MUTATIONS = ("missing_uncharge_on_abort", "evict_outside_device_lock")

    BUDGET = 150

    def setup(self) -> None:
        from pinot_tpu_torch.cluster.admission import ResourceBudget
        from pinot_tpu_torch.segment.residency import ResidencyManager

        self.budget = ResourceBudget(self.BUDGET)
        rm_cls = ResidencyManager
        if self.mutation == "missing_uncharge_on_abort":
            rm_cls = _make_broken_residency()
        self.rm = rm_cls(self.budget, name="mc.residency")
        self.device = _Device(broken_evict=self.mutation == "evict_outside_device_lock")
        self.owners: Dict[Tuple, int] = {}  # group -> live staging owners
        self.sheds = 0

    def _stage(self, group: Tuple, table: str, nbytes: int, crash: bool = False) -> None:
        from pinot_tpu_torch.cluster.admission import ReservationError
        from pinot_tpu_torch.segment.residency import HIT, OWN, WAIT

        for _ in range(10):  # re-plan bound: transitions are finite
            status, entry = self.rm.begin_stage(
                group, table, evict_cb=lambda g=group: self.device.drop(g)
            )
            if status == HIT:
                return
            if status == WAIT:
                if not self.rm.wait(entry, timeout_s=20.0):
                    raise RuntimeError(f"stall timeout waiting for {group}")
                continue
            assert status == OWN
            self.owners[group] = self.owners.get(group, 0) + 1
            try:
                self.rm.charge(group, nbytes)
                threads.checkpoint()  # the host->device copy window
                if crash:
                    raise _InjectedCrash(f"mid-stage crash while staging {group}")
                self.device.put(group, nbytes)
                self.rm.finish_stage(group)
            except ReservationError:
                self.rm.abort_stage(group)  # cache full even after draining: shed
                self.sheds += 1
                return
            except _InjectedCrash:
                self.rm.abort_stage(group)  # the crash-path unwind under test
                return
            finally:
                self.owners[group] = self.owners.get(group, 1) - 1
            return
        raise RuntimeError(f"staging {group} did not settle within the re-plan bound")

    def threads(self) -> List[Tuple[str, Callable[[], None]]]:
        return [
            ("stage-A", lambda: self._stage(("segA", 0), "t1", 60)),
            ("stage-B", lambda: self._stage(("segB", 0), "t1", 60)),
            ("stage-C", lambda: self._stage(("segC", 0), "t2", 60)),
            ("crash-D", lambda: self._stage(("segD", 0), "t2", 10, crash=True)),
        ]

    def invariants(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def single_owner() -> Optional[str]:
            bad = {g: n for g, n in self.owners.items() if n > 1}
            return f"multiple staging owners: {bad}" if bad else None

        def ledger_bounded() -> Optional[str]:
            if self.budget._in_use > self.budget.budget_bytes:
                return (
                    f"ledger overcommitted: {self.budget._in_use} > "
                    f"{self.budget.budget_bytes}"
                )
            return None

        def flavors_paired() -> Optional[str]:
            groups = {g for (g, _f) in self.device.slots}
            for g in groups:
                have = {f for (gg, f) in self.device.slots if gg == g}
                if have != {"raw", "packed"}:
                    return f"group {g} observed with mixed flavors: {sorted(have)}"
            return None

        return [
            ("single-staging-owner", single_owner),
            ("ledger-never-overcommits", ledger_bounded),
            ("flavors-publish-atomically", flavors_paired),
        ]

    def at_quiescence(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def ledger_balances() -> Optional[str]:
            resident = sum(e.nbytes for e in self.rm._entries.values())
            pending = sum(e.pending for e in self.rm._entries.values())
            if pending:
                return f"{pending} pending bytes left at quiescence"
            if self.budget._in_use != resident:
                return (
                    f"ledger leak: in_use={self.budget._in_use} but resident "
                    f"bytes total {resident} (abort/evict path lost an uncharge)"
                )
            if self.device.group_bytes() != resident:
                return (
                    f"device holds {self.device.group_bytes()} bytes but the "
                    f"manager accounts {resident}"
                )
            return None

        return [("ledger-balances-at-rest", ledger_balances)]


def _make_broken_residency() -> type:
    from pinot_tpu_torch.segment.residency import RESIDENT, ResidencyManager

    class NoUnchargeOnAbortRM(ResidencyManager):
        def abort_stage(self, group: Tuple) -> None:
            with self._lock:
                e = self._entries.get(group)
                if e is None:
                    return
                e.pending = 0
                if e.nbytes > 0:
                    e.state = RESIDENT
                else:
                    del self._entries[group]
                e.event.set()
            # MUTATION: the pending bytes are never uncharged — a mid-stage
            # crash leaks its charge forever

    return NoUnchargeOnAbortRM


# ---------------------------------------------------------------------------
# admission: reserve_or_wait never overcommits; waiters woken or timed out
# ---------------------------------------------------------------------------
class AdmissionModel(BaseModel):
    name = "admission"
    MUTATIONS = ("if_not_while", "notify_one")

    BUDGET = 100

    def setup(self) -> None:
        from pinot_tpu_torch.cluster.admission import ResourceBudget

        cls = ResourceBudget
        if self.mutation == "if_not_while":
            cls = _make_if_not_while()
        elif self.mutation == "notify_one":
            cls = _make_notify_one()
        self.budget = cls(self.BUDGET)
        self.budget.clock = threads.monotonic  # fake clock under the checker
        self.served = 0
        self.both_held = threads.Event()
        self.held = 0

    def _whole(self) -> None:
        t = self.budget.reserve_or_wait(100, what="mc-big", max_wait_ms=10_000)
        try:
            threads.checkpoint()
        finally:
            self.budget.release(t)
        self.served += 1

    def _half(self) -> None:
        t = self.budget.reserve_or_wait(50, what="mc-half", max_wait_ms=10_000)
        try:
            self.held += 1
            if self.held >= 2:
                self.both_held.set()
            # hold until BOTH halves are in: a lost wakeup cannot hide behind
            # an early release re-notifying the queue
            if not self.both_held.wait(timeout=10_000):
                raise RuntimeError("peer half never reserved (lost wakeup upstream)")
        finally:
            self.budget.release(t)
        self.served += 1

    def threads(self) -> List[Tuple[str, Callable[[], None]]]:
        return [
            ("whole-100", self._whole),
            ("half-50-a", self._half),
            ("half-50-b", self._half),
        ]

    def invariants(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def never_overcommit() -> Optional[str]:
            if self.budget._in_use > self.budget.budget_bytes:
                return (
                    f"reservations overcommitted: {self.budget._in_use} of "
                    f"{self.budget.budget_bytes} bytes"
                )
            return None

        return [("never-overcommits", never_overcommit)]

    def at_quiescence(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def all_served() -> Optional[str]:
            if self.served != 3:
                return f"only {self.served}/3 reservations served (waiter starved)"
            if self.budget._in_use != 0:
                return f"{self.budget._in_use} bytes still reserved at rest"
            return None

        return [("every-waiter-served", all_served)]


def _make_if_not_while() -> type:
    from pinot_tpu_torch.cluster.admission import ResourceBudget

    class IfNotWhileBudget(ResourceBudget):
        def reserve_or_wait(self, nbytes, what="query", query_id=None,
                            deadline=None, max_wait_ms=None, queue_limit=8):
            n = max(0, int(nbytes))
            wait_s = (250.0 if max_wait_ms is None else float(max_wait_ms)) / 1000.0
            with self._lock:
                if self._in_use + n <= self.budget_bytes:
                    return self._reserve_locked(n)
                self._waiters += 1
                try:
                    self._lock.wait(timeout=wait_s)
                finally:
                    self._waiters -= 1
                # MUTATION: `if` where `while` is required — one wake, no
                # re-check of the predicate before charging
                return self._reserve_locked(n)

    return IfNotWhileBudget


def _make_notify_one() -> type:
    from pinot_tpu_torch.cluster.admission import ResourceBudget

    class NotifyOneBudget(ResourceBudget):
        def release(self, ticket: int) -> int:
            with self._lock:
                n = self._by_ticket.pop(ticket, 0)
                self._in_use -= n
                self._publish_locked()
                # MUTATION: notify(1) where notify_all is required — a woken
                # waiter that still does not fit consumes the only wakeup
                self._lock.notify(1)
                return n

    return NotifyOneBudget


# ---------------------------------------------------------------------------
# batcher: no lost and no double-settled futures
# ---------------------------------------------------------------------------
class BatcherModel(BaseModel):
    name = "batcher"
    MUTATIONS = ("double_run", "lost_on_crash")

    def setup(self) -> None:
        from pinot_tpu_torch.cluster.batcher import MicroBatcher

        cls = MicroBatcher
        if self.mutation == "double_run":
            cls = _make_double_run()
        elif self.mutation == "lost_on_crash":
            cls = _make_no_safety_net()
        # runner crashes mid-group only in the crash scenario; the intact
        # batcher's safety net turns that into failed futures (handled
        # below), the mutated twin silently loses the rest of the group
        self.crashy = self.mutation == "lost_on_crash"
        self.b = cls(self._runner, wait_ms=50.0, max_batch=2, clock=threads.monotonic)
        self.futures: List[Any] = []
        self.results: Dict[int, Any] = {}
        self.submitted = 0
        self.all_submitted = threads.Event()

    def _runner(self, entries: List[Any]) -> None:
        for i, e in enumerate(entries):
            if self.crashy and len(entries) >= 2 and i == 1:
                raise RuntimeError("runner crash mid-group")
            e.future.set_result(e.payload * 2)

    def _submit(self, idx: int, payload: int) -> None:
        f = self.b.submit("k", payload)
        self.futures.append(f)
        self.submitted += 1
        if self.submitted >= 2:
            self.all_submitted.set()
        try:
            self.results[idx] = f.result(timeout=10_000)
        except RuntimeError as e:
            # the safety net failing a crashed group's futures is correct
            # protocol behavior — record and move on
            self.results[idx] = e

    def _pump(self) -> None:
        if not self.all_submitted.wait(timeout=10_000):
            raise RuntimeError("submitters never arrived")
        for _ in range(3):
            threads.checkpoint()
            self.b.pump(now=threads.monotonic() + 1.0)
        self.b.flush()

    def threads(self) -> List[Tuple[str, Callable[[], None]]]:
        return [
            ("submit-1", lambda: self._submit(1, 10)),
            ("submit-2", lambda: self._submit(2, 20)),
            ("pumper", self._pump),
        ]

    def invariants(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def settle_once() -> Optional[str]:
            for f in self.futures:
                attempts = getattr(f, "resolve_attempts", 0)
                if attempts > 1:
                    return f"future settled {attempts} times (double-run group)"
            return None

        return [("futures-settle-at-most-once", settle_once)]

    def at_quiescence(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def all_settled() -> Optional[str]:
            pending = sum(len(g.entries) for g in self.b._groups.values())
            if pending:
                return f"{pending} submissions never flushed"
            if set(self.results) != {1, 2}:
                return f"results missing for {sorted({1, 2} - set(self.results))}"
            for idx, payload in ((1, 10), (2, 20)):
                got = self.results[idx]
                if not isinstance(got, RuntimeError) and got != payload * 2:
                    return f"submit-{idx} got {got!r}, wanted {payload * 2}"
            return None

        return [("no-lost-futures", all_settled)]


def _make_double_run() -> type:
    from pinot_tpu_torch.cluster.batcher import MicroBatcher, _Group

    class DoubleRunBatcher(MicroBatcher):
        def submit(self, key, payload):
            from pinot_tpu_torch.cluster.batcher import BatchEntry

            entry = BatchEntry(payload)
            if self.wait_ms <= 0 or self.max_batch <= 1:
                self._run([entry])
                return entry.future
            full = None
            with self._cv:
                group = self._groups.get(key)
                if group is None:
                    group = _Group(self.clock() + self.wait_ms / 1000.0)
                    self._groups[key] = group
                group.entries.append(entry)
                if len(group.entries) >= self.max_batch:
                    # MUTATION: the full group is run inline but NOT removed
                    # from the pending map — the next pump runs it again
                    full = group.entries
                else:
                    self._cv.notify_all()
            if full is not None:
                self._run(full)
            return entry.future

    return DoubleRunBatcher


def _make_no_safety_net() -> type:
    from pinot_tpu_torch.cluster.batcher import MicroBatcher

    class NoSafetyNetBatcher(MicroBatcher):
        def _run(self, entries) -> None:
            # MUTATION: no safety net — a runner crash mid-group leaves the
            # unreached entries' futures unresolved forever
            self.runner(entries)

    return NoSafetyNetBatcher


# ---------------------------------------------------------------------------
# lease fencing: at most one epoch appends; deposed writer always fenced
# ---------------------------------------------------------------------------
class LeaseModel(BaseModel):
    name = "lease"
    MUTATIONS = ("skip_fence",)

    def setup(self) -> None:
        from pinot_tpu_torch.cluster.election import LeaseManager

        self.tmpdir = tempfile.mkdtemp(prefix="mc-lease-")
        self.node_a = LeaseManager(self.tmpdir, "A", ttl_s=60.0, clock=threads.monotonic)
        self.node_b = LeaseManager(self.tmpdir, "B", ttl_s=60.0, clock=threads.monotonic)
        self.journal_lock = threads.Lock()
        self.journal: List[int] = []  # the epoch stamped on each entry  # pinot-lint: disable=W010
        self.fenced: List[str] = []

    def teardown(self) -> None:
        shutil.rmtree(self.tmpdir, ignore_errors=True)

    def _append(self, lm: Any) -> None:
        """MetaJournal.append in miniature: fence-then-write under the
        journal lock, with the write window made visible to the scheduler."""
        with self.journal_lock:
            if self.mutation == "skip_fence":
                # MUTATION: the epoch fence never runs — a deposed writer's
                # stale append lands after the usurper's entries
                threads.checkpoint()
                self.journal.append(lm.epoch)
            else:
                epoch = lm.validate_writer()
                threads.checkpoint()
                self.journal.append(epoch)

    def _writer(self, lm: Any, node: str, appends: int, force: bool) -> None:
        from pinot_tpu_torch.cluster.election import NotLeaderError

        if not lm.try_acquire(force=force):
            return
        for _ in range(appends):
            threads.checkpoint()
            try:
                self._append(lm)
            except NotLeaderError:
                self.fenced.append(node)  # deposed: exactly the fence working
                return

    def threads(self) -> List[Tuple[str, Callable[[], None]]]:
        return [
            ("writer-A", lambda: self._writer(self.node_a, "A", 3, force=False)),
            ("usurper-B", lambda: self._writer(self.node_b, "B", 2, force=True)),
        ]

    def invariants(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def epochs_non_decreasing() -> Optional[str]:
            for i in range(1, len(self.journal)):  # pinot-lint: disable=W010
                if self.journal[i] < self.journal[i - 1]:
                    return (
                        f"journal epochs interleaved: {self.journal} — a deposed "
                        "writer appended after the usurper"
                    )
            return None

        return [("one-epoch-appends", epochs_non_decreasing)]

    def at_quiescence(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def fence_observed() -> Optional[str]:
            for i in range(1, len(self.journal)):  # pinot-lint: disable=W010
                if self.journal[i] < self.journal[i - 1]:
                    return f"journal epochs interleaved at rest: {self.journal}"
            return None

        return [("journal-fenced-at-rest", fence_observed)]


# ---------------------------------------------------------------------------
# knobs: a controller tick publishes atomically; queries never see a mix
# ---------------------------------------------------------------------------
class KnobModel(BaseModel):
    name = "knobs"
    MUTATIONS = ("torn_knob_write",)

    # one controller "tick" always writes these two knobs to the SAME value
    # (both clamp ranges admit it), so any reader observing them unequal —
    # other than the env-default initial pair — caught a mid-tick mix
    PAIR = ("batch_wait_ms", "hedge_budget_pct")
    TICKS = (3.0, 5.0, 7.0)

    def setup(self) -> None:
        from pinot_tpu_torch.cluster.autopilot import KnobRegistry

        cls = KnobRegistry
        if self.mutation == "torn_knob_write":
            cls = _make_torn_registry()
        self.reg = cls()
        a, b = self.PAIR
        # lock-free spec reads: setup runs on the harness thread, where the
        # deterministic provider's lock may not be acquired
        self.initial = (self.reg.initial(a), self.reg.initial(b))
        self.torn: List[str] = []

    def _controller(self) -> None:
        a, b = self.PAIR
        for v in self.TICKS:
            threads.checkpoint()
            self.reg.set_many({a: v, b: v}, who="mc-tick")

    def _query(self) -> None:
        a, b = self.PAIR
        for _ in range(4):
            threads.checkpoint()
            view = self.reg.view()
            got = (view[a], view[b])
            if got != self.initial and got[0] != got[1]:
                self.torn.append(f"{a}={got[0]} with {b}={got[1]}")

    def threads(self) -> List[Tuple[str, Callable[[], None]]]:
        return [
            ("controller", self._controller),
            ("query-1", self._query),
            ("query-2", self._query),
        ]

    def invariants(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def coherent_snapshot() -> Optional[str]:
            if self.torn:
                return f"query observed a mid-tick knob mix: {self.torn[0]}"
            return None

        return [("coherent-knob-snapshot", coherent_snapshot)]

    def at_quiescence(self) -> List[Tuple[str, Callable[[], Optional[str]]]]:
        def final_tick_applied() -> Optional[str]:
            a, b = self.PAIR
            last = self.TICKS[-1]
            # raw read: quiescence callbacks run on the harness thread with
            # every model thread parked  # pinot-lint: disable=W010
            ov = self.reg._overrides
            if (ov.get(a), ov.get(b)) != (last, last):
                return (
                    f"final tick lost: {a}={ov.get(a)} {b}={ov.get(b)}, "
                    f"wanted both {last}"
                )
            return None

        return [("last-tick-fully-applied", final_tick_applied)]


def _make_torn_registry() -> type:
    from pinot_tpu_torch.cluster.autopilot import KnobRegistry

    class TornKnobRegistry(KnobRegistry):
        def set_many(self, updates, who="manual"):
            # MUTATION: knobs land one swap at a time with a visible window
            # between them — a concurrent view() reads half the tick
            out = {}
            for n, v in updates.items():
                out.update(super().set_many({n: v}, who=who))
                threads.checkpoint()
            return out

    return TornKnobRegistry


PROTOCOLS: Dict[str, type] = {
    ResidencyModel.name: ResidencyModel,
    AdmissionModel.name: AdmissionModel,
    BatcherModel.name: BatcherModel,
    LeaseModel.name: LeaseModel,
    KnobModel.name: KnobModel,
}
