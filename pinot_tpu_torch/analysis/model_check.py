"""Exploration harness over the deterministic scheduler.

Port of pinot_tpu/analysis/model_check.py (the same harness), driving the
port's protocol models (analysis/models.py).

`explore()` drives a protocol MODEL (analysis/models.py) through a budget
of schedules — alternating unbounded seeded-random schedules with
preemption-bounded ones (the CHESS observation: most concurrency bugs
need ≤2 preemptions, so bounded schedules concentrate the budget where
bugs live).  Each schedule runs the model's threads to quiescence under a
`SchedulerProvider`, checking

  * the model's ALWAYS-invariants after every scheduled step,
  * its QUIESCENCE-invariants once every thread has finished,
  * thread crashes (an uncaught exception in any model thread),
  * deadlocks and livelocks (raised by the scheduler itself).

A failing schedule serializes to a JSON-able TRACE — the protocol name,
mutation, seed, preemption bound, the exact sequence of task ids the
scheduler chose, and the failure (kind, detail, step index).  `replay()`
re-runs the trace with the schedule FORCED, reproducing the identical
failure at the identical step: the debugging loop is "capture once,
replay forever".

The model contract (duck-typed; see models.py):

    model = ModelCls(mutation=None_or_name)
    model.setup()            # construct protocol objects under the provider
    model.threads()          # [(name, zero-arg fn), ...] — fixed order
    model.invariants()       # [(name, fn->None|str)], checked every step
    model.at_quiescence()    # [(name, fn->None|str)], checked at the end
    model.teardown()         # cleanup (tmpdirs etc.)

Invariant callbacks run on the HARNESS thread between steps, while every
model thread is parked at a yield point — they must read protocol state
raw (plain attributes) and never touch a provider primitive.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple, Type

from pinot_tpu_torch.analysis.scheduler import (
    DeadlockError,
    DeterministicScheduler,
    LivelockError,
    SchedulerProvider,
    TraceDivergenceError,
)
from pinot_tpu_torch.utils import threads


class InvariantViolation(AssertionError):
    def __init__(self, name: str, detail: str):
        super().__init__(f"{name}: {detail}")
        self.invariant = name
        self.detail = detail


def _failure(kind: str, detail: str, sched: DeterministicScheduler) -> Dict[str, Any]:
    return {
        "kind": kind,
        "detail": detail,
        "step": len(sched.trace),
        "schedule": list(sched.trace),
    }


def run_schedule(
    model_cls: Type,
    seed: int = 0,
    preemption_bound: Optional[int] = None,
    schedule: Optional[List[int]] = None,
    mutation: Optional[str] = None,
    max_steps: int = 20_000,
) -> Optional[Dict[str, Any]]:
    """One schedule of one model.  Returns a failure record, or None when
    the schedule ran to quiescence with every invariant holding."""
    sched = DeterministicScheduler(
        seed=seed,
        preemption_bound=preemption_bound,
        schedule=schedule,
        max_steps=max_steps,
    )
    prov = SchedulerProvider(sched)
    model = model_cls(mutation=mutation)
    failure: Optional[Dict[str, Any]] = None
    with threads.use_provider(prov), prov:
        try:
            model.setup()
            for tname, fn in model.threads():
                threads.Thread(target=fn, name=tname).start()
            always = model.invariants()

            def on_step() -> None:
                for iname, check in always:
                    msg = check()
                    if msg:
                        raise InvariantViolation(iname, str(msg))

            sched.on_step = on_step
            try:
                sched.run()
                for t in sched.tasks:
                    if t.exc is not None:
                        failure = _failure(
                            "thread-crash", f"{t.name}: {t.exc!r}", sched
                        )
                        break
                if failure is None:
                    for iname, check in model.at_quiescence():
                        msg = check()
                        if msg:
                            failure = _failure("quiescence", f"{iname}: {msg}", sched)
                            break
            except InvariantViolation as e:
                failure = _failure("invariant", str(e), sched)
            except DeadlockError as e:
                failure = _failure("deadlock", str(e), sched)
            except LivelockError as e:
                failure = _failure("livelock", str(e), sched)
        finally:
            sched.shutdown()
            try:
                model.teardown()
            except Exception:  # noqa: BLE001 — teardown must not mask the failure
                pass
    if failure is not None:
        failure["seed"] = seed
        failure["preemptionBound"] = preemption_bound
    return failure


def explore(
    model_cls: Type,
    max_schedules: int = 40,
    seed: int = 0,
    mutation: Optional[str] = None,
    preemption_bound: int = 2,
) -> Dict[str, Any]:
    """Drive `max_schedules` schedules (even index: unbounded random; odd:
    preemption-bounded) and stop at the first failure.  The returned record
    carries everything `replay()` needs."""
    for i in range(max_schedules):
        pb = None if i % 2 == 0 else preemption_bound
        failure = run_schedule(
            model_cls, seed=seed + i, preemption_bound=pb, mutation=mutation
        )
        if failure is not None:
            return {
                "protocol": getattr(model_cls, "name", model_cls.__name__),
                "mutation": mutation,
                "schedulesExplored": i + 1,
                "failure": failure,
            }
    return {
        "protocol": getattr(model_cls, "name", model_cls.__name__),
        "mutation": mutation,
        "schedulesExplored": max_schedules,
        "failure": None,
    }


def replay(trace: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Re-run a captured failing trace with the schedule FORCED.  Returns
    the reproduced failure record (bit-identical kind/detail/step/schedule
    for a faithful trace); raises TraceDivergenceError when the code under
    test no longer matches the trace."""
    from pinot_tpu_torch.analysis.models import PROTOCOLS

    model_cls = PROTOCOLS[trace["protocol"]]
    failure = trace["failure"]
    return run_schedule(
        model_cls,
        seed=failure.get("seed", 0),
        preemption_bound=failure.get("preemptionBound"),
        schedule=list(failure["schedule"]),
        mutation=trace.get("mutation"),
    )


def save_trace(trace: Dict[str, Any], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f, indent=2, sort_keys=True)


def load_trace(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def check_all(
    seed: int = 0,
    max_schedules: int = 25,
    mutations: bool = False,
    protocols: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """The gate entry point: every registered protocol model explored over
    the seeded budget; with `mutations=True` every broken twin must FAIL
    within the same budget (mutation-detection coverage).  `ok` is the
    single gate bit: clean models clean, broken twins caught."""
    from pinot_tpu_torch.analysis.models import PROTOCOLS

    names = protocols if protocols is not None else sorted(PROTOCOLS)
    report: Dict[str, Any] = {"seed": seed, "maxSchedules": max_schedules, "protocols": {}}
    ok = True
    for name in names:
        model_cls = PROTOCOLS[name]
        clean = explore(model_cls, max_schedules=max_schedules, seed=seed)
        entry: Dict[str, Any] = {
            "schedulesExplored": clean["schedulesExplored"],
            "failure": clean["failure"],
            "invariants": [iname for iname, _ in _invariant_names(model_cls)],
        }
        if clean["failure"] is not None:
            ok = False
        if mutations:
            entry["mutations"] = {}
            for mut in getattr(model_cls, "MUTATIONS", ()):  # broken twins
                res = explore(model_cls, max_schedules=max_schedules, seed=seed, mutation=mut)
                caught = res["failure"] is not None
                entry["mutations"][mut] = {
                    "caught": caught,
                    "schedulesExplored": res["schedulesExplored"],
                    "failure": res["failure"],
                }
                if not caught:
                    ok = False
        report["protocols"][name] = entry
    report["ok"] = ok
    return report


def _invariant_names(model_cls: Type) -> List[Tuple[str, Any]]:
    """Invariant (name, fn) pairs without running a schedule — a throwaway
    instance is set up under the REAL provider just to enumerate names."""
    try:
        m = model_cls(mutation=None)
        m.setup()
        pairs = list(m.invariants()) + list(m.at_quiescence())
        try:
            m.teardown()
        except Exception:  # noqa: BLE001
            pass
        return pairs
    except Exception:  # noqa: BLE001 — observability only, never gate on it
        return []
