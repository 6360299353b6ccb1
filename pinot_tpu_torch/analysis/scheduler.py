"""Deterministic cooperative scheduler: the dynamic half of the checker.

Port of pinot_tpu/analysis/scheduler.py (the same scheduler; pure Python,
no device).  It is the provider `pinot_tpu_torch.utils.threads` installs
for one explored schedule.

The serving tier's concurrency protocols are exercised under a scheduler
that owns every interleaving decision.  Model threads are real OS threads,
but they run ONE AT A TIME: each parks on its own semaphore and only the
scheduler's main loop hands out the single run token.  Every primitive
operation (lock acquire/release, condition wait/notify, event wait/set,
future resolve, an explicit `threads.checkpoint()`) is a YIELD POINT where
the token returns to the scheduler, which picks the next runnable thread

  * by a seeded RNG (random-schedule exploration),
  * under a preemption bound (at most K switches away from a runnable
    thread — the CHESS result: most concurrency bugs need few preemptions),
  * or from a FORCED schedule (bit-identical replay of a failing trace).

Because only one model thread ever runs and it can only lose the token at
a yield point, the protocol state visible between steps is a consistent
snapshot: the harness checks invariants after every step without any
locking of its own.

Time is fake: `provider.monotonic()` reads a logical clock that advances
ONLY when every live thread is blocked and at least one of them holds a
timed wait — then the earliest deadline fires (the wait times out).  A
timeout can therefore never preempt progress, and a schedule's outcome is
a pure function of (seed, preemption bound, forced schedule).

Failure modes the scheduler itself detects:

  * DeadlockError — every live thread is blocked and none holds a timed
    wait (includes lost wakeups: a condition waiter nobody can notify);
  * LivelockError — a schedule exceeds `max_steps` without quiescing
    (a spin loop that yields forever).

Primitive semantics mirror the stdlib: non-reentrant Lock, reentrant
RLock, Condition with FIFO waiters (notify wakes in wait order; woken
waiters re-contend for the lock), Event, Thread with join, and a Future
matching `concurrent.futures.Future` closely enough for the batcher
(InvalidStateError on double-resolve, TimeoutError from `result`).
"""
from __future__ import annotations

import random
from concurrent.futures import InvalidStateError, TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, List, Optional, Tuple

import threading as _real_threading

NEW = "new"
RUNNABLE = "runnable"
BLOCKED = "blocked"
DONE = "done"


class DeadlockError(AssertionError):
    """All live model threads are blocked with no timed wait to fire."""


class LivelockError(AssertionError):
    """A schedule ran past max_steps without quiescing (spin loop)."""


class TraceDivergenceError(AssertionError):
    """A forced replay schedule named a thread that is not runnable —
    the code under test changed since the trace was captured."""


class _Killed(BaseException):
    """Unwinds a parked model thread during scheduler shutdown.  Derives
    from BaseException so model code's `except Exception` cannot eat it."""


class _Task:
    __slots__ = (
        "tid", "name", "target", "sem", "state", "block_kind", "block_obj",
        "deadline", "timed_out", "exc", "thread", "started",
    )

    def __init__(self, tid: int, name: str, target: Callable[[], None]):
        self.tid = tid
        self.name = name
        self.target = target
        self.sem = _real_threading.Semaphore(0)
        self.state = NEW
        self.block_kind: Optional[str] = None   # "lock"|"cond"|"event"|"join"|"future"|"sleep"
        self.block_obj: Any = None
        self.deadline: Optional[float] = None   # fake-clock deadline for timed waits
        self.timed_out = False
        self.exc: Optional[BaseException] = None
        self.thread: Optional[_real_threading.Thread] = None
        self.started = False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<task {self.tid}:{self.name} {self.state}>"


class DeterministicScheduler:
    """One explored schedule: spawn tasks, `run()`, inspect `trace`."""

    def __init__(
        self,
        seed: int = 0,
        preemption_bound: Optional[int] = None,
        schedule: Optional[List[int]] = None,
        max_steps: int = 20_000,
    ):
        self.rng = random.Random(seed)
        self.seed = seed
        self.preemption_bound = preemption_bound
        self.preemptions = 0
        self.forced = list(schedule) if schedule is not None else None
        self._forced_pos = 0
        self.max_steps = max_steps
        self.tasks: List[_Task] = []
        self.current: Optional[_Task] = None
        self.trace: List[int] = []
        self.clock_now = 0.0
        self.steps = 0
        self.on_step: Optional[Callable[[], None]] = None
        self._abort = False
        self._main_sem = _real_threading.Semaphore(0)

    # -- task plumbing ----------------------------------------------------

    def create_task(self, target: Callable[[], None], name: str) -> _Task:
        task = _Task(len(self.tasks), name or f"t{len(self.tasks)}", target)
        self.tasks.append(task)
        return task

    def start_task(self, task: _Task) -> None:
        if task.started:
            raise RuntimeError(f"task {task.name} started twice")
        task.started = True
        task.state = RUNNABLE
        task.thread = _real_threading.Thread(
            target=self._task_main, args=(task,), name=f"mc-{task.name}", daemon=True
        )
        task.thread.start()

    def _task_main(self, task: _Task) -> None:
        task.sem.acquire()  # park until first scheduled
        try:
            if not self._abort:
                task.target()
        except _Killed:
            pass
        except BaseException as e:  # noqa: BLE001 — recorded as a model failure
            task.exc = e
        finally:
            task.state = DONE
            self._wake("join", task)
            self._main_sem.release()

    # -- token handoff (called from MODEL threads only) -------------------

    def _switch_out(self) -> None:
        """Give the token back to the main loop and park until rescheduled."""
        task = self.current
        assert task is not None, "primitive used outside a scheduled thread"
        self._main_sem.release()
        task.sem.acquire()
        if self._abort:
            raise _Killed()

    def yield_point(self) -> None:
        """A scheduling point where the thread stays runnable."""
        if self._abort:
            raise _Killed()
        self._switch_out()

    def block(
        self, kind: str, obj: Any, timeout: Optional[float] = None
    ) -> bool:
        """Park the current thread on (kind, obj); returns True when the
        wake was a fake-clock TIMEOUT rather than an explicit wake."""
        if self._abort:
            raise _Killed()
        task = self.current
        assert task is not None
        task.block_kind, task.block_obj = kind, obj
        task.deadline = (
            self.clock_now + timeout if timeout is not None and timeout > 0 else None
        )
        task.timed_out = False
        task.state = BLOCKED
        self._switch_out()
        task.block_kind = task.block_obj = None
        task.deadline = None
        return task.timed_out

    def _wake(self, kind: str, obj: Any, limit: Optional[int] = None) -> int:
        """Mark threads blocked on (kind, obj) runnable, FIFO by tid order
        of blocking; returns how many woke."""
        n = 0
        for t in self.tasks:
            if t.state == BLOCKED and t.block_kind == kind and t.block_obj is obj:
                t.state = RUNNABLE
                n += 1
                if limit is not None and n >= limit:
                    break
        return n

    # -- main loop (called from the HARNESS thread) -----------------------

    def _choose(self, runnable: List[_Task]) -> _Task:
        if self.forced is not None:
            if self._forced_pos >= len(self.forced):
                raise TraceDivergenceError(
                    f"forced schedule exhausted at step {self.steps} with "
                    f"{len(runnable)} thread(s) still live"
                )
            tid = self.forced[self._forced_pos]
            self._forced_pos += 1
            for t in runnable:
                if t.tid == tid:
                    return t
            raise TraceDivergenceError(
                f"forced schedule chose t{tid} at step {self.steps} but runnable "
                f"set is {[t.tid for t in runnable]}"
            )
        cur = self.current
        cur_runnable = cur is not None and cur.state == RUNNABLE and cur in runnable
        if (
            self.preemption_bound is not None
            and cur_runnable
            and self.preemptions >= self.preemption_bound
        ):
            return cur  # budget spent: run the current thread to its next block
        pick = self.rng.choice(sorted(runnable, key=lambda t: t.tid))
        if cur_runnable and pick is not cur:
            self.preemptions += 1
        return pick

    def _fire_earliest_timeout(self) -> bool:
        timed = [t for t in self.tasks if t.state == BLOCKED and t.deadline is not None]
        if not timed:
            return False
        deadline = min(t.deadline for t in timed)
        self.clock_now = max(self.clock_now, deadline)
        for t in timed:
            if t.deadline is not None and t.deadline <= self.clock_now:
                t.timed_out = True
                t.state = RUNNABLE
        return True

    def blocked_report(self) -> List[str]:
        out = []
        for t in self.tasks:
            if t.state == BLOCKED:
                obj = t.block_obj
                desc = getattr(obj, "mc_name", None) or type(obj).__name__
                out.append(f"{t.name} waits on {t.block_kind}:{desc}")
        return out

    def run(self) -> None:
        """Drive to quiescence (all tasks DONE) or raise Deadlock/Livelock.
        `on_step` runs after every step — invariant checks live there."""
        while True:
            live = [t for t in self.tasks if t.started and t.state != DONE]
            if not live:
                return
            runnable = [t for t in live if t.state == RUNNABLE]
            if not runnable:
                if self._fire_earliest_timeout():
                    continue
                raise DeadlockError(
                    "deadlock: all live threads blocked — " + "; ".join(self.blocked_report())
                )
            self.steps += 1
            if self.steps > self.max_steps:
                raise LivelockError(
                    f"schedule exceeded {self.max_steps} steps without quiescing"
                )
            chosen = self._choose(runnable)
            self.trace.append(chosen.tid)
            self.current = chosen
            chosen.sem.release()
            self._main_sem.acquire()
            if self.on_step is not None:
                self.on_step()

    def shutdown(self) -> None:
        """Kill parked threads after a failure: every parked semaphore is
        released with `_abort` set, so each thread raises `_Killed` at its
        park point and unwinds; primitives short-circuit during abort so
        `finally:` blocks in model code cannot re-park."""
        self._abort = True
        for t in self.tasks:
            if t.started and t.state != DONE:
                for _ in range(4):
                    t.sem.release()
        for t in self.tasks:
            if t.thread is not None:
                t.thread.join(timeout=2.0)

    # -- clock ------------------------------------------------------------

    def monotonic(self) -> float:
        return self.clock_now


# ---------------------------------------------------------------------------
# primitives (the scheduler-backed utils.threads provider)
# ---------------------------------------------------------------------------
class SchedLock:
    """Non-reentrant lock.  State changes happen atomically between yield
    points (only one model thread runs at a time), so no real lock backs
    the bookkeeping."""

    def __init__(self, sched: DeterministicScheduler, name: str = "lock"):
        self._sched = sched
        self.mc_name = name
        self.owner: Optional[_Task] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        if sched._abort:
            return True
        sched.yield_point()  # interleaving point before the acquisition race
        while self.owner is not None:
            if self.owner is sched.current:
                raise RuntimeError(f"non-reentrant {self.mc_name} re-acquired (self-deadlock)")
            if not blocking:
                return False
            timed_out = sched.block("lock", self, timeout if timeout and timeout > 0 else None)
            if timed_out:
                return False
        self.owner = sched.current
        return True

    def release(self) -> None:
        sched = self._sched
        if sched._abort:
            self.owner = None
            return
        if self.owner is not sched.current:
            raise RuntimeError(f"release of {self.mc_name} not held by releaser")
        self.owner = None
        sched._wake("lock", self)  # all waiters re-contend, stdlib-style
        sched.yield_point()

    def locked(self) -> bool:
        return self.owner is not None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class SchedRLock:
    def __init__(self, sched: DeterministicScheduler, name: str = "rlock"):
        self._sched = sched
        self.mc_name = name
        self.owner: Optional[_Task] = None
        self.count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        if sched._abort:
            return True
        if self.owner is sched.current:
            self.count += 1
            return True
        sched.yield_point()
        while self.owner is not None and self.owner is not sched.current:
            if not blocking:
                return False
            timed_out = sched.block("lock", self, timeout if timeout and timeout > 0 else None)
            if timed_out:
                return False
        self.owner = sched.current
        self.count += 1
        return True

    def release(self) -> None:
        sched = self._sched
        if sched._abort:
            self.owner, self.count = None, 0
            return
        if self.owner is not sched.current:
            raise RuntimeError(f"release of {self.mc_name} not held by releaser")
        self.count -= 1
        if self.count == 0:
            self.owner = None
            sched._wake("lock", self)
            sched.yield_point()

    def __enter__(self) -> "SchedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # internal: full release/restore for Condition.wait on an RLock
    def _release_save(self) -> int:
        saved, self.count, self.owner = self.count, 0, None
        self._sched._wake("lock", self)
        return saved

    def _acquire_restore(self, saved: int) -> None:
        self.acquire()
        self.count = saved


class SchedCondition:
    """Condition variable over a Sched lock.  Waiters queue FIFO; notify
    moves them to runnable (they re-contend for the lock on wake, exactly
    like the stdlib)."""

    def __init__(self, sched: DeterministicScheduler, lock: Any = None, name: str = "cond"):
        self._sched = sched
        self.mc_name = name
        self._lock = lock if lock is not None else SchedRLock(sched, name=f"{name}.lock")
        self._waiters: List[_Task] = []
        self.notifies_delivered = 0  # observability for W024-style dynamic checks

    # lock interface delegation
    def acquire(self, *a: Any, **kw: Any) -> bool:
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "SchedCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock.release()

    def _is_owned(self) -> bool:
        return self._lock.owner is self._sched.current

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        if sched._abort:
            return False
        if not self._is_owned():
            raise RuntimeError("cannot wait on un-acquired condition")
        task = sched.current
        assert task is not None
        self._waiters.append(task)
        if isinstance(self._lock, SchedRLock):
            saved = self._lock._release_save()
        else:
            self._lock.release()
            saved = 1
        timed_out = sched.block("cond", self, timeout)
        if task in self._waiters:  # timeout path: notify never removed us
            self._waiters.remove(task)
        if isinstance(self._lock, SchedRLock):
            self._lock._acquire_restore(saved)
        else:
            self._lock.acquire()
        return not timed_out

    def notify(self, n: int = 1) -> None:
        sched = self._sched
        if sched._abort:
            return
        if not self._is_owned():
            raise RuntimeError("cannot notify on un-acquired condition")
        for task in self._waiters[:n]:
            self._waiters.remove(task)
            if task.state == BLOCKED and task.block_kind == "cond" and task.block_obj is self:
                task.state = RUNNABLE
            self.notifies_delivered += 1

    def notify_all(self) -> None:
        self.notify(len(self._waiters))


class SchedEvent:
    def __init__(self, sched: DeterministicScheduler, name: str = "event"):
        self._sched = sched
        self.mc_name = name
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        sched = self._sched
        self._flag = True
        if sched._abort:
            return
        sched._wake("event", self)
        sched.yield_point()

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        if sched._abort:
            return self._flag
        sched.yield_point()
        while not self._flag:
            timed_out = sched.block("event", self, timeout)
            if timed_out:
                break
        return self._flag


class SchedThread:
    """threading.Thread lookalike registered with the scheduler."""

    def __init__(
        self,
        group: None = None,
        target: Optional[Callable] = None,
        name: Optional[str] = None,
        args: Tuple = (),
        kwargs: Optional[Dict] = None,
        daemon: Optional[bool] = None,
    ):
        sched = _ambient_scheduler()
        self._sched = sched
        self.daemon = daemon
        kwargs = kwargs or {}

        def _run() -> None:
            if target is not None:
                target(*args, **kwargs)

        self._task = sched.create_task(_run, name or f"thread-{len(sched.tasks)}")
        self.name = self._task.name

    def start(self) -> None:
        self._sched.start_task(self._task)

    def is_alive(self) -> bool:
        return self._task.started and self._task.state != DONE

    def join(self, timeout: Optional[float] = None) -> None:
        sched = self._sched
        if sched._abort:
            return
        while self._task.state != DONE:
            timed_out = sched.block("join", self._task, timeout)
            if timed_out:
                return


class SchedFuture:
    """concurrent.futures.Future lookalike: InvalidStateError on double
    resolution, TimeoutError from result(), waiters parked on the
    scheduler.  `resolve_attempts` counts resolution calls (including
    rejected doubles) for the model invariants."""

    def __init__(self, sched: DeterministicScheduler, name: str = "future"):
        self._sched = sched
        self.mc_name = name
        self._done = False
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self.resolve_attempts = 0

    def done(self) -> bool:
        return self._done

    def set_result(self, value: Any) -> None:
        self.resolve_attempts += 1
        if self._done:
            raise InvalidStateError(f"{self.mc_name} already resolved")
        self._done = True
        self._result = value
        sched = self._sched
        if not sched._abort:
            sched._wake("future", self)
            sched.yield_point()

    def set_exception(self, exc: BaseException) -> None:
        self.resolve_attempts += 1
        if self._done:
            raise InvalidStateError(f"{self.mc_name} already resolved")
        self._done = True
        self._exc = exc
        sched = self._sched
        if not sched._abort:
            sched._wake("future", self)
            sched.yield_point()

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        self._wait_done(timeout)
        return self._exc

    def result(self, timeout: Optional[float] = None) -> Any:
        self._wait_done(timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def _wait_done(self, timeout: Optional[float]) -> None:
        sched = self._sched
        if sched._abort:
            return
        sched.yield_point()
        while not self._done:
            timed_out = sched.block("future", self, timeout)
            if timed_out and not self._done:
                raise FutureTimeoutError(f"{self.mc_name} unresolved past timeout")


# ---------------------------------------------------------------------------
# the provider
# ---------------------------------------------------------------------------
_AMBIENT: Optional["SchedulerProvider"] = None


def _ambient_scheduler() -> DeterministicScheduler:
    if _AMBIENT is None:
        raise RuntimeError("SchedThread constructed with no scheduler provider installed")
    return _AMBIENT.sched


class SchedulerProvider:
    """The utils.threads provider backed by one DeterministicScheduler.
    Install with `threads.use_provider(provider)` for the duration of a
    schedule; `Thread` needs the ambient hookup because the stdlib Thread
    signature has no room for the scheduler handle."""

    name = "model-check"

    def __init__(self, sched: DeterministicScheduler):
        self.sched = sched
        self._n = 0

    def _name(self, kind: str) -> str:
        self._n += 1
        return f"{kind}{self._n}"

    def Lock(self) -> SchedLock:
        return SchedLock(self.sched, name=self._name("lock"))

    def RLock(self) -> SchedRLock:
        return SchedRLock(self.sched, name=self._name("rlock"))

    def Condition(self, lock: Any = None) -> SchedCondition:
        return SchedCondition(self.sched, lock=lock, name=self._name("cond"))

    def Event(self) -> SchedEvent:
        return SchedEvent(self.sched, name=self._name("event"))

    def Future(self) -> SchedFuture:
        return SchedFuture(self.sched, name=self._name("future"))

    def Thread(self, *args: Any, **kwargs: Any) -> SchedThread:
        global _AMBIENT
        _AMBIENT = self
        return SchedThread(*args, **kwargs)

    def monotonic(self) -> float:
        return self.sched.monotonic()

    def checkpoint(self) -> None:
        if not self.sched._abort:
            self.sched.yield_point()

    def __enter__(self) -> "SchedulerProvider":
        global _AMBIENT
        _AMBIENT = self
        return self

    def __exit__(self, *exc: Any) -> None:
        global _AMBIENT
        _AMBIENT = None
