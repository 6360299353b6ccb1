"""Threading-primitive injection seam for the serving-tier protocols.

Copy of pinot_tpu/utils/threads.py.  The hand-rolled lock/condition-variable
protocols of the port (ResidencyManager, ResourceBudget, MicroBatcher,
LeaseManager, KnobRegistry) construct their primitives through THIS module
instead of `threading` directly:

    from pinot_tpu_torch.utils import threads
    ...
    self._lock = threads.Lock()
    self._cv = threads.Condition()

Under the default provider every call delegates 1:1 to the stdlib
(`threading.Lock`, `concurrent.futures.Future`, `time.monotonic`) — zero
behavior change, nothing to configure.  The model checker
(analysis/model_check.py) installs a `SchedulerProvider` over a
`DeterministicScheduler` (analysis/scheduler.py) for the duration of one
explored schedule, so every primitive the protocol touches becomes a
cooperative yield point and the interleaving is chosen by a seeded,
replayable scheduler instead of the OS.

`checkpoint()` marks a "real work happens here" point (a device copy, an
fsync window): a no-op in production, a scheduling point under a checker.

The provider is process-global on purpose: a schedule under exploration
owns the whole process, and production never changes it.  `use_provider`
restores the previous provider even when the schedule dies mid-flight.
"""
from __future__ import annotations

import threading as _threading
import time as _time
from concurrent.futures import Future as _Future
from contextlib import contextmanager
from typing import Any, Iterator


class RealProvider:
    """The production provider: stdlib primitives, verbatim."""

    name = "threading"

    Lock = staticmethod(_threading.Lock)
    RLock = staticmethod(_threading.RLock)
    Condition = staticmethod(_threading.Condition)
    Event = staticmethod(_threading.Event)
    Thread = staticmethod(_threading.Thread)
    Future = staticmethod(_Future)
    monotonic = staticmethod(_time.monotonic)

    @staticmethod
    def checkpoint() -> None:
        pass


_DEFAULT = RealProvider()
_current: Any = _DEFAULT


def provider() -> Any:
    return _current


def set_provider(p: Any) -> Any:
    """Install a provider; returns the one it replaced."""
    global _current
    prev = _current
    _current = p
    return prev


def reset_provider() -> None:
    global _current
    _current = _DEFAULT


@contextmanager
def use_provider(p: Any) -> Iterator[Any]:
    prev = set_provider(p)
    try:
        yield p
    finally:
        set_provider(prev)


# -- primitive constructors (dispatch at CALL time, not import time) -------

def Lock():
    return _current.Lock()


def RLock():
    return _current.RLock()


def Condition(lock=None):
    if lock is None:
        return _current.Condition()
    return _current.Condition(lock)


def Event():
    return _current.Event()


def Thread(*args, **kwargs):
    return _current.Thread(*args, **kwargs)


def Future():
    return _current.Future()


def monotonic() -> float:
    return _current.monotonic()


def checkpoint() -> None:
    _current.checkpoint()
