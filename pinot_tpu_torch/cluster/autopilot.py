"""SLO autopilot: the feedback loop that turns the serving tier's static
env knobs into a self-tuning system (ROADMAP item 5(b)).

Two halves:

``KnobRegistry`` — process-global, typed, clamped serving knobs.  Every
knob's INITIAL value and clamp bounds come from the same ``PINOT_TPU_*``
env var the consumer used to read at construction; the registry stores
only *overrides*, swapped in as one immutable dict, so

  * a knob nobody has written reads its env default at decision time —
    with the autopilot disabled the whole surface is bit-exact with the
    pre-registry behavior, and tests that monkeypatch env vars still work;
  * a controller write takes effect on the NEXT decision (next query,
    next refill, next launch) without rebuilding broker/engine/batcher;
  * ``view()`` returns one coherent snapshot — a query can never observe
    a mid-tick mix of old and new knob values (the model-checked
    contract: analysis/models.py ``KnobModel``);
  * setters clamp to the static env-derived ceilings — the controller
    can *never* exceed what the deployment configured.

``Autopilot`` — a sim-clock-friendly controller on a fixed tick
(injectable clock, utils/threads primitives so the deterministic
scheduler can drive it).  It reads the PerfLedger windows (admitted p99,
roofline %, plan-cache hit rate, QPS), hedge/brownout counters, and
ResourceBudget high-water marks, and moves AT MOST ONE knob per tick
along a fixed degradation ladder:

    shed hedges (budget pct, multiplicative decrease)
      -> widen the batch window (more coalescing per launch)
      -> shrink the macro-batch pipeline depth
      -> shrink the staging window
      -> cut the admission refill rate
      -> walk the degradation ladder up (cooldown after every walk)

Policy is deliberately boring and provable: a hysteresis band around the
SLO (breach above ``slo_ms``, recovery only below ``recover_ratio *
slo_ms``, no moves in between), sustained-signal streaks before any
move, multiplicative-decrease on degrade / additive-increase on recover,
anti-windup (saturated knobs are skipped, never pushed), recovery
climbing back the SAME ladder in reverse, and a bounded knob-change
count per rolling window so the loop can never oscillate.
"""
from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from pinot_tpu_torch.utils import perf, threads
from pinot_tpu_torch.utils.metrics import METRICS


def autopilot_enabled() -> bool:
    """PINOT_TPU_AUTOPILOT toggle; default off (pre-PR behavior)."""
    return os.environ.get("PINOT_TPU_AUTOPILOT", "0").lower() in ("1", "true", "yes")


# ---------------------------------------------------------------------------
# knob specs: env-derived initial value + clamp bounds per knob
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KnobSpec:
    """One registry-managed serving knob.

    ``lo``/``hi`` are functions of the env-derived initial value — the
    static configuration *is* the ceiling; the controller moves inside
    it.  ``degrade`` names the direction the degradation ladder moves
    this knob ("down" shrinks toward ``lo``, "up" grows toward ``hi``).
    ``step`` is the additive-increase recovery step (0 = initial/8)."""

    name: str
    env: str
    default: float
    lo: Callable[[float], float]
    hi: Callable[[float], float]
    step: float = 1.0
    integer: bool = False
    degrade: str = "down"

    def initial(self) -> float:
        raw = os.environ.get(self.env)
        try:
            v = float(raw) if raw not in (None, "") else float(self.default)
        except ValueError:
            v = float(self.default)
        return float(int(v)) if self.integer else v

    def step_of(self, initial: float) -> float:
        return self.step if self.step > 0 else max(abs(initial) / 8.0, 1e-6)


SPECS: Tuple[KnobSpec, ...] = (
    # broker micro-batcher coalescing window (cluster/batcher.py)
    KnobSpec(
        "batch_wait_ms", "PINOT_TPU_BATCH_WAIT_MS", 2.0,
        lo=lambda i: 0.0, hi=lambda i: max(4.0 * i, i + 6.0),
        step=1.0, degrade="up",
    ),
    # macro-batch in-flight launch depth (parallel/engine.py)
    KnobSpec(
        "pipeline_depth", "PINOT_TPU_PIPELINE_DEPTH", 2,
        lo=lambda i: 1.0, hi=lambda i: max(i, 1.0),
        step=1.0, integer=True, degrade="down",
    ),
    # scatter staging window: segments resident at once (cluster/server.py)
    KnobSpec(
        "staging_depth", "PINOT_TPU_STAGING_DEPTH", 2,
        lo=lambda i: 1.0, hi=lambda i: max(i, 1.0),
        step=1.0, integer=True, degrade="down",
    ),
    # hedge launch budget as % of primaries (cluster/broker.py)
    KnobSpec(
        "hedge_budget_pct", "PINOT_TPU_HEDGE_BUDGET_PCT", 10.0,
        lo=lambda i: 0.0, hi=lambda i: max(i, 0.0),
        step=0.0, degrade="down",
    ),
    # hedge delay as a multiple of the peer p95 (cluster/broker.py)
    KnobSpec(
        "hedge_delay_mult", "PINOT_TPU_HEDGE_QUANTILE_MULT", 1.0,
        lo=lambda i: max(i, 1e-6), hi=lambda i: 4.0 * max(i, 1e-6),
        step=0.0, degrade="up",
    ),
    # admission token-bucket refill rate; env 0 = admission off -> inert
    KnobSpec(
        "admission_rate", "PINOT_TPU_ADMISSION_RATE", 0.0,
        lo=lambda i: 0.25 * i, hi=lambda i: i,
        step=0.0, degrade="down",
    ),
    # degradation-ladder FLOOR (the occupancy signal can still push
    # the effective level higher; the controller can only raise the floor)
    KnobSpec(
        "degrade_level", "PINOT_TPU_DEGRADE_FLOOR", 0,
        lo=lambda i: 0.0, hi=lambda i: 3.0,
        step=1.0, integer=True, degrade="up",
    ),
)


# degrade order; recovery climbs back the same path in reverse
LADDER: Tuple[str, ...] = (
    "hedge_budget_pct",
    "batch_wait_ms",
    "pipeline_depth",
    "staging_depth",
    "admission_rate",
    "degrade_level",
)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


class KnobRegistry:
    """Clamped, typed, atomically-snapshotted serving knobs.

    Overrides live in ONE immutable dict swapped under ``_lock`` —
    ``set_many`` is a single swap, so readers (``get``/``view``) always
    see a coherent tick, never a mid-tick mix.  Unset knobs fall through
    to their env default, read at decision time."""

    def __init__(self, specs: Optional[Tuple[KnobSpec, ...]] = None):
        self._specs: Dict[str, KnobSpec] = {s.name: s for s in (specs or SPECS)}
        self._lock = threads.Lock()
        self._overrides: Dict[str, float] = {}
        self._splits: Dict[str, float] = {}

    # -- reads ----------------------------------------------------------
    def spec(self, name: str) -> KnobSpec:
        return self._specs[name]

    def names(self) -> List[str]:
        return list(self._specs)

    def initial(self, name: str) -> float:
        return self._specs[name].initial()

    def bounds(self, name: str) -> Tuple[float, float]:
        s = self._specs[name]
        init = s.initial()
        lo, hi = s.lo(init), s.hi(init)
        return (min(lo, hi), max(lo, hi))

    def get(self, name: str) -> float:
        with self._lock:
            ov = self._overrides  # the override dict is swapped, never mutated
        v = ov.get(name)
        return v if v is not None else self._specs[name].initial()

    def view(self) -> Dict[str, float]:
        """Coherent per-decision snapshot of every knob."""
        with self._lock:
            ov = self._overrides
        return {n: (ov[n] if n in ov else s.initial()) for n, s in self._specs.items()}

    # -- writes (clamped; the only mutation path) ------------------------
    def _clamp(self, name: str, value: float) -> float:
        s = self._specs[name]
        lo, hi = self.bounds(name)
        v = min(hi, max(lo, float(value)))
        return float(int(round(v))) if s.integer else v

    def set(self, name: str, value: float, who: str = "manual") -> float:
        return self.set_many({name: value}, who=who)[name]

    def set_many(self, updates: Dict[str, float], who: str = "manual") -> Dict[str, float]:
        """Clamp and apply every update in ONE atomic swap (one tick =
        one swap); returns the values actually applied."""
        applied = {n: self._clamp(n, v) for n, v in updates.items()}
        with self._lock:
            merged = dict(self._overrides)
            merged.update(applied)
            self._overrides = merged
        for n, v in applied.items():
            METRICS.gauge(f"autopilot.knob.{n}").set(v)
        return applied

    # -- per-table residency budget splits ------------------------------
    def set_splits(self, splits: Dict[str, float], who: str = "autopilot") -> None:
        """Replace the per-table residency split weights (fractions of the
        HBM cache budget) in one swap; empty dict restores pure heat/LRU
        eviction (the pre-registry policy)."""
        clean = {t: max(0.0, float(f)) for t, f in splits.items()}
        with self._lock:
            self._splits = dict(clean)
        for t, f in clean.items():
            METRICS.gauge(f"autopilot.split.{t}").set(f)

    def splits(self) -> Dict[str, float]:
        with self._lock:
            s = self._splits  # swapped atomically, never mutated in place
        return dict(s)

    # -- observability ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            ov = self._overrides
            splits = dict(self._splits)
        out: Dict[str, Any] = {}
        for n, s in self._specs.items():
            lo, hi = self.bounds(n)
            v = ov[n] if n in ov else s.initial()
            METRICS.gauge(f"autopilot.knob.{n}").set(float(v))
            out[n] = {
                "value": v,
                "initial": s.initial(),
                "lo": lo,
                "hi": hi,
                "overridden": n in ov,
                "degrade": s.degrade,
            }
        return {"knobs": out, "splits": splits}

    def reset(self) -> None:
        with self._lock:
            self._overrides = {}
            self._splits = {}


_KNOBS_LOCK = threads.Lock()
# Constructed eagerly so the registry's lock comes from the ambient (real)
# thread provider: a lazy first touch inside a model-checker schedule would
# bind the lock to that scheduler and break replay determinism.
_REGISTRY: KnobRegistry = KnobRegistry()


def knobs() -> KnobRegistry:
    """The process-global registry every consumer consults per decision."""
    with _KNOBS_LOCK:
        return _REGISTRY


def reset_knobs() -> None:
    """Drop every override and split (tests; conftest autouse)."""
    global _REGISTRY
    with _KNOBS_LOCK:
        _REGISTRY = KnobRegistry()


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


class Autopilot:
    """Fixed-tick feedback controller over the KnobRegistry.

    ``tick()`` is the whole control law and is directly drivable by
    tests/benches (fake clock, no thread); ``start()`` runs it on a
    daemon thread via utils/threads primitives.  One knob moves per
    tick, at most ``max_changes_per_window`` moves per rolling window of
    ticks, with a cooldown after every degradation-ladder walk."""

    def __init__(
        self,
        registry: Optional[KnobRegistry] = None,
        ledger: Optional[Any] = None,
        governor: Optional[Any] = None,
        clock: Optional[Callable[[], float]] = None,
        tick_s: Optional[float] = None,
        slo_ms: Optional[float] = None,
        history: int = 64,
    ):
        self.registry = registry if registry is not None else knobs()
        self.ledger = ledger if ledger is not None else perf.PERF_LEDGER
        self.governor = governor
        self.clock = clock if clock is not None else threads.monotonic
        self.tick_s = (
            float(os.environ.get("PINOT_TPU_AUTOPILOT_TICK_S", "1.0"))
            if tick_s is None
            else float(tick_s)
        )
        self.slo_ms = (
            float(os.environ.get("PINOT_TPU_SLO_MS", "250"))
            if slo_ms is None
            else float(slo_ms)
        )
        # hysteresis band: breach above slo_ms, recover below this ratio
        self.recover_ratio = 0.7
        self.breach_ticks = 2  # sustained-breach evidence before degrading
        self.recover_ticks = 3  # sustained-health evidence before recovering
        self.cooldown_ticks = 3  # after every degradation-ladder walk
        self.md_factor = 0.5  # multiplicative decrease
        self.change_window = 16  # ticks per oscillation-bound window
        self.max_changes_per_window = 4
        self._ladder = [n for n in LADDER if n in self.registry.names()]
        self._lock = threads.Lock()
        self._stop = threads.Event()
        self._thread: Optional[Any] = None
        self._tick_n = 0
        self._cooldown = 0
        self._breach_streak = 0
        self._healthy_streak = 0
        self._decisions: collections.deque = collections.deque(maxlen=history)
        self._change_ticks: collections.deque = collections.deque(maxlen=256)
        # per-instance counters: the METRICS twins are process-global and
        # survive controller restarts, so snapshot() must not report them
        self._knob_changes = 0
        self._ladder_walks = 0
        self._tables: Dict[str, Any] = {}

    # -- signal plane ----------------------------------------------------
    def _signals(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Read the feedback signal: PerfLedger windows, hedge/brownout
        counters, budget high-water marks.  Telemetry failures degrade to
        an idle signal — the controller holds rather than dies."""
        tables: Dict[str, Any] = {}
        worst_p99: Optional[float] = None
        qps_total = 0.0
        hit_rates: List[float] = []
        roof = 0.0
        try:
            snap = self.ledger.snapshot()
            for tname, t in snap.get("tables", {}).items():
                p99 = None
                for shape in t.get("shapes", {}).values():
                    lat = shape.get("latencyMs", {})
                    v = lat.get("p99", lat.get("max"))
                    if v is not None and (p99 is None or v > p99):
                        p99 = float(v)
                    hr = shape.get("planCacheHitRate")
                    if hr is not None:
                        hit_rates.append(float(hr))
                    rf = (shape.get("rooflinePct", {}) or {}).get("mean")
                    if rf:
                        roof = max(roof, float(rf))
                tqps = float(t.get("qps", 0.0))
                qps_total += tqps
                tables[tname] = {
                    "p99_ms": p99,
                    "qps": tqps,
                    "state": (
                        "breach" if p99 is not None and p99 > self.slo_ms else "ok"
                    ),
                }
                if p99 is not None and tqps > 0 and (worst_p99 is None or p99 > worst_p99):
                    worst_p99 = p99
        except Exception:  # noqa: BLE001 — telemetry must not kill the loop
            METRICS.counter("autopilot.signalErrors").inc()
        sig: Dict[str, Any] = {
            "p99_ms": worst_p99,
            "qps": round(qps_total, 3),
            "planCacheHitRate": (
                round(sum(hit_rates) / len(hit_rates), 3) if hit_rates else None
            ),
            "rooflinePct": round(roof, 3),
            "hedgesLaunched": METRICS.counter("broker.hedgesLaunched").value,
            "hedgesDenied": METRICS.counter("broker.hedgesDenied").value,
            "pressureLevel": METRICS.gauge("admission.pressureLevel").value,
        }
        if self.governor is not None:
            try:
                sig["hostPeakBytes"] = int(self.governor.host_budget.peak)
                sig["occupancy"] = round(self.governor._occupancy(), 4)
            except Exception:  # noqa: BLE001 — optional source, hold on failure
                METRICS.counter("autopilot.signalErrors").inc()
        return sig, tables

    # -- control law ------------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        sig, tables = self._signals()
        now = self.clock()
        with self._lock:
            self._tick_n += 1
            n = self._tick_n
            self._tables = tables
            decision: Dict[str, Any] = {
                "tick": n,
                "clock": round(now, 4),
                "action": "hold",
                "signal": sig,
            }
            p99 = sig.get("p99_ms")
            if self.slo_ms <= 0:
                decision["action"] = "disabled"
            elif self._cooldown > 0:
                self._cooldown -= 1
                decision["action"] = "cooldown"
                decision["remaining"] = self._cooldown
            elif p99 is None:
                # no traffic in the window: hold, decay the evidence
                self._breach_streak = 0
                self._healthy_streak = 0
                decision["action"] = "idle"
            elif p99 > self.slo_ms:
                self._healthy_streak = 0
                self._breach_streak += 1
                if self._breach_streak >= self.breach_ticks:
                    self._move_locked(n, decision, degrade=True)
                else:
                    decision["action"] = "breach-pending"
            elif p99 <= self.recover_ratio * self.slo_ms:
                self._breach_streak = 0
                self._healthy_streak += 1
                if self._healthy_streak >= self.recover_ticks:
                    self._move_locked(n, decision, degrade=False)
                else:
                    decision["action"] = "recover-pending"
            else:
                # inside the hysteresis band: no knob change, evidence resets
                self._breach_streak = 0
                self._healthy_streak = 0
            self._decisions.append(decision)
        self._update_splits(tables)
        return decision

    def _move_locked(self, n: int, decision: Dict[str, Any], degrade: bool) -> None:
        move = self._degrade_move() if degrade else self._recover_move()
        if move is None:
            decision["action"] = "saturated" if degrade else "recovered"
            self._breach_streak = 0
            self._healthy_streak = 0
            return
        name, new = move
        # oscillation bound: at most max_changes_per_window knob changes
        # per rolling change_window ticks — asserted by tests and bench
        while self._change_ticks and self._change_ticks[0] <= n - self.change_window:
            self._change_ticks.popleft()
        if len(self._change_ticks) >= self.max_changes_per_window:
            decision["action"] = "capped"
            decision["knob"] = name
            METRICS.counter("autopilot.movesCapped").inc()
            return
        old = self.registry.get(name)
        applied = self.registry.set(name, new, who="autopilot")
        self._change_ticks.append(n)
        # _move_locked runs under self._lock (held by tick)
        self._knob_changes += 1  # pinot-lint: disable=W004
        METRICS.counter("autopilot.knobChanges").inc()
        decision["action"] = "degrade" if degrade else "recover"
        decision["knob"] = name
        decision["from"] = old
        decision["to"] = applied
        if name == "degrade_level":
            self._ladder_walks += 1  # pinot-lint: disable=W004
            METRICS.counter("autopilot.ladderWalks").inc()
            self._cooldown = self.cooldown_ticks
        # a move consumes its evidence: the next one needs a fresh streak
        self._breach_streak = 0
        self._healthy_streak = 0

    def _degrade_move(self) -> Optional[Tuple[str, float]]:
        """First non-saturated knob in ladder order, moved one MD step in
        its degrade direction.  Saturated knobs are skipped (anti-windup:
        integrating further past the clamp would only delay recovery)."""
        reg = self.registry
        for name in self._ladder:
            s = reg.spec(name)
            init = reg.initial(name)
            if name == "admission_rate" and init <= 0:
                continue  # admission disabled by env: the knob is inert
            lo, hi = reg.bounds(name)
            cur = reg.get(name)
            step = s.step_of(init)
            if s.degrade == "down":
                if cur <= lo + 1e-9:
                    continue
                return name, max(lo, min(cur * self.md_factor, cur - step))
            if cur >= hi - 1e-9:
                continue
            return name, min(hi, max(cur * 2.0, cur + step))
        return None

    def _recover_move(self) -> Optional[Tuple[str, float]]:
        """Deepest displaced knob (reverse ladder order), one additive
        step back toward its env initial — recovery retraces the path."""
        reg = self.registry
        for name in reversed(self._ladder):
            s = reg.spec(name)
            init = reg.initial(name)
            cur = reg.get(name)
            if abs(cur - init) < 1e-9:
                continue
            step = s.step_of(init)
            if s.degrade == "down":
                return name, min(init, cur + step)
            return name, max(init, cur - step)
        return None

    def _update_splits(self, tables: Dict[str, Any]) -> None:
        """Resize per-table residency splits by measured traffic share —
        only when at least two tables carry load (a single-tenant process
        keeps the pre-registry pure heat/LRU eviction)."""
        active = {t: d["qps"] for t, d in tables.items() if d.get("qps", 0.0) > 0}
        if len(active) < 2:
            return
        total = sum(active.values())
        if total <= 0:
            return
        self.registry.set_splits({t: q / total for t, q in active.items()})

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threads.Event()
            self._thread = threads.Thread(
                target=self._run, name="autopilot", daemon=True
            )
            self._thread.start()

    # sensing backoff: a steady controller stretches its own cadence up to
    # 8x tick_s so a converged loop stops taxing the serving path it tunes.
    # "hold"/"idle" are steady by definition; "saturated" is too — breaching
    # with nothing left to move, re-sensing faster changes nothing until the
    # load eases.  Any evidence tick (breach/recover pending), move, or
    # cooldown snaps the cadence back to tick_s.
    _STEADY_ACTIONS = ("hold", "idle", "recovered", "saturated", "disabled")
    max_idle_backoff = 8

    @classmethod
    def _next_backoff(cls, backoff: int, action: str) -> int:
        if action in cls._STEADY_ACTIONS:
            return min(backoff * 2, cls.max_idle_backoff)
        return 1

    def _run(self) -> None:
        with self._lock:
            stop = self._stop
        backoff = 1
        while not stop.wait(timeout=self.tick_s * backoff):
            decision = self.tick()
            backoff = self._next_backoff(backoff, decision.get("action", ""))

    def stop(self) -> None:
        with self._lock:
            stop = self._stop
            t = self._thread
        stop.set()
        if t is not None:
            t.join(timeout=5.0)

    # -- observability ----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            decisions = list(self._decisions)
            tables = dict(self._tables)
            state = {
                "ticks": self._tick_n,
                "cooldown": self._cooldown,
                "breachStreak": self._breach_streak,
                "healthyStreak": self._healthy_streak,
                "running": self._thread is not None and self._thread.is_alive(),
                "knobChanges": self._knob_changes,
                "ladderWalks": self._ladder_walks,
            }
        reg = self.registry.snapshot()
        return {
            "enabled": True,
            "sloMs": self.slo_ms,
            "tickS": self.tick_s,
            **state,
            **reg,
            "tables": tables,
            "decisions": decisions,
            "changeBound": {
                "windowTicks": self.change_window,
                "maxChanges": self.max_changes_per_window,
            },
        }
