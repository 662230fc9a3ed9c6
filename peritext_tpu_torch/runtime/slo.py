"""Process-wide SLO plane: declarative objectives + burn-rate breach alerts.

A copy of ``peritext_tpu/runtime/slo.py`` for the PyTorch port, fed by the
port's telemetry registry.

The observability stack (telemetry.py) can *reconstruct* latency and error
behavior offline — ``obs.summary()`` estimates e2e percentiles from the
log2 histograms, ``scripts/trace_report.py`` re-derives them from a trace
— but nothing in the process could say "the p95 admit-to-applied objective
is being violated *right now*".  This module is that online judgment: a
seeded :class:`SloPlan` holds one sliding-window evaluator per named
**objective**, fed live from the existing telemetry sites (no new
instrumentation — the evaluators subscribe to :func:`telemetry.observe` /
:func:`telemetry.counter` names through sink maps), with multi-window
burn-rate breach detection in the Google-SRE shape: a breach requires the
**fast** window (recent events) AND the **slow** window (the full window)
to both burn error budget faster than the threshold, so a single slow
launch cannot page while a sustained regression fires within a handful of
events.

Objective kinds (inferred from the clause's parameters):

- **latency**: ``pNN=<ms>`` targets against a stream of observed seconds —
  any histogram name fed through ``telemetry.observe`` (``e2e.*``,
  ``span.<name>.seconds``, ``serve.flush_seconds``, ...).  The error
  budget for ``p95=50`` is 5% of events over 50ms; the burn rate is the
  observed over-target fraction divided by that budget.
- **error rate**: ``err_rate=<P>`` against a pair of counters — by
  convention ``<name>_attempts`` (events) and ``<name>_failures``
  (errors), which is exactly how the ingest launch path already counts
  (``ingest.launch_attempts`` / ``ingest.launch_failures``); override
  with ``total=<counter>,errors=<counter>`` for pairs that don't follow
  the convention (e.g. ``total=serve.flushes,errors=serve.flush_failures``).

Spec grammar (the ``PERITEXT_FAULTS`` shape, ``;``-separated clauses)::

    PERITEXT_SLO="seed=0;e2e.admit_to_applied:p95=50,window=256;\
ingest.launch:err_rate=0.01,window=128"

Per-clause parameters: ``window=N`` (sliding event window, default 128),
``fast=N`` (fast-window length, default ``max(8, window // 8)``),
``burn=X`` (burn-rate threshold both windows must reach, default 1.0),
``min=N`` (events required before a verdict, default the fast length),
``cooldown=T`` (black-box dump rate limit per objective, seconds, default
60; judged on the plan's injectable clock, so chaos tests drive it
deterministically).

Evaluation is **deterministic given the event order**: no wall-clock
enters a verdict (the clock only rate-limits dumps), so a seeded chaos
run breaches at exactly the same event on every run.  On a breach
transition the objective increments ``slo.<name>.breach``, sets the
``slo.<name>.breached`` gauge, records a flight-recorder event, and fires
a rate-limited black-box dump naming the objective; recovery clears the
gauge.  The live ``slo.<name>.burn`` / ``slo.<name>.compliance`` gauges
ride :func:`telemetry.summary`, and the breach
state feeds tail-sampled tracing's ``breach`` rule through the installed
probe.

With no plan installed, the fed sites cost one module-attribute load and
a ``None`` check on top of the normal enabled-path work — the disabled
path (telemetry off) is unchanged at one attribute check
(tests/test_telemetry.py pins it).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from peritext_tpu_torch.runtime import telemetry

_DEF_WINDOW = 128
_DEF_BURN = 1.0
_DEF_COOLDOWN = 60.0


class SloObjective:
    """One objective's sliding-window evaluator (thread-safe; the feed
    sites may fire from scheduler threads and foreground ingest at once)."""

    def __init__(
        self, name: str, clock: Optional[Callable[[], float]] = None
    ) -> None:
        self.name = name
        self.window = _DEF_WINDOW
        self.fast: Optional[int] = None  # default resolves from window
        self.burn_threshold = _DEF_BURN
        self.min_events: Optional[int] = None  # default resolves to fast
        self.cooldown = _DEF_COOLDOWN
        # Latency targets: quantile key ("p95") -> threshold seconds.
        self.latency_targets: Dict[str, float] = {}
        self.err_rate: Optional[float] = None
        self.total_counter: Optional[str] = None
        self.error_counter: Optional[str] = None
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        # The event window.  Latency: observed seconds (floats).  Error
        # rate: per-event badness (bools).
        self._vals: deque = deque()
        # Per-target over-budget counts across the SLOW (full) window,
        # maintained incrementally so evaluation is O(fast + targets),
        # not O(window).
        self._slow_bad: Dict[str, int] = {}
        self.events = 0  # total events ever fed (monotonic)
        self.burn = 0.0
        self.compliance = 1.0
        self.breached = False
        self.breaches = 0
        self._last_dump: Optional[float] = None

    # -- construction --------------------------------------------------------

    def set_param(self, action: str, value: str) -> None:
        """Apply one spec ``param=value`` pair (PERITEXT_SLO grammar)."""
        if action.startswith("p") and action[1:].replace(".", "").isdigit():
            q = float(action[1:]) / 100.0
            if not 0.0 < q < 1.0:
                raise ValueError(f"quantile target {action!r} out of (p0, p100)")
            self.latency_targets[action] = float(value) / 1000.0  # ms -> s
        elif action == "err_rate":
            self.err_rate = float(value)
            if not 0.0 < self.err_rate <= 1.0:
                raise ValueError(f"err_rate must be in (0, 1], got {value}")
        elif action == "window":
            self.window = int(value)
            if self.window < 2:
                raise ValueError(f"window must be >= 2, got {value}")
        elif action == "fast":
            self.fast = int(value)
            if self.fast < 1:
                raise ValueError(f"fast must be >= 1, got {value}")
        elif action == "burn":
            self.burn_threshold = float(value)
            if self.burn_threshold <= 0:
                raise ValueError(f"burn must be > 0, got {value}")
        elif action == "min":
            self.min_events = int(value)
        elif action == "cooldown":
            self.cooldown = float(value)
            if self.cooldown < 0:
                raise ValueError(f"cooldown must be >= 0, got {value}")
        elif action == "total":
            self.total_counter = value
        elif action == "errors":
            self.error_counter = value
        else:
            raise ValueError(
                f"unknown SLO parameter {action!r} for objective {self.name!r}"
            )

    def validate(self) -> None:
        if bool(self.latency_targets) == (self.err_rate is not None):
            raise ValueError(
                f"objective {self.name!r} needs exactly one of pNN=<ms> "
                "latency targets or err_rate=<P>"
            )

    def _fast_n(self) -> int:
        return self.fast if self.fast is not None else max(8, self.window // 8)

    def _min_n(self) -> int:
        return self.min_events if self.min_events is not None else self._fast_n()

    def _budgets(self) -> Dict[str, float]:
        """Per-target error budgets: the allowed bad-event fraction."""
        if self.err_rate is not None:
            return {"err": self.err_rate}
        return {
            key: 1.0 - float(key[1:]) / 100.0
            for key in self.latency_targets
        }

    def _bad(self, key: str, value: Any) -> bool:
        if self.err_rate is not None:
            return bool(value)
        return value > self.latency_targets[key]

    # -- the event feed ------------------------------------------------------

    def _append_locked(self, value: Any) -> None:
        self._vals.append(value)
        self.events += 1
        for key in self._budgets():
            if self._bad(key, value):
                self._slow_bad[key] = self._slow_bad.get(key, 0) + 1
        while len(self._vals) > self.window:
            old = self._vals.popleft()
            for key in self._budgets():
                if self._bad(key, old):
                    self._slow_bad[key] -= 1

    def feed_value(self, value: float) -> None:
        """One latency observation (seconds — the telemetry.observe unit)."""
        with self._lock:
            self._append_locked(value)
            dump = self._evaluate_locked()
        self._fire(dump)

    def feed_total(self, n: int = 1) -> None:
        """``n`` events (the total/attempts counter incremented)."""
        with self._lock:
            for _ in range(n):
                self._append_locked(False)
            dump = self._evaluate_locked()
        self._fire(dump)

    def feed_errors(self, n: int = 1) -> None:
        """``n`` of the recent events failed (the errors counter).  The
        instrumented convention counts the attempt first and the failure
        after it lands, so errors flip the most recent still-ok events;
        an error with no matching attempt (defensive) appends."""
        with self._lock:
            flipped = 0
            idx = len(self._vals) - 1
            while idx >= 0 and flipped < n:
                if self._vals[idx] is False:
                    self._vals[idx] = True
                    self._slow_bad["err"] = self._slow_bad.get("err", 0) + 1
                    flipped += 1
                idx -= 1
            for _ in range(n - flipped):
                self._append_locked(True)
            dump = self._evaluate_locked()
        self._fire(dump)

    # -- evaluation ----------------------------------------------------------

    def _evaluate_locked(self) -> Optional[Dict[str, Any]]:
        """Re-judge the objective after one event; returns black-box dump
        info to fire OUTSIDE the lock (file I/O must not serialize the
        feed sites), or None."""
        n = len(self._vals)
        if n == 0:
            return None
        fast_n = min(n, self._fast_n())
        budgets = self._budgets()
        burn = 0.0
        burn_exit = 0.0
        worst_slow_frac = 0.0
        for key, budget in budgets.items():
            slow_frac = self._slow_bad.get(key, 0) / n
            fast_bad = 0
            for i in range(fast_n):  # fast window: the most recent events
                if self._bad(key, self._vals[-1 - i]):
                    fast_bad += 1
            fast_frac = fast_bad / fast_n
            # Multi-window rule: the target's effective burn is the LOWER
            # of its fast/slow burns — both windows must burn for a
            # breach, so a lone outlier (fast spikes, slow doesn't) and a
            # stale streak aging out (slow high, fast recovered) both
            # stay quiet.  Recovery is judged on the HIGHER of the two
            # (hysteresis): an ongoing storm whose windows momentarily
            # disagree event-to-event must not flap the breach state.
            burn = max(burn, min(fast_frac, slow_frac) / budget)
            burn_exit = max(burn_exit, max(fast_frac, slow_frac) / budget)
            worst_slow_frac = max(worst_slow_frac, slow_frac)
        self.burn = burn
        self.compliance = 1.0 - worst_slow_frac
        if telemetry.enabled:
            telemetry.gauge(f"slo.{self.name}.burn", burn)
            telemetry.gauge(f"slo.{self.name}.compliance", self.compliance)
        if self.breached:
            breached_now = burn_exit >= self.burn_threshold
        else:
            breached_now = n >= self._min_n() and burn >= self.burn_threshold
        if breached_now and not self.breached:
            self.breached = True
            self.breaches += 1
            if telemetry.enabled:
                telemetry.counter(f"slo.{self.name}.breach")
                telemetry.gauge(f"slo.{self.name}.breached", 1)
                telemetry.record(
                    "slo.breach", outcome="breach", slo=self.name, burn=burn
                )
            now = self._clock()
            if self._last_dump is None or now - self._last_dump >= self.cooldown:
                self._last_dump = now
                return {
                    "slo": self.name,
                    "burn": burn,
                    "compliance": self.compliance,
                    "events": self.events,
                    "breaches": self.breaches,
                    "objective": self.describe(),
                }
            if telemetry.enabled:
                telemetry.counter(f"slo.{self.name}.dump_suppressed")
        elif not breached_now and self.breached:
            self.breached = False
            if telemetry.enabled:
                telemetry.gauge(f"slo.{self.name}.breached", 0)
                telemetry.record(
                    "slo.breach", outcome="recovered", slo=self.name, burn=burn
                )
        return None

    def _fire(self, dump: Optional[Dict[str, Any]]) -> None:
        if dump is not None:
            # The objective already rate-limited on its own (injectable)
            # clock — dedupe_cooldown_s=0 bypasses the wall-clock limiter
            # so a fake-clock chaos test still sees its dump; the per-SLO
            # dedupe key keeps distinct objectives independent.
            telemetry.blackbox_dump(
                "slo_breach",
                dedupe_key=f"slo_breach:{self.name}",
                dedupe_cooldown_s=0.0,
                **dump,
            )

    # -- introspection -------------------------------------------------------

    def describe(self) -> str:
        if self.err_rate is not None:
            return f"err_rate<={self.err_rate:g}"
        return ",".join(
            f"{k}<={t * 1000:g}ms" for k, t in sorted(self.latency_targets.items())
        )

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "objective": self.describe(),
                "window": self.window,
                "fast": self._fast_n(),
                "burn_threshold": self.burn_threshold,
                "events": self.events,
                "burn": round(self.burn, 4),
                "compliance": round(self.compliance, 4),
                "breached": self.breached,
                "breaches": self.breaches,
            }


class SloPlan:
    """A set of objectives (the SLO analog of FaultPlan/HealthPlan).  The
    ``seed`` clause is accepted for grammar symmetry and recorded; the
    evaluators themselves are deterministic in event order and draw no
    randomness."""

    def __init__(
        self, seed: int = 0, clock: Optional[Callable[[], float]] = None
    ) -> None:
        self.seed = seed
        self.clock = clock
        self._objectives: Dict[str, SloObjective] = {}

    def objective(self, name: str, **params: Any) -> SloObjective:
        obj = self._objectives.get(name)
        if obj is None:
            obj = self._objectives[name] = SloObjective(name, clock=self.clock)
        for action, value in params.items():
            obj.set_param(action, str(value))
        return obj

    def objectives(self) -> List[SloObjective]:
        return list(self._objectives.values())

    @classmethod
    def from_spec(
        cls,
        spec: str,
        seed: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> "SloPlan":
        """Parse the ``PERITEXT_SLO`` grammar (the ``PERITEXT_FAULTS``
        shape: ``seed=N`` clauses and ``name:param=value[,...]`` clauses,
        ``;``-separated)."""
        plan = cls(seed=seed if seed is not None else 0, clock=clock)
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed=") and ":" not in clause:
                if seed is None:
                    plan.seed = int(clause[5:])
                continue
            name, sep, params = clause.partition(":")
            if not sep or not params:
                raise ValueError(
                    f"bad SLO clause {clause!r} (want name:param=value[,...])"
                )
            obj = plan.objective(name.strip())
            for part in params.split(","):
                action, sep, value = part.partition("=")
                if not sep:
                    raise ValueError(
                        f"bad SLO parameter {part!r} in clause {clause!r}"
                    )
                obj.set_param(action.strip(), value.strip())
        for obj in plan._objectives.values():
            obj.validate()
        return plan

    # -- wiring --------------------------------------------------------------

    def sinks(
        self,
    ) -> Tuple[Dict[str, Callable[[float], None]], Dict[str, Callable[[int], None]]]:
        """(observe-name -> feed, counter-name -> feed) maps for
        :func:`telemetry._install_slo_sinks`."""
        observe_map: Dict[str, Callable[[float], None]] = {}
        counter_map: Dict[str, Callable[[int], None]] = {}
        for obj in self._objectives.values():
            if obj.err_rate is not None:
                total = obj.total_counter or obj.name + "_attempts"
                errors = obj.error_counter or obj.name + "_failures"
                counter_map[total] = obj.feed_total
                counter_map[errors] = obj.feed_errors
            else:
                observe_map[obj.name] = obj.feed_value
        return observe_map, counter_map

    def breach_active(self) -> bool:
        """True while any objective is in breach — the tail-sampled
        tracer's ``breach`` retention probe."""
        return any(obj.breached for obj in self._objectives.values())

    def summary(self) -> Dict[str, Any]:
        return {name: obj.summary() for name, obj in self._objectives.items()}


# -- the process-wide plan ----------------------------------------------------

_installed: Optional[SloPlan] = None
_env_plan: Optional[SloPlan] = None
_env_spec: Optional[str] = None


def _wire(plan: Optional[SloPlan]) -> None:
    if plan is None:
        telemetry._install_slo_sinks(None, None, None)
        return
    observe_map, counter_map = plan.sinks()
    telemetry._install_slo_sinks(observe_map, counter_map, plan.breach_active)


def active() -> Optional[SloPlan]:
    """The active plan: an installed one, else one parsed (and wired) from
    ``PERITEXT_SLO`` (re-parsed with fresh evaluators if the spec
    changes)."""
    global _env_plan, _env_spec
    if _installed is not None:
        return _installed
    spec = os.environ.get("PERITEXT_SLO")
    if not spec:
        return None
    if spec != _env_spec:
        # Parse BEFORE caching the spec: a malformed spec must raise on
        # every use, not once-then-silently-judge-nothing.
        _env_plan = SloPlan.from_spec(spec)
        _env_spec = spec
        _wire(_env_plan)
    return _env_plan


def install(plan: "SloPlan | str") -> SloPlan:
    """Install a plan process-wide (overrides any ``PERITEXT_SLO`` env)
    and wire its feed sinks into the telemetry plane.  Objectives only
    evaluate while collection is on — callers enable telemetry (env
    activation does both)."""
    global _installed
    if isinstance(plan, str):
        plan = SloPlan.from_spec(plan)
    _installed = plan
    _wire(plan)
    return plan


def reset() -> None:
    """Remove any installed plan, forget the env-parsed one, and clear the
    telemetry sinks (a spec still in the env re-parses with fresh
    evaluators on next use)."""
    global _installed, _env_plan, _env_spec
    _installed = None
    _env_plan = None
    _env_spec = None
    _wire(None)


@contextlib.contextmanager
def guarded(plan: "SloPlan | str"):
    """Scoped installation:
    ``with slo.guarded("ingest.launch:err_rate=0.1"):``."""
    global _installed
    prev = _installed
    current = install(plan)
    try:
        yield current
    finally:
        _installed = prev
        # Re-wire whatever is active now: the previous installed plan, or
        # — when none — the cached env plan (active() returns it without
        # re-wiring, so wiring `prev` alone would permanently disconnect
        # a PERITEXT_SLO env plan's sinks while summary() kept showing
        # its frozen objectives).
        _wire(prev if prev is not None else active())


def summary() -> Dict[str, Any]:
    """Per-objective verdicts for bench stamps and chaos footers (empty
    when no plan is active)."""
    plan = active()
    if plan is None:
        return {}
    return plan.summary()


def _activate_from_env() -> None:
    """Import-time activation: a ``PERITEXT_SLO`` spec in the environment
    wires its sinks and turns collection on (an objective that never sees
    events because telemetry stayed off would judge nothing, vacuously)."""
    if os.environ.get("PERITEXT_SLO"):
        active()  # parses + wires (raises loudly on a malformed spec)
        telemetry.enable()


_activate_from_env()
