"""Process-wide health plane: circuit-breaker launch gating + recovery.

A copy of ``peritext_tpu/runtime/health.py`` for the PyTorch port; its
breakers are the port's own.

The chaos plane (runtime/faults.py) made each ingest batch survive a faulty
device launch — retry/backoff/deadline, then oracle degradation.  What it
did NOT bound is the *fleet-level* cost of a backend that stays sick: a
backend wedged for hours charges
every subsequent batch the full ``PERITEXT_LAUNCH_RETRIES x
PERITEXT_LAUNCH_TIMEOUT`` budget before degrading.  This module factors the
fast-fail/recover decision out of the per-batch retry policy the same way
Collabs (PAPERS.md) factors delivery resilience out of the CRDT core:

- a :class:`CircuitBreaker` per fault **site** (the same site names the
  chaos plane uses) tracks launch outcomes in a rolling window;
- ``closed -> open`` on a consecutive-failure streak or a failure *rate*
  over the window.  While open, callers skip the whole retry budget and
  **fast-fail** (ingest drops straight into the oracle degrade path at
  degrade-only cost — no retries, no backoff sleeps, no deadline waits);
- ``open -> half_open`` after a jittered cool-down.  Half-open admits
  exactly ONE **canary** launch; concurrent callers keep fast-failing;
- ``half_open -> closed`` when the canary succeeds (the fleet rehydrates
  onto the device fast path), back to ``open`` with a fresh cool-down when
  it fails.

The clock is injectable, so tests drive transitions deterministically
(seeded ``FaultPlan`` ``wedge=TxN`` schedules + a fake clock), and the
cool-down jitter comes from a ``random.Random`` seeded per (plan seed,
site) — two runs of the same schedule open and close at the same instants.

Enable via ``PERITEXT_BREAKER=<spec>`` (the ``PERITEXT_FAULTS`` grammar)
or programmatically::

    PERITEXT_BREAKER="seed=7;device_launch:threshold=3,cooldown=5,jitter=0.2"

    with health.guarded("device_launch:threshold=1,cooldown=0.1"):
        uni.apply_changes(...)

Parameters per site: ``threshold=N`` (consecutive failures to trip;
default 3), ``window=N`` / ``rate=P`` (trip when the last N outcomes are
>= P failures; default 16 / 1.0), ``cooldown=T`` (base cool-down seconds;
default 1.0), ``jitter=P`` (cool-down randomized up to ``+P`` fraction;
default 0.1).

With no plan active every hook returns ``None``/``ALLOW`` at one
dict-lookup cost, so production paths without a breaker stay free.  Every
``CircuitBreaker.stats`` increment mirrors into the telemetry registry as
``health.<site>.<key>`` exactly (tests assert tally equality), fast-fails
additionally bump the aggregate ``health.fastfail`` counter, and every
transition updates the ``health.breaker.state`` /
``health.breaker.<site>.state`` gauges (0 closed, 1 half-open, 2 open).
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from peritext_tpu_torch.runtime import faults, telemetry

# Breaker states (gauge numerics chosen so "bigger = sicker").
CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
_STATE_NUM = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# admit() decisions.
ALLOW = "allow"  # closed: launch normally under the full retry budget
CANARY = "canary"  # half-open: exactly one probe launch, no retries
FASTFAIL = "fastfail"  # open: skip the budget, degrade immediately

_STAT_KEYS = (
    "fastfails",
    "trips",
    "half_opens",
    "closes",
    "canary_failures",
    "successes",
    "failures",
)


class BreakerOpenError(RuntimeError):
    """A launch was fast-failed by an open circuit breaker (no attempt was
    made against the backend; the retry/backoff/timeout budget was not
    charged)."""

    def __init__(self, site: str, remaining: Optional[float] = None):
        msg = f"circuit breaker open for site {site!r}"
        if remaining is not None:
            msg += f" (cool-down: {remaining:.3f}s remaining)"
        super().__init__(msg)
        self.site = site


class CircuitBreaker:
    """One site's breaker state machine (thread-safe; injectable clock)."""

    def __init__(
        self,
        site: str,
        *,
        threshold: int = 3,
        window: int = 16,
        rate: float = 1.0,
        cooldown: float = 1.0,
        jitter: float = 0.1,
        clock: Optional[Callable[[], float]] = None,
        seed: int = 0,
    ) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"rate must be in (0, 1], got {rate}")
        if cooldown < 0 or jitter < 0:
            raise ValueError("cooldown and jitter must be >= 0")
        self.site = site
        self.threshold = threshold
        self.rate = rate
        self.cooldown = cooldown
        self.jitter = jitter
        self._clock = clock if clock is not None else time.monotonic
        self._rng = random.Random(f"{seed}/{site}")
        self._lock = threading.RLock()
        self._window: deque = deque(maxlen=window)
        self._consec = 0
        self._canary_inflight = False
        self._open_until = 0.0
        self.state = CLOSED
        self.stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}

    # -- bookkeeping (all called under self._lock) ---------------------------

    def _stat(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        # Mirror exactly into the registry (the faults.py convention:
        # same schedule + call order => same counts on both planes).
        if telemetry.enabled:
            telemetry.counter(f"health.{self.site}.{key}", n)

    def _set_state(self, state: str) -> None:
        self.state = state
        if telemetry.enabled:
            telemetry.gauge(f"health.breaker.{self.site}.state", _STATE_NUM[state])
            telemetry.gauge("health.breaker.state", _STATE_NUM[state])

    def _trip_locked(self) -> Dict[str, Any]:
        # Jittered cool-down: deterministic given the plan seed and the
        # trip sequence (one rng draw per trip).
        span = self.cooldown * (1.0 + self.jitter * self._rng.random())
        self._open_until = self._clock() + span
        self._set_state(OPEN)
        # A trip is the definitional post-mortem moment: the backend just
        # crossed from "flaky" to "sick".  The ring event lands here (O(1)
        # under our lock); the black-box dump — snapshot + file I/O — is
        # returned to the caller to run AFTER the lock releases, so a slow
        # disk cannot stall every concurrent admit()/record on this site
        # behind the post-mortem write.
        if telemetry.enabled:
            telemetry.record(
                "health.trip", outcome="open", breaker=self.site, cooldown_s=span
            )
        return {
            "site": self.site,
            "cooldown_s": span,
            "consecutive_failures": self._consec,
            "stats": dict(self.stats),
        }

    def _should_trip_locked(self) -> bool:
        if self._consec >= self.threshold:
            return True
        if len(self._window) == self._window.maxlen:
            fails = sum(1 for ok in self._window if not ok)
            return fails / len(self._window) >= self.rate
        return False

    # -- the caller-facing protocol ------------------------------------------

    def admit(self) -> str:
        """Gate one launch: ALLOW (closed), CANARY (half-open probe — granted
        to exactly one caller per half-open period), or FASTFAIL (open, or a
        canary is already in flight)."""
        with self._lock:
            if self.state == OPEN:
                if self._clock() >= self._open_until:
                    self._stat("half_opens")
                    self._set_state(HALF_OPEN)
                else:
                    self._stat("fastfails")
                    if telemetry.enabled:
                        telemetry.counter("health.fastfail")
                        telemetry.record(
                            "health.fastfail", outcome="open", breaker=self.site
                        )
                    return FASTFAIL
            if self.state == HALF_OPEN:
                if self._canary_inflight:
                    self._stat("fastfails")
                    if telemetry.enabled:
                        telemetry.counter("health.fastfail")
                        telemetry.record(
                            "health.fastfail", outcome="canary_inflight", breaker=self.site
                        )
                    return FASTFAIL
                self._canary_inflight = True
                return CANARY
            return ALLOW

    def record_success(self) -> None:
        """A launch completed (readback-verified where the caller does so).
        Closes the breaker when this was the half-open canary."""
        with self._lock:
            self._stat("successes")
            self._consec = 0
            self._window.append(True)
            self._canary_inflight = False
            if self.state == HALF_OPEN:
                # Recovery: the rolling history predates the outage and must
                # not re-trip the fresh circuit.
                self._window.clear()
                self._stat("closes")
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        """A launch attempt failed with a transient (retryable) error."""
        dump_info: Optional[Dict[str, Any]] = None
        with self._lock:
            self._stat("failures")
            self._consec += 1
            self._window.append(False)
            if self.state == HALF_OPEN:
                # The canary failed: back to open with a fresh cool-down.
                self._canary_inflight = False
                self._stat("canary_failures")
                dump_info = self._trip_locked()
            elif self.state == CLOSED and self._should_trip_locked():
                self._stat("trips")
                dump_info = self._trip_locked()
        if dump_info is not None:
            # Post-mortem dump outside the breaker lock (no-op unless
            # PERITEXT_BLACKBOX is armed; names the tripped site).  The
            # dedupe key is per site: a trip storm on one site writes one
            # dump per cooldown, without suppressing another site's first
            # trip (the cooldown is shared per site, not global).
            telemetry.blackbox_dump(
                "breaker_trip",
                dedupe_key=f"breaker_trip:{self.site}",
                **dump_info,
            )

    def abandon(self) -> None:
        """Release a canary slot without recording an outcome (the launch
        died on a SEMANTIC error — no evidence about backend health)."""
        with self._lock:
            self._canary_inflight = False

    def cooldown_remaining(self) -> float:
        """Seconds until an open breaker will half-open (0 when not open)."""
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(0.0, self._open_until - self._clock())

    def set_param(self, action: str, value: str) -> None:
        """Apply one spec ``action=value`` pair (PERITEXT_BREAKER grammar)."""
        if action == "threshold":
            self.threshold = int(value)
            if self.threshold < 1:
                raise ValueError(f"threshold must be >= 1, got {value}")
        elif action == "window":
            n = int(value)
            if n < 1:
                raise ValueError(f"window must be >= 1, got {value}")
            self._window = deque(self._window, maxlen=n)
        elif action == "rate":
            self.rate = float(value)
            if not 0.0 < self.rate <= 1.0:
                raise ValueError(f"rate must be in (0, 1], got {value}")
        elif action == "cooldown":
            self.cooldown = float(value)
            if self.cooldown < 0:
                raise ValueError(f"cooldown must be >= 0, got {value}")
        elif action == "jitter":
            self.jitter = float(value)
            if self.jitter < 0:
                raise ValueError(f"jitter must be >= 0, got {value}")
        else:
            raise ValueError(f"unknown breaker parameter {action!r}")

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"state": self.state}
            out.update(self.stats)
            return out


class HealthPlan:
    """A set of per-site breakers (the health-plane analog of FaultPlan)."""

    def __init__(self, seed: int = 0, clock: Optional[Callable[[], float]] = None) -> None:
        self.seed = seed
        self.clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}

    def site(self, name: str, **params: Any) -> CircuitBreaker:
        if name not in faults.KNOWN_SITES:
            # Same rationale as FaultPlan.site: a typo'd site would gate
            # nothing and let a resilience test pass vacuously.
            raise ValueError(
                f"unknown breaker site {name!r}; known sites: "
                f"{', '.join(faults.KNOWN_SITES)}"
            )
        br = self._breakers.get(name)
        if br is None:
            br = self._breakers[name] = CircuitBreaker(
                name, clock=self.clock, seed=self.seed
            )
        for action, value in params.items():
            br.set_param(action, str(value))
        return br

    def breaker(self, name: str) -> Optional[CircuitBreaker]:
        return self._breakers.get(name)

    @classmethod
    def from_spec(
        cls,
        spec: str,
        seed: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> "HealthPlan":
        """Parse the ``PERITEXT_BREAKER`` grammar (same shape as
        ``PERITEXT_FAULTS``: ``seed=N`` clauses and
        ``site:param=value[,param=value...]`` clauses, ``;``-separated)."""
        plan = cls(seed=seed if seed is not None else 0, clock=clock)
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed=") and ":" not in clause:
                if seed is None:
                    plan.seed = int(clause[5:])
                continue
            site_name, sep, actions = clause.partition(":")
            if not sep or not actions:
                raise ValueError(
                    f"bad breaker clause {clause!r} (want site:param=value[,...])"
                )
            br = plan.site(site_name.strip())
            for part in actions.split(","):
                action, sep, value = part.partition("=")
                if not sep:
                    raise ValueError(
                        f"bad breaker parameter {part!r} in clause {clause!r}"
                    )
                br.set_param(action.strip(), value.strip())
        # Re-seed every breaker with the final plan seed (a ``seed=N``
        # clause may appear after a site clause; jitter must not depend on
        # clause order).
        for br in plan._breakers.values():
            br._rng = random.Random(f"{plan.seed}/{br.site}")
        return plan

    def summary(self) -> Dict[str, Any]:
        return {name: br.summary() for name, br in self._breakers.items()}


# -- the process-wide plan ---------------------------------------------------

_installed: Optional[HealthPlan] = None
_env_plan: Optional[HealthPlan] = None
_env_spec: Optional[str] = None


def active() -> Optional[HealthPlan]:
    """The active plan: an installed one, else one parsed from
    ``PERITEXT_BREAKER`` (re-parsed with fresh state if the spec changes)."""
    global _env_plan, _env_spec
    if _installed is not None:
        return _installed
    spec = os.environ.get("PERITEXT_BREAKER")
    if not spec:
        return None
    if spec != _env_spec:
        # Parse BEFORE caching the spec: a malformed spec must raise on
        # EVERY use, not once — otherwise the breaker silently gates
        # nothing for the rest of the process (the vacuous-pass mode
        # plan.site() exists to prevent).
        _env_plan = HealthPlan.from_spec(spec)
        _env_spec = spec
    return _env_plan


def install(plan: "HealthPlan | str") -> HealthPlan:
    """Install a plan process-wide (overrides any ``PERITEXT_BREAKER`` env)."""
    global _installed
    if isinstance(plan, str):
        plan = HealthPlan.from_spec(plan)
    _installed = plan
    return plan


def reset() -> None:
    """Remove any installed plan and forget the env-parsed one (a spec still
    in the env re-parses with pristine breakers on next use)."""
    global _installed, _env_plan, _env_spec
    _installed = None
    _env_plan = None
    _env_spec = None


@contextlib.contextmanager
def guarded(plan: "HealthPlan | str"):
    """Scoped installation: ``with health.guarded("device_launch:threshold=1"):``."""
    global _installed
    prev = _installed
    current = install(plan)
    try:
        yield current
    finally:
        _installed = prev


def breaker(site: str) -> Optional[CircuitBreaker]:
    """The active breaker for a site, or None (the common no-plan case)."""
    plan = active()
    if plan is None:
        return None
    return plan.breaker(site)


def summary() -> Dict[str, Any]:
    """Per-site breaker state + tallies for bench lines and chaos footers
    (empty when no plan is active — callers stamp it only when non-empty)."""
    plan = active()
    if plan is None:
        return {}
    return plan.summary()
