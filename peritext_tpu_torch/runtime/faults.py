"""Process-wide deterministic fault injection (the chaos plane).

A copy of ``peritext_tpu/runtime/faults.py`` for the PyTorch port, with the
same plan grammar, sites and ``retryable`` classification: torch's CUDA
errors (``torch.cuda.OutOfMemoryError`` included) subclass ``RuntimeError``
and so retry.  A plan armed here does not reach the JAX package's plane.

Peritext's correctness claim is convergence under arbitrary delivery orders,
duplication, and loss — and on an accelerator the failure modes to plan for
are a wedged backend, an asynchronous error that surfaces only at the next
synchronization, or mid-run device death.  This module
makes those failures reproducible: a seeded :class:`FaultPlan` holds one
schedule per named **site**, and the runtime fires the sites at its natural
chokepoints:

========================  ====================================================
site                      fired from
========================  ====================================================
``device_launch``         every kernel launch attempt (ops/universe.py,
                          ops/doc.py local generation)
``device_readback``       the host readback barrier — the only honest
                          completion signal (ops/universe.py
                          strict-commit / per-attempt deadline, ops/doc.py
                          anchor queries)
``pubsub_deliver``        per-subscriber delivery (runtime/pubsub.py)
``queue_flush``           outbound batch flush (runtime/queue.py)
``checkpoint_write``      snapshot save (runtime/checkpoint.py)
``log_append``            durable change-log append (runtime/log.py)
``serve_admit``           serving-plane session admission (runtime/serve.py;
                          ``fail``/``wedge`` hit the submit call,
                          drop/dup/reorder filter the submitted changes)
``shard_migrate``         live session migration between serving shards
                          (runtime/elastic.py; ``fail``/``wedge`` hit every
                          protocol step — drain, export, provision, import,
                          commit — and drop/dup/reorder filter the parked
                          submissions replayed onto the target shard)
``doc_evict``             session eviction to durable checkpoint
                          (runtime/lifecycle.py; ``fail``/``wedge`` hit every
                          protocol step — drain, export, persist, commit —
                          and ``corrupt=N`` truncates the just-written
                          generation npz, the crash-corruption drill)
``doc_hydrate``           cold-session hydration from checkpoint
                          (runtime/lifecycle.py; ``fail``/``wedge`` hit every
                          protocol step — provision, load, import, replay,
                          commit — and drop/dup/reorder filter the parked
                          deliveries replayed at commit)
========================  ====================================================

Schedules per site (all deterministic given the plan seed and call order):

- ``fail=N`` — the next N fires raise :class:`FaultError`.
- ``wedge=TxN`` — the next N fires sleep T seconds first (default N=1);
  models a wedged backend (pairs with ``PERITEXT_LAUNCH_TIMEOUT``).
- ``drop=P`` / ``dup=P`` / ``reorder=P`` — per-message probabilities for
  stream sites (:func:`filter_stream`); reordered messages are held back and
  re-emerge on later calls for the same stream.
- ``corrupt=N`` — consumed by the site's writer (checkpoint save truncates
  the written npz), for crash-corruption drills.

Enable via ``PERITEXT_FAULTS=<spec>`` or programmatically::

    PERITEXT_FAULTS="seed=7;device_launch:fail=2;pubsub_deliver:drop=0.3,dup=0.1"

    with faults.injected("device_launch:fail=1"):
        uni.apply_changes(...)   # first launch attempt fails, retry succeeds

Sites fire as no-ops when no plan is active, so production paths pay one
module-attribute check.  Counters live on the plan (``plan.stats``), so chaos
tests can assert exactly how many faults actually landed.
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from peritext_tpu_torch.runtime import telemetry

KNOWN_SITES = (
    "device_launch",
    "device_readback",
    "pubsub_deliver",
    "queue_flush",
    "checkpoint_write",
    "log_append",
    "serve_admit",
    "shard_migrate",
    "doc_evict",
    "doc_hydrate",
)

_STAT_KEYS = ("fired", "failed", "wedged", "dropped", "duplicated", "reordered", "corrupted")


class FaultError(RuntimeError):
    """An injected failure (always classified as transient/retryable)."""

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at site {site!r}")
        self.site = site


def retryable(exc: BaseException) -> bool:
    """Transient-failure classification shared by every retry policy in the
    runtime: injected faults, backend/runtime errors (XlaRuntimeError
    subclasses RuntimeError), OS-level failures and deadline misses are
    worth retrying; semantic errors (ValueError/TypeError/KeyError — bad
    ops, gate violations) and NotImplementedError are permanent."""
    if isinstance(exc, FaultError):
        return True
    if isinstance(exc, NotImplementedError):
        return False
    return isinstance(exc, (RuntimeError, OSError, TimeoutError))


class SiteRule:
    """One site's fault schedule (mutable counters, guarded by the plan lock)."""

    __slots__ = ("fail", "wedge_seconds", "wedge", "drop", "dup", "reorder", "corrupt")

    def __init__(self) -> None:
        self.fail = 0  # remaining fires that raise
        self.wedge_seconds = 0.0
        self.wedge = 0  # remaining fires that sleep first
        self.drop = 0.0  # per-message probabilities
        self.dup = 0.0
        self.reorder = 0.0
        self.corrupt = 0  # remaining corrupt-on-write events

    def set_action(self, action: str, value: str) -> None:
        if action == "fail":
            self.fail = int(value)
        elif action == "wedge":
            secs, _, count = value.partition("x")
            self.wedge_seconds = float(secs)
            self.wedge = int(count) if count else 1
        elif action == "drop":
            self.drop = float(value)
        elif action == "dup":
            self.dup = float(value)
        elif action == "reorder":
            self.reorder = float(value)
        elif action == "corrupt":
            self.corrupt = int(value)
        else:
            raise ValueError(f"unknown fault action {action!r}")


class FaultPlan:
    """A seeded set of per-site fault schedules.

    Deterministic: probabilistic decisions come from one ``random.Random``
    per (site, stream) seeded from the plan seed, and counted schedules
    (fail/wedge/corrupt) decrement on each event — the same call sequence
    always injects the same faults.
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rules: Dict[str, SiteRule] = {}
        self._rngs: Dict[Any, random.Random] = {}
        self._held: Dict[Any, List[Any]] = {}
        self._lock = threading.RLock()
        self.stats: Dict[str, Dict[str, int]] = {}

    # -- construction -------------------------------------------------------

    def site(self, name: str) -> SiteRule:
        if name not in KNOWN_SITES:
            # A typo'd site name would otherwise inject nothing and let a
            # chaos run pass vacuously — fail at plan-construction time.
            raise ValueError(
                f"unknown fault site {name!r}; known sites: {', '.join(KNOWN_SITES)}"
            )
        rule = self._rules.get(name)
        if rule is None:
            rule = self._rules[name] = SiteRule()
        return rule

    def with_site(self, name: str, **actions: Any) -> "FaultPlan":
        """Programmatic spec: ``plan.with_site("device_launch", fail=2)``."""
        rule = self.site(name)
        for action, value in actions.items():
            rule.set_action(action, str(value))
        return self

    @classmethod
    def from_spec(cls, spec: str, seed: Optional[int] = None) -> "FaultPlan":
        """Parse the ``PERITEXT_FAULTS`` grammar.

        ``spec ::= clause (";" clause)*``;  a clause is either ``seed=N`` or
        ``site:action=value[,action=value...]``.
        """
        plan = cls(seed=seed if seed is not None else 0)
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
                    f"bad fault clause {clause!r} (want site:action=value[,...])"
                )
            rule = plan.site(site_name.strip())
            for part in actions.split(","):
                action, sep, value = part.partition("=")
                if not sep:
                    raise ValueError(f"bad fault action {part!r} in clause {clause!r}")
                rule.set_action(action.strip(), value.strip())
        return plan

    # -- bookkeeping ---------------------------------------------------------

    def _stat(self, site: str, key: str, n: int = 1) -> None:
        stats = self.stats.setdefault(site, {k: 0 for k in _STAT_KEYS})
        stats[key] += n
        # Mirror every landed fault into the telemetry registry
        # (``faults.<site>.<key>``): seeded chaos runs become
        # self-describing, and tests assert the two tallies agree exactly
        # (same seed + call order ⇒ same counts on both planes).
        if telemetry.enabled:
            telemetry.counter(f"faults.{site}.{key}", n)

    def _rng(self, site: str, stream: str) -> random.Random:
        key = (site, stream)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(f"{self.seed}/{site}/{stream}")
        return rng

    # -- the injection points ------------------------------------------------

    def fire(self, site: str) -> None:
        """Control-point hook: may sleep (wedge) and/or raise (fail)."""
        with self._lock:
            rule = self._rules.get(site)
            if rule is None:
                return
            self._stat(site, "fired")
            wedge = 0.0
            if rule.wedge > 0:
                rule.wedge -= 1
                wedge = rule.wedge_seconds
                self._stat(site, "wedged")
            failing = rule.fail > 0
            if failing:
                rule.fail -= 1
                self._stat(site, "failed")
        # Sleep outside the lock: a wedge must not serialize other sites.
        if wedge:
            time.sleep(wedge)
        if failing:
            raise FaultError(site)

    def take(self, site: str, action: str) -> bool:
        """Consume one counted event of ``action`` (used for ``corrupt``)."""
        with self._lock:
            rule = self._rules.get(site)
            if rule is None:
                return False
            if action == "corrupt" and rule.corrupt > 0:
                rule.corrupt -= 1
                self._stat(site, "corrupted")
                return True
            return False

    def filter_stream(self, site: str, items: Iterable[Any], stream: str = "") -> List[Any]:
        """Apply drop/dup/reorder schedules to a message batch.

        Reordered messages are held back in a per-(site, stream) buffer and
        re-emerge (ahead of newer traffic, coin-flipped per call) on later
        calls for the same stream; :meth:`drain` flushes the leftovers for a
        final fault-free sync.
        """
        items = list(items)
        with self._lock:
            rule = self._rules.get(site)
            if rule is None or not (rule.drop or rule.dup or rule.reorder):
                return items
            rng = self._rng(site, stream)
            key = (site, stream)
            held = self._held.get(key, [])
            out: List[Any] = []
            still: List[Any] = []
            for it in held:
                (out if rng.random() < 0.5 else still).append(it)
            for it in items:
                if rule.drop and rng.random() < rule.drop:
                    self._stat(site, "dropped")
                    continue
                if rule.reorder and rng.random() < rule.reorder:
                    still.append(it)
                    self._stat(site, "reordered")
                    continue
                out.append(it)
                if rule.dup and rng.random() < rule.dup:
                    out.append(it)
                    self._stat(site, "duplicated")
            if rule.reorder and len(out) > 1 and rng.random() < rule.reorder:
                i = rng.randrange(len(out) - 1)
                out[i], out[i + 1] = out[i + 1], out[i]
            if still:
                self._held[key] = still
            else:
                self._held.pop(key, None)
            return out

    def drain(self, site: str, stream: str = "") -> List[Any]:
        """Release every held-back (reordered) message for a stream."""
        with self._lock:
            return self._held.pop((site, stream), [])

    def pending(self, site: str) -> int:
        """Total held-back messages across a site's streams."""
        with self._lock:
            return sum(len(v) for (s, _), v in self._held.items() if s == site)


# -- the process-wide plan ---------------------------------------------------

_installed: Optional[FaultPlan] = None
_env_plan: Optional[FaultPlan] = None
_env_spec: Optional[str] = None


def active() -> Optional[FaultPlan]:
    """The active plan: an installed one, else one parsed from
    ``PERITEXT_FAULTS`` (re-parsed with fresh counters if the spec changes)."""
    global _env_plan, _env_spec
    if _installed is not None:
        return _installed
    spec = os.environ.get("PERITEXT_FAULTS")
    if not spec:
        return None
    if spec != _env_spec:
        # Parse BEFORE caching the spec: a malformed spec must raise on
        # every use, not once-then-silently-inject-nothing.
        _env_plan = FaultPlan.from_spec(spec)
        _env_spec = spec
    return _env_plan


def install(plan: "FaultPlan | str") -> FaultPlan:
    """Install a plan process-wide (overrides any ``PERITEXT_FAULTS`` env)."""
    global _installed
    if isinstance(plan, str):
        plan = FaultPlan.from_spec(plan)
    _installed = plan
    return plan


def reset() -> None:
    """Remove any installed plan and forget the env-parsed one (so a spec
    still in the env re-parses with fresh counters on next use)."""
    global _installed, _env_plan, _env_spec
    _installed = None
    _env_plan = None
    _env_spec = None


@contextlib.contextmanager
def injected(plan: "FaultPlan | str"):
    """Scoped installation: ``with faults.injected("device_launch:fail=1"):``."""
    global _installed
    prev = _installed
    current = install(plan)
    try:
        yield current
    finally:
        _installed = prev


def fire(site: str) -> None:
    plan = active()
    if plan is not None:
        plan.fire(site)


def filter_stream(site: str, items: Iterable[Any], stream: str = "") -> List[Any]:
    plan = active()
    if plan is None:
        return list(items)
    return plan.filter_stream(site, items, stream)


def take(site: str, action: str) -> bool:
    plan = active()
    return plan is not None and plan.take(site, action)
