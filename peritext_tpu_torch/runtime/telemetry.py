"""Process-wide telemetry plane: metrics registry + span tracer.

A copy of ``peritext_tpu/runtime/telemetry.py`` for the PyTorch port (the
port imports nothing of the JAX package); its late imports name the
port's ``health`` and ``slo``, and its registry is the port's own.

Until this module existed the only windows into runtime behavior were the
ad-hoc ``TorchUniverse.stats`` dict, ``FaultPlan.stats`` on the chaos plane,
and the one-line bench JSON — questions like "how many launches retried",
"which merge path actually ran", or "did the cohort pipeline overlap" took
printf archaeology.  This module is the shared substrate every layer
reports through:

- a **metrics registry**: monotonic counters, last/max gauges, and
  histograms with fixed log2 buckets (64 buckets; bucket *i* counts values
  in ``[2**(i-33), 2**(i-32))``, exact over ``[2**-32, 2**30)`` — sub-ns
  to ~34-year durations — with explicit ``"<=-32"`` / ``">=31"`` overflow
  buckets at the ends; larger magnitudes belong in counters);
- a **span tracer**: ``with telemetry.span("ingest.launch"): ...`` records
  a Chrome trace-event-format *complete event* (``"ph": "X"``) with
  monotonic microsecond timestamps and the recording thread's id, so
  nested spans render as flame stacks per thread in Perfetto /
  chrome://tracing.  Every span also lands in the registry as a
  ``span.<name>.seconds`` histogram;
- a **causal flow plane**: a :class:`TraceContext` (monotonic id — no
  wall-clock entropy) is minted where a change enters the system
  (``ChangeQueue.enqueue``, ``TorchDoc.change``, ``Publisher.publish``,
  cohort launch) and threaded through every seam it crosses, emitting
  Chrome *flow events* (``ph: s/t/f``) bound to the enclosing span, so
  Perfetto draws one arrow-connected lane per change across threads.
  The terminal seam feeds end-to-end latency histograms
  (``e2e.enqueue_to_applied``, ``e2e.publish_to_delivered``, ...).
  Propagation is thread-local (:func:`flowing` / :func:`current_flows`)
  so deep seams (ingest retries, degradation, readback) join the lane
  without threading a context argument through every signature;
- a **flight recorder**: a fixed-capacity ring of recent structured
  events (site, flow id, outcome, µs) that is always recording while
  telemetry is enabled.  On a failure worth a post-mortem (launch-budget
  exhaustion, breaker trip, checkpoint corruption, unhandled ingest
  exception, SLO breach) :func:`blackbox_dump` writes the ring + a
  registry snapshot to ``PERITEXT_BLACKBOX=<dir>`` — the post-mortem for
  the wedged-backend failure mode where the atexit-only dump dies with the
  process.  Dumps are **rate-limited per reason** (30 s by default): a
  breach or trip storm
  writes one dump per reason per cooldown instead of eating the 32-dump
  cap before the interesting dump lands (skips count as
  ``blackbox.deduped``);
- **tail-sampled flow tracing** (:func:`set_trace_sampling`): with head
  sampling
  below 1.0 the flow plane buffers each lane's events instead of writing
  them, and decides at the terminal seam — a lane is kept when its flow
  id head-samples in, OR (tail rules) when it was slow, touched an
  error/retry/degrade seam, or terminated while an SLO breach was active.
  Interesting lanes therefore survive at 100% even at ``SAMPLE=0``, which
  is what makes an always-on production tracer affordable
  (``trace.lanes_kept`` / ``trace.lanes_dropped`` count the verdicts;
  span/complete events are never sampled, so kept lanes still bind);
- an **SLO feed**: :mod:`peritext_tpu_torch.runtime.slo` registers sink maps via
  :func:`_install_slo_sinks`; :func:`counter` / :func:`observe` (and span
  exits) forward matching names to the active plan's sliding-window
  evaluators.  With no plan installed the cost is one module-attribute
  load + ``None`` check per already-enabled call;
- a **live status surface**: :func:`status` assembles one operator-facing
  JSON object — breaker states, queue depth/high-water, per-session serve
  lane depth + deficit, per-shard occupancy, the elastic and lifecycle
  blocks (via :func:`register_status_source`), windowed-merge engagement,
  per-SLO compliance/burn, and sampler verdicts.

  ``PERITEXT_STATUS=<path>`` writes it periodically (atomic tmp+rename,
  riding the metrics flusher thread) and at exit (:func:`dump_status`);
  ``scripts/ops_top.py`` renders the file live in a terminal.

Activation
==========

``PERITEXT_TRACE=<path>`` writes trace events as JSONL (one JSON object
per line; wrap with ``jq -s . trace.jsonl > trace.json`` for
chrome://tracing — Perfetto's importer reads the newline-delimited form
directly).  ``PERITEXT_METRICS=<path>`` dumps a JSON metrics snapshot at
interpreter exit; ``PERITEXT_METRICS_INTERVAL=<secs>`` additionally
flushes that snapshot periodically from a daemon thread (atomic
tmp+rename), so a killed or timed-out child leaves a recent snapshot
instead of nothing.  ``PERITEXT_BLACKBOX=<dir>`` arms the flight
recorder's failure dumps (a ring of the last 512 events).
``PERITEXT_STATUS=<path>`` arms the periodic status surface (cadence:
``PERITEXT_METRICS_INTERVAL``, 2 s when only the status path is set).  Any of these
env vars enables collection at import; tests and embedders call :func:`enable` /
:func:`disable` / :func:`reset` programmatically.

The overhead contract
=====================

Instrumented call sites sit inside the ingest hot loop, so the DISABLED
path must be near-free: every site guards on the single module attribute
:data:`enabled` —

    if telemetry.enabled:
        telemetry.counter("ingest.launch_retries")

— one attribute check, no call, no allocation, no lock taken.  (The
module-level helpers also re-check ``enabled`` internally, so unguarded
sites are merely slower, never wrong.)  ``span()`` when disabled returns a
shared no-op singleton, so even unguarded ``with telemetry.span(...)``
allocates nothing.  tests/test_telemetry.py pins both properties.

Enabled, the cost is one small dict update under a lock per event —
instrumentation is launch-level (per kernel launch / flush / cohort),
never per-op, so a telemetry-on run stays within a couple percent of
telemetry-off on the patched-fleet steady state.

Thread safety: all registry mutation happens under one lock (concurrent
``ChangeQueue`` timer flushes and foreground ingest cannot lose
increments), and each ``span()`` call returns a fresh span object, so
nested or cross-thread spans cannot corrupt one another.
"""
from __future__ import annotations

import atexit
import itertools
import json
import math
import os
import random
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# NOTE: `enabled` is deliberately NOT in __all__ — `from telemetry import
# enabled` would snapshot the flag at import time and make guards
# permanently dead.  The one correct spelling is the attribute form the
# docstring prescribes: `telemetry.enabled`.
__all__ = [
    "enable",
    "disable",
    "reset",
    "counter",
    "gauge",
    "gauge_max",
    "observe",
    "span",
    "snapshot",
    "summary",
    "dump_metrics",
    "dump_status",
    "flush_trace",
    "trace_path",
    "TraceContext",
    "flow",
    "flow_point",
    "flow_steps",
    "flowing",
    "current_flows",
    "current_flow",
    "flow_elapsed_s",
    "flow_keep",
    "set_trace_sampling",
    "sampling_active",
    "record",
    "recorder_events",
    "recorder_stats",
    "blackbox_dir",
    "blackbox_dump",
    "estimate_quantiles",
    "status",
    "register_status_source",
]

# THE hot-path gate (see the overhead contract above).
enabled = False

_N_BUCKETS = 64
_BUCKET_OFFSET = 32  # bucket i counts values v with frexp(v)[1] == i - 32


class _Histogram:
    """Fixed-log2-bucket histogram (+ count/sum/min/max)."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets = [0] * _N_BUCKETS

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if value > 0:
            i = min(_N_BUCKETS - 1, max(0, math.frexp(value)[1] + _BUCKET_OFFSET))
        else:
            i = 0  # non-positive values share the smallest bucket
        self.buckets[i] += 1

    def to_json(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            # Keyed by the bucket's upper-bound exponent: a value v landed
            # in bucket "e" iff 2**(e-1) <= v < 2**e.  The clamped end
            # buckets say so explicitly — "<=-32" holds everything below
            # 2**-32 (including non-positive values), ">=31" everything
            # from 2**30 up — so a snapshot can never silently claim an
            # out-of-range value sat inside a nominal bucket.
            "buckets": {
                (
                    "<=-32"
                    if i == 0
                    else ">=31"
                    if i == _N_BUCKETS - 1
                    else str(i - _BUCKET_OFFSET)
                ): c
                for i, c in enumerate(self.buckets)
                if c
            },
        }


def estimate_quantiles(
    hist_json: Dict[str, Any], qs: Sequence[float] = (0.5, 0.95, 0.99)
) -> Optional[Dict[str, float]]:
    """p-quantile estimates from a snapshot-format log2-bucket histogram.

    Works on the JSON form (so dumped snapshots and live ones estimate
    identically): each nominal bucket "e" holds values in [2**(e-1), 2**e);
    the estimate is the bucket's geometric midpoint, clamped to the
    histogram's observed [min, max].  The clamped end buckets estimate at
    the observed extreme on their side.  Returns {"p50": v, ...} or None
    for an empty histogram.
    """
    count = hist_json.get("count", 0)
    if not count:
        return None
    vmin, vmax = hist_json["min"], hist_json["max"]

    def bucket_key(item: Tuple[str, int]) -> int:
        k = item[0]
        if k == "<=-32":
            return -(10**6)
        if k == ">=31":
            return 10**6
        return int(k)

    buckets = sorted(hist_json["buckets"].items(), key=bucket_key)
    out: Dict[str, float] = {}
    for q in qs:
        target = q * count
        cum = 0
        est = vmax
        for k, c in buckets:
            cum += c
            if cum >= target:
                if k == "<=-32":
                    est = vmin
                elif k == ">=31":
                    est = vmax
                else:
                    est = 2.0 ** (int(k) - 0.5)  # geometric bucket midpoint
                break
        # %g keeps the label faithful to the requested quantile: 0.5 ->
        # "p50", 0.29 -> "p29" (int() would float-truncate to "p28"),
        # 0.999 -> "p99.9" (distinct from "p99", no silent collision).
        out["p%g" % (q * 100)] = min(max(est, vmin), vmax)
    return out


class Registry:
    """Thread-safe metrics store.  One process-wide instance lives in this
    module; tests may build private ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}

    def counter(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.to_json() for k, h in self._hists.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


class _Tracer:
    """Chrome trace-event JSONL writer (buffered, lock-guarded)."""

    _FLUSH_EVERY = 512

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._buf: List[str] = []
        self._file: Optional[Any] = open(path, "w")
        self._emit(
            {
                "name": "process_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": 0,
                "args": {"name": "peritext-tpu"},
            }
        )

    def _emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, separators=(",", ":"))
        with self._lock:
            if self._file is None:
                return
            self._buf.append(line)
            if len(self._buf) >= self._FLUSH_EVERY:
                self._flush_locked()

    def emit_complete(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        tid: int,
        args: Optional[Dict[str, Any]],
    ) -> None:
        event: Dict[str, Any] = {
            "name": name,
            "cat": "peritext",
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": os.getpid(),
            "tid": tid,
        }
        if args:
            event["args"] = args
        self._emit(event)

    def emit_flow(
        self,
        name: str,
        phase: str,
        flow_id: int,
        ts_us: float,
        tid: int,
        args: Optional[Dict[str, Any]],
    ) -> None:
        """One Chrome flow event (ph s/t/f).  Binding rule: the event
        attaches to the slice covering (pid, tid, ts) — callers emit from
        inside an open span, whose complete event (written later, at span
        exit) covers this timestamp."""
        event: Dict[str, Any] = {
            "name": name,
            "cat": "peritext.flow",
            "ph": phase,
            "id": flow_id,
            "ts": ts_us,
            "pid": os.getpid(),
            "tid": tid,
        }
        if phase == "f":
            # Bind the finish to the ENCLOSING slice (the default binds to
            # the next slice that begins, which here would be arbitrary).
            event["bp"] = "e"
        if args:
            event["args"] = args
        self._emit(event)

    def _flush_locked(self) -> None:
        if self._buf and self._file is not None:
            self._file.write("\n".join(self._buf) + "\n")
            self._file.flush()
            self._buf.clear()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None


class _NullSpan:
    """The disabled-path span: a shared, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.args = args
        self._t0 = 0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter_ns()
        # The span may outlive a disable() (e.g. a test tearing down while a
        # timer-thread flush is mid-span); record into whatever plane is
        # current — the registry/tracer never become invalid, only unused.
        secs = (t1 - self._t0) / 1e9
        hist_name = "span." + self.name + ".seconds"
        _registry.observe(hist_name, secs)
        sinks = _observe_sinks
        if sinks is not None:
            fn = sinks.get(hist_name)
            if fn is not None:
                fn(secs)
        tracer = _tracer
        if tracer is not None:
            tracer.emit_complete(
                self.name,
                self._t0 / 1e3,
                (t1 - self._t0) / 1e3,
                threading.get_ident(),
                self.args,
            )
        return False


# -- causal flow contexts -----------------------------------------------------

# Monotonic flow ids: allocation order IS causal mint order, deterministic
# given call order (no Date.now()-style wall entropy), and distinct across
# every plane in the process.
_flow_ids = itertools.count(1)
_flow_lock = threading.Lock()
_tls = threading.local()


class TraceContext:
    """One change-batch's causal identity, threaded across seams.

    ``id`` is the Chrome flow-event id; ``kind`` names the lane (the flow
    events' shared name); ``t0_ns`` is the mint time (perf_counter), so the
    terminal seam can feed the e2e latency histograms.  The phase machine
    (unstarted -> started -> finished) makes emission idempotent-safe: the
    first :func:`flow_point` emits ``s``, later ones ``t``, the terminal
    one ``f``, and anything after a finish is ignored — a retried flush
    cannot corrupt the triplet.
    """

    __slots__ = ("id", "kind", "t0_ns", "meta", "_phase", "_keep")

    def __init__(self, kind: str, meta: Optional[Dict[str, Any]] = None) -> None:
        self.id = next(_flow_ids)
        self.kind = kind
        self.t0_ns = time.perf_counter_ns()
        self.meta = meta
        self._phase = 0  # 0 unstarted, 1 started, 2 finished
        self._keep = False  # explicit tail-keep mark (flow_keep)


class _Flowing:
    """Scoped thread-local flow propagation (replace semantics: the inner
    scope's lanes are what downstream seams join)."""

    __slots__ = ("ctxs", "prev")

    def __init__(self, ctxs: Tuple["TraceContext", ...]) -> None:
        self.ctxs = ctxs
        self.prev: Tuple["TraceContext", ...] = ()

    def __enter__(self) -> "_Flowing":
        self.prev = getattr(_tls, "flows", ())
        _tls.flows = self.ctxs
        return self

    def __exit__(self, *exc: Any) -> bool:
        _tls.flows = self.prev
        return False


# -- flight recorder ----------------------------------------------------------


class _FlightRecorder:
    """Fixed-capacity ring of recent structured events.

    Preallocated slots, one lock, O(1) per record; overwrites count as
    ``dropped`` so post-mortems know how much history the ring held vs
    lost.  Never grows — the always-on cost is bounded by construction.
    """

    __slots__ = ("cap", "buf", "n", "dropped", "lock")

    def __init__(self, cap: int) -> None:
        self.cap = max(1, cap)
        self.buf: List[Any] = [None] * self.cap
        self.n = 0
        self.dropped = 0
        self.lock = threading.Lock()

    def record(
        self,
        t_us: float,
        site: str,
        flow_id: Optional[int],
        outcome: str,
        fields: Optional[Dict[str, Any]],
    ) -> None:
        with self.lock:
            if self.n >= self.cap:
                self.dropped += 1
            self.buf[self.n % self.cap] = (t_us, site, flow_id, outcome, fields)
            self.n += 1

    def events(self) -> List[Dict[str, Any]]:
        with self.lock:
            if self.n <= self.cap:
                items = list(self.buf[: self.n])
            else:
                i = self.n % self.cap
                items = list(self.buf[i:]) + list(self.buf[:i])
        out = []
        for t_us, site, flow_id, outcome, fields in items:
            event: Dict[str, Any] = {"ts_us": t_us, "site": site, "outcome": outcome}
            if flow_id is not None:
                event["flow"] = flow_id
            if fields:
                event["fields"] = fields
            out.append(event)
        return out


class _MetricsFlusher(threading.Thread):
    """Periodic metrics-snapshot + status flush (PERITEXT_METRICS_INTERVAL
    / PERITEXT_STATUS): the atexit dump dies exactly when it matters most
    (a killed child, a timed-out run); this daemon leaves a recent atomic
    snapshot — and the live ops status surface — behind instead.  Each
    tick writes whichever of the metrics/status paths are configured."""

    def __init__(self, interval: float) -> None:
        super().__init__(daemon=True, name="peritext-metrics-flusher")
        self.interval = interval
        self.stop_event = threading.Event()

    def run(self) -> None:
        while not self.stop_event.wait(self.interval):
            try:
                dump_metrics()
            except Exception:  # a full disk must not kill the flusher
                import logging

                logging.getLogger(__name__).warning(
                    "periodic metrics flush failed", exc_info=True
                )
            try:
                dump_status()
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "periodic status flush failed", exc_info=True
                )


# -- the process-wide plane ---------------------------------------------------

_registry = Registry()
_tracer: Optional[_Tracer] = None
_metrics_path: Optional[str] = None
_config_lock = threading.Lock()
_atexit_registered = False
_recorder: Optional[_FlightRecorder] = None
_blackbox_dir: Optional[str] = None
_blackbox_seq = itertools.count(1)
_MAX_BLACKBOX_DUMPS = 32
_BLACKBOX_RING = 512  # events the flight recorder keeps
# Per-reason black-box dump rate limiting: one
# dump per dedupe key per cooldown, so a breach/trip storm cannot exhaust
# the 32-dump cap before the interesting dump.  Keyed by reason (or an
# explicit dedupe key), judged on time.monotonic.
_dump_last: Dict[str, float] = {}
_DUMP_COOLDOWN_DEFAULT = 30.0
_flusher: Optional[_MetricsFlusher] = None
_status_path: Optional[str] = None

# -- tail-sampled tracing state ----------------------------------------------
# Head-sampling probability per flow lane (1.0 = emit everything directly,
# the historical behavior).  Below 1.0 the flow plane buffers lanes in
# _lane_buf and judges them at the terminal seam against the tail rules.
_sample_p = 1.0
_sample_seed = 0
_tail_slow_us: Optional[float] = None  # keep lanes slower than this
_tail_error = False  # keep lanes that touched an error/retry/degrade seam
_tail_breach = False  # keep lanes terminating while an SLO breach is active
_breach_probe: Optional[Callable[[], bool]] = None  # set by the SLO plane
# flow id -> [buffered emit_flow arg tuples, interesting flag].  Bounded:
# past _LANE_BUF_CAP open lanes the oldest is evicted (trace.lanes_evicted).
_lane_buf: Dict[int, List[Any]] = {}
_LANE_BUF_CAP = 4096

# -- SLO feed sinks -----------------------------------------------------------
# Installed by peritext_tpu_torch.runtime.slo: metric-name -> feed callable.
# None (the common case) costs one module-attribute load per enabled call.
_observe_sinks: Optional[Dict[str, Callable[[float], None]]] = None
_counter_sinks: Optional[Dict[str, Callable[[int], None]]] = None

# -- status surface -----------------------------------------------------------
# (kind, WeakMethod) pairs registered by live planes (serve, serve_shard,
# elastic, lifecycle); dead refs are pruned on read.
_status_sources: List[Tuple[str, Any]] = []


def counter(name: str, n: int = 1) -> None:
    """Add ``n`` to a monotonic counter (no-op while disabled).  With an
    SLO plan installed, names it watches also feed its evaluators."""
    if enabled:
        _registry.counter(name, n)
        sinks = _counter_sinks
        if sinks is not None:
            fn = sinks.get(name)
            if fn is not None:
                fn(n)


def gauge(name: str, value: float) -> None:
    """Set a last-value gauge (no-op while disabled)."""
    if enabled:
        _registry.gauge(name, value)


def gauge_max(name: str, value: float) -> None:
    """Raise a high-water-mark gauge (no-op while disabled)."""
    if enabled:
        _registry.gauge_max(name, value)


def observe(name: str, value: float) -> None:
    """Record a value into a log2-bucket histogram (no-op while disabled).
    With an SLO plan installed, names it watches also feed its
    evaluators."""
    if enabled:
        _registry.observe(name, value)
        sinks = _observe_sinks
        if sinks is not None:
            fn = sinks.get(name)
            if fn is not None:
                fn(value)


def span(name: str, **args: Any) -> Any:
    """Context manager timing a region.  Disabled: returns a shared no-op
    singleton (zero allocation).  Enabled: records a ``span.<name>.seconds``
    histogram entry and, when tracing, a Chrome complete event."""
    if not enabled:
        return _NULL_SPAN
    return _Span(name, args or None)


def flow(kind: str, **meta: Any) -> Optional[TraceContext]:
    """Mint a causal trace context (None while disabled — call sites keep
    the one-attr-check contract by guarding on ``telemetry.enabled``).
    ``meta`` rides on the flow's start event (change ids, actor, count)."""
    if not enabled:
        return None
    return TraceContext(kind, meta or None)


# Terminal/step args that mark a lane tail-interesting: failed or rejected
# outcomes, the oracle-degrade seam, and retry attempts (attempt >= 1).
# Every terminal failure outcome any seam emits belongs here — a missed
# spelling silently drops exactly the lanes a post-mortem needs (the
# emitters: serve resolve/shed/close, ingest launch/record, TorchDoc local
# rollback, stream sweep abort, queue drop).
_TAIL_BAD_OUTCOMES = frozenset(
    (
        "error",
        "rejected",
        "shed",
        "closed",
        "fail",
        "fastfail",
        "degraded",
        "rollback",
        "abort",
        "dropped",
    )
)


def _args_interesting(args: Optional[Dict[str, Any]]) -> bool:
    if not args:
        return False
    if args.get("outcome") in _TAIL_BAD_OUTCOMES:
        return True
    if args.get("path") == "degrade":
        return True
    attempt = args.get("attempt")
    return isinstance(attempt, int) and attempt >= 1


def _head_sampled(flow_id: int) -> bool:
    """Deterministic head-sampling verdict for one lane: a seeded hash of
    the flow id (mint order is deterministic under seeded chaos, so the
    same run keeps the same lanes)."""
    p = _sample_p
    if p >= 1.0:
        return True
    if p <= 0.0:
        return False
    return random.Random(f"{_sample_seed}/{flow_id}").random() < p


def flow_point(
    ctx: Optional[TraceContext], terminal: bool = False, **args: Any
) -> None:
    """Mark the current seam on a flow's lane (no-op for None / no tracer).

    MUST be called from inside an open :func:`span` — flow events bind to
    the slice covering their timestamp on this thread.  The first point
    emits the flow start (``s``), later ones steps (``t``), and
    ``terminal=True`` the finish (``f``); points after a finish are
    dropped, so retried seams cannot emit a second finish.

    With head sampling below 1.0 (:func:`set_trace_sampling`) the lane's
    events buffer instead, and the terminal point decides: head-sampled
    in, or retained by a tail rule (slow / error / breach-coincident), the
    whole lane flushes to the tracer; otherwise it drops
    (``trace.lanes_kept`` / ``trace.lanes_dropped``)."""
    if ctx is None:
        return
    tracer = _tracer
    if tracer is None:
        return
    now_us = time.perf_counter_ns() / 1e3
    with _flow_lock:
        phase0 = ctx._phase
        if phase0 == 2:
            return
        start = phase0 == 0
        ctx._phase = 2 if terminal else 1
    tid = threading.get_ident()
    events: List[Tuple[Any, ...]] = []
    if start:
        events.append((ctx.kind, "s", ctx.id, now_us, tid, ctx.meta))
    if terminal:
        events.append((ctx.kind, "f", ctx.id, now_us, tid, args or None))
    elif not start:
        events.append((ctx.kind, "t", ctx.id, now_us, tid, args or None))
    # Direct emission (the historical path) unless sampling is on.  The
    # `_lane_buf` check keeps a lane that STARTED buffered coherent if
    # sampling is reconfigured mid-lane: its remaining points keep
    # buffering, and the terminal verdict (p=1 head-samples everything in)
    # emits the whole lane.
    if _sample_p >= 1.0 and not _lane_buf:
        for ev in events:
            tracer.emit_flow(*ev)
        return
    _buffer_flow(tracer, ctx, events, args or None, terminal)


def _buffer_flow(
    tracer: "_Tracer",
    ctx: TraceContext,
    events: List[Tuple[Any, ...]],
    args: Optional[Dict[str, Any]],
    terminal: bool,
) -> None:
    keep = None
    with _flow_lock:
        buf = _lane_buf.get(ctx.id)
        if buf is None:
            if len(_lane_buf) >= _LANE_BUF_CAP:
                # Evict the oldest still-open lane (insertion order): a
                # leak of never-terminated lanes must not grow unbounded.
                oldest = next(iter(_lane_buf))
                del _lane_buf[oldest]
                if enabled:
                    _registry.counter("trace.lanes_evicted")
            buf = _lane_buf[ctx.id] = [events, False]
        else:
            buf[0].extend(events)
        if args is not None and _args_interesting(args):
            buf[1] = True
        if not terminal:
            return
        lane_events, interesting = _lane_buf.pop(ctx.id)
        interesting = interesting or ctx._keep
        keep = _head_sampled(ctx.id)
        if not keep and _tail_error and interesting:
            keep = True
        if not keep and _tail_slow_us is not None:
            keep = (time.perf_counter_ns() - ctx.t0_ns) / 1e3 >= _tail_slow_us
        if not keep and _tail_breach:
            probe = _breach_probe
            if probe is not None:
                try:
                    keep = bool(probe())
                except Exception:
                    keep = True  # a broken probe must not drop evidence
    # Emission + counters outside _flow_lock (the tracer has its own lock).
    if keep:
        for ev in lane_events:
            tracer.emit_flow(*ev)
    if enabled:
        _registry.counter("trace.lanes_kept" if keep else "trace.lanes_dropped")


def flow_keep(ctx: Optional[TraceContext] = None) -> None:
    """Explicitly mark a lane (default: every lane scoped onto this
    thread) as tail-interesting, guaranteeing retention under tail
    sampling's ``error`` rule regardless of what args its seams carried.
    The degrade/fast-fail seams call this so a sampled production trace
    can never lose a failed lane.  No-op while disabled."""
    if not enabled:
        return
    if ctx is not None:
        ctx._keep = True
        return
    for c in getattr(_tls, "flows", ()):
        c._keep = True


def set_trace_sampling(
    sample: Optional[float] = None,
    tail: Optional[str] = None,
    seed: Optional[int] = None,
) -> None:
    """Configure flow-lane sampling (``PERITEXT_TRACE_SAMPLE`` /
    ``PERITEXT_TRACE_TAIL`` / ``PERITEXT_TRACE_SAMPLE_SEED``).

    ``sample`` is the head-sampling probability per lane, clamped to
    [0, 1]; 1.0 restores direct emission.  ``tail`` is a ``|``-separated
    rule list — ``slow:<ms>`` (keep lanes at least that slow), ``error``
    (keep lanes that touched an error/retry/degrade seam or were
    :func:`flow_keep`-marked), ``breach`` (keep lanes terminating while an
    SLO breach is active); the empty string clears the rules.  Unknown
    rules raise ValueError (a typo'd spec must not silently sample
    everything away)."""
    global _sample_p, _sample_seed, _tail_slow_us, _tail_error, _tail_breach
    with _config_lock:
        if sample is not None:
            _sample_p = min(1.0, max(0.0, float(sample)))
        if seed is not None:
            _sample_seed = int(seed)
        if tail is not None:
            slow_us: Optional[float] = None
            error = breach = False
            for term in tail.split("|"):
                term = term.strip()
                if not term:
                    continue
                if term.startswith("slow:"):
                    slow_us = float(term[5:]) * 1e3
                elif term == "error":
                    error = True
                elif term == "breach":
                    breach = True
                else:
                    raise ValueError(
                        f"unknown trace tail rule {term!r} "
                        "(want slow:<ms> | error | breach)"
                    )
            _tail_slow_us = slow_us
            _tail_error = error
            _tail_breach = breach


def sampling_active() -> bool:
    """True when flow lanes are being buffered and judged (head sampling
    below 1.0), False in direct-emission mode."""
    return _sample_p < 1.0


def flow_steps(terminal: bool = False, **args: Any) -> None:
    """flow_point for every lane propagated onto this thread (deep seams —
    ingest attempts, degradation, readback — join whatever lanes the
    enclosing flush/change/delivery scoped in via :func:`flowing`)."""
    for ctx in getattr(_tls, "flows", ()):
        flow_point(ctx, terminal=terminal, **args)


def flowing(ctxs: Sequence[Optional[TraceContext]]) -> Any:
    """Scope flow contexts onto this thread for downstream seams.  Returns
    an allocation-free no-op for an empty/None-only sequence, so disabled
    call sites pay nothing."""
    live = tuple(c for c in ctxs if c is not None)
    if not live:
        return _NULL_SPAN
    return _Flowing(live)


def current_flows() -> Tuple[TraceContext, ...]:
    """The lanes scoped onto this thread (empty tuple when none)."""
    return getattr(_tls, "flows", ())


def current_flow() -> Optional[TraceContext]:
    """The first lane scoped onto this thread, or None — the one to stamp
    on single-flow recorder events."""
    flows = getattr(_tls, "flows", ())
    return flows[0] if flows else None


def flow_elapsed_s(ctx: TraceContext) -> float:
    """Seconds since the context was minted (feeds the e2e histograms)."""
    return (time.perf_counter_ns() - ctx.t0_ns) / 1e9


def record(
    site: str,
    flow: Optional[TraceContext] = None,
    outcome: str = "ok",
    **fields: Any,
) -> None:
    """Append one structured event to the flight-recorder ring (no-op
    while disabled).  Launch-level granularity, like every other site."""
    if not enabled:
        return
    rec = _recorder
    if rec is None:
        rec = _ensure_recorder()
    rec.record(
        time.perf_counter_ns() / 1e3,
        site,
        None if flow is None else flow.id,
        outcome,
        fields or None,
    )


def _ensure_recorder() -> _FlightRecorder:
    global _recorder
    with _config_lock:
        if _recorder is None:
            _recorder = _FlightRecorder(_BLACKBOX_RING)
        return _recorder


def recorder_events() -> List[Dict[str, Any]]:
    """The ring's events, oldest first (empty when nothing recorded)."""
    rec = _recorder
    return [] if rec is None else rec.events()


def recorder_stats() -> Tuple[int, int]:
    """(events recorded, events dropped by ring overwrite)."""
    rec = _recorder
    return (0, 0) if rec is None else (rec.n, rec.dropped)


def blackbox_dir() -> Optional[str]:
    """The armed black-box dump directory, or None."""
    return _blackbox_dir


def blackbox_dump(
    reason: str,
    dedupe_key: Optional[str] = None,
    dedupe_cooldown_s: Optional[float] = None,
    **info: Any,
) -> Optional[str]:
    """Write a post-mortem dump (ring + registry snapshot + summary) to the
    ``PERITEXT_BLACKBOX`` directory; returns the path or None when unarmed.

    Atomic (tmp+rename), monotonic per-process sequence numbers, and capped
    at a few dozen dumps per process so a wedge storm cannot fill the disk
    (skips count as ``blackbox.skipped``).  Additionally rate-limited per
    reason: within ``dedupe_cooldown_s`` (default 30 s) of the previous dump for the same
    ``dedupe_key`` (default: the reason), the dump is skipped and counted
    as ``blackbox.deduped`` — a trip/breach storm writes its first dump,
    not 32 copies of it.  Callers that rate-limit themselves (the SLO
    plane, on its injectable clock) pass ``dedupe_cooldown_s=0`` to bypass
    the wall-clock limiter.  Never raises
    — a full disk must not turn a post-mortem into a second failure."""
    d = _blackbox_dir
    if d is None:
        return None
    if dedupe_cooldown_s is None:
        dedupe_cooldown_s = _DUMP_COOLDOWN_DEFAULT
    key = dedupe_key or reason
    now = time.monotonic()
    with _config_lock:
        last = _dump_last.get(key)
        if (
            last is not None
            and dedupe_cooldown_s > 0
            and now - last < dedupe_cooldown_s
        ):
            if enabled:
                _registry.counter("blackbox.deduped")
            return None
        _dump_last[key] = now
    seq = next(_blackbox_seq)
    if seq > _MAX_BLACKBOX_DUMPS:
        if enabled:
            _registry.counter("blackbox.skipped")
        return None
    rec = _recorder
    payload = {
        "reason": reason,
        "info": info,
        "pid": os.getpid(),
        "ring": [] if rec is None else rec.events(),
        "ring_dropped": 0 if rec is None else rec.dropped,
        "metrics": snapshot(),
        "summary": summary(),
    }
    path = os.path.join(d, f"blackbox-{os.getpid()}-{seq:04d}-{reason}.json")
    tmp = path + ".tmp"
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        import logging

        logging.getLogger(__name__).warning(
            "black-box dump to %r failed", path, exc_info=True
        )
        return None
    if enabled:
        _registry.counter("blackbox.dumps")
    flush_trace()  # the trace should cover everything the dump names
    return path


def snapshot() -> Dict[str, Any]:
    """Full registry contents: {"counters", "gauges", "histograms"}."""
    return _registry.snapshot()


def summary() -> Dict[str, Any]:
    """Compact well-known subset for bench lines and chaos-run footers:
    launch/retry/degradation tallies, merge-path choices, queue depth,
    traffic bytes, and the mirrored fault counters.  Only keys that saw
    traffic appear, so the summary stays one short JSON object."""
    snap = _registry.snapshot()
    counters, gauges = snap["counters"], snap["gauges"]
    out: Dict[str, Any] = {}
    for key, src in (
        ("launches", "ingest.launches"),
        ("launch_attempts", "ingest.launch_attempts"),
        ("launch_retries", "ingest.launch_retries"),
        ("launch_failures", "ingest.launch_failures"),
        ("degraded_batches", "ingest.degraded_batches"),
        ("h2d_bytes", "ingest.h2d_bytes"),
        ("d2h_bytes", "ingest.d2h_bytes"),
        ("queue_flushes", "queue.flushes"),
        ("queue_reenqueues", "queue.reenqueues"),
        ("queue_shed", "queue.shed"),
        ("queue_coalesced", "queue.coalesced"),
        ("queue_blocked", "queue.blocked"),
        ("sync_deferred", "sync.deferred"),
        ("health_fastfails", "health.fastfail"),
        ("pubsub_delivered", "pubsub.delivered"),
        ("stream_cohorts", "stream.cohorts"),
        ("checkpoint_corrupt_fallbacks", "checkpoint.corrupt_fallbacks"),
        ("local_gen_rollbacks", "doc.local_gen_rollbacks"),
        ("blackbox_dumps", "blackbox.dumps"),
        ("blackbox_skipped", "blackbox.skipped"),
        ("window_fallbacks", "ingest.window_fallbacks"),
        ("window_rebuilds", "ingest.window_rebuilds"),
        ("blackbox_deduped", "blackbox.deduped"),
        ("trace_lanes_kept", "trace.lanes_kept"),
        ("trace_lanes_dropped", "trace.lanes_dropped"),
        ("trace_lanes_evicted", "trace.lanes_evicted"),
    ):
        if src in counters:
            out[key] = counters[src]
    paths = {
        name.rsplit(".", 1)[1]: n
        for name, n in counters.items()
        if name.startswith("ingest.path.")
    }
    if paths:
        out["merge_path"] = paths
    if "queue.depth_max" in gauges:
        out["queue_depth_max"] = gauges["queue.depth_max"]
    if "stream.inflight_max" in gauges:
        out["stream_inflight_max"] = gauges["stream.inflight_max"]
    faults_mirror = {
        name[len("faults.") :]: n
        for name, n in counters.items()
        if name.startswith("faults.")
    }
    if faults_mirror:
        out["faults"] = faults_mirror
    health_mirror = {
        name[len("health.") :]: n
        for name, n in counters.items()
        if name.startswith("health.") and name != "health.fastfail"
    }
    if health_mirror:
        out["health"] = health_mirror
    # SLO-plane mirror (runtime/slo.py): breach counters plus the live
    # burn/compliance/breached gauges, so a bench stamp or chaos footer
    # carries the objective verdicts without a separate plumbing path.
    slo_mirror: Dict[str, Any] = {
        name[len("slo.") :]: n
        for name, n in counters.items()
        if name.startswith("slo.")
    }
    for name, v in gauges.items():
        if name.startswith("slo."):
            slo_mirror[name[len("slo.") :]] = v
    if slo_mirror:
        out["slo"] = slo_mirror
    # Serving-plane tallies (runtime/serve.py): present whenever serve
    # traffic happened, so bench JSON stamps and the fuzz --chaos footer
    # carry admission/batching/shed behavior without a separate plumbing
    # path.  The e2e.admit_to_applied percentiles ride in out["e2e"].
    serve_mirror = {
        name[len("serve.") :]: n
        for name, n in counters.items()
        if name.startswith("serve.")
    }
    if serve_mirror:
        if "serve.depth_max" in gauges:
            serve_mirror["depth_max"] = gauges["serve.depth_max"]
        out["serve"] = serve_mirror
    # Autoscaler tallies (runtime/elastic.py): migrations / rollbacks /
    # parked-delivery counts ride bench stamps and the fuzz footer the
    # same way the serve block does.
    elastic_mirror = {
        name[len("elastic.") :]: n
        for name, n in counters.items()
        if name.startswith("elastic.")
    }
    if elastic_mirror:
        out["elastic"] = elastic_mirror
    # End-to-end latency percentiles (the causal-flow plane's terminal
    # seams) + the key per-seam latencies, estimated from the log2
    # histograms — the "why was p99 40x the median" numbers a one-line
    # bench stamp or chaos footer can carry.
    hists = snap["histograms"]
    e2e = {}
    for name, h in hists.items():
        if name.startswith("e2e."):
            q = estimate_quantiles(h)
            if q is not None:
                q["count"] = h["count"]
                e2e[name[len("e2e.") :]] = q
    if e2e:
        out["e2e"] = e2e
    lat = {}
    for label, src in (
        ("ingest_launch_s", "span.ingest.launch_attempt.seconds"),
        ("queue_flush_s", "queue.flush_seconds"),
    ):
        if src in hists:
            q = estimate_quantiles(hists[src])
            if q is not None:
                lat[label] = q
    if lat:
        out["latency"] = lat
    rec_n, rec_dropped = recorder_stats()
    if rec_n:
        out["recorder_events"] = rec_n
        out["recorder_dropped"] = rec_dropped
    return out


def _install_slo_sinks(
    observe_map: Optional[Dict[str, Callable[[float], None]]],
    counter_map: Optional[Dict[str, Callable[[int], None]]],
    breach_probe: Optional[Callable[[], bool]],
) -> None:
    """Wire (or clear, with Nones) the SLO plane's feed maps and breach
    probe.  Called by :mod:`peritext_tpu_torch.runtime.slo` on install/reset —
    not a public API."""
    global _observe_sinks, _counter_sinks, _breach_probe
    with _config_lock:
        _observe_sinks = observe_map or None
        _counter_sinks = counter_map or None
        _breach_probe = breach_probe


def register_status_source(kind: str, method: Any) -> None:
    """Register a live plane's status contributor (a *bound method*
    returning a JSON-able dict; held as a weakref, so a dropped plane
    silently leaves the surface).  ``kind`` groups the payload in
    :func:`status` — the serving planes register ``"serve"`` /
    ``"serve_shards"``, the controllers ``"elastic"`` / ``"lifecycle"``."""
    ref = weakref.WeakMethod(method)
    with _config_lock:
        # Opportunistic prune: long test sessions mint many short-lived
        # planes; dead refs must not accumulate.
        _status_sources[:] = [(k, r) for k, r in _status_sources if r() is not None]
        _status_sources.append((kind, ref))


def status() -> Dict[str, Any]:
    """One operator-facing snapshot of the live process: breaker states,
    queue pressure, serving-plane occupancy (per-session lane depth +
    deficit, per-shard width/occupancy + fleet shape pressure),
    windowed-merge engagement, per-SLO compliance/burn, e2e latency
    quantiles, and the trace sampler's verdict counts.  Built entirely
    from already-collected state — calling it never perturbs the planes
    it reports on."""
    snap = _registry.snapshot()
    counters, gauges = snap["counters"], snap["gauges"]
    out: Dict[str, Any] = {
        "pid": os.getpid(),
        "time": time.time(),
        "enabled": enabled,
    }
    # Health plane: breaker state + tallies per site.  Late import — the
    # health module imports this one, so the dependency must stay one-way
    # at import time.
    try:
        from peritext_tpu_torch.runtime import health as _health

        breakers = _health.summary()
    except Exception:
        breakers = {}
    if breakers:
        out["breakers"] = breakers
    queue_block: Dict[str, Any] = {}
    for label, src in (
        ("flushes", "queue.flushes"),
        ("reenqueues", "queue.reenqueues"),
        ("shed", "queue.shed"),
        ("coalesced", "queue.coalesced"),
        ("blocked", "queue.blocked"),
    ):
        if src in counters:
            queue_block[label] = counters[src]
    if "queue.depth_max" in gauges:
        queue_block["depth_max"] = gauges["queue.depth_max"]
    if queue_block:
        out["queue"] = queue_block
    launches = counters.get("ingest.launches", 0)
    if launches:
        windowed = counters.get("ingest.path.windowed", 0)
        out["ingest"] = {
            "launches": launches,
            "degraded_batches": counters.get("ingest.degraded_batches", 0),
            "launch_failures": counters.get("ingest.launch_failures", 0),
            "fastfails": counters.get("health.fastfail", 0),
            "windowed_launches": windowed,
            "window_engagement_pct": round(100.0 * windowed / launches, 1),
            "window_fallbacks": counters.get("ingest.window_fallbacks", 0),
        }
    # Live plane contributors (serve / serve_shards / elastic / lifecycle).
    with _config_lock:
        sources = list(_status_sources)
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for kind, ref in sources:
        method = ref()
        if method is None:
            continue
        try:
            payload = method()
        except Exception:  # a closing plane must not break the surface
            continue
        if payload:
            by_kind.setdefault(kind, []).append(payload)
    for kind, payloads in by_kind.items():
        out[kind] = payloads
    # SLO plane verdicts (late import, same one-way rationale as health).
    try:
        from peritext_tpu_torch.runtime import slo as _slo

        slo_summary = _slo.summary()
    except Exception:
        slo_summary = {}
    if slo_summary:
        out["slo"] = slo_summary
    e2e = {}
    for name, h in snap["histograms"].items():
        if name.startswith("e2e."):
            q = estimate_quantiles(h)
            if q is not None:
                q["count"] = h["count"]
                e2e[name[len("e2e.") :]] = q
    if e2e:
        out["e2e"] = e2e
    trace_block: Dict[str, Any] = {}
    if _tracer is not None:
        trace_block["path"] = _tracer.path
    if sampling_active():
        trace_block["sample"] = _sample_p
        trace_block["tail"] = {
            "slow_ms": None if _tail_slow_us is None else _tail_slow_us / 1e3,
            "error": _tail_error,
            "breach": _tail_breach,
        }
        with _flow_lock:
            trace_block["open_lanes"] = len(_lane_buf)
    for label, src in (
        ("lanes_kept", "trace.lanes_kept"),
        ("lanes_dropped", "trace.lanes_dropped"),
        ("lanes_evicted", "trace.lanes_evicted"),
    ):
        if src in counters:
            trace_block[label] = counters[src]
    if trace_block:
        out["trace"] = trace_block
    for label, src in (
        ("blackbox_dumps", "blackbox.dumps"),
        ("blackbox_deduped", "blackbox.deduped"),
    ):
        if src in counters:
            out[label] = counters[src]
    return out


def trace_path() -> Optional[str]:
    """Path of the active trace file, or None when not tracing."""
    tracer = _tracer
    return None if tracer is None else tracer.path


def dump_status(path: Optional[str] = None) -> Optional[str]:
    """Write :func:`status` as JSON, atomically (tmp+rename, per-writer tmp
    names — same discipline as :func:`dump_metrics`).  Defaults to the
    ``PERITEXT_STATUS`` path; returns the path written or None."""
    path = path or _status_path
    if not path:
        return None
    payload = status()
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with _dump_lock:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    return path


def enable(
    trace: Optional[str] = None,
    metrics: Optional[str] = None,
    blackbox: Optional[str] = None,
    metrics_interval: Optional[float] = None,
    status_path: Optional[str] = None,
) -> None:
    """Turn collection on.  ``trace`` opens (truncating) a Chrome trace
    JSONL file; ``metrics`` schedules a snapshot dump at interpreter exit
    (``metrics_interval`` > 0 additionally flushes it periodically from a
    daemon thread); ``blackbox`` arms failure dumps to a directory;
    ``status_path`` arms the live ops status surface (written on the same
    periodic flusher and at exit).  All may be omitted — a bare
    ``enable()`` collects registry metrics only."""
    global enabled, _tracer, _metrics_path, _blackbox_dir, _flusher, _status_path
    with _config_lock:
        if trace:
            if _tracer is not None and _tracer.path != trace:
                _tracer.close()
                _tracer = None
            if _tracer is None:
                _tracer = _Tracer(trace)
        if metrics:
            _metrics_path = metrics
        if blackbox:
            _blackbox_dir = blackbox
        if status_path:
            _status_path = status_path
        _ensure_atexit_locked()
        enabled = True
        if metrics_interval and metrics_interval > 0 and (_metrics_path or _status_path):
            if _flusher is not None and _flusher.interval != metrics_interval:
                _flusher.stop_event.set()
                _flusher = None
            if _flusher is None:
                _flusher = _MetricsFlusher(metrics_interval)
                _flusher.start()


def disable() -> None:
    """Stop collection (registry contents and the trace file are kept —
    re-enable resumes into them; use :func:`reset` for a pristine plane)."""
    global enabled
    enabled = False


def reset() -> None:
    """Back to a pristine, disabled plane: counters cleared, tracer closed,
    exit dump canceled, recorder ring dropped, black-box disarmed, the
    periodic flusher stopped, sampling back to direct emission, SLO sinks
    and status sources cleared.  Does NOT re-read the environment (tests
    own the lifecycle after a reset)."""
    global enabled, _tracer, _metrics_path, _recorder, _blackbox_dir, _flusher
    global _sample_p, _sample_seed, _tail_slow_us, _tail_error, _tail_breach
    global _breach_probe, _observe_sinks, _counter_sinks, _status_path
    with _config_lock:
        enabled = False
        if _tracer is not None:
            _tracer.close()
            _tracer = None
        _metrics_path = None
        _recorder = None
        _blackbox_dir = None
        if _flusher is not None:
            _flusher.stop_event.set()
            _flusher = None
        _sample_p = 1.0
        _sample_seed = 0
        _tail_slow_us = None
        _tail_error = _tail_breach = False
        _breach_probe = None
        _observe_sinks = None
        _counter_sinks = None
        _status_path = None
        _dump_last.clear()
        _registry.clear()
        _status_sources.clear()
    with _flow_lock:
        _lane_buf.clear()


def flush_trace() -> None:
    """Force buffered trace events to disk (the tracer also flushes every
    few hundred events and at exit)."""
    tracer = _tracer
    if tracer is not None:
        tracer.flush()


_dump_lock = threading.Lock()


def dump_metrics(path: Optional[str] = None) -> Optional[str]:
    """Write the metrics snapshot (+ summary) as JSON, atomically.
    Defaults to the ``PERITEXT_METRICS`` path; returns the path written or
    None.  Serialized under a lock AND written via a per-writer tmp name:
    the periodic flusher can race the atexit dump (or a programmatic
    call), and two writers sharing one tmp path would rename an
    interleaved file into place — exactly the corrupt snapshot this
    feature exists to prevent."""
    path = path or _metrics_path
    if not path:
        return None
    payload = snapshot()
    payload["summary"] = summary()
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with _dump_lock:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    return path


def _at_exit() -> None:
    try:
        try:
            if _metrics_path:
                dump_metrics(_metrics_path)
        finally:
            if _status_path:
                dump_status(_status_path)
    finally:
        tracer = _tracer
        if tracer is not None:
            tracer.flush()


def _ensure_atexit_locked() -> None:
    global _atexit_registered
    if not _atexit_registered:
        atexit.register(_at_exit)
        _atexit_registered = True


def _activate_from_env() -> None:
    """Import-time activation from PERITEXT_TRACE / PERITEXT_METRICS /
    PERITEXT_BLACKBOX / PERITEXT_STATUS (+ PERITEXT_METRICS_INTERVAL).

    A bad trace path (missing directory, permissions) must not take the
    whole product down at import — observability degrades to untraced
    collection with a warning instead.  Programmatic :func:`enable` still
    raises, so deliberate callers see the real error."""
    trace = os.environ.get("PERITEXT_TRACE")
    metrics = os.environ.get("PERITEXT_METRICS")
    blackbox = os.environ.get("PERITEXT_BLACKBOX")
    status_p = os.environ.get("PERITEXT_STATUS")
    try:
        interval = float(os.environ.get("PERITEXT_METRICS_INTERVAL", "0") or 0)
    except ValueError:
        interval = 0.0
    if status_p and not interval:
        # The status surface is only useful live; give it a cadence even
        # when the metrics snapshot doesn't ask for one.
        interval = 2.0
    if not (trace or metrics or blackbox or status_p):
        return
    rest = dict(
        metrics=metrics or None,
        blackbox=blackbox or None,
        metrics_interval=interval or None,
        status_path=status_p or None,
    )
    try:
        enable(trace=trace or None, **rest)
    except OSError as exc:
        import logging

        logging.getLogger(__name__).warning(
            "PERITEXT_TRACE=%r unusable (%s); continuing without a tracer",
            trace,
            exc,
        )
        enable(**rest)


_activate_from_env()
