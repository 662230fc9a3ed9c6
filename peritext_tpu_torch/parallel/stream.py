"""Streaming replica cohorts: a replica population larger than the card.

Counterpart of ``peritext_tpu/parallel/stream.py``.  BASELINE's north-star
shape (config 5: 100k replicas of 10k-char documents, C = 16384, M = 128)
holds 772,616 B of state a replica, 77 GB in all: more than an 80 GB card
can merge while resident, since a merge writes a fresh copy of every
plane it touches.  The population stays in host memory as numpy arrays
(a broadcast view is fine) and fixed-size cohorts stream through the
card.  Each cohort runs both hand kernels (``cuda_kernels.merge_step_full``:
text kernel, boundary permute, mark kernel, table append), then the
convergence digest.  A batch the kernels cannot take (a capacity past
``kernel_capacity_limit``, or an insert run longer than the kernels'
MAX_RUN_LEN window) takes the sorted merge instead
(``sorted_merge.merge_step_sorted_batch``), counted in
``stats["capacity_routes"]``.  Either way the result is byte-identical to
one resident merge of the whole population, for every cohort size and
depth (``tests/test_torch_stream.py`` holds it against the JAX stream).

The pipeline is CUDA's own, not a copy of JAX's asynchronous dispatch:

- ``depth`` slots, each with pinned host staging buffers and device
  buffers at the cohort's shape, allocated once and reused cohort after
  cohort (where the JAX stream donates its input buffers).  Device
  residency is ``depth`` x (cohort state + the merge's outputs and
  transients), whatever the population.
- A slot is refilled from the population only after its previous H2D copy
  completed (its event).  H2D runs on a copy stream from pinned memory,
  the merge and the digest on a compute stream that waits on that copy,
  D2H on a third stream into pinned output buffers.
- Cohort k+1 is staged and launched before cohort k drains, so the host
  copy and H2D of k+1 overlap the merge of k.  A drain waits on its
  cohort's D2H event, never on the whole device.
- Nothing on the kernel route waits on the host: the mark-table append
  and the digest take their bounds from shapes and from what the host
  knows of its inputs (``mark_cols``).

On the CPU the same function runs the kernels' plain versions, without
pinning or streams.  There is no fallback: a kernel that fails to build or
launch on the card fails the sweep.  The JAX stream's ``mesh=`` and
``shard_seq=`` have no counterpart yet.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.cuda_kernels import kernel_capacity_limit, merge_step_full
from peritext_tpu_torch.ops.sorted_merge import merge_step_sorted_batch
from peritext_tpu_torch.ops.state import FIELDS, MASK_WORD_BITS, DocState, Device, resolve_device
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.schema import allow_multiple_array

_BOOL_FIELDS = ("deleted", "bnd_def")
# The digest's chunk, in [C, M'] entries (``convergence_digest``'s
# ``chunk_elems``).  Each chunk enqueues a few dozen eager kernels, and
# the host cannot stage the next cohort while it enqueues them, so a
# cohort's digest runs in few, large chunks: at C = 16384 and M' = 32 one
# chunk is 256 replicas, 1 GiB an int64 plane.  On an H100 (PERF.md,
# ``bench/stream_chunks.py``) depth 2 beat depth 1 by 26-29% at 2**27 and
# not at all at the universe's 2**24.
DIGEST_CHUNK_ELEMS = 1 << 27
_EVENTS = ("h2d0", "h2d1", "merge0", "merge1", "digest1", "d2h0", "d2h1")


def _field_shapes(capacity: int, max_mark_ops: int) -> Dict[str, Tuple[int, ...]]:
    """One replica's DocState field shapes (``ops/state.py``)."""
    if max_mark_ops % MASK_WORD_BITS != 0:
        raise ValueError("max_mark_ops must be a multiple of 32")
    c, m = capacity, max_mark_ops
    shapes: Dict[str, Tuple[int, ...]] = dict.fromkeys(("elem_ctr", "elem_act", "deleted", "chars"), (c,))
    shapes["bnd_def"] = (2 * c,)
    shapes["bnd_mask"] = (2 * c, m // MASK_WORD_BITS)
    shapes.update(dict.fromkeys(("mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr"), (m,)))
    shapes.update(dict.fromkeys(("length", "mark_count"), ()))
    return shapes


def state_bytes_per_replica(capacity: int, max_mark_ops: int) -> int:
    """Exact DocState bytes for one replica at the given shape, from the
    shapes alone (int32 planes, bool flags): no state is made, so this
    runs without a card."""
    return sum(
        int(np.prod(shape, dtype=np.int64)) * (1 if name in _BOOL_FIELDS else 4)
        for name, shape in _field_shapes(capacity, max_mark_ops).items()
    )


def transient_bytes_per_replica(capacity: int, max_mark_ops: int, ops_len: int) -> int:
    """Upper-bound merge transients per replica of the sorted merge, the
    JAX package's formula (so both packages size cohorts alike): the
    placement phase holds O(L*C) int32 compare planes and the mark phase
    O(L_mark*2C) planes, where L is the op-batch length, with a 2x safety
    factor.  The kernel route's own footprint is measured on the card
    (``chip_smoke.py``, PERF.md)."""
    del max_mark_ops  # table capacity does not size the transients
    return 2 * 4 * (ops_len * capacity + ops_len * 2 * capacity)


def cohort_for_budget(
    capacity: int,
    max_mark_ops: int,
    ops_len: int,
    hbm_bytes: int = 16 * 2**30,
    headroom: float = 0.9,
    depth: int = 2,
    n_devices: int = 1,
) -> int:
    """Largest cohort whose ``depth`` in-flight copies fit the device
    memory budget (per device; ``n_devices`` multiplies it).  Pass the
    card's free memory (``torch.cuda.mem_get_info()[0]``) as
    ``hbm_bytes``; the default is the JAX package's."""
    per = state_bytes_per_replica(capacity, max_mark_ops) + transient_bytes_per_replica(
        capacity, max_mark_ops, ops_len
    )
    return max(1, int(hbm_bytes * headroom * n_devices / (depth * per)))


def _host_fields(states: Any) -> Dict[str, np.ndarray]:
    """The population's 13 fields as numpy (a mapping of field arrays, as
    ``state_to_numpy`` gives, or any object holding them as attributes);
    uint32 mask words viewed as the int32 the card holds."""
    out = {}
    for name in FIELDS:
        a = np.asarray(states[name] if isinstance(states, Mapping) else getattr(states, name))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        want = np.bool_ if name in _BOOL_FIELDS else np.int32
        if a.dtype != want:
            raise TypeError(f"states[{name!r}]: dtype {a.dtype}, expected {np.dtype(want)}")
        out[name] = a
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a`` without a copy.  A population may be a
    read-only broadcast view (stride 0); it is only ever read."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def _stage(dst: torch.Tensor, src: np.ndarray, lo: int, hi: int) -> None:
    """Cohort rows [lo, hi) into ``dst``, padded to its length with
    replica 0 (one shape for every cohort; the pad rows are dropped)."""
    n = hi - lo
    dst[:n].copy_(_tensor(src[lo:hi]))
    if n < dst.shape[0]:
        dst[n:].copy_(_tensor(src[0:1]).expand((dst.shape[0] - n,) + src.shape[1:]))


class _Slot:
    """One pipeline slot: staging buffers (pinned on the card), the device
    buffers the merge reads, the output buffers the drain reads, and the
    events that order and time the three streams."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], out_specs,
                 device: torch.device, streams: Tuple[Any, ...]) -> None:
        cuda = device.type == "cuda"
        self.stage = {k: torch.empty(shape, dtype=dt, pin_memory=cuda) for k, (shape, dt) in specs.items()}
        self.out = {k: torch.empty(shape, dtype=dt, pin_memory=cuda) for k, (shape, dt) in out_specs.items()}
        self.dev = self.stage
        self.ev: Optional[Dict[str, Any]] = None
        if cuda:
            self.dev = {k: torch.empty_like(t, device=device) for k, t in self.stage.items()}
            for t in self.dev.values():
                # Written on the copy stream, read on the compute stream:
                # their memory must outlive both streams' use when freed.
                for s in streams:
                    t.record_stream(s)
            self.ev = {name: torch.cuda.Event(enable_timing=True) for name in _EVENTS}


def stream_merge_sorted(
    states: Any,
    text_ops: np.ndarray,
    round_of: np.ndarray,
    num_rounds: int,
    mark_ops: np.ndarray,
    ranks: np.ndarray,
    char_buf: np.ndarray,
    maxk: int,
    cohort: int,
    compute_digest: bool = True,
    readback_states: bool = True,
    depth: int = 2,
    device: Device = None,
) -> Tuple[Optional[Dict[str, np.ndarray]], np.ndarray, Dict[str, Any]]:
    """Merge an arbitrarily large replica population by streaming cohorts.

    ``states`` (13 host fields) and the op arrays (``prepare_sorted_batch``
    rows) have leading dim R_total; at most ``depth`` cohorts of
    ``cohort`` replicas are on ``device`` at once (``None``: the card).
    Returns (updated host states as ``state_to_numpy`` gives them | None,
    digests [R_total] uint32, stats).  The tail cohort is padded by
    repeating replica 0; padded lanes are dropped on readback.  With
    ``compute_digest=False`` the digest slot carries post-merge lengths
    instead (a completion token, not a convergence digest).  ``stats``
    has the JAX stream's keys, ``route`` (``kernels`` or ``sorted``),
    ``capacity_routes`` and per-cohort ``timings`` (host seconds to
    stage, to enqueue the copies, merge and digest, and to drain; H2D,
    merge, digest and D2H ms from CUDA events on the card).
    """
    device = resolve_device(device)
    cuda = device.type == "cuda"
    r_total = int(text_ops.shape[0])
    if cohort <= 0:
        raise ValueError(f"cohort must be positive, got {cohort}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    cohort = min(cohort, r_total)
    host = _host_fields(states)
    capacity = host["elem_ctr"].shape[-1]
    words = host["bnd_mask"].shape[-1]
    kind = text_ops[..., K.K_KIND]
    runs = text_ops[..., K.K_RUN_LEN][kind == K.KIND_INSERT_RUN]
    kernels = (
        capacity <= kernel_capacity_limit(words)
        and char_buf.shape[-1] >= K.MAX_RUN_LEN
        and (runs.size == 0 or int(runs.max()) <= K.MAX_RUN_LEN)
    )
    # A bound on every replica's post-merge mark count, known on the host:
    # the digest then never reads one back.
    mark_cols = int(host["mark_count"].max()) + int((mark_ops[..., K.K_KIND] == K.KIND_MARK).sum(axis=-1).max())

    sources: Dict[str, np.ndarray] = dict(host)
    sources.update(text_ops=text_ops, mark_ops=mark_ops, char_buf=char_buf)
    if not kernels:
        sources["round_of"] = round_of
    specs = {}
    for name, a in sources.items():
        if a.dtype not in (np.int32, np.bool_):
            raise TypeError(f"{name}: dtype {a.dtype}, expected int32")
        specs[name] = ((cohort,) + a.shape[1:], torch.bool if a.dtype == np.bool_ else torch.int32)
    out_specs = {"digest": ((cohort,), torch.int64)}
    if readback_states:
        out_specs.update({f: specs[f] for f in FIELDS})

    streams: Tuple[Any, ...] = ()
    if cuda:
        streams = tuple(torch.cuda.Stream(device) for _ in range(3))
    copy_s, compute_s, d2h_s = streams if cuda else (None, None, None)
    slots = [_Slot(specs, out_specs, device, streams) for _ in range(depth)]
    ranks_d = torch.from_numpy(np.ascontiguousarray(ranks, dtype=np.int32)).to(device)
    multi_d = torch.from_numpy(allow_multiple_array()).to(device)
    if cuda:
        compute_s.wait_stream(torch.cuda.current_stream(device))

    out_states = (
        {f: np.empty((r_total,) + host[f].shape[1:], host[f].dtype) for f in FIELDS}
        if readback_states else None
    )
    digests = np.zeros((r_total,), np.uint32)
    timings = []

    def merge(bufs: Dict[str, torch.Tensor]) -> DocState:
        st = DocState(**{f: bufs[f] for f in FIELDS})
        if kernels:
            return merge_step_full(st, bufs["text_ops"], bufs["mark_ops"], ranks_d, bufs["char_buf"])
        return merge_step_sorted_batch(
            st, bufs["text_ops"], bufs["round_of"], num_rounds, bufs["mark_ops"], ranks_d,
            bufs["char_buf"], maxk,
        )

    def digest(new: DocState) -> torch.Tensor:
        if compute_digest:
            return K.convergence_digest(new, ranks_d, multi_d, DIGEST_CHUNK_ELEMS, mark_cols=mark_cols)
        return new.length.to(torch.int64)

    def run_slot(slot: _Slot, lo: int, hi: int, timing: Dict[str, Any]) -> None:
        ev = slot.ev
        if ev is not None:
            ev["h2d1"].synchronize()  # the slot's previous H2D has read its staging
        t0 = time.perf_counter()
        for name, src in sources.items():
            _stage(slot.stage[name], src, lo, hi)
        t1 = time.perf_counter()
        timing["stage_s"] = t1 - t0
        _enqueue(slot, ev)
        timing["enqueue_s"] = time.perf_counter() - t1

    def _enqueue(slot: _Slot, ev) -> None:
        if ev is None:
            new = merge(slot.dev)
            dg = digest(new)
            slot.out["digest"].copy_(dg)
            if readback_states:
                for f in FIELDS:
                    slot.out[f].copy_(getattr(new, f))
            return
        with torch.cuda.stream(copy_s):
            copy_s.wait_event(ev["digest1"])  # the slot's previous cohort is done with its buffers
            ev["h2d0"].record(copy_s)
            for name, t in slot.stage.items():
                slot.dev[name].copy_(t, non_blocking=True)
            ev["h2d1"].record(copy_s)
        with torch.cuda.stream(compute_s):
            compute_s.wait_event(ev["h2d1"])
            ev["merge0"].record(compute_s)
            new = merge(slot.dev)
            ev["merge1"].record(compute_s)
            dg = digest(new)
            ev["digest1"].record(compute_s)
        with torch.cuda.stream(d2h_s):
            d2h_s.wait_event(ev["digest1"])
            ev["d2h0"].record(d2h_s)
            reads = [("digest", dg)] + ([(f, getattr(new, f)) for f in FIELDS] if readback_states else [])
            for name, t in reads:
                slot.out[name].copy_(t, non_blocking=True)
                t.record_stream(d2h_s)  # made on the compute stream, read here
            ev["d2h1"].record(d2h_s)

    def _record(br, exc: BaseException) -> None:
        # Transient errors are breaker signal; semantic errors and
        # BaseExceptions (KeyboardInterrupt mid-sweep) are not — but they
        # must still release a held canary slot, or the breaker would
        # fast-fail forever with no probe able to run.
        if br is not None:
            if faults.retryable(exc):
                br.record_failure()
            else:
                br.abandon()

    def launch(k: int, lo: int):
        # The launch span covers host staging, the H2D enqueue and the
        # merge's asynchronous launch; the matching drain span covers the
        # D2H barrier.  In a trace, launch spans overlapping earlier
        # cohorts' drain spans ARE the pipeline overlap depth > 1 claims.
        #
        # Health gating: the stream has no oracle degrade path (the whole
        # point is a population too big to re-apply host-side per cohort),
        # so an OPEN device_launch breaker fast-fails the sweep immediately
        # with BreakerOpenError — the caller retries the round once the
        # circuit recovers.  Outcomes feed the breaker at the honest
        # barrier: success on drain, failure on a launch OR drain exception.
        br = health.breaker("device_launch")
        decision = health.ALLOW if br is None else br.admit()
        if decision == health.FASTFAIL:
            if telemetry.enabled:
                telemetry.record("stream.launch", outcome="fastfail", lo=lo)
            raise health.BreakerOpenError("device_launch")
        hi = min(lo + cohort, r_total)
        slot = slots[k % depth]
        timing: Dict[str, Any] = {"lo": lo, "rows": hi - lo}
        # One causal lane per cohort: start at launch, finish at drain.
        ctx = telemetry.flow("stream.cohort", lo=lo, hi=hi) if telemetry.enabled else None
        with telemetry.span("stream.launch", lo=lo, hi=hi):
            telemetry.flow_point(ctx)
            try:
                faults.fire("device_launch")
                run_slot(slot, lo, hi, timing)
            except BaseException as exc:
                _record(br, exc)
                if telemetry.enabled:
                    telemetry.record(
                        "stream.launch", flow=ctx, outcome="error",
                        error=type(exc).__name__,
                    )
                # The lane ends here — an unterminated flow would read as
                # a lost cohort.
                telemetry.flow_point(ctx, terminal=True, outcome="error")
                raise
        return lo, hi, slot, br, decision, ctx, timing

    def drain(entry) -> None:
        lo, hi, slot, br, _decision, ctx, timing = entry
        with telemetry.span("stream.drain", lo=lo, hi=hi):
            n = hi - lo
            try:
                faults.fire("device_readback")
                ev = slot.ev
                if ev is not None:
                    ev["d2h1"].synchronize()
                    timing["h2d_ms"] = ev["h2d0"].elapsed_time(ev["h2d1"])
                    timing["merge_ms"] = ev["merge0"].elapsed_time(ev["merge1"])
                    timing["digest_ms"] = ev["merge1"].elapsed_time(ev["digest1"])
                    timing["d2h_ms"] = ev["d2h0"].elapsed_time(ev["d2h1"])
                t0 = time.perf_counter()
                digests[lo:hi] = slot.out["digest"][:n].numpy().astype(np.uint32)
                if out_states is not None:
                    for f in FIELDS:
                        out_states[f][lo:hi] = slot.out[f][:n].numpy()
                timing["drain_s"] = time.perf_counter() - t0
            except BaseException as exc:
                _record(br, exc)
                if telemetry.enabled:
                    telemetry.record(
                        "stream.drain", flow=ctx, outcome="error",
                        error=type(exc).__name__,
                    )
                telemetry.flow_point(ctx, terminal=True, outcome="error")
                raise
            # Lane terminal: the readback completed — the cohort is done.
            telemetry.flow_point(ctx, terminal=True)
        timings.append(timing)
        if ctx is not None:
            telemetry.observe("e2e.cohort_launch_to_drain", telemetry.flow_elapsed_s(ctx))
        if br is not None:
            br.record_success()

    inflight: deque = deque()
    n_cohorts = 0
    try:
        for k, lo in enumerate(range(0, r_total, cohort)):
            entry = launch(k, lo)
            n_cohorts += 1
            if entry[4] == health.CANARY:  # the admit() decision slot
                # A half-open probe must resolve (its drain is the honest
                # barrier) before any further cohort is admitted: its
                # success closes the circuit for the rest of the sweep, its
                # failure re-opens — either way the next admit() sees the
                # verdict instead of fast-failing behind an in-flight canary.
                drain(entry)
                if telemetry.enabled:
                    telemetry.counter("stream.cohorts")
                continue
            inflight.append(entry)
            if telemetry.enabled:
                telemetry.counter("stream.cohorts")
                telemetry.gauge_max("stream.inflight_max", len(inflight))
            # Keep `depth` cohorts in flight: the next cohort's staging, H2D
            # and merge are enqueued before this drain blocks.
            while len(inflight) >= depth:
                drain(inflight.popleft())
        while inflight:
            drain(inflight.popleft())
    except BaseException:
        # A mid-sweep abort (failed drain, breaker fast-fail, Ctrl-C)
        # leaves launched-but-undrained cohorts in the window; their lanes
        # must still end or the trace reads them as lost.
        if telemetry.enabled and inflight:
            with telemetry.span("stream.abort", pending=len(inflight)):
                for entry in inflight:
                    telemetry.flow_point(entry[5], terminal=True, outcome="abort")
        raise

    if out_states is not None:
        out_states["bnd_mask"] = out_states["bnd_mask"].view(np.uint32)
    stats = {
        "replicas": r_total,
        "cohort": cohort,
        "n_cohorts": n_cohorts,
        "depth": depth,
        "padded_tail": (r_total % cohort) != 0,
        "route": "kernels" if kernels else "sorted",
        "capacity_routes": 0 if kernels else n_cohorts,
        "timings": timings,
    }
    return out_states, digests, stats
