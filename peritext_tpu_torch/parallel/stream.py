"""Streaming replica cohorts: a replica population larger than the card.

Counterpart of ``peritext_tpu/parallel/stream.py``.  BASELINE's north-star
shape (config 5: 100k replicas of 10k-char documents, C = 16384, M = 128)
holds 772,616 B of state a replica, 77 GB in all: more than an 80 GB card
can merge while resident, since a merge writes a fresh copy of every
plane it touches.  The population stays in host memory as numpy arrays
(a broadcast view is fine) and fixed-size cohorts stream through the
card.  Each cohort runs both hand kernels (``cuda_kernels.merge_step_full``:
the text kernel, then the mark kernel with the boundary permute and the
table append folded in; past C = 16384 they run as thread-block
clusters), then the digest kernel (``cuda_kernels.convergence_digest``:
one launch a cohort and replica group, at any capacity).  A batch the
kernels cannot take (a capacity past ``kernel_capacity_limit``, C =
131072, or an insert run longer than the kernels' MAX_RUN_LEN window)
takes the sorted merge instead
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
  takes its bounds from shapes, and the digest kernel reads each
  replica's mark count on the card.

On a mesh (``mesh=``, ``shard_seq=``: JAX's cohorts over a device mesh)
each cohort is laid over the mesh's entries with ``state_sharding``'s
placement, and each replica group merges through both hand kernels and
takes its digest on its group device, its seq shards gathered before the
merge and split after, as ``parallel.mesh.sharded_merge_step`` does.
Every device of the mesh has its own copy, compute and D2H streams and
events; a copy that crosses devices runs with every device's stream of
that kind current.  Entries that name one device (``n x cuda:0``) share
its three streams, so the groups merge one after another on one compute
stream.  Without a mesh the stream is a one-entry mesh on ``device``.

On the CPU the same function runs the kernels' plain versions, without
pinning or streams.  There is no fallback: a kernel that fails to build or
launch on the card fails the sweep.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import deque
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.cuda_kernels import convergence_digest, kernel_capacity_limit, merge_step_full
from peritext_tpu_torch.ops.sorted_merge import merge_step_sorted_batch
from peritext_tpu_torch.ops.state import FIELDS, MASK_WORD_BITS, DocState, Device, resolve_device
from peritext_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTensor,
    _check_even,
    from_group_states,
    group_state,
    make_mesh,
    state_sharding,
)
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.schema import allow_multiple_array

_BOOL_FIELDS = ("deleted", "bnd_def")
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


def _key(device: torch.device) -> torch.device:
    """A device with its index: the key of its streams and events."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Slot:
    """One pipeline slot: staging buffers (pinned on the card) for each
    replica group's rows (and each seq part of a field split over
    ``seq``), the buffers of every mesh entry the merge reads, the output
    buffers the drain reads, and per device of the mesh the events that
    order and time its three streams."""

    def __init__(self, specs: Dict[Any, Tuple[Tuple[int, ...], torch.dtype]], out_specs,
                 entries: Dict[Any, Tuple[Any, torch.device]], streams: Dict[torch.device, Tuple[Any, ...]],
                 cuda: bool) -> None:
        self.stage = {k: torch.empty(shape, dtype=dt, pin_memory=cuda) for k, (shape, dt) in specs.items()}
        self.out = {k: torch.empty(shape, dtype=dt, pin_memory=cuda) for k, (shape, dt) in out_specs.items()}
        self.dev = {k: self.stage[src] for k, (src, _) in entries.items()}
        self.ev: Optional[Dict[torch.device, Dict[str, Any]]] = None
        if cuda:
            self.dev = {k: torch.empty_like(self.stage[src], device=dev) for k, (src, dev) in entries.items()}
            for t in self.dev.values():
                # Written on the copy stream, read on the compute stream:
                # their memory must outlive both streams' use when freed.
                for s in streams[_key(t.device)]:
                    t.record_stream(s)
            self.ev = {d: {name: torch.cuda.Event(enable_timing=True) for name in _EVENTS} for d in streams}


def _on(streams: Dict[torch.device, Tuple[Any, ...]], which: int) -> contextlib.ExitStack:
    """Every device's stream ``which`` (0 copy, 1 compute, 2 D2H) made
    current at once, so a copy between two devices of the mesh orders on
    both of them."""
    stack = contextlib.ExitStack()
    for trio in streams.values():
        stack.enter_context(torch.cuda.stream(trio[which]))
    return stack


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
    mesh: Optional[Mesh] = None,
    shard_seq: bool = True,
    compute_digest: bool = True,
    readback_states: bool = True,
    depth: int = 2,
    device: Device = None,
) -> Tuple[Optional[Dict[str, np.ndarray]], np.ndarray, Dict[str, Any]]:
    """Merge an arbitrarily large replica population by streaming cohorts.

    ``states`` (13 host fields) and the op arrays (``prepare_sorted_batch``
    rows) have leading dim R_total; at most ``depth`` cohorts of
    ``cohort`` replicas are on ``device`` (``None``: the card) or on
    ``mesh`` at once.  With a mesh the cohort rounds up to a multiple of
    its replica axis (as JAX's stream does), each cohort is laid over it
    with ``state_sharding(mesh, shard_seq)``'s placement (the op rows
    split over ``replica``), and each replica group merges and digests on
    its group device, its seq shards gathered before the merge and split
    after (``parallel.mesh.sharded_merge_step``); ``device`` must then be
    ``None``.  Returns (updated host states as ``state_to_numpy`` gives
    them | None, digests [R_total] uint32, stats).  The tail cohort is
    padded by repeating replica 0; padded lanes are dropped on readback.
    With ``compute_digest=False`` the digest slot carries post-merge
    lengths instead (a completion token, not a convergence digest).
    ``stats`` has the JAX stream's keys, ``route`` (``kernels`` or
    ``sorted``), ``capacity_routes`` and per-cohort ``timings`` (host
    seconds to stage, to enqueue the copies, merge and digest, and to
    drain; H2D, merge, digest and D2H ms from CUDA events on the card, of
    the mesh's first device's streams).
    """
    r_total = int(text_ops.shape[0])
    if cohort <= 0:
        raise ValueError(f"cohort must be positive, got {cohort}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if mesh is None:
        mesh = make_mesh([resolve_device(device)], 1, 1)
        cohort = min(cohort, r_total)
    else:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        # Cohorts must divide over the replica mesh axis; round up (the
        # tail pad already fills partial cohorts).
        axis = mesh.shape["replica"]
        cohort = min(cohort, -(-r_total // axis) * axis)
        cohort = -(-cohort // axis) * axis
    kinds = {d.type for d in mesh.devices.flat}
    if len(kinds) != 1:
        raise ValueError(f"a stream's mesh holds one kind of device, got {sorted(kinds)}")
    cuda = kinds == {"cuda"}
    groups, n_seq = mesh.shape["replica"], mesh.shape["seq"]
    rows = cohort // groups
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
    sources: Dict[str, np.ndarray] = dict(host)
    sources.update(text_ops=text_ops, mark_ops=mark_ops, char_buf=char_buf)
    if not kernels:
        sources["round_of"] = round_of
    field_specs = state_sharding(mesh, shard_seq)
    spec = {name: getattr(field_specs, name) if name in FIELDS else ("replica",) for name in sources}
    # Staging (and output) parts: group i's rows of a source, and its seq
    # part j where the spec splits it over ``seq`` (else part 0 only).
    split = {name: "seq" in spec[name] and n_seq > 1 for name in sources}
    parts = {name: range(n_seq) if split[name] else range(1) for name in sources}

    def seq_part(a: np.ndarray, name: str, j: int) -> np.ndarray:
        """Seq part ``j`` of rows ``a`` of source ``name`` (a view)."""
        if not split[name]:
            return a
        width = a.shape[1] // n_seq
        return a[:, j * width : (j + 1) * width]

    specs: Dict[Any, Tuple[Tuple[int, ...], torch.dtype]] = {}
    entries: Dict[Any, Tuple[Any, torch.device]] = {}
    for name, a in sources.items():
        if a.dtype not in (np.int32, np.bool_):
            raise TypeError(f"{name}: dtype {a.dtype}, expected int32")
        _check_even((cohort,) + a.shape[1:], mesh, spec[name])
        shape = seq_part(a[:rows], name, 0).shape
        dtype = torch.bool if a.dtype == np.bool_ else torch.int32
        for i in range(groups):
            for j in parts[name]:
                specs[(name, i, j)] = ((rows,) + shape[1:], dtype)
            for j in range(n_seq):
                entries[(name, i, j)] = ((name, i, j if split[name] else 0), mesh.devices[i, j])
    out_specs = {("digest", i, 0): ((rows,), torch.int64) for i in range(groups)}
    if readback_states:
        out_specs.update({k: specs[k] for k in specs if k[0] in FIELDS})

    devices = list(dict.fromkeys(_key(d) for d in mesh.devices.flat))
    streams: Dict[torch.device, Tuple[Any, ...]] = {}
    if cuda:
        streams = {d: tuple(torch.cuda.Stream(d) for _ in range(3)) for d in devices}
    slots = [_Slot(specs, out_specs, entries, streams, cuda) for _ in range(depth)]
    ranks_np = np.ascontiguousarray(ranks, dtype=np.int32)
    ranks_d = {d: torch.from_numpy(ranks_np).to(d) for d in devices}
    multi_d = {d: torch.from_numpy(allow_multiple_array()).to(d) for d in devices}
    for d, trio in streams.items():
        trio[1].wait_stream(torch.cuda.current_stream(d))
    first = devices[0]

    out_states = (
        {f: np.empty((r_total,) + host[f].shape[1:], host[f].dtype) for f in FIELDS}
        if readback_states else None
    )
    digests = np.zeros((r_total,), np.uint32)
    timings = []

    def laid_out(slot: _Slot, name: str) -> ShardedTensor:
        grid = np.empty((groups, n_seq), dtype=object)
        for i in range(groups):
            for j in range(n_seq):
                grid[i, j] = slot.dev[(name, i, j)]
        return ShardedTensor(mesh, spec[name], grid, (cohort,) + sources[name].shape[1:])

    def merge(st: DocState, ops: Dict[str, torch.Tensor], dev: torch.device) -> DocState:
        if kernels:
            return merge_step_full(st, ops["text_ops"], ops["mark_ops"], ranks_d[dev], ops["char_buf"])
        return merge_step_sorted_batch(
            st, ops["text_ops"], ops["round_of"], num_rounds, ops["mark_ops"], ranks_d[dev],
            ops["char_buf"], maxk,
        )

    def digest(new: DocState, dev: torch.device) -> torch.Tensor:
        if compute_digest:
            return convergence_digest(new, ranks_d[dev], multi_d[dev])
        return new.length.to(torch.int64)

    def mark(ev, name: str, which: int) -> None:
        """Record event ``name`` on every device's stream ``which``."""
        if ev is not None:
            for d, trio in streams.items():
                ev[d][name].record(trio[which])

    def compute(slot: _Slot, ev) -> list:
        """Every group's merge and digest; returns (output key, tensor)
        pairs to read back: the digests and the new state's shards."""
        states_in = DocState(**{f: laid_out(slot, f) for f in FIELDS})
        ops_in = {name: laid_out(slot, name) for name in sources if name not in FIELDS}
        mark(ev, "merge0", 1)
        outs = []
        for i in range(groups):
            dev = _key(mesh.group_device(i))
            outs.append(merge(group_state(states_in, i), {k: v.group(i) for k, v in ops_in.items()}, dev))
        new = from_group_states(outs, mesh, shard_seq)
        mark(ev, "merge1", 1)
        reads = [(("digest", i, 0), digest(outs[i], _key(mesh.group_device(i)))) for i in range(groups)]
        mark(ev, "digest1", 1)
        if readback_states:
            reads += [((f, i, j), getattr(new, f).shards[i, j]) for f in FIELDS for i in range(groups)
                      for j in parts[f]]
        return reads

    def run_slot(slot: _Slot, lo: int, hi: int, timing: Dict[str, Any]) -> None:
        ev = slot.ev
        if ev is not None:
            with telemetry.span("stream.wait", on="h2d"):
                for d in devices:
                    ev[d]["h2d1"].synchronize()  # the slot's previous H2D has read its staging
        t0 = time.perf_counter()
        for name, src in sources.items():
            for i in range(groups):
                g_lo = min(lo + i * rows, hi)
                g_hi = min(g_lo + rows, hi)
                for j in parts[name]:
                    _stage(slot.stage[(name, i, j)], seq_part(src, name, j), g_lo, g_hi)
        t1 = time.perf_counter()
        timing["stage_s"] = t1 - t0
        _enqueue(slot, ev)
        timing["enqueue_s"] = time.perf_counter() - t1

    def _enqueue(slot: _Slot, ev) -> None:
        if ev is None:
            for key, t in compute(slot, None):
                slot.out[key].copy_(t)
            return
        with _on(streams, 0):
            for trio in streams.values():
                for e in devices:
                    trio[0].wait_event(ev[e]["digest1"])  # the slot's previous cohort is done with its buffers
            mark(ev, "h2d0", 0)
            for key, (src, _) in entries.items():
                slot.dev[key].copy_(slot.stage[src], non_blocking=True)
            mark(ev, "h2d1", 0)
        with _on(streams, 1):
            for trio in streams.values():
                for e in devices:
                    trio[1].wait_event(ev[e]["h2d1"])
            reads = compute(slot, ev)
        with _on(streams, 2):
            for trio in streams.values():
                for e in devices:
                    trio[2].wait_event(ev[e]["digest1"])
            mark(ev, "d2h0", 2)
            for key, t in reads:
                slot.out[key].copy_(t, non_blocking=True)
                t.record_stream(streams[_key(t.device)][2])  # made on the compute stream, read here
            mark(ev, "d2h1", 2)

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
            try:
                faults.fire("device_readback")
                if slot.ev is not None:
                    with telemetry.span("stream.wait", on="d2h"):
                        for d in devices:
                            slot.ev[d]["d2h1"].synchronize()
                    ev = slot.ev[first]
                    timing["h2d_ms"] = ev["h2d0"].elapsed_time(ev["h2d1"])
                    timing["merge_ms"] = ev["merge0"].elapsed_time(ev["merge1"])
                    timing["digest_ms"] = ev["merge1"].elapsed_time(ev["digest1"])
                    timing["d2h_ms"] = ev["d2h0"].elapsed_time(ev["d2h1"])
                t0 = time.perf_counter()
                for i in range(groups):
                    g_lo = lo + i * rows
                    m = min(rows, hi - g_lo)
                    if m <= 0:
                        break
                    digests[g_lo : g_lo + m] = slot.out[("digest", i, 0)][:m].numpy().astype(np.uint32)
                    for f in FIELDS if out_states is not None else ():
                        for j in parts[f]:
                            seq_part(out_states[f][g_lo : g_lo + m], f, j)[...] = slot.out[(f, i, j)][:m].numpy()
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
