#!/usr/bin/env python3
"""Drive the PyTorch port of peritext_tpu on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build both CUDA kernels from ``peritext_tpu_torch/csrc`` with nvcc and
   print what the compiler reports, the card and its power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   benchmark's shape (1024 replicas, a 1000-char document, 4 concurrent
   writer streams of 64 ops with marks; C = 2048, M = 1024): outputs must
   be byte-equal, and so must ``merge_step_full``, ``merge_step`` (the
   text kernel and the per-op mark scan) and ``merge_step_plain``.  Print each one's time beside the plain version's, and
   each timed input's text-row mix.  The text kernel is also held and timed
   on an insert-heavy seeded input (a quarter each of pads, inserts,
   deletes and runs of up to 64 chars).
3. The same at the 10k-character latency shape (``make_merge_workload(
   10_000, 64, 2)``; 1024 replicas, C = 16384, M = 128), insert-heavy
   input included.
4. The main path: ``TorchUniverse.apply_changes`` (its default route, the
   exact per-op merge with both kernels) on 1024 replicas ingests the
   genesis change, 8 chained rounds in which replica r takes writer
   r % 4's 64 new ops, then an all-to-all merge of the other writers'
   histories.  Every replica's digest must agree, the texts and sampled
   spans must equal an oracle Doc that merged all four writers, and both
   kernels' launch counts must equal the merges the universe ran.
5. The exact path past 8192 characters: 64 replicas start at C = 8192,
   ingest an 8300-char genesis (growing to C = 16384), 2 chained rounds of
   2 writers and the all-to-all merge, with the checks of phase 4.
6. The patch path (``apply_changes_with_patches``, the exact per-op loop in
   plain torch on the card) at phase 4's width: 1024 replicas load the
   genesis and rounds 1-4 through the kernels (the scan path), then ingest
   rounds 5-8 with
   patches.  Four oracle observers, one per writer class, ingest the same
   changes in the gate's order; every replica's stream must equal its
   class's, patch for patch, and the accumulated stream its spans.  Then
   64 replicas (a depth cut) take the all-to-all through patches, checked
   the same way, and 8 replicas take round 5 with a span cap of 1, which
   must overflow into the planes readback with the same stream.  Prints
   the median ms per patched call (device loop, record readback, host
   assembly) beside phase 4's ``apply_changes`` on the same rounds.
7. ``TorchDoc`` on the card: three TorchDocs and an oracle Doc make 200
   random edits with marks on a 1000-char genesis, syncing every 10; each
   change and applied change must return the patches of an oracle twin,
   and the docs converge.  Prints the median and p95 ms of ``change()``
   and ``apply_change()``.  Neither phase may call a kernel's plain
   version or launch a merge kernel.
8. The sorted route at full width: phase 4's workload through
   ``apply_changes`` under ``PERITEXT_MERGE_PATH=sorted`` (sort-based
   placement and the batched mark phase, the census window where it bounds
   a batch, the kernels only for a batch deeper than
   ``PERITEXT_SORTED_MAX_ROUNDS``).  All 13 state fields must equal phase
   4's byte for byte, the oracle checks of phase 4 hold, each kernel
   launched once per counted scan fallback and no plain version ran.
   Prints per-round seconds beside phase 4's, the route stats and the
   device-busy share of one round under torch.profiler.
9. The window at the 10k-char shape: 1024 replicas at C = 16384, M = 128
   take a 10,000-char genesis and 8 rounds in which replica r takes writer
   r % 4's 64 ops, each writer's indices inside one 256-char hotspot per
   round, on the sorted route.  The window must engage; digests, texts and
   sampled spans must equal the writers'.  The same rounds on the default
   route (the kernels) on all 1024 replicas, and a full-table leg
   (``PERITEXT_MERGE_WINDOW=0``) on the first 64, must equal the windowed
   universe's rows on all 13 fields.  Prints per-round ms of the three
   legs.
10. The serving plane at the bench shape: ``ServePlane`` over a
   1024-replica ``TorchUniverse`` (C = 2048, M = 1024) holding phase 4's
   genesis, one session per replica.  Manual leg: rounds 1-2 of phase 4's
   writer streams, each writer's 64 ops per round cut into changes of 8
   ops (``split_rounds``), one submission per change, then ``drain()``.
   Threaded leg (the scheduler thread, default batch target, 25 ms
   deadline, telemetry on): 64 sessions take round 3, then
   ``flush_and_wait``.  Each session's patches must equal its writer
   class's oracle observer's, patch for patch; the accumulated stream its
   spans; each class one digest.  Prints flushes, flush ms, submissions
   per second, admit-to-applied p50/p95 and the plane's stats.
11. Resilience and durability on the card: (a) a ``device_launch`` fault
   absorbed by one retry on phase 4's round 1 at R = 1024, and a
   ``device_readback`` fault after the merge under
   ``PERITEXT_STRICT_COMMIT=1`` (the merge runs twice), each byte-equal
   to a fault-free twin; (b) with ``PERITEXT_DEGRADE=1``, a fault past the
   launch budget on one patched round at R = 64 degrades to the oracle,
   byte-equal in fields and patches; (c) an open ``device_launch``
   breaker under phase 10's plane: ``on_open="degrade"`` still serves the
   observers' patches, ``on_open="hold"`` sheds past the deadline; (d)
   ``save_universe``/``load_universe`` of phase 10's universe,
   ``export_replica``/``import_replica`` into a fresh universe, and
   ``resume_universe`` from the snapshot plus a ``ChangeLog`` tail through
   the kernels, equal to the live universe and the oracle.
12. The patched sorted route (``PERITEXT_MERGE_PATH=sorted``): phase 6's
   universe shape and rounds 5-8 through ``apply_changes_with_patches``,
   once windowed where the census plans a window and once on the full
   table (``PERITEXT_MERGE_WINDOW=0``); in each leg every stream must equal
   phase 6's per-op stream (and so its class's observer's), all 13 state
   fields phase 6's, and neither kernel nor either plain version may run.
   The full-table leg must build the winner cache on its first call and
   hand it to every later one.  Prints each call's total, device merge,
   readback and assembly ms, its cold and warm merge slices and the cache
   it kept, the route counters, and the busy share of one windowed call
   under torch.profiler.
13. The patched windowed route on phase 9's 10,000-char document (C =
   16384, R = 1024), rounds 5-8: the window must engage; 8 sampled
   replicas' streams and fields must equal the same batches on the
   full-table patched route and on the per-op loop, their spans their
   writers'.  Prints each leg's calls and a profiled last round.
14. Phase 10's manual serving leg on the sorted route: the sessions'
   patches equal the observers'; prints the flush median and p95 and the
   submissions per second beside phase 10's from the same run.
15. The capacity route: 64 replicas at C = 16384 take a 16,300-char
   genesis through the kernels, then runs that grow the document past
   16384: every merge above the kernels' limit must be counted in
   ``stats["capacity_routes"]`` and launch no kernel; one digest, and
   sampled spans equal to an oracle's.
16. The sharded serving tier on the card: ``ShardedServePlane`` with 4
   shards (``devices=None``: the card), C = 2048, M = 1024, each shard
   as wide as its sessions (so an evicted row frees a device row), a DWRR quantum of 1 (the widest
   and shallowest cohorts: a flush's per-op loop takes one step per op row
   of its deepest replica), manual mode.  256 documents of 4 collaborators (1024 sessions; rr
   placement puts collaborator w on shard w, 256 rows a shard): the
   genesis fans out from collaborator 0 and is drained, then collaborator
   w submits writer w's rounds 1-2 in changes of 8 ops (``split_rounds``),
   with ``drain``/``anti_entropy``/``drain`` after each round.  During
   round 2 ``migrate_session`` moves collaborator 0 of 64 documents to
   shard 1; each mover is held after it parks, so its round-2 submissions
   park and replay.  Then a ``DocLifecycle`` evicts every session of 64
   documents (256 rows) and round 3 hydrates each cold (the 64 migrated
   documents take round 3 first, warm), and once more under a watermark
   of 768 resident sessions: 64 more documents are evicted and round 3
   hydrates 16 of them, each hydration evicting the least recently active
   session first.  A threaded leg serves 16 documents (64 sessions) with
   one scheduler thread per shard: the genesis and the first half of
   round 1 drained by hand, then the second half on the threads, so the
   two modes are timed at one width on the same plane.  After each leg every
   document's sessions share one
   digest and the spans of an oracle ``Doc`` that merged all four writers,
   every session's accumulated stream equals its spans, and 16 sessions'
   streams equal oracle twins that ingest exactly what each was handed, in
   order.  Prints flush ms and submissions per second beside phase 10's
   manual leg, migration, evict and hydrate ms, warm and cold
   admit-to-applied, the bytes of one generation and the tenancy ratio
   (sessions served / device rows, above 1).  No kernel and no plain
   version runs.
17. Streamed replica cohorts at the north-star population (BASELINE
   config 5): ``make_merge_workload(10_000, 64, 4, seed=5)`` at C = 16384,
   M = 128; replica r takes stream r % 4; the host population is a
   broadcast of the genesis state plus tiled op rows.  8,192 replicas
   streamed in cohorts of 3,000 (a padded tail) at depth 1 and 2 must give
   states and digests byte-equal to one resident ``merge_step_full`` plus
   the digest, whose rows (one replica a stream) must equal
   ``merge_step_plain``'s on the card, digests included; the depth-2 sweep
   runs traced and ``scripts/trace_report.py``
   must find every ``stream.cohort`` lane ended.  Then 100,000 replicas in
   25 cohorts of 4,096 (the last 1,696 rows padded), digests only, at
   depth 2, 1, 1, 2: exactly 4 distinct digests, replica r's equal to the
   resident digest of stream r % 4.  A readback sweep of the first cohort
   and of the last two (the padded tail) gives the resident rows.  Every
   sweep launches each kernel once a cohort.  Prints the host's memory,
   the population's bytes beside the card's and ``cohort_for_budget``,
   each sweep's seconds and merged ops/s, per-cohort staging, enqueue,
   H2D, merge, digest and D2H times, peak device memory a slot beside the
   estimate, and the calls that wait on the host in a profiled sweep.
18. The reference's host-side drivers on ``TorchDoc(device="cuda")``, each
   leg under the status surface (``PERITEXT_STATUS`` with a 0.25 s
   ``PERITEXT_METRICS_INTERVAL``) and rendered by ``scripts/ops_top.py
   --once``: the fuzzer on TorchDocs, on mixed engines under
   ``DEFAULT_CHAOS_SPEC``, with a serving plane, and with a 4-shard plane
   that migrates and evicts; ``replay.assert_replay_converges`` on
   ``traces/fail-seed3.json`` equal to the oracle's replay; an
   ``EditorNetwork`` of three editors, manual (equal to an oracle network)
   and interval-driven (equal to oracle twins of every change made); and
   ``python -m peritext_tpu_torch.fuzz --engine torch --device cuda`` with
   the variables set.  Prints each leg's iterations and seconds.
19. Print the resilience counts of every phase (the script runs under
   ``PERITEXT_DEGRADE=0`` but for legs (b) and (c); launch retries,
   fast-fails and degraded batches must be 0 outside the legs that inject
   them, which assert their exact counts), the kernels' JSON summary
   (launches summed over phases 4, 5 and 8-18; ``ms`` per wrapper call
   between CUDA events, ``device_ms`` the kernel alone with a cold L2,
   both at phase 2), the card, and as the last line ``{"ok": true,
   "device": {...}}``.  Peak device memory is printed after every phase.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from peritext_tpu_torch import TorchDoc, TorchUniverse, replay, state_to_numpy
from peritext_tpu_torch.bench.bounds import bound, nbytes, text_phase_bytes
from peritext_tpu_torch.bench.timing import call_ms, device_ms
from peritext_tpu_torch.bench.workloads import (
    build_device_batch,
    doc_session,
    insert_heavy_text_ops,
    make_merge_workload,
    make_writer_rounds,
    split_rounds,
    text_row_mix,
    wire_rounds,
)
from peritext_tpu_torch.bridge import EditorNetwork
from peritext_tpu_torch.fuzz import DEFAULT_CHAOS_SPEC, fuzz
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops import sorted_patched as SP
from peritext_tpu_torch.ops.encode import prepare_sorted_batch
from peritext_tpu_torch.ops.state import FIELDS, map_state, state_from_numpy
from peritext_tpu_torch.oracle import Doc, accumulate_patches
from peritext_tpu_torch.parallel.stream import (
    cohort_for_budget,
    state_bytes_per_replica,
    stream_merge_sorted,
    transient_bytes_per_replica,
)
from peritext_tpu_torch.runtime import (
    ChangeLog,
    DocLifecycle,
    ServePlane,
    ServeSession,
    ServeShedError,
    ShardedServePlane,
    faults,
    health,
    migrate_session,
    telemetry,
)
from peritext_tpu_torch.runtime import checkpoint as ckpt
from peritext_tpu_torch.runtime.serve_shard import ParkedSubmission
from peritext_tpu_torch.runtime.sync import apply_changes, causal_order
from peritext_tpu_torch.schema import allow_multiple_array

REPO = os.path.dirname(os.path.abspath(__file__))

DOC_LEN = 1000
OPS_PER_ROUND = 64
WRITERS = 4
REPLICAS = 1024
ROUNDS = 8
# The JAX latency bench's 10k-character shape (time_merge_latency).
LARGE_DOC_LEN = 10_000
LARGE_CAPACITY = 16384
# Phase 9: each writer's edits stay in one hotspot of this many chars per round.
HOTSPOT = 256
DEVICE = "cuda"
# Selects the JAX package's default route (phases 8-9).
SORTED = {"PERITEXT_MERGE_PATH": "sorted"}
# Phase 10: internal ops per served change, and sessions of the threaded leg.
SERVE_OPS = 8
THREADED_SESSIONS = 64
# Phase 11b: replicas of the degraded universe.
DEGRADE_REPLICAS = 64
# Phase 15: a genesis just under the kernels' limit and the runs that push
# the document past it, on this many replicas.
CAPACITY_DOC_LEN = 16_300
CAPACITY_RUN = 128
CAPACITY_REPLICAS = 64
# Phase 16: documents of WRITERS collaborators each over SHARDS shards.
SHARDS = 4
SHARD_DOCS = 256
MIGRATED = 64
EVICTED_DOCS = 64
WATERMARK = 768
WATERMARK_DOCS = 16  # of the EVICTED_DOCS evicted again, those round 3 hydrates
THREADED_DOCS = 16
TWINS = 16
SHARD_DEVICES = None  # None: every visible CUDA device
# Phase 17, the north-star stream (BASELINE config 5): 100,000 replicas of
# a 10,000-char document at C = 16384, M = 128, in cohorts of 4,096.
STREAM_REPLICAS = 100_000
STREAM_MARKS = 128
STREAM_COHORT = 4096
STREAM_CHECK_REPLICAS = 8192  # the resident-equality population
STREAM_CHECK_COHORT = 3000  # leaves a padded tail at 8192
STREAM_CLASSES = 4
# Phase 18, the reference's drivers on TorchDocs on the card.
FUZZ_ITERS = 40
SERVE_FUZZ_ITERS = 30
STATUS_INTERVAL = "0.25"


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def env(**values: str):
    """Set environment variables for the block, restoring them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log_peak(label: str) -> None:
    """Peak device memory since the last call, then reset."""
    log(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    torch.cuda.reset_peak_memory_stats()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired outputs; logs where the
    first difference of each differing output lies."""
    err = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"kernel output {a.dtype}{tuple(a.shape)} vs plain {b.dtype}{tuple(b.shape)}")
        if not a.numel():
            continue
        diff = (a.long() - b.long()).abs()
        e = int(diff.max().item())
        if e:
            where = tuple(int(x) for x in (diff != 0).nonzero()[0])
            log(f"  output {i}: {int((diff != 0).sum().item())} elements differ; first at {where}: "
                f"kernel {a[where].item()} plain {b[where].item()}")
        err = max(err, e)
    return err


def measure_text(label: str, text_in, capacity: int, runs: int) -> dict:
    """Hold the text kernel byte-equal to its plain version, time it and
    bound it."""
    log(f"  [{label}] text rows: {text_row_mix(text_in[5], text_in[7])}")
    want = K.text_phase_plain(*text_in)
    got = cuda_kernels.text_phase(*text_in)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"[{label}] text_phase differs from its plain version: max abs err {err}")
    text_ops = text_in[5]
    live_rows = int((text_ops[:, :, K.K_KIND] != K.KIND_PAD).sum().item())
    t_bound, t_by = bound(text_phase_bytes(*text_in), 4 * live_rows * capacity)
    # The same planes with no op rows: what loading and storing them costs.
    no_rows = (*text_in[:5], text_ops[:, :0].contiguous(), *text_in[6:])
    floor_ms = device_ms(lambda: cuda_kernels.text_phase(*no_rows), runs)
    log(f"  [{label}] text kernel with no rows (planes in and out only): {floor_ms:.4f} ms device")
    return {
        "err": err,
        "ms": call_ms(lambda: cuda_kernels.text_phase(*text_in), runs),
        "device_ms": device_ms(lambda: cuda_kernels.text_phase(*text_in), runs),
        "plain_ms": call_ms(lambda: K.text_phase_plain(*text_in), max(2, runs // 4)),
        "bound_ms": t_bound,
        "bound_by": t_by,
    }


def phase_kernels(label: str, b: dict, capacity: int, runs: int) -> dict:
    """Both kernels and ``merge_step_full`` against their plain versions on
    one device batch (``build_device_batch``), timed and bounded."""
    st, text_ops, char_buf, mark_ops, ranks = (
        b["states"], b["text_ops"], b["char_buf"], b["mark_ops"], b["ranks"]
    )
    log(f"{label}: R={text_ops.shape[0]} C={capacity} M={st.max_mark_ops} "
        f"text rows={text_ops.shape[1]} mark rows={mark_ops.shape[1]}")
    results = {}

    text_in = (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text_ops, ranks, char_buf)
    results["text_phase"] = measure_text(label, text_in, capacity, runs)

    ec, ea, _, _, oi, ln = K.text_phase_plain(*text_in)
    bnd_def, bnd_mask = K._permute_boundaries(st.bnd_def, st.bnd_mask, oi)
    mark_in = (bnd_def, bnd_mask, ec, ea, ln, st.mark_count, mark_ops)
    got_m = cuda_kernels.mark_phase(*mark_in)
    want_m = K.mark_phase_plain(*mark_in)
    torch.cuda.synchronize()
    err = max_abs_err(got_m, want_m)
    if err != 0:
        raise AssertionError(f"[{label}] mark_phase differs from its plain version: max abs err {err}")
    if not (want_m[1] != bnd_mask).any():
        raise AssertionError(f"[{label}] the mark phase changed no mask word: the check proves nothing")
    live_marks = int((mark_ops[:, :, K.K_KIND] == K.KIND_MARK).sum().item())
    m_bound, m_by = bound(nbytes(*mark_in) + nbytes(*got_m), 8 * live_marks * capacity)
    results["mark_phase"] = {
        "err": err,
        "ms": call_ms(lambda: cuda_kernels.mark_phase(*mark_in), runs),
        "device_ms": device_ms(lambda: cuda_kernels.mark_phase(*mark_in), runs),
        "plain_ms": call_ms(lambda: K.mark_phase_plain(*mark_in), max(2, runs // 4)),
        "bound_ms": m_bound,
        "bound_by": m_by,
    }

    merge_in = (st, text_ops, mark_ops, ranks, char_buf)
    full = cuda_kernels.merge_step_full(*merge_in)
    plain = K.merge_step_plain(*merge_in)
    torch.cuda.synchronize()
    err = max_abs_err([getattr(full, f) for f in FIELDS], [getattr(plain, f) for f in FIELDS])
    if err != 0:
        raise AssertionError(f"[{label}] merge_step_full differs from merge_step_plain: max abs err {err}")
    full_ms = call_ms(lambda: cuda_kernels.merge_step_full(*merge_in), runs)
    plain_ms = call_ms(lambda: K.merge_step_plain(*merge_in), max(2, runs // 4))
    # The two plain-torch stages between and after the kernels, timed per
    # call as the whole merge is (the table append synchronizes).
    permute_ms = call_ms(lambda: K._permute_boundaries(st.bnd_def, st.bnd_mask, oi), runs)
    table_ms = call_ms(lambda: K.append_mark_table(st, mark_ops), runs)
    log(f"  [{label}] merge_step_full stages (per call): text {results['text_phase']['ms']:.4f} ms, "
        f"permute {permute_ms:.4f} ms, mark {results['mark_phase']['ms']:.4f} ms, "
        f"table {table_ms:.4f} ms")
    for name, r in results.items():
        report(label, name, r)
    log(f"  [{label}] merge_step_full: byte-equal to merge_step_plain on all {len(FIELDS)} fields; "
        f"{full_ms:.4f} ms per call, plain {plain_ms:.4f} ms")
    # merge_step_pallas's counterpart: the text kernel, then the per-op mark
    # scan in plain torch (it launches the text kernel once per call).
    before = cuda_kernels.LAUNCHES["text_phase"]
    composite = cuda_kernels.merge_step(*merge_in)
    torch.cuda.synchronize()
    if cuda_kernels.LAUNCHES["text_phase"] != before + 1:
        raise AssertionError(f"[{label}] merge_step did not launch the text kernel once")
    err = max_abs_err([getattr(composite, f) for f in FIELDS], [getattr(full, f) for f in FIELDS])
    if err != 0:
        raise AssertionError(f"[{label}] merge_step differs from merge_step_full: max abs err {err}")
    step_ms = call_ms(lambda: cuda_kernels.merge_step(*merge_in), max(2, runs // 4))
    log(f"  [{label}] merge_step (merge_step_pallas's counterpart: text kernel, plain per-op mark scan): "
        f"byte-equal to merge_step_full and merge_step_plain on all {len(FIELDS)} fields; "
        f"{step_ms:.4f} ms per call; 0 launches on the main path")
    insert_heavy(label, b, capacity, runs)
    return results


def report(label: str, name: str, r: dict) -> None:
    log(f"  [{label}] {name}: byte-equal to plain; kernel {r['ms']:.4f} ms per call, "
        f"{r['device_ms']:.4f} ms device (cold L2), plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def insert_heavy(label: str, b: dict, capacity: int, runs: int) -> None:
    """The text kernel on insert-heavy rows over the batch's states."""
    st = b["states"]
    ops, buf = insert_heavy_text_ops(np.random.default_rng(0), st, OPS_PER_ROUND, 128)
    label = f"{label} insert-heavy"
    heavy = measure_text(label, (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length,
                                 ops.to(DEVICE), b["ranks"], buf.to(DEVICE)), capacity, runs)
    report(label, "text_phase", heavy)


def phase_bench_shape(replicas: int, rounds: int, runs: int) -> dict:
    capacity = 1
    while capacity < DOC_LEN + (rounds + 1) * OPS_PER_ROUND + 8:
        capacity *= 2
    max_marks = 64
    while max_marks < (rounds + 1) * OPS_PER_ROUND + 32:
        max_marks *= 2
    wl = make_merge_workload(DOC_LEN, OPS_PER_ROUND, WRITERS, True, seed=0)
    b = build_device_batch(wl, replicas, capacity, max_marks, device=DEVICE)
    return phase_kernels("phase 2", b, capacity, runs)


def phase_large_shape(replicas: int, runs: int) -> dict:
    t0 = time.perf_counter()
    wl = make_merge_workload(LARGE_DOC_LEN, OPS_PER_ROUND, 2, True, seed=0)
    b = build_device_batch(wl, replicas, LARGE_CAPACITY, 128, device=DEVICE)
    log(f"phase 3: workload + batch built in {time.perf_counter() - t0:.2f} s (host)")
    return phase_kernels("phase 3", b, LARGE_CAPACITY, runs)


def drive(uni: TorchUniverse, batches: list):
    """``apply_changes`` each batch (cut to the universe's replicas), each
    synchronized.  Returns the seconds of each call and of its host control
    plane."""
    times, host = [], []
    for batch in batches:
        h = uni.stats["host_seconds"]
        t = time.perf_counter()
        uni.apply_changes(batch[: len(uni.replica_ids)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        host.append(uni.stats["host_seconds"] - h)
    return times, host


def profile_round(label: str, uni: TorchUniverse, batches: list, wall_s: float) -> None:
    """Every batch but the last on ``uni``, then the last under
    torch.profiler, against ``wall_s``, that round's unprofiled time."""
    for batch in batches[:-1]:
        uni.apply_changes(batch)
    p = profile_device(lambda: uni.apply_changes(batches[-1]))
    wall = 1e3 * wall_s
    if p is None:
        log(f"  [{label}] profiler: no device time recorded; device busy share not measured")
        return
    log(f"  [{label}] profiler, round {len(batches) - 1} at R={len(uni.replica_ids)}: {p['launches']} "
        f"kernel launches, {p['kernel_ms']:.4f} ms kernel time, busy {100 * p['kernel_ms'] / wall:.1f}% of "
        f"the unprofiled round's {wall:.4f} ms; {p['copies']} copies, {p['copy_ms']:.4f} ms; top kernels: "
        f"{p['top']}")


def main_path_batches(wl: dict, replicas: int, writers: int) -> list:
    """Genesis, the rounds (replica r takes writer r % writers' changes) and
    the all-to-all of the other writers' histories."""
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(writers)]
    batches = [[[wl["genesis"]]] * replicas]
    batches += [[rnd[r % writers] for r in range(replicas)] for rnd in wl["rounds"]]
    batches.append([
        [c for w in range(writers) if w != r % writers for c in history[w]]
        for r in range(replicas)
    ])
    return batches


def phase_main_path(label: str, replicas: int, doc_len: int, writers: int, rounds: int,
                    capacity: int, max_marks: int, samples: int, seed: int, scan: bool) -> dict:
    """``apply_changes`` over genesis, rounds and the all-to-all, on the
    default route (``scan``: each merge launches both kernels) or under
    ``PERITEXT_MERGE_PATH=sorted`` (a kernel launches only for a counted
    scan fallback)."""
    t0 = time.perf_counter()
    wl = make_writer_rounds(doc_len, OPS_PER_ROUND, writers, rounds, True, seed=seed)
    oracle = Doc("oracle")
    oracle.apply_change(wl["genesis"])
    for w in range(writers):
        for rnd in wl["rounds"]:
            for c in rnd[w]:
                oracle.apply_change(c)
    expect_spans = oracle.get_text_with_formatting(["text"])
    expect_text = "".join(s["text"] for s in expect_spans)
    log(f"{label}: workload + oracle built in {time.perf_counter() - t0:.2f} s (host); "
        f"{'the default route (the kernels)' if scan else 'PERITEXT_MERGE_PATH=sorted'}")

    names = [f"replica{i}" for i in range(replicas)]
    batches = main_path_batches(wl, replicas, writers)
    reset_counts()
    with env(**({} if scan else SORTED)):
        uni = TorchUniverse(names, capacity=capacity, max_mark_ops=max_marks, device=DEVICE)
        times, host = drive(uni, batches)
    launches = dict(cuda_kernels.LAUNCHES)
    merges = uni.stats["launches"]
    want = merges if scan else uni.stats["scan_fallbacks"]
    if merges <= 0 or any(n != want for n in launches.values()) or any(PLAIN_CALLS.values()):
        raise AssertionError(f"[{label}] launch counts {launches} (plain calls {PLAIN_CALLS}) != "
                             f"{'universe merges' if scan else 'scan fallbacks'} {want}")

    digests = uni.digests()
    if len(set(digests.tolist())) != 1:
        raise AssertionError(f"[{label}] replicas disagree: {len(set(digests.tolist()))} distinct digests")
    texts = uni.texts()
    bad = [r for r, t in enumerate(texts) if t != expect_text]
    if bad:
        raise AssertionError(f"[{label}] {len(bad)} replicas' text differs from the oracle's (first {bad[0]})")
    step = max(1, replicas // samples)
    for r in list(range(0, replicas, step))[:samples] + [replicas - 1]:
        if uni.spans(r) != expect_spans:
            raise AssertionError(f"[{label}] replica {r}'s spans differ from the oracle's")
    if not any(s["marks"] for s in expect_spans):
        raise AssertionError(f"[{label}] the merged document carries no marks: the check proves nothing")

    state_bytes = nbytes(*(getattr(uni.states, f) for f in FIELDS))
    total = sum(times)
    ops = uni.stats["ops_applied"]
    log(f"  merges={merges} launches={launches} ops_applied={ops} changes={uni.stats['changes_ingested']}")
    log(f"  round seconds (genesis, {rounds} rounds, all-to-all): "
        + " ".join(f"{t:.4f}" for t in times))
    log("  host control plane ms per round (stats['host_seconds']): " + " ".join(f"{1e3 * t:.4f}" for t in host))
    log(f"  merged ops/s {ops / total:.1f} over {total:.3f} s (host clock, each merge synchronized); "
        f"host control plane {uni.stats['host_seconds']:.4f} s of it")
    log(f"  routes: scan_fallbacks={uni.stats['scan_fallbacks']} "
        f"windowed_launches={uni.stats['windowed_launches']} "
        f"window_fallbacks={uni.stats['window_fallbacks']} window_rebuilds={uni.stats['window_rebuilds']} "
        f"window_census_skips={uni.stats['window_census_skips']}")
    log(f"  capacity={uni.capacity} (growths {uni.stats['capacity_growths']}) "
        f"max_mark_ops={uni.max_mark_ops} max length={max(uni.lengths)} "
        f"state bytes on device={state_bytes} text chars={len(expect_text)} "
        f"spans={len(expect_spans)} digest={int(digests[0])}")
    return {"launches": launches, "capacity": uni.capacity, "max_length": max(uni.lengths),
            "growths": uni.stats["capacity_growths"], "round_seconds": times, "uni": uni,
            "wl": wl, "ops": ops}


PLAIN_CALLS = {"text_phase_plain": 0, "mark_phase_plain": 0}


def count_plain_calls() -> None:
    """Count every call of the kernels' plain versions from here on (the
    wrappers and this script reach them through the module attribute)."""
    for name in PLAIN_CALLS:
        fn = getattr(K, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            PLAIN_CALLS[_name] += 1
            return _fn(*args, **kwargs)

        setattr(K, name, counted)


def no_kernel_or_plain_calls(label: str) -> None:
    """The patch path and TorchDoc run neither merge kernel nor either
    kernel's plain version: the counts must still be 0."""
    if any(cuda_kernels.LAUNCHES.values()) or any(PLAIN_CALLS.values()):
        raise AssertionError(f"[{label}] launches {cuda_kernels.LAUNCHES}, plain calls {PLAIN_CALLS}")


def reset_counts() -> None:
    cuda_kernels.reset_launch_counts()
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0


def median_p95(xs) -> str:
    xs = sorted(xs)
    return f"median {statistics.median(xs):.4f} p95 {xs[min(len(xs) - 1, int(0.95 * len(xs)))]:.4f}"


def observer_streams(wl: dict, writers: int, cut: int):
    """One oracle observer per writer class ingests the genesis and every
    round in the gate's order.  Returns the observers, each class's stream
    of the genesis and rounds before ``cut`` (loaded without patches) and
    its stream per round from ``cut`` on."""
    observers = [Doc(f"observer{w}") for w in range(writers)]
    prefix = [list(o.apply_change(wl["genesis"])) for o in observers]
    per_round = [[] for _ in range(writers)]
    for k, rnd in enumerate(wl["rounds"]):
        for w, obs in enumerate(observers):
            patches = [p for c in causal_order(rnd[w], dict(obs.clock)) for p in obs.apply_change(c)]
            if k < cut:
                prefix[w] += patches
            else:
                per_round[w].append(patches)
    return observers, prefix, per_round


def load_universe(names, wl, rounds, writers, capacity, max_marks) -> TorchUniverse:
    """A universe that took the genesis and the first ``rounds`` rounds
    through ``apply_changes`` on its default route (the kernels); their
    launches must equal the merges."""
    uni = TorchUniverse(names, capacity=capacity, max_mark_ops=max_marks, device=DEVICE)
    reset_counts()
    uni.apply_changes([[wl["genesis"]]] * len(names))
    for rnd in wl["rounds"][:rounds]:
        uni.apply_changes([rnd[r % writers] for r in range(len(names))])
    merges = uni.stats["launches"]
    if any(n != merges for n in cuda_kernels.LAUNCHES.values()):
        raise AssertionError(f"launch counts {cuda_kernels.LAUNCHES} != merges {merges}")
    return uni


def check_streams(label: str, uni: TorchUniverse, out: dict, expect, writers: int) -> None:
    bad = [r for r, name in enumerate(uni.replica_ids) if out[name] != expect[r % writers]]
    if bad:
        r = bad[0]
        got, want = out[uni.replica_ids[r]], expect[r % writers]
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        raise AssertionError(f"[{label}] {len(bad)} replicas' patch streams differ from their observer's; "
                             f"replica {r}: {len(got)} vs {len(want)} patches, first difference at {first}")


def profile_device(call) -> dict | None:
    """Run ``call`` once under torch.profiler and sum its device-side events
    (kernels, and copies apart); None when the profiler recorded no device
    time.  CPU-side operator rows are left out: they repeat the device time
    of the kernels they launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    if not kernels:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "launches": sum(e.count for e in kernels),
        "kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "copies": sum(e.count for e in copies),
        "copy_ms": sum(e.self_device_time_total for e in copies) / 1e3,
        "top": "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}" for e in top),
    }


def profile_patched_call(label: str, names, wl: dict, cut: int, ms: dict, route=None) -> None:
    """Round ``cut + 1`` once more on a fresh universe, under torch.profiler
    (under the ``route`` variables, if given): the device time of the
    patched call against the unprofiled calls' median loop and total, and
    the kernels that take most of it."""
    uni = load_universe(names, wl, cut, WRITERS, 2048, 1024)
    batch = [wl["rounds"][cut][r % WRITERS] for r in range(len(names))]
    with env(**(route or {})):
        p = profile_device(lambda: uni.apply_changes_with_patches(batch))
    if p is None:
        log(f"  [{label}] profiler: no device time recorded; device busy share not measured")
        return
    log(f"  [{label}] profiler, one patched call at R={len(names)}: {p['launches']} "
        f"kernel launches, {p['kernel_ms']:.4f} ms kernel time (busy "
        f"{100 * p['kernel_ms'] / ms['patch_loop_seconds']:.1f}% of the unprofiled loop's median "
        f"{ms['patch_loop_seconds']:.4f} ms); {p['copies']} copies, {p['copy_ms']:.4f} ms; kernels and "
        f"copies {100 * (p['kernel_ms'] + p['copy_ms']) / ms['total']:.1f}% of the call's median "
        f"{ms['total']:.4f} ms; top kernels: {p['top']}")


def phase_patch_path(replicas: int, a2a_replicas: int, main_round_seconds, samples: int) -> dict:
    label = "phase 6"
    t0 = time.perf_counter()
    wl = make_writer_rounds(DOC_LEN, OPS_PER_ROUND, WRITERS, ROUNDS, True, seed=1)
    cut = ROUNDS // 2
    observers, prefix, per_round = observer_streams(wl, WRITERS, cut)
    log(f"{label}: workload + {WRITERS} oracle observers built in {time.perf_counter() - t0:.2f} s (host)")

    names = [f"replica{i}" for i in range(replicas)]
    uni = load_universe(names, wl, cut, WRITERS, 2048, 1024)
    merges = uni.stats["launches"]
    reset_counts()
    streams = {r: [] for r in range(0, replicas, max(1, replicas // samples))}
    calls, outs = [], []
    for k in range(cut, ROUNDS):
        before = {key: uni.stats[key] for key in ("patch_loop_seconds", "patch_readback_seconds",
                                                   "patch_assemble_seconds")}
        t = time.perf_counter()
        out = uni.apply_changes_with_patches([wl["rounds"][k][r % WRITERS] for r in range(replicas)])
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        check_streams(label, uni, out, [per_round[w][k - cut] for w in range(WRITERS)], WRITERS)
        for r in streams:
            streams[r] += out[names[r]]
        outs.append(out)
        calls.append({"total": total, **{key: uni.stats[key] - v for key, v in before.items()}})
    no_kernel_or_plain_calls(label)
    for r, stream in streams.items():
        spans = uni.spans(r)
        if spans != observers[r % WRITERS].get_text_with_formatting(["text"]):
            raise AssertionError(f"[{label}] replica {r}'s spans differ from its observer's")
        if accumulate_patches(prefix[r % WRITERS] + stream) != spans:
            raise AssertionError(f"[{label}] replica {r}'s accumulated stream differs from its spans")
    n_patches = sum(len(per_round[w][k]) for w in range(WRITERS) for k in range(ROUNDS - cut))
    ms = {key: 1e3 * statistics.median(c[key] for c in calls) for key in calls[0]}
    merge_ms = 1e3 * statistics.median(main_round_seconds[1 + cut : 1 + ROUNDS])
    log(f"  R={replicas} C={uni.capacity} M={uni.max_mark_ops}: rounds {cut + 1}-{ROUNDS} through "
        f"patches, {OPS_PER_ROUND} ops per replica per call; every replica's stream equals its "
        f"observer's ({n_patches} patches over the 4 classes); patch-path launches "
        f"{uni.stats['launches'] - merges} after {merges} merges, "
        f"rows padded {uni.stats['rows_padded']}, readback overflows {uni.stats['readback_overflows']}")
    log(f"  patched call, median of {len(calls)}: {ms['total']:.4f} ms (device loop, synchronized, "
        f"{ms['patch_loop_seconds']:.4f}; record readback {ms['patch_readback_seconds']:.4f}; "
        f"host assembly {ms['patch_assemble_seconds']:.4f}); apply_changes on the same rounds "
        f"(phase 4) {merge_ms:.4f} ms")
    log("  per call ms (total, loop, readback, assembly): " + "; ".join(
        f"{1e3 * c['total']:.4f}, {1e3 * c['patch_loop_seconds']:.4f}, "
        f"{1e3 * c['patch_readback_seconds']:.4f}, {1e3 * c['patch_assemble_seconds']:.4f}" for c in calls))
    final_states = uni.states
    del uni
    torch.cuda.empty_cache()
    profile_patched_call(label, names, wl, cut, ms)

    # The all-to-all through patches, cut to a2a_replicas replicas.
    a2a_names = names[:a2a_replicas]
    uni = load_universe(a2a_names, wl, ROUNDS, WRITERS, 2048, 1024)
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(WRITERS)]
    batch = [[c for w in range(WRITERS) if w != r % WRITERS for c in history[w]]
             for r in range(a2a_replicas)]
    expect = [[p for c in causal_order(batch[w], dict(obs.clock)) for p in obs.apply_change(c)]
              for w, obs in enumerate(observers)]
    reset_counts()
    t = time.perf_counter()
    out = uni.apply_changes_with_patches(batch)
    torch.cuda.synchronize()
    a2a_s = time.perf_counter() - t
    no_kernel_or_plain_calls(label)
    check_streams(label, uni, out, expect, WRITERS)
    for r in range(min(WRITERS, a2a_replicas)):
        full = prefix[r] + [p for rnd in per_round[r] for p in rnd] + out[a2a_names[r]]
        if accumulate_patches(full) != uni.spans(r):
            raise AssertionError(f"[{label}] all-to-all replica {r}'s accumulated stream differs from its spans")
    if len(set(uni.digests().tolist())) != 1:
        raise AssertionError(f"[{label}] all-to-all replicas disagree")
    rows = max(sum(len(c["ops"]) for c in b) for b in batch)
    passes = 1 + uni.stats["readback_overflows"]
    log(f"  all-to-all through patches on {a2a_replicas} of the {replicas} replicas (depth cut: each "
        f"replica takes up to {rows} ops, one loop step per op row): "
        f"{1e3 * a2a_s:.4f} ms, device loop {1e3 * uni.stats['patch_loop_seconds']:.4f} "
        f"({1e3 * uni.stats['patch_loop_seconds'] / (rows * passes):.4f} per row over {passes} "
        f"pass(es)), readback "
        f"{1e3 * uni.stats['patch_readback_seconds']:.4f}, assembly "
        f"{1e3 * uni.stats['patch_assemble_seconds']:.4f}; {sum(map(len, expect))} patches over the "
        f"4 classes equal the observers'; readback overflows {uni.stats['readback_overflows']}; "
        f"one digest")
    del uni

    # One small batch with a span cap of 1: it must overflow into planes.
    os.environ["PERITEXT_PATCH_SPAN_CAP"] = "1"
    try:
        small = load_universe(names[:8], wl, cut, WRITERS, 2048, 1024)
        reset_counts()
        out = small.apply_changes_with_patches([wl["rounds"][cut][r % WRITERS] for r in range(8)])
    finally:
        del os.environ["PERITEXT_PATCH_SPAN_CAP"]
    no_kernel_or_plain_calls(label)
    if small.stats["readback_overflows"] < 1:
        raise AssertionError(f"[{label}] a span cap of 1 did not overflow")
    check_streams(label, small, out, [per_round[w][0] for w in range(WRITERS)], WRITERS)
    log(f"  span cap 1 on 8 replicas, round {cut + 1}: {small.stats['readback_overflows']} overflow, "
        f"planes readback, the same streams; cap grew to {small._span_cap}")
    return {"patched_ms": ms, "merge_ms": merge_ms, "a2a_ms": 1e3 * a2a_s, "wl": wl,
            "per_round": per_round, "outs": outs, "states": final_states}


def phase_doc(edits: int, sync_every: int) -> dict:
    label = "phase 7"
    genesis = make_writer_rounds(DOC_LEN, 1, 1, 0, False, seed=3)["genesis"]
    docs = [TorchDoc(f"torch{i}", capacity=2048, max_mark_ops=256, device=DEVICE) for i in range(3)]
    docs.append(Doc("oracle"))
    reset_counts()
    t = time.perf_counter()
    out = doc_session(docs, genesis, edits=edits, sync_every=sync_every, seed=7)
    total = time.perf_counter() - t
    no_kernel_or_plain_calls(label)
    for d in docs[:3]:
        if d._uni.states.elem_ctr.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"[{label}] {d.actor_id} is not on the card")
    if not any(span["marks"] for span in out["spans"]):
        raise AssertionError(f"[{label}] the session ended with no marks: the check proves nothing")
    n_torch_changes = len(out["change_ms"])
    log(f"{label}: 3 TorchDocs + 1 oracle Doc, {edits} edits from a {DOC_LEN}-char genesis, sync every "
        f"{sync_every}: every change and applied change equals its oracle twin's; converged at "
        f"{sum(len(s['text']) for s in out['spans'])} chars, {len(out['spans'])} spans; {total:.2f} s")
    log(f"  change() ms over {n_torch_changes} calls (all four docs): {median_p95(out['change_ms'])}; "
        f"apply_change() ms over {len(out['apply_ms'])} calls: {median_p95(out['apply_ms'])}")
    torch_change = [ms for ms, who in zip(out["change_ms"], out["change_by"]) if who < 3]
    torch_apply = [ms for ms, who in zip(out["apply_ms"], out["apply_by"]) if who < 3]
    log(f"  TorchDoc only: change() {median_p95(torch_change)} over {len(torch_change)}; "
        f"apply_change() {median_p95(torch_apply)} over {len(torch_apply)}")
    return out


def same_fields(label: str, got, want) -> None:
    """All 13 state fields byte-equal (both DocStates, any device)."""
    a, b = state_to_numpy(got), state_to_numpy(want)
    bad = [f for f in FIELDS if a[f].dtype != b[f].dtype or a[f].shape != b[f].shape or (a[f] != b[f]).any()]
    if bad:
        raise AssertionError(f"[{label}] state fields differ: {bad}")


def phase_sorted_path(scan_run: dict, capacity: int, max_marks: int, samples: int) -> dict:
    """Phase 4's workload on the sorted route; phase 4's universe (the
    default route, the kernels) is the byte-level reference."""
    label = "phase 8"
    torch.cuda.reset_peak_memory_stats()
    run = phase_main_path(label, REPLICAS, DOC_LEN, WRITERS, ROUNDS, capacity, max_marks, samples=samples,
                          seed=1, scan=False)
    uni = run["uni"]
    same_fields(label, uni.states, scan_run["uni"].states)
    log(f"  all {len(FIELDS)} state fields of {REPLICAS} replicas equal phase 4's (the kernels) byte for byte")
    t_sorted, t_scan = run["round_seconds"], scan_run["round_seconds"]
    log("  round ms, sorted route / default route (phase 4), genesis, rounds, all-to-all: " + "; ".join(
        f"{1e3 * a:.4f} / {1e3 * b:.4f}" for a, b in zip(t_sorted, t_scan)))
    log(f"  merged ops/s: sorted {run['ops'] / sum(t_sorted):.1f}, default (phase 4) "
        f"{scan_run['ops'] / sum(t_scan):.1f}; rounds 1-{ROUNDS} alone: sorted "
        f"{1e3 * statistics.median(t_sorted[1:-1]):.4f} ms median, default "
        f"{1e3 * statistics.median(t_scan[1:-1]):.4f}; host control plane {uni.stats['host_seconds']:.4f} s")
    del run["uni"], uni
    torch.cuda.empty_cache()

    # Round 8 again on a fresh universe, under the profiler.
    names = [f"replica{i}" for i in range(REPLICAS)]
    batches = main_path_batches(run["wl"], REPLICAS, WRITERS)[: ROUNDS + 1]
    with env(**SORTED):
        uni = TorchUniverse(names, capacity=capacity, max_mark_ops=max_marks, device=DEVICE)
        profile_round(label, uni, batches, t_sorted[ROUNDS])
    del uni
    torch.cuda.empty_cache()
    return run


def phase_window(replicas: int, full_replicas: int, samples: int) -> dict:
    """The 10k-char document with hotspot edits on the sorted route,
    windowed, against the writers, the default route (the kernels) and a
    full-table leg."""
    label = "phase 9"
    t0 = time.perf_counter()
    wl = make_writer_rounds(LARGE_DOC_LEN, OPS_PER_ROUND, WRITERS, ROUNDS, True, seed=4, locality=HOTSPOT)
    expect = [w.get_text_with_formatting(["text"]) for w in wl["writers"]]
    expect_text = ["".join(s["text"] for s in e) for e in expect]
    if not all(any(s["marks"] for s in e) for e in expect):
        raise AssertionError(f"[{label}] a writer's document carries no marks: the check proves nothing")
    log(f"{label}: workload built in {time.perf_counter() - t0:.2f} s (host); {WRITERS} writers, "
        f"{ROUNDS} rounds of {OPS_PER_ROUND} ops in a {HOTSPOT}-char hotspot each")
    names = [f"replica{i}" for i in range(replicas)]
    batches = [[[wl["genesis"]]] * replicas] + [[rnd[r % WRITERS] for r in range(replicas)] for rnd in wl["rounds"]]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with env(**SORTED):
        uni = TorchUniverse(names, capacity=LARGE_CAPACITY, max_mark_ops=128, device=DEVICE)
        times, host = drive(uni, batches)
    launches = dict(cuda_kernels.LAUNCHES)
    if any(n != uni.stats["scan_fallbacks"] for n in launches.values()) or any(PLAIN_CALLS.values()):
        raise AssertionError(f"[{label}] launch counts {launches} (plain calls {PLAIN_CALLS}) != "
                             f"scan fallbacks {uni.stats['scan_fallbacks']}")
    if uni.stats["windowed_launches"] < 1:
        raise AssertionError(f"[{label}] the window never engaged: {uni.stats}")
    digests = uni.digests()
    for w in range(WRITERS):
        if len(set(digests[w::WRITERS].tolist())) != 1:
            raise AssertionError(f"[{label}] writer {w}'s replicas disagree")
    texts = uni.texts()
    bad = [r for r, t in enumerate(texts) if t != expect_text[r % WRITERS]]
    if bad:
        raise AssertionError(f"[{label}] {len(bad)} replicas' text differs from their writer's (first {bad[0]})")
    step = max(1, replicas // samples)
    for r in list(range(0, replicas, step))[:samples] + [replicas - 1]:
        if uni.spans(r) != expect[r % WRITERS]:
            raise AssertionError(f"[{label}] replica {r}'s spans differ from its writer's")
    log(f"  windowed: R={replicas} C={uni.capacity} M={uni.max_mark_ops}; launches={launches} "
        f"scan_fallbacks={uni.stats['scan_fallbacks']} windowed_launches={uni.stats['windowed_launches']} "
        f"window_fallbacks={uni.stats['window_fallbacks']} window_rebuilds={uni.stats['window_rebuilds']} "
        f"window_census_skips={uni.stats['window_census_skips']}; digests, texts and {samples + 1} "
        f"replicas' spans equal the writers'; host control plane {uni.stats['host_seconds']:.4f} s")
    log_peak(f"  [{label}] windowed leg")

    # The same rounds on the default route, every replica: both kernels
    # launch once per merge.
    reset_counts()
    scan = TorchUniverse(names, capacity=LARGE_CAPACITY, max_mark_ops=128, device=DEVICE)
    scan_times, scan_host = drive(scan, batches)
    scan_launches = dict(cuda_kernels.LAUNCHES)
    if any(n != scan.stats["launches"] for n in scan_launches.values()) or any(PLAIN_CALLS.values()):
        raise AssertionError(f"[{label}] default-route launch counts {scan_launches} (plain calls "
                             f"{PLAIN_CALLS}) != merges {scan.stats['launches']}")
    same_fields(label, scan.states, uni.states)
    log(f"  default route (the kernels) on all {replicas} replicas: all {len(FIELDS)} state fields equal the "
        f"windowed universe's; launches={scan_launches}")
    del scan
    torch.cuda.empty_cache()
    log_peak(f"  [{label}] default-route leg")

    # The full table on the first full_replicas replicas (a depth cut).
    with env(**SORTED, PERITEXT_MERGE_WINDOW="0"):
        full = TorchUniverse(names[:full_replicas], capacity=LARGE_CAPACITY, max_mark_ops=128, device=DEVICE)
        full_times, full_host = drive(full, batches)
    if full.stats["windowed_launches"] != 0:
        raise AssertionError(f"[{label}] the full-table leg windowed: {full.stats}")
    same_fields(label, full.states, map_state(lambda x: x[:full_replicas], uni.states))
    log(f"  full-table leg on replicas 0-{full_replicas - 1}: all {len(FIELDS)} state fields equal the "
        f"windowed universe's rows; scan_fallbacks={full.stats['scan_fallbacks']}")
    log(f"  round ms (genesis, rounds 1-{ROUNDS}), windowed R={replicas} / default route R={replicas} / "
        f"full table R={full_replicas}: " + "; ".join(
            f"{1e3 * a:.4f} / {1e3 * b:.4f} / {1e3 * c:.4f}" for a, b, c in zip(times, scan_times, full_times)))
    log("  host control plane ms per round, windowed / default route / full table: " + "; ".join(
        f"{1e3 * a:.4f} / {1e3 * b:.4f} / {1e3 * c:.4f}" for a, b, c in zip(host, scan_host, full_host)))
    log(f"  rounds 1-{ROUNDS} median: windowed {1e3 * statistics.median(times[1:]):.4f} ms at R={replicas} "
        f"(host {1e3 * statistics.median(host[1:]):.4f}), default route "
        f"{1e3 * statistics.median(scan_times[1:]):.4f} ms at R={replicas} "
        f"(host {1e3 * statistics.median(scan_host[1:]):.4f}), full table "
        f"{1e3 * statistics.median(full_times[1:]):.4f} ms at R={full_replicas} "
        f"(host {1e3 * statistics.median(full_host[1:]):.4f})")
    out = {"launches": {k: launches[k] + scan_launches[k] for k in launches}, "round_seconds": times,
           "scan_round_seconds": scan_times, "full_round_seconds": full_times, "wl": wl}
    del uni, full
    torch.cuda.empty_cache()
    # Round 8 of the windowed universe again on a fresh one, under the profiler.
    with env(**SORTED):
        uni = TorchUniverse(names, capacity=LARGE_CAPACITY, max_mark_ops=128, device=DEVICE)
        profile_round(label, uni, batches, times[-1])
    del uni
    torch.cuda.empty_cache()
    return out


RESILIENCE = ("launch_retries", "fastfails", "degraded_batches")
TALLY = dict.fromkeys(RESILIENCE, 0)
PHASE_TALLIES = []


class TalliedStats(dict):
    """A universe's stats that also add their resilience counters to TALLY."""

    def __setitem__(self, key, value):
        if key in TALLY:
            TALLY[key] += value - self.get(key, 0)
        super().__setitem__(key, value)


def tally_resilience() -> None:
    """From here on every TorchUniverse (a TorchDoc's and a loaded one's
    too) counts its launch retries, fast-fails and degraded batches into
    TALLY."""
    init = TorchUniverse.__init__

    def counted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.stats = TalliedStats(self.stats)

    TorchUniverse.__init__ = counted


@contextlib.contextmanager
def resilience(label: str, **expected: int):
    """Hold a block's resilience counts to exactly ``expected`` (0 where
    unnamed): no fallback may hide a failing device."""
    before = dict(TALLY)
    yield
    got = {k: TALLY[k] - before[k] for k in RESILIENCE}
    want = {k: expected.get(k, 0) for k in RESILIENCE}
    PHASE_TALLIES.append((label, got))
    if got != want:
        raise AssertionError(f"[{label}] resilience counts {got}, expected {want}")


def add_launches(acc: dict) -> None:
    """Add the kernels' counts since the last reset to ``acc``, and reset."""
    for name, n in cuda_kernels.LAUNCHES.items():
        acc[name] = acc.get(name, 0) + n
    reset_counts()


def serve_workload(rounds: int) -> dict:
    """Phase 4's genesis and first ``rounds`` writer rounds, each writer's
    64 ops per round cut into changes of SERVE_OPS ops."""
    wl = make_writer_rounds(DOC_LEN, OPS_PER_ROUND, WRITERS, rounds, True, seed=1)
    return {"genesis": wl["genesis"], "rounds": split_rounds(wl["rounds"], SERVE_OPS)}


def quantile_ms(xs, q: float) -> float:
    xs = sorted(xs)
    return 1e3 * xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_serving(replicas: int, threaded: int, samples: int) -> dict:
    """ServePlane over a universe on the card: a manual leg at the full
    width, then a threaded leg on ``threaded`` sessions."""
    label = "phase 10"
    t0 = time.perf_counter()
    wl = serve_workload(3)
    observers, prefix, per_round = observer_streams(wl, WRITERS, 0)
    log(f"{label}: workload + {WRITERS} oracle observers built in {time.perf_counter() - t0:.2f} s (host); "
        f"{len(wl['rounds'][0][0])} changes of {SERVE_OPS} ops per writer per round")
    names = [f"replica{i}" for i in range(replicas)]
    launches: dict = {}
    reset_counts()
    uni = TorchUniverse(names, capacity=2048, max_mark_ops=1024, device=DEVICE)
    uni.apply_changes([[wl["genesis"]]] * replicas)
    if any(n != uni.stats["launches"] for n in cuda_kernels.LAUNCHES.values()):
        raise AssertionError(f"[{label}] genesis launches {cuda_kernels.LAUNCHES} != merges")
    add_launches(launches)

    manual = serve_manual_leg(label, uni, names, wl, per_round)
    sessions = manual["sessions"]

    # Threaded leg: the scheduler thread, default batch target, 25 ms deadline.
    telemetry.reset()
    telemetry.enable()
    tplane = ServePlane(uni, deadline_ms=25.0)
    tsessions = [tplane.session(f"t{r}", replica=names[r], record_stream=True) for r in range(threaded)]
    t = time.perf_counter()
    subs = [s.submit([c]) for r, s in enumerate(tsessions) for c in wl["rounds"][2][r % WRITERS]]
    tplane.flush_and_wait(timeout=600.0)
    threaded_s = time.perf_counter() - t
    tplane.close()
    snap = telemetry.snapshot()
    telemetry.reset()
    no_kernel_or_plain_calls(label)
    threaded_stats = dict(tplane.stats)
    e2e = [sub.t_done - sub.t0 for sub in subs]
    est = telemetry.estimate_quantiles(snap["histograms"]["e2e.admit_to_applied"], (0.5, 0.95))
    fl = telemetry.estimate_quantiles(snap["histograms"]["serve.flush_seconds"], (0.5, 0.95))
    for r, s in enumerate(tsessions):
        if s.patch_log != per_round[r % WRITERS][2]:
            raise AssertionError(f"[{label}] threaded session {r}'s patches differ from its observer's")
    log(f"  threaded leg: {threaded} sessions, round 3, {len(subs)} submissions in {threaded_s:.3f} s "
        f"({len(subs) / threaded_s:.1f} submissions/s); admit-to-applied ms p50 {quantile_ms(e2e, 0.5):.4f} "
        f"p95 {quantile_ms(e2e, 0.95):.4f} (each submission's future); telemetry e2e.admit_to_applied "
        f"log2-bucket estimate p50 {1e3 * est['p50']:.4f} p95 {1e3 * est['p95']:.4f} ms; serve.flush_seconds "
        f"estimate p50 {1e3 * fl['p50']:.4f} p95 {1e3 * fl['p95']:.4f} ms")
    log(f"  threaded plane stats: {threaded_stats}")

    # Streams accumulate to the spans; each class (and round) one digest.
    digests = uni.digests()
    for r in list(range(0, replicas, max(1, replicas // samples)))[:samples] + list(range(WRITERS)):
        w = r % WRITERS
        stream = prefix[w] + sessions[r].patch_log + (tsessions[r].patch_log if r < threaded else [])
        if accumulate_patches(stream) != uni.spans(r):
            raise AssertionError(f"[{label}] replica {r}'s accumulated stream differs from its spans")
        if r < threaded and uni.spans(r) != observers[w].get_text_with_formatting(["text"]):
            raise AssertionError(f"[{label}] replica {r}'s spans differ from its observer's")
    for w in range(WRITERS):
        for rows in (range(w, threaded, WRITERS), range(threaded + w, replicas, WRITERS)):
            if len(set(digests[list(rows)].tolist())) != 1:
                raise AssertionError(f"[{label}] writer {w}'s replicas disagree")
    log(f"  accumulated streams equal the spans of {samples + WRITERS} sampled replicas; one digest per class")
    return {"uni": uni, "wl": wl, "per_round": per_round, "launches": launches, "names": names,
            "threaded": threaded, "manual": manual}


def serve_manual_leg(label: str, uni: TorchUniverse, names, wl: dict, per_round) -> dict:
    """The manual leg: every session submits rounds 1-2, one change at a
    time, and the plane steps until empty.  Each session's patches must
    equal its writer class's observer's; nothing may launch a kernel."""
    plane = ServePlane(uni, start=False, batch_target=len(names))
    sessions = [plane.session(f"s{r}", replica=n, record_stream=True) for r, n in enumerate(names)]
    t = time.perf_counter()
    n_subs = 0
    for k in range(2):
        for r, s in enumerate(sessions):
            for c in wl["rounds"][k][r % WRITERS]:
                s.submit([c])
                n_subs += 1
    flush_ms = []
    while True:
        t1 = time.perf_counter()
        if not plane.step():
            break
        flush_ms.append(1e3 * (time.perf_counter() - t1))
    if plane.drain() != 0:
        raise AssertionError(f"[{label}] the manual plane did not drain")
    seconds = time.perf_counter() - t
    no_kernel_or_plain_calls(label)
    stats = dict(plane.stats)
    plane.close()
    for r, s in enumerate(sessions):
        if s.patch_log != per_round[r % WRITERS][0] + per_round[r % WRITERS][1]:
            raise AssertionError(f"[{label}] session {r}'s patches differ from its observer's")
    log(f"  manual leg: {len(names)} sessions, rounds 1-2, {n_subs} submissions in {seconds:.3f} s "
        f"({n_subs / seconds:.1f} submissions/s); {len(flush_ms)} flushes, flush ms "
        f"{median_p95(flush_ms)}; every session's patches equal its observer's")
    log(f"  manual plane stats: {stats}")
    return {"sessions": sessions, "flush_ms": flush_ms, "subs": n_subs, "seconds": seconds}


def phase_resilience(serve_run: dict, samples: int) -> dict:
    """Retry, degrade, breaker and checkpoint legs on the card, each held
    to the resilience counts it injects."""
    label = "phase 11"
    launches: dict = {}
    wl = make_writer_rounds(DOC_LEN, OPS_PER_ROUND, WRITERS, 2, True, seed=1)
    names = [f"replica{i}" for i in range(REPLICAS)]
    rounds = [[rnd[r % WRITERS] for r in range(REPLICAS)] for rnd in wl["rounds"]]
    reset_counts()
    uni = TorchUniverse(names, capacity=2048, max_mark_ops=1024, device=DEVICE)
    twin = TorchUniverse(names, capacity=2048, max_mark_ops=1024, device=DEVICE)
    for u in (uni, twin):
        u.apply_changes([[wl["genesis"]]] * REPLICAS)
    for batch in rounds:
        twin.apply_changes(batch)
    add_launches(launches)

    # (a) One device_launch fault: the failed attempt stops at the site,
    # before its merge, so each kernel launches once.
    with resilience(f"{label}a launch retry", launch_retries=1), \
            faults.injected("device_launch:fail=1") as plan:
        t = time.perf_counter()
        uni.apply_changes(rounds[0])
        torch.cuda.synchronize()
        retry_ms = 1e3 * (time.perf_counter() - t)
    if plan.stats["device_launch"]["failed"] != 1 or plan.stats["device_launch"]["fired"] != 2:
        raise AssertionError(f"[{label}a] fault stats {plan.stats}")
    if any(n != 1 for n in cuda_kernels.LAUNCHES.values()):
        raise AssertionError(f"[{label}a] launches {cuda_kernels.LAUNCHES} != 1 (one merge after the retry)")
    add_launches(launches)
    # A device_readback fault after the merge ran (strict barrier): the
    # merge runs twice from the same committed states.
    with resilience(f"{label}a readback retry", launch_retries=1), env(PERITEXT_STRICT_COMMIT="1"), \
            faults.injected("device_readback:fail=1"):
        t = time.perf_counter()
        uni.apply_changes(rounds[1])
        torch.cuda.synchronize()
        readback_ms = 1e3 * (time.perf_counter() - t)
    if any(n != 2 for n in cuda_kernels.LAUNCHES.values()):
        raise AssertionError(f"[{label}a] launches {cuda_kernels.LAUNCHES} != 2 (one merge per attempt)")
    add_launches(launches)
    same_fields(f"{label}a", uni.states, twin.states)
    log(f"{label}a: R={REPLICAS}: a device_launch fault on round 1 retried once ({retry_ms:.4f} ms, each "
        f"kernel launched once), a device_readback fault after round 2's merge under "
        f"PERITEXT_STRICT_COMMIT=1 retried once ({readback_ms:.4f} ms, each kernel launched twice); all "
        f"{len(FIELDS)} fields equal the fault-free twin's")
    del uni, twin
    torch.cuda.empty_cache()

    # (b) Past the launch budget on one patched round at R=64: degrade.
    n = DEGRADE_REPLICAS
    deg = TorchUniverse(names[:n], capacity=2048, max_mark_ops=1024, device=DEVICE)
    dtwin = TorchUniverse(names[:n], capacity=2048, max_mark_ops=1024, device=DEVICE)
    for u in (deg, dtwin):
        u.apply_changes([[wl["genesis"]]] * n)
        u.apply_changes(rounds[0][:n])
    add_launches(launches)
    want = dtwin.apply_changes_with_patches(rounds[1][:n])
    with resilience(f"{label}b degrade", launch_retries=2, degraded_batches=1), \
            env(PERITEXT_DEGRADE="1", PERITEXT_LAUNCH_RETRIES="2"), faults.injected("device_launch:fail=99"):
        t = time.perf_counter()
        got = deg.apply_changes_with_patches(rounds[1][:n])
        torch.cuda.synchronize()
        degrade_ms = 1e3 * (time.perf_counter() - t)
    if got != want:
        raise AssertionError(f"[{label}b] the degraded patch streams differ from the fault-free twin's")
    same_fields(f"{label}b", deg.states, dtwin.states)
    log(f"{label}b: R={n}, one patched round past the launch budget (3 attempts): degraded to the oracle in "
        f"{degrade_ms:.4f} ms; patch streams and all {len(FIELDS)} fields equal the fault-free twin's")
    del deg, dtwin
    torch.cuda.empty_cache()

    # (c) An open device_launch breaker under phase 10's universe.
    uni = serve_run["uni"]
    per_round, threaded = serve_run["per_round"], serve_run["threaded"]
    rows = list(range(threaded, threaded + WRITERS))
    with health.guarded("device_launch:threshold=1,cooldown=600"):
        health.breaker("device_launch").record_failure()
        if health.breaker("device_launch").state != health.OPEN:
            raise AssertionError(f"[{label}c] the breaker did not open")
        plane = ServePlane(uni, start=False, batch_target=REPLICAS, on_open="degrade")
        sessions = [plane.session(f"d{r}", replica=names[r], record_stream=True) for r in rows]
        for r, s in zip(rows, sessions):
            for c in serve_run["wl"]["rounds"][2][r % WRITERS]:
                s.submit([c])
        with resilience(f"{label}c breaker degrade", fastfails=1, degraded_batches=1), env(PERITEXT_DEGRADE="1"):
            t = time.perf_counter()
            if plane.drain() != 0 or plane.stats["flushes"] != 1:
                raise AssertionError(f"[{label}c] degrade policy: {plane.stats}")
            open_ms = 1e3 * (time.perf_counter() - t)
        plane.close()
        for r, s in zip(rows, sessions):
            if s.patch_log != per_round[r % WRITERS][2]:
                raise AssertionError(f"[{label}c] replica {r}'s degraded patches differ from its observer's")
        hold = ServePlane(uni, start=False, deadline_ms=50.0, on_open="hold")
        r = threaded + WRITERS
        sub = hold.session("h", replica=names[r]).submit(serve_run["wl"]["rounds"][2][r % WRITERS])
        with resilience(f"{label}c breaker hold"):
            held = hold.step()
            time.sleep(0.06)
            shed = hold.step()
        try:
            sub.result(timeout=1.0)
            raise AssertionError(f"[{label}c] the held submission was not shed")
        except ServeShedError:
            pass
        if held or not shed or hold.stats["held"] < 1 or hold.stats["shed"] != len(sub.changes):
            raise AssertionError(f"[{label}c] hold policy: {hold.stats}")
        hold.close()
    log(f"{label}c: breaker open under phase 10's plane: on_open=degrade served {WRITERS} sessions' round 3 "
        f"through one fast-failed, degraded flush ({open_ms:.4f} ms) equal to the observers' patches; "
        f"on_open=hold held the cohort, then shed {hold.stats['shed']} changes past the 50 ms deadline "
        f"(ServeShedError)")
    add_launches(launches)

    # (d) Checkpoints of phase 10's universe.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap")
        t = time.perf_counter()
        ckpt.save_universe(uni, path)
        save_ms = 1e3 * (time.perf_counter() - t)
        size = os.path.getsize(path + ".npz") + os.path.getsize(path + ".json")
        t = time.perf_counter()
        loaded = ckpt.load_universe(path)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t)
        same_fields(f"{label}d load", loaded.states, uni.states)
        if loaded.clocks != uni.clocks or (loaded.digests() != uni.digests()).any():
            raise AssertionError(f"[{label}d] the loaded universe's clocks or digests differ")
        sample = list(range(0, REPLICAS, max(1, REPLICAS // samples)))[:samples] + rows
        if any(loaded.spans(r) != uni.spans(r) for r in sample):
            raise AssertionError(f"[{label}d] the loaded universe's spans differ")
        del loaded
        fresh = TorchUniverse([f"fresh{i}" for i in range(len(sample))], capacity=2048, max_mark_ops=1024,
                              device=DEVICE)
        t = time.perf_counter()
        for i, r in enumerate(sample):
            ckpt.import_replica(fresh, f"fresh{i}", ckpt.export_replica(uni, names[r]))
        handoff_ms = 1e3 * (time.perf_counter() - t) / len(sample)
        if (fresh.digests() != uni.digests()[sample]).any() or any(
                fresh.spans(i) != uni.spans(r) for i, r in enumerate(sample)):
            raise AssertionError(f"[{label}d] an imported replica differs from its source")
        del fresh
        # Every writer's changes in a log; resume replays what the snapshot lacks.
        changelog = ChangeLog()
        changelog.record(serve_run["wl"]["genesis"])
        for w in range(WRITERS):
            for rnd in serve_run["wl"]["rounds"]:
                for c in rnd[w]:
                    changelog.record(c)
        add_launches(launches)
        t = time.perf_counter()
        resumed = ckpt.resume_universe(path, changelog)
        torch.cuda.synchronize()
        resume_ms = 1e3 * (time.perf_counter() - t)
    resume_launches = dict(cuda_kernels.LAUNCHES)
    if resumed.stats["launches"] != 1 or any(n != 1 for n in resume_launches.values()):
        raise AssertionError(f"[{label}d] resume launches {resume_launches}, merges {resumed.stats['launches']}")
    add_launches(launches)
    frontier = changelog.clock()
    uni.apply_changes({n: changelog.missing_changes(frontier, uni.clock(n)) for n in names})
    add_launches(launches)
    same_fields(f"{label}d resume", resumed.states, uni.states)
    oracle = Doc("oracle")
    for c in [serve_run["wl"]["genesis"]] + [c for w in range(WRITERS) for rnd in serve_run["wl"]["rounds"]
                                             for c in rnd[w]]:
        oracle.apply_change(c)
    digests = resumed.digests()
    if len(set(digests.tolist())) != 1 or any(
            resumed.spans(r) != oracle.get_text_with_formatting(["text"]) for r in sample):
        raise AssertionError(f"[{label}d] the resumed universe differs from the oracle")
    log(f"{label}d: snapshot of {REPLICAS} replicas: {size} bytes (npz + sidecar), save {save_ms:.4f} ms, load "
        f"{load_ms:.4f} ms; all {len(FIELDS)} fields, clocks, digests and {len(sample)} replicas' spans equal; "
        f"export/import into a fresh universe {handoff_ms:.4f} ms per replica, digests and spans equal; "
        f"resume (snapshot + the tail of a {len(changelog.all_changes())}-change log) {resume_ms:.4f} ms through one merge, launches {resume_launches}; equal to the "
        f"live universe after the same tail and to the oracle (one digest)")
    del resumed
    torch.cuda.empty_cache()
    return {"launches": launches}


PATCH_STATS = ("patch_loop_seconds", "patch_readback_seconds", "patch_assemble_seconds")


def patched_call(uni: TorchUniverse, batch) -> tuple:
    """One synchronized ``apply_changes_with_patches``: its output and its
    total, device (merge), readback and assembly seconds."""
    before = {key: uni.stats[key] for key in PATCH_STATS}
    t = time.perf_counter()
    out = uni.apply_changes_with_patches(batch)
    torch.cuda.synchronize()
    return out, {"total": time.perf_counter() - t, **{key: uni.stats[key] - v for key, v in before.items()}}


def log_calls(label: str, calls) -> None:
    log(f"  [{label}] per call ms (total, device merge, record readback, host assembly): " + "; ".join(
        f"{1e3 * c['total']:.4f}, {1e3 * c['patch_loop_seconds']:.4f}, "
        f"{1e3 * c['patch_readback_seconds']:.4f}, {1e3 * c['patch_assemble_seconds']:.4f}" for c in calls))


def route_stats(uni: TorchUniverse) -> str:
    keys = ("launches", "scan_fallbacks", "multi_group_fallbacks", "readback_overflows", "windowed_launches",
            "window_fallbacks", "window_rebuilds", "window_census_skips", "capacity_routes")
    return " ".join(f"{k}={uni.stats[k]}" for k in keys)


def on_route(label: str, uni: TorchUniverse, calls: int) -> None:
    """At least one of ``calls`` patched calls took the sorted route (the
    rest are the counted fallbacks to the per-op loop)."""
    if calls - uni.stats["scan_fallbacks"] - uni.stats["multi_group_fallbacks"] < 1:
        raise AssertionError(f"[{label}] no call took the patched sorted route: {route_stats(uni)}")


@contextlib.contextmanager
def cache_spy():
    """Record, for every ``merge_step_sorted_patched`` call (the full-table
    slices and each windowed slice), whether it was handed a winner cache
    (warm) or had to build one (cold)."""
    seen: list = []
    inner = SP.merge_step_sorted_patched

    def spy(*args, **kwargs):
        seen.append(kwargs.get("wcache_in") is not None)
        return inner(*args, **kwargs)

    SP.merge_step_sorted_patched = spy
    try:
        yield seen
    finally:
        SP.merge_step_sorted_patched = inner


def cache_state(uni: TorchUniverse) -> str:
    wc = uni._wcaches
    if wc is None:
        return "no winner cache"
    return f"winner cache {list(wc.shape)} {wc.dtype} ({wc.numel() * wc.element_size()} B)"


def phase_patched_sorted(p6: dict, replicas: int) -> dict:
    """Phase 6's rounds 5-8 on the patched sorted route, windowed where the
    census plans a window and on the full table (``PERITEXT_MERGE_WINDOW=0``):
    streams equal to phase 6's per-op streams (and so to the observers),
    states equal to phase 6's, no kernel and no plain version run.  The
    full-table leg must build the winner cache on its first call and carry
    it into every later one."""
    label = "phase 12"
    wl, per_round = p6["wl"], p6["per_round"]
    cut = ROUNDS // 2
    names = [f"replica{i}" for i in range(replicas)]
    launches: dict = {}
    legs = {}
    for leg, route in (("windowed", SORTED), ("full table", dict(SORTED, PERITEXT_MERGE_WINDOW="0"))):
        uni = load_universe(names, wl, cut, WRITERS, 2048, 1024)
        add_launches(launches)
        calls = []
        with env(**route), cache_spy() as warm:
            for k in range(cut, ROUNDS):
                warm.clear()
                out, c = patched_call(uni, [wl["rounds"][k][r % WRITERS] for r in range(replicas)])
                if out != p6["outs"][k - cut]:
                    raise AssertionError(f"[{label} {leg}] round {k + 1}'s streams differ from phase 6's per-op streams")
                check_streams(label, uni, out, [per_round[w][k - cut] for w in range(WRITERS)], WRITERS)
                c.update(warm=sum(warm), cold=len(warm) - sum(warm), cache=cache_state(uni))
                calls.append(c)
        no_kernel_or_plain_calls(label)
        same_fields(f"{label} {leg}", uni.states, p6["states"])
        on_route(label, uni, len(calls))
        if leg == "full table":
            if uni.stats["windowed_launches"] != 0:
                raise AssertionError(f"[{label}] PERITEXT_MERGE_WINDOW=0 windowed: {route_stats(uni)}")
            first, rest = calls[0], calls[1:]
            if first["warm"] or not first["cold"] or any(c["cold"] or not c["warm"] for c in rest) or \
                    uni._wcaches is None:
                raise AssertionError(f"[{label}] the full-table leg did not build the winner cache on its first "
                                     f"call and carry it: {[(c['cold'], c['warm'], c['cache']) for c in calls]}")
        ms = {key: 1e3 * statistics.median(c[key] for c in calls) for key in PATCH_STATS + ("total",)}
        legs[leg] = {"ms": ms, "calls": calls}
        log(f"{label} ({leg}): the patched sorted route at R={replicas} C={uni.capacity} M={uni.max_mark_ops}, "
            f"rounds {cut + 1}-{ROUNDS}: streams equal phase 6's per-op streams and the {WRITERS} observers'; all "
            f"{len(FIELDS)} state fields equal phase 6's; no kernel or plain version ran")
        log_calls(f"{label} {leg}", calls)
        log(f"  [{label} {leg}] per call, merge slices handed a winner cache (warm) / building one (cold) and the "
            f"cache kept after it: " + "; ".join(f"{c['warm']}/{c['cold']}, {c['cache']}" for c in calls))
        log(f"  [{label} {leg}] median of {len(calls)}: {ms['total']:.4f} ms (device {ms['patch_loop_seconds']:.4f}, "
            f"readback {ms['patch_readback_seconds']:.4f}, assembly {ms['patch_assemble_seconds']:.4f}); phase 6's "
            f"per-op loop {p6['patched_ms']['total']:.4f}")
        log(f"  [{label} {leg}] routes: {route_stats(uni)}")
        del uni
        torch.cuda.empty_cache()
    ms = legs["windowed"]["ms"]
    profile_patched_call(label, names, wl, cut, ms, route=SORTED)
    add_launches(launches)
    return {"launches": launches, "ms": ms, "calls": legs["windowed"]["calls"]}


def phase_patched_window(p9: dict, replicas: int, samples: int) -> dict:
    """Phase 9's 10k-char hotspot rounds 5-8 through patches on the sorted
    route, windowed, against the full-table patched route and the per-op
    loop on sampled replicas."""
    label = "phase 13"
    wl = p9["wl"]
    cut = ROUNDS // 2
    names = [f"replica{i}" for i in range(replicas)]
    sample = list(range(0, replicas, max(1, replicas // samples)))[:samples]
    launches: dict = {}

    def loaded(rows):
        uni = TorchUniverse([names[r] for r in rows], capacity=LARGE_CAPACITY, max_mark_ops=128, device=DEVICE)
        uni.apply_changes([[wl["genesis"]]] * len(rows))
        for rnd in wl["rounds"][:cut]:
            uni.apply_changes([rnd[r % WRITERS] for r in rows])
        add_launches(launches)
        return uni

    def rounds(uni, rows, route):
        outs, calls = [], []
        with env(**route):
            for rnd in wl["rounds"][cut:]:
                out, c = patched_call(uni, [rnd[r % WRITERS] for r in rows])
                outs.append(out)
                calls.append(c)
        no_kernel_or_plain_calls(label)
        return outs, calls

    torch.cuda.reset_peak_memory_stats()
    uni = loaded(range(replicas))
    outs, calls = rounds(uni, range(replicas), SORTED)
    if uni.stats["windowed_launches"] < 1:
        raise AssertionError(f"[{label}] the window never engaged: {route_stats(uni)}")
    log_peak(f"  [{label}] windowed leg")
    expect = [w.get_text_with_formatting(["text"]) for w in wl["writers"]]
    for r in sample:
        if uni.spans(r) != expect[r % WRITERS]:
            raise AssertionError(f"[{label}] replica {r}'s spans differ from its writer's")
    legs = {}
    for leg, route in (("full table", dict(SORTED, PERITEXT_MERGE_WINDOW="0")), ("per-op loop", {})):
        other = loaded(sample)
        o_outs, o_calls = rounds(other, sample, route)
        for k, (a, b) in enumerate(zip(outs, o_outs)):
            if any(a[names[r]] != b[names[r]] for r in sample):
                raise AssertionError(f"[{label}] round {cut + k + 1}: the {leg} leg's streams differ")
        same_fields(label, other.states, map_state(lambda x: x[sample], uni.states))
        legs[leg] = (o_calls, route_stats(other))
        del other
    ms = {key: 1e3 * statistics.median(c[key] for c in calls) for key in calls[0]}
    log(f"{label}: the patched windowed route at R={replicas} C={uni.capacity} M={uni.max_mark_ops}, phase 9's "
        f"rounds {cut + 1}-{ROUNDS}: {len(sample)} sampled replicas' streams and all {len(FIELDS)} fields equal the "
        f"full-table patched route and the per-op loop on the same rows, spans equal their writers'; "
        f"no kernel or plain version ran")
    log_calls(f"{label} windowed R={replicas}", calls)
    log(f"  [{label}] windowed routes: {route_stats(uni)}")
    for leg, (o_calls, stats) in legs.items():
        log_calls(f"{label} {leg} R={len(sample)}", o_calls)
        log(f"  [{label}] {leg} routes: {stats}")
    log(f"  [{label}] median: windowed {ms['total']:.4f} ms at R={replicas} (device {ms['patch_loop_seconds']:.4f}, "
        f"readback {ms['patch_readback_seconds']:.4f}, assembly {ms['patch_assemble_seconds']:.4f})")
    del uni
    torch.cuda.empty_cache()
    # The last round again on a fresh windowed universe, under the profiler.
    uni = loaded(range(replicas))
    with env(**SORTED):
        for rnd in wl["rounds"][cut:-1]:
            uni.apply_changes_with_patches([rnd[r % WRITERS] for r in range(replicas)])
        p = profile_device(lambda: uni.apply_changes_with_patches(
            [wl["rounds"][-1][r % WRITERS] for r in range(replicas)]))
    if p is None:
        log(f"  [{label}] profiler: no device time recorded; device busy share not measured")
    else:
        last = calls[-1]
        log(f"  [{label}] profiler, round {ROUNDS} windowed at R={replicas}: {p['launches']} kernel launches, "
            f"{p['kernel_ms']:.4f} ms kernel time (busy {100 * p['kernel_ms'] / (1e3 * last['patch_loop_seconds']):.1f}% "
            f"of the unprofiled call's device merge {1e3 * last['patch_loop_seconds']:.4f} ms); {p['copies']} copies, "
            f"{p['copy_ms']:.4f} ms; top kernels: {p['top']}")
    add_launches(launches)
    del uni
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms}


def phase_serving_sorted(p10: dict, replicas: int) -> dict:
    """Phase 10's manual leg with the plane's flushes on the patched sorted
    route, beside phase 10's numbers from this run."""
    label = "phase 14"
    wl, per_round = p10["wl"], p10["per_round"]
    names = [f"replica{i}" for i in range(replicas)]
    launches: dict = {}
    reset_counts()
    uni = TorchUniverse(names, capacity=2048, max_mark_ops=1024, device=DEVICE)
    uni.apply_changes([[wl["genesis"]]] * replicas)
    add_launches(launches)
    with env(**SORTED):
        manual = serve_manual_leg(label, uni, names, wl, per_round)
    on_route(label, uni, len(manual["flush_ms"]))
    digests = uni.digests()
    for w in range(WRITERS):
        if len(set(digests[w::WRITERS].tolist())) != 1:
            raise AssertionError(f"[{label}] writer {w}'s replicas disagree")
    base = p10["manual"]
    log(f"{label}: phase 10's manual leg on the patched sorted route: flush ms {median_p95(manual['flush_ms'])} "
        f"over {len(manual['flush_ms'])} flushes, {manual['subs'] / manual['seconds']:.1f} submissions/s; "
        f"phase 10 (per-op loop, this run): {median_p95(base['flush_ms'])} over {len(base['flush_ms'])}, "
        f"{base['subs'] / base['seconds']:.1f} submissions/s; one digest per writer class")
    log(f"  [{label}] routes: {route_stats(uni)}")
    del uni
    torch.cuda.empty_cache()
    return {"launches": launches, "manual": manual}


def phase_capacity(replicas: int, samples: int) -> dict:
    """A universe on the default route grown from C = 16384 (the kernels'
    limit) to 32768: the merges above the limit take the capacity route,
    counted, and launch no kernel."""
    label = "phase 15"
    t0 = time.perf_counter()
    hist = wire_rounds(CAPACITY_DOC_LEN, 2, 2, CAPACITY_RUN, seed=5)
    oracle = Doc("oracle")
    for c in [hist["genesis"]] + [c for rnd in hist["rounds"] for cs in rnd for c in cs]:
        oracle.apply_change(c)
    expect = oracle.get_text_with_formatting(["text"])
    log(f"{label}: workload + oracle built in {time.perf_counter() - t0:.2f} s (host); a {CAPACITY_DOC_LEN}-char "
        f"genesis, 2 rounds of 2 writers' {CAPACITY_RUN}-char runs and marks, then the all-to-all")
    names = [f"replica{i}" for i in range(replicas)]
    launches: dict = {}
    reset_counts()
    uni = TorchUniverse(names, capacity=LARGE_CAPACITY, max_mark_ops=256, device=DEVICE)
    limit = cuda_kernels.kernel_capacity_limit(uni.max_mark_ops // 32)
    uni.apply_changes([[hist["genesis"]]] * replicas)
    if uni.capacity > limit or any(n != 1 for n in cuda_kernels.LAUNCHES.values()):
        raise AssertionError(f"[{label}] the genesis did not merge through the kernels: {cuda_kernels.LAUNCHES}")
    add_launches(launches)
    history = [[c for rnd in hist["rounds"] for c in rnd[w]] for w in range(2)]
    batches = [[rnd[r % 2] for r in range(replicas)] for rnd in hist["rounds"]]
    batches.append([history[1 - r % 2] for r in range(replicas)])
    above, times = 0, []
    for batch in batches:
        t = time.perf_counter()
        uni.apply_changes(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        above += uni.capacity > limit
    if uni.capacity != 2 * LARGE_CAPACITY or above != len(batches):
        raise AssertionError(f"[{label}] capacity {uni.capacity}, {above} merges above the limit")
    if uni.stats["capacity_routes"] != above or any(cuda_kernels.LAUNCHES.values()) or any(PLAIN_CALLS.values()):
        raise AssertionError(f"[{label}] capacity_routes {uni.stats['capacity_routes']} != {above}, or launches "
                             f"{cuda_kernels.LAUNCHES} / plain calls {PLAIN_CALLS} moved above the limit")
    if len(set(uni.digests().tolist())) != 1:
        raise AssertionError(f"[{label}] replicas that took the same changes disagree")
    for r in list(range(0, replicas, max(1, replicas // samples)))[:samples] + [replicas - 1]:
        if uni.spans(r) != expect:
            raise AssertionError(f"[{label}] replica {r}'s spans differ from the oracle's")
    if not any(span["marks"] for span in expect):
        raise AssertionError(f"[{label}] the document carries no marks: the check proves nothing")
    log(f"  R={replicas}: C {LARGE_CAPACITY} -> {uni.capacity} (kernel limit {limit}); {above} merges above the "
        f"limit, capacity_routes={uni.stats['capacity_routes']}, kernel launches after the genesis "
        f"{cuda_kernels.LAUNCHES}; one digest; {samples + 1} replicas' spans equal the oracle's; merge ms "
        + " ".join(f"{1e3 * t:.4f}" for t in times))
    del uni
    torch.cuda.empty_cache()
    return {"launches": launches}


@contextlib.contextmanager
def record_handed(names):
    """Record every batch handed to the named sessions' shard-local
    admission lanes, in order: client submits, fan-out and anti-entropy
    deliveries, migration and hydration replays."""
    handed = {n: [] for n in names}
    submit = ServeSession.submit

    def recording(self, changes, wait=False, timeout=None):
        if self.name in handed:
            handed[self.name].extend(changes)
        return submit(self, changes, wait, timeout)

    ServeSession.submit = recording
    try:
        yield handed
    finally:
        ServeSession.submit = submit


def twin_stream(base: Doc, base_patches: list, handed: list) -> list:
    """The patches of an oracle twin that ingests exactly ``handed`` in
    order under the admission gate's rules (a change already seen drops,
    a causally unready one waits); ``base`` has taken the genesis,
    ``handed[0]``."""
    twin = copy.deepcopy(base)
    out, held = list(base_patches), []
    for change in handed[1:]:
        held.append(change)
        fresh = [c for c in held if c["seq"] > twin.clock.get(c["actor"], 0)]
        for c in causal_order(fresh, dict(twin.clock)):
            out += twin.apply_change(c)
        held = [c for c in held if c["seq"] > twin.clock.get(c["actor"], 0)]
    return out


def drain_shards(label: str, splane: ShardedServePlane) -> list:
    """Step every shard until none flushes; the ms of each flush."""
    flush_ms, worked = [], True
    while worked:
        worked = False
        for plane in splane._planes():
            t = time.perf_counter()
            if plane.step():
                flush_ms.append(1e3 * (time.perf_counter() - t))
                worked = True
    if splane.drain() != 0:
        raise AssertionError(f"[{label}] the sharded plane did not drain")
    return flush_ms


def settle(label: str, splane: ShardedServePlane) -> list:
    """Drain, redeliver every doc group's missing suffix, drain again."""
    flush_ms = drain_shards(label, splane)
    splane.anti_entropy()
    return flush_ms + drain_shards(label, splane)


def check_sharded(label: str, splane: ShardedServePlane, docs: list, expect: list, handed: dict,
                  genesis: dict) -> None:
    """Each document's sessions share one digest and the spans of its
    oracle; every session's accumulated stream equals its spans; each
    recorded session's stream equals its oracle twin's."""
    t = time.perf_counter()
    rows = {}
    for shard in splane.shards:
        uni = shard.universe
        for r, spans, digest in zip(uni.replica_ids, uni.spans_batch(), uni.digests().tolist()):
            rows[r] = (spans, digest)
    for d, sessions in enumerate(docs):
        if len({rows[s.replica][1] for s in sessions}) != 1:
            raise AssertionError(f"[{label}] document {d}'s sessions disagree")
        if rows[sessions[0].replica][0] != expect[d]:
            raise AssertionError(f"[{label}] document {d}'s spans differ from its oracle's")
        for s in sessions:
            if accumulate_patches(s.patch_log) != rows[s.replica][0]:
                raise AssertionError(f"[{label}] session {s.name}'s accumulated stream differs from its spans")
    base = Doc("twin")
    base_patches = base.apply_change(genesis)
    by_name = {s.name: s for sessions in docs for s in sessions}
    for name, changes in handed.items():
        if changes[0] != genesis:
            raise AssertionError(f"[{label}] session {name} was not handed the genesis first")
        if by_name[name].patch_log != twin_stream(base, base_patches, changes):
            raise AssertionError(f"[{label}] session {name}'s patches differ from its oracle twin's")
    log(f"  [{label}] {len(docs)} documents of {len(docs[0])} sessions: one digest each, spans equal to the "
        f"oracle's; {sum(map(len, docs))} accumulated streams equal their spans; {len(handed)} sessions' streams "
        f"equal their twins' ({sum(map(len, handed.values()))} changes handed); checked in "
        f"{time.perf_counter() - t:.2f} s (host)")


def oracle_spans(wl: dict, rounds: int) -> list:
    doc = Doc("oracle")
    doc.apply_change(wl["genesis"])
    for rnd in wl["rounds"][:rounds]:
        for w in range(WRITERS):
            for c in rnd[w]:
                doc.apply_change(c)
    return doc.get_text_with_formatting(["text"])


def submit_round(docs, wl: dict, k: int, subs: list | None = None, part: slice = slice(None)) -> int:
    """Collaborator w of each document submits ``part`` of writer w's
    round k, one change per submission; returns the count."""
    n = 0
    for sessions in docs:
        for w, s in enumerate(sessions):
            for c in wl["rounds"][k][w][part]:
                sub = s.submit([c])
                if subs is not None:
                    subs.append(sub)
                n += 1
    return n


def leg_line(label: str, leg: str, flush_ms: list, subs: int, seconds: float, p10: dict) -> None:
    base = p10["manual"]
    log(f"  [{label}] {leg}: {subs} submissions in {seconds:.3f} s ({subs / seconds:.1f} submissions/s); "
        f"{len(flush_ms)} flushes, flush ms {median_p95(flush_ms)}; phase 10's manual leg (one plane, this run): "
        f"{median_p95(base['flush_ms'])}, {base['subs'] / base['seconds']:.1f} submissions/s")


def serve_totals(splane: ShardedServePlane) -> dict:
    """Flushes, flushed changes and the patch calls' loop, readback and
    assembly seconds, summed over the shards."""
    out = {k: sum(s.plane.stats[k] for s in splane.shards) for k in ("flushes", "flushed_changes")}
    for k in ("patch_loop_seconds", "patch_readback_seconds", "patch_assemble_seconds"):
        out[k] = sum(s.universe.stats[k] for s in splane.shards)
    return out


def totals_line(before: dict, after: dict, seconds: float) -> str:
    d = {k: after[k] - before[k] for k in after}
    return (f"{d['flushes']} flushes of {d['flushed_changes'] / max(1, d['flushes']):.1f} changes on average; "
            f"summed over the shards, loop {d['patch_loop_seconds']:.3f} s, readback "
            f"{d['patch_readback_seconds']:.3f} s, assembly {d['patch_assemble_seconds']:.3f} s "
            f"in {seconds:.3f} s of wall time")


def widths(splane: ShardedServePlane) -> list:
    return [len(s.universe.replica_ids) if s.universe is not None else 0 for s in splane.shards]


def phase_sharded(p10: dict) -> dict:
    """The sharded serving tier on the card: doc groups over SHARDS
    shards, live migration, the lifecycle and a threaded fleet."""
    label = "phase 16"
    wl = p10["wl"]
    t0 = time.perf_counter()
    expect12, expect123 = oracle_spans(wl, 2), oracle_spans(wl, 3)
    log(f"{label}: oracles built in {time.perf_counter() - t0:.2f} s (host); {SHARD_DOCS} documents x {WRITERS} "
        f"collaborators over {SHARDS} shards, C=2048, M=1024")
    reset_counts()
    telemetry.reset()
    splane = ShardedServePlane(SHARDS, start=False, capacity=2048, max_mark_ops=1024, batch_target=256,
                               quantum=1, devices=SHARD_DEVICES)
    docs = [[splane.session(f"d{d}w{w}", replica=f"d{d}w{w}", doc=f"doc{d}", record_stream=True)
             for w in range(WRITERS)] for d in range(SHARD_DOCS)]
    if any(s.shard != w for sessions in docs for w, s in enumerate(sessions)):
        raise AssertionError(f"[{label}] rr placement did not put collaborator w on shard w")
    log(f"  [{label}] shard widths {widths(splane)} on {[str(s.device) for s in splane.shards]}")
    # Twins: two movers, then sessions spread over every quarter of the
    # documents (migrated, pressure-evicted, evicted, watermark).
    picks = [(0, 0), (1, 0)] + [((d * SHARD_DOCS // (TWINS - 2) + 2) % SHARD_DOCS, d % WRITERS)
                                for d in range(TWINS - 2)]
    twins = sorted({docs[d][w].name for d, w in picks})
    with record_handed(twins) as handed, tempfile.TemporaryDirectory(prefix="chip_smoke_lifecycle_") as store:
        # Setup: the genesis fans out from collaborator 0 and is drained
        # (one cohort a shard: the per-op loop takes one step per char of
        # an insert), then round 1.
        t = time.perf_counter()
        for sessions in docs:
            sessions[0].submit([wl["genesis"]])
        flush_ms = drain_shards(label, splane)
        log(f"  [{label}] genesis: {SHARD_DOCS} submissions fanned out to {SHARD_DOCS * WRITERS} sessions in "
            f"{time.perf_counter() - t:.3f} s; {len(flush_ms)} flushes, ms {' '.join(f'{x:.1f}' for x in flush_ms)}")
        t = time.perf_counter()
        n_subs = submit_round(docs, wl, 0)
        flush_ms = settle(label, splane)
        leg_line(label, "round 1", flush_ms, n_subs, time.perf_counter() - t, p10)

        # Migration leg: collaborator 0 of the first MIGRATED documents
        # moves from shard 0 to shard 1 while its document's round 2
        # arrives.  The shard-0 plane's lock holds each migration after it
        # parks the session and before it drains the source lane, so
        # every round-2 submission of the mover parks and is replayed.
        src = splane.shards[0].plane
        move_ms, parked = [], 0
        t = time.perf_counter()
        n_subs = 0
        for d in range(MIGRATED):
            mover, out = docs[d][0], {}

            def move(name=mover.name, out=out):
                try:
                    migrate_session(splane, name, 1)
                except BaseException as exc:  # re-raised below
                    out["error"] = exc
                out["t"] = time.perf_counter()

            with src._lock:
                thread = threading.Thread(target=move)
                thread.start()
                while mover._parked is None and thread.is_alive():
                    time.sleep(0.0002)
                for w, s in enumerate(docs[d]):
                    for c in wl["rounds"][1][w]:
                        parked += isinstance(s.submit([c]), ParkedSubmission)
                        n_subs += 1
                released = time.perf_counter()
            thread.join()
            if "error" in out:
                raise AssertionError(f"[{label}] migrating {mover.name} failed") from out["error"]
            move_ms.append(1e3 * (out["t"] - released))
        n_subs += submit_round(docs[MIGRATED:], wl, 1)
        flush_ms = settle(label, splane)
        seconds = time.perf_counter() - t
        if parked != MIGRATED * len(wl["rounds"][1][0]) or any(docs[d][0].shard != 1 for d in range(MIGRATED)):
            raise AssertionError(f"[{label}] {parked} parked submissions; movers on shards "
                                 f"{sorted({docs[d][0].shard for d in range(MIGRATED)})}")
        leg_line(label, "round 2 with the migration", flush_ms, n_subs, seconds, p10)
        log(f"  [{label}] {MIGRATED} migrations shard 0 -> 1, ms (lock release to commit) {median_p95(move_ms)}; "
            f"{parked} client submissions parked and replayed; shard widths after the move {widths(splane)}")
        check_sharded(f"{label} migration", splane, docs, [expect12] * SHARD_DOCS, handed, wl["genesis"])

        # Lifecycle leg: evict every session of EVICTED_DOCS documents, then
        # round 3 hydrates each on its first submission (the migrated
        # documents take round 3 first, warm, for the comparison).
        lc = DocLifecycle(splane, directory=store, start=False, watermark=0, keep=2, cooldown=0.0)
        cold_docs = list(range(SHARD_DOCS // 2, SHARD_DOCS // 2 + EVICTED_DOCS))
        evict_ms = []
        for d in cold_docs:
            for s in docs[d]:
                t = time.perf_counter()
                lc.evict(s.name)
                evict_ms.append(1e3 * (time.perf_counter() - t))
        status = lc._status()
        gen = os.path.join(lc._doc_dir(docs[cold_docs[0]][0].name), "gen-00000000")
        gen_bytes = os.path.getsize(gen + ".npz") + os.path.getsize(gen + ".json")
        log(f"  [{label}] evicted {len(evict_ms)} sessions of {EVICTED_DOCS} documents: evict ms "
            f"{median_p95(evict_ms)}; one generation {gen_bytes} B (npz + sidecar); shard widths {widths(splane)}; "
            f"{status['docs']} sessions on {status['device_rows']} device rows (tenancy {status['tenancy_ratio']})")
        lat = {"warm": [], "cold": []}
        t = time.perf_counter()
        n_subs, flush_ms = 0, []
        for group in (range(MIGRATED), cold_docs):
            subs: list = []
            n_subs += submit_round([docs[d] for d in group], wl, 2, subs)
            flush_ms += drain_shards(label, splane)
            for sub in subs:
                lat[sub.lat_class].append(sub.t_done - sub.t0)
        flush_ms += settle(label, splane)
        seconds = time.perf_counter() - t
        hydrate_ms = [1e3 * x for x in lc._cold_starts]
        lc._cold_starts.clear()
        if lc.stats["hydrations"] != len(evict_ms) or len(lat["cold"]) != len(evict_ms):
            raise AssertionError(f"[{label}] {lc.stats['hydrations']} hydrations, {len(lat['cold'])} cold "
                                 f"submissions after {len(evict_ms)} evictions")
        leg_line(label, "round 3 with the hydrations", flush_ms, n_subs, seconds, p10)
        log(f"  [{label}] {lc.stats['hydrations']} hydrations, ms {median_p95(hydrate_ms)}; admit-to-applied ms "
            f"warm p50 {quantile_ms(lat['warm'], 0.5):.4f} p95 {quantile_ms(lat['warm'], 0.95):.4f} "
            f"({len(lat['warm'])}), cold p50 {quantile_ms(lat['cold'], 0.5):.4f} p95 "
            f"{quantile_ms(lat['cold'], 0.95):.4f} ({len(lat['cold'])}); fallbacks {lc.stats['corrupt_fallbacks']}, "
            f"full replays {lc.stats['full_replays']}")
        third = set(range(MIGRATED)) | set(cold_docs)
        expect = [expect123 if d in third else expect12 for d in range(SHARD_DOCS)]
        check_sharded(f"{label} lifecycle", splane, docs, expect, handed, wl["genesis"])

        # Once more under a watermark: evict the last EVICTED_DOCS
        # documents (the resident count falls to the watermark), then round
        # 3 hydrates the sessions of WATERMARK_DOCS of them, each past the
        # watermark, which evicts the least recently active resident
        # session first.  Each session's first change goes first, so the
        # drain each pressure eviction makes of its victim's shard finds
        # one change per hydrated session.
        lc.watermark = WATERMARK
        for d in range(SHARD_DOCS - EVICTED_DOCS, SHARD_DOCS):
            for s in docs[d]:
                lc.evict(s.name)
        warm_docs = list(range(SHARD_DOCS - WATERMARK_DOCS, SHARD_DOCS))
        before = dict(lc.stats)
        t = time.perf_counter()
        batch = [docs[d] for d in warm_docs]
        n_subs = submit_round(batch, wl, 2, part=slice(0, 1))
        n_subs += submit_round(batch, wl, 2, part=slice(1, None))
        flush_ms = drain_shards(label, splane)
        seconds = time.perf_counter() - t
        status = lc._status()
        pressure = lc.stats["pressure_evictions"] - before["pressure_evictions"]
        if status["resident"] > WATERMARK or status["tenancy_ratio"] <= 1 or pressure != len(warm_docs) * WRITERS:
            raise AssertionError(f"[{label}] under the watermark: {status}, {pressure} pressure evictions")
        leg_line(label, f"round 3 under a watermark of {WATERMARK}", flush_ms, n_subs, seconds, p10)
        log(f"  [{label}] {pressure} pressure evictions; {status['resident']} resident of {status['docs']} sessions "
            f"on {status['device_rows']} device rows: tenancy ratio {status['tenancy_ratio']}; hydrate ms "
            f"{median_p95([1e3 * x for x in lc._cold_starts])}; shard widths {widths(splane)}")
        lc.watermark = 0
        for sessions in docs:
            for s in sessions:
                lc.hydrate(s.name)
        settle(label, splane)
        third |= set(warm_docs)
        expect = [expect123 if d in third else expect12 for d in range(SHARD_DOCS)]
        check_sharded(f"{label} watermark", splane, docs, expect, handed, wl["genesis"])
        splane.close()
    no_kernel_or_plain_calls(label)
    launches = dict(cuda_kernels.LAUNCHES)
    log(f"  [{label}] kernel launches {launches}, plain calls {PLAIN_CALLS}; lifecycle stats {lc.stats}")
    del splane, docs, lc
    torch.cuda.empty_cache()

    # Threaded leg: the genesis and the first half of round 1 are drained
    # by hand, then one scheduler thread per shard, all on the card,
    # serves the second half: both modes at one width, on one plane.
    tplane = ShardedServePlane(SHARDS, start=False, capacity=2048, max_mark_ops=1024, deadline_ms=25.0,
                               quantum=1, devices=SHARD_DEVICES)
    tdocs = [[tplane.session(f"t{d}w{w}", replica=f"t{d}w{w}", doc=f"tdoc{d}", record_stream=True)
              for w in range(WRITERS)] for d in range(THREADED_DOCS)]
    with record_handed([tdocs[d][d % WRITERS].name for d in range(THREADED_DOCS)]) as thanded:
        t = time.perf_counter()
        for sessions in tdocs:
            sessions[0].submit([wl["genesis"]])
        drain_shards(label, tplane)
        genesis_s = time.perf_counter() - t
        half = len(wl["rounds"][0][0]) // 2
        m_before = serve_totals(tplane)
        t = time.perf_counter()
        msubs: list = []
        m_subs = submit_round(tdocs, wl, 0, msubs, part=slice(0, half))
        m_flush = drain_shards(label, tplane)
        m_seconds = time.perf_counter() - t
        m_totals = totals_line(m_before, serve_totals(tplane), m_seconds)
        t_before = serve_totals(tplane)
        telemetry.enable()
        for plane in tplane._planes():
            plane.start()
        t = time.perf_counter()
        subs: list = []
        n_subs = submit_round(tdocs, wl, 0, subs, part=slice(half, None))
        tplane.flush_and_wait(timeout=600.0)
        tplane.anti_entropy()
        tplane.flush_and_wait(timeout=600.0)
        seconds = time.perf_counter() - t
        t_totals = totals_line(t_before, serve_totals(tplane), seconds)
        snap = telemetry.snapshot()
        threads = sum(s.plane._thread is not None for s in tplane.shards)
        check_sharded(f"{label} threaded", tplane, tdocs, [oracle_spans(wl, 1)] * THREADED_DOCS, thanded,
                      wl["genesis"])
    tplane.close()
    telemetry.reset()
    no_kernel_or_plain_calls(label)
    m_e2e = [sub.t_done - sub.t0 for sub in msubs]
    e2e = [sub.t_done - sub.t0 for sub in subs]
    fl = telemetry.estimate_quantiles(snap["histograms"]["serve.flush_seconds"], (0.5, 0.95))
    log(f"  [{label}] threaded leg: {THREADED_DOCS * WRITERS} sessions in {THREADED_DOCS} documents; the genesis "
        f"drained by hand in {genesis_s:.3f} s; round 1's first half by hand: {m_subs} submissions in "
        f"{m_seconds:.3f} s ({m_subs / m_seconds:.1f} submissions/s), admit-to-applied ms p50 "
        f"{quantile_ms(m_e2e, 0.5):.4f} p95 {quantile_ms(m_e2e, 0.95):.4f}, flush ms {median_p95(m_flush)}; "
        f"{m_totals}")
    log(f"  [{label}] threaded leg: round 1's second half on {threads} scheduler threads: "
        f"{n_subs} submissions in {seconds:.3f} s ({n_subs / seconds:.1f} submissions/s); "
        f"admit-to-applied ms p50 {quantile_ms(e2e, 0.5):.4f} p95 {quantile_ms(e2e, 0.95):.4f}; "
        f"serve.flush_seconds estimate p50 {1e3 * fl['p50']:.4f} p95 {1e3 * fl['p95']:.4f} ms; {t_totals}")
    return {"launches": launches}


def meminfo() -> str:
    """The host's memory from /proc/meminfo (pinned buffers come out of it)."""
    fields = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields[key] = value.strip()
    return ", ".join(f"{k} {fields.get(k, 'n/a')}" for k in ("MemTotal", "MemAvailable"))


def stream_population() -> dict:
    """BASELINE config 5's workload: a 10,000-char genesis, 4 writer
    streams of 64 ops with marks (seed 5), encoded at C = 16384, M = 128 as
    the stream takes it (``prepare_sorted_batch`` rows)."""
    wl = make_merge_workload(doc_len=LARGE_DOC_LEN, ops_per_merge=64, num_streams=STREAM_CLASSES,
                             with_marks=True, seed=5)
    batch = build_device_batch(wl, STREAM_CLASSES, LARGE_CAPACITY, STREAM_MARKS, device=DEVICE)
    sp = prepare_sorted_batch([batch["text_ops"][r].cpu().numpy() for r in range(STREAM_CLASSES)])
    ops = [sum(len(c["ops"]) for c in stream) for stream in wl["streams"]]
    return {"genesis": state_to_numpy(batch["states"]), "text": sp["text"], "rounds": sp["rounds"],
            "num_rounds": sp["num_rounds"], "marks": batch["mark_ops"].cpu().numpy(),
            "ranks": batch["ranks"].cpu().numpy(), "bufs": sp["bufs"], "maxk": sp["maxk"], "ops": ops}


def stream_args(pop: dict, lo: int, hi: int) -> tuple:
    """Population rows [lo, hi): a host broadcast of the genesis state (one
    replica's bytes, stride 0) and tiled op rows, replica r taking stream
    r % 4."""
    pick = np.arange(lo, hi) % STREAM_CLASSES
    states = {f: np.broadcast_to(a[:1], (hi - lo,) + a.shape[1:]) for f, a in pop["genesis"].items()}
    return (states, pop["text"][pick], pop["rounds"][pick], pop["num_rounds"], pop["marks"][pick],
            pop["ranks"], pop["bufs"][pick], pop["maxk"])


def stream_sweep(label: str, args: tuple, launches: dict, **kw) -> tuple:
    """One counted sweep: each kernel launches once a cohort, and the
    launches join the phase's."""
    reset_counts()
    t = time.perf_counter()
    out, dg, stats = stream_merge_sorted(*args, device=DEVICE, **kw)
    secs = time.perf_counter() - t
    want = {"text_phase": stats["n_cohorts"], "mark_phase": stats["n_cohorts"]}
    if stats["route"] != "kernels" or cuda_kernels.LAUNCHES != want:
        raise AssertionError(f"[{label}] route {stats['route']}, launches {cuda_kernels.LAUNCHES}, expected {want}")
    add_launches(launches)
    return out, dg, stats, secs


def stage_line(stats: dict) -> str:
    """Per-cohort stage times of a sweep: median and max over its cohorts."""
    parts = []
    for key, unit, scale in (("stage_s", "ms", 1e3), ("enqueue_s", "ms", 1e3), ("h2d_ms", "ms", 1.0),
                             ("merge_ms", "ms", 1.0), ("digest_ms", "ms", 1.0), ("d2h_ms", "ms", 1.0),
                             ("drain_s", "ms", 1e3)):
        xs = [t[key] * scale for t in stats["timings"]]
        parts.append(f"{key.rsplit('_', 1)[0]} {statistics.median(xs):.3f}/{max(xs):.3f} {unit}")
    return "; ".join(parts) + " (median/max a cohort)"


def same_rows(label: str, out: dict, lo: int, classes: dict) -> None:
    """Every row of ``out`` (population rows from ``lo``) equals the
    resident row of its stream, field by field."""
    for cls, want in classes.items():
        rows = slice((cls - lo) % STREAM_CLASSES, None, STREAM_CLASSES)
        for f in FIELDS:
            if not (out[f][rows] == want[f]).all():
                raise AssertionError(f"[{label}] field {f} of stream {cls}'s rows differs from the resident merge")


def phase_stream() -> dict:
    """Phase 17: the north-star population streamed through both kernels."""
    log(f"phase 17: host memory before pinning: {meminfo()}")
    t = time.perf_counter()
    pop = stream_population()
    launches: dict = {}
    c, m = LARGE_CAPACITY, STREAM_MARKS
    per = state_bytes_per_replica(c, m)
    free, total = torch.cuda.mem_get_info()
    log(f"  workload: {LARGE_DOC_LEN}-char genesis, {STREAM_CLASSES} streams of {pop['ops']} ops, "
        f"text rows {pop['text'].shape[1]}, mark rows {pop['marks'].shape[1]}, sorted rounds "
        f"{pop['num_rounds']}; built in {time.perf_counter() - t:.1f} s")
    log(f"  state {per:,} B a replica; {STREAM_REPLICAS:,} replicas = {STREAM_REPLICAS * per / 1e9:.2f} GB "
        f"against the card's {total / 1e9:.2f} GB ({free / 1e9:.2f} GB free); cohort_for_budget(free, "
        f"depth 2) = {cohort_for_budget(c, m, pop['text'].shape[1], hbm_bytes=free, depth=2)}, "
        f"depth 1 = {cohort_for_budget(c, m, pop['text'].shape[1], hbm_bytes=free, depth=1)}; "
        f"the sweeps use {STREAM_COHORT}")

    # The resident reference: one merge_step_full plus the digest over the
    # STREAM_CHECK_REPLICAS population, which fits on the card.
    r = STREAM_CHECK_REPLICAS
    args = stream_args(pop, 0, r)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    ranks_d = to(pop["ranks"])
    st = state_from_numpy(args[0], device=DEVICE)
    resident = cuda_kernels.merge_step_full(st, to(args[1]), to(args[4]), ranks_d, to(args[6]))
    multi = to(allow_multiple_array())
    res_dg = K.convergence_digest(resident, ranks_d, multi).cpu().numpy().astype(np.uint32)
    res_host = state_to_numpy(resident)
    del st, resident
    if not (res_dg == res_dg[np.arange(r) % STREAM_CLASSES]).all() or np.unique(res_dg).size != STREAM_CLASSES:
        raise AssertionError(f"[phase 17] resident digests do not follow the {STREAM_CLASSES} streams")
    classes = {cls: {f: res_host[f][cls].copy() for f in FIELDS} for cls in range(STREAM_CLASSES)}

    # The kernels against their plain versions at the stream's inputs: rows
    # of one stream have the same inputs, so one replica a stream suffices.
    t = time.perf_counter()
    few = stream_args(pop, 0, STREAM_CLASSES)
    plain = K.merge_step_plain(state_from_numpy(few[0], device=DEVICE), to(few[1]), to(few[4]), ranks_d,
                               to(few[6]))
    plain_dg = K.convergence_digest(plain, ranks_d, multi).cpu().numpy().astype(np.uint32)
    plain_host = state_to_numpy(plain)
    del plain
    if not np.array_equal(plain_dg, res_dg[:STREAM_CLASSES]):
        raise AssertionError(f"[phase 17] resident digests {res_dg[:STREAM_CLASSES]} differ from merge_step_plain's "
                             f"{plain_dg}")
    for cls, want in classes.items():
        for f in FIELDS:
            if plain_host[f].dtype != want[f].dtype or not np.array_equal(plain_host[f][cls], want[f]):
                raise AssertionError(f"[phase 17] field {f} of stream {cls}: the resident kernel merge differs "
                                     "from merge_step_plain")
    log(f"  the resident kernel merge of {r} replicas equals merge_step_plain (one replica a stream) on all "
        f"{len(FIELDS)} fields and the digests, byte for byte; {time.perf_counter() - t:.2f} s")
    reset_counts()
    torch.cuda.empty_cache()

    # Resident equality at r replicas, a padded tail, depth 1 and 2; the
    # depth-2 sweep runs traced and every cohort lane must end.
    trace = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_stream_"), "trace.jsonl")
    for depth in (1, 2):
        if depth == 2:
            telemetry.reset()
            telemetry.enable(trace=trace)
        out, dg, stats, secs = stream_sweep("phase 17", args, launches, cohort=STREAM_CHECK_COHORT, depth=depth)
        if depth == 2:
            telemetry.flush_trace()
            telemetry.reset()
        if not stats["padded_tail"] or not (dg == res_dg).all():
            raise AssertionError(f"[phase 17] depth {depth}: digests differ from the resident merge")
        for f in FIELDS:
            if out[f].dtype != res_host[f].dtype or not np.array_equal(out[f], res_host[f]):
                raise AssertionError(f"[phase 17] depth {depth}: field {f} differs from the resident merge")
        log(f"  {r} replicas, cohort {STREAM_CHECK_COHORT}, depth {depth}: {stats['n_cohorts']} cohorts, "
            f"states and digests byte-equal to the resident merge_step_full; {secs:.2f} s")
        del out
    del res_host
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "trace_report.py"), trace],
                          capture_output=True, text=True, timeout=120)
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or "problems=0" not in proc.stdout:
        raise AssertionError(f"[phase 17] trace_report rc {proc.returncode}: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    log(f"  traced depth-2 sweep: trace_report rc 0, {summary}")

    # Which calls wait on the host during a sweep (three cohorts, depth 2).
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        stream_sweep("phase 17", stream_args(pop, 0, 3 * STREAM_COHORT), launches, cohort=STREAM_COHORT,
                     depth=2, readback_states=False)
    waits = {e.key: e.count for e in prof.key_averages()
             if any(w in e.key for w in ("Synchronize", "aten::item", "_local_scalar_dense", "aten::nonzero",
                                         "aten::unique", "cudaMemcpy("))}
    log(f"  host waits in a 3-cohort depth-2 sweep (torch.profiler, calls): {waits}")

    # The full population, digests only: depth 2 and depth 1 in turns.
    full = stream_args(pop, 0, STREAM_REPLICAS)
    ops = int(np.asarray(pop["ops"])[np.arange(STREAM_REPLICAS) % STREAM_CLASSES].sum())
    walls = {1: [], 2: []}
    for depth in (2, 1, 1, 2):
        torch.cuda.reset_peak_memory_stats()
        _, dg, stats, secs = stream_sweep("phase 17", full, launches, cohort=STREAM_COHORT, depth=depth,
                                          readback_states=False)
        peak = torch.cuda.max_memory_allocated()
        want = res_dg[np.arange(STREAM_REPLICAS) % STREAM_CLASSES]
        if stats["n_cohorts"] != -(-STREAM_REPLICAS // STREAM_COHORT) or not stats["padded_tail"]:
            raise AssertionError(f"[phase 17] cohorts {stats}")
        if np.unique(dg).size != STREAM_CLASSES or not (dg == want).all():
            raise AssertionError(f"[phase 17] depth {depth}: {np.unique(dg).size} distinct digests, or a "
                                 "replica's digest differs from its stream's resident digest")
        walls[depth].append(secs)
        est = STREAM_COHORT * (per + transient_bytes_per_replica(c, m, pop["text"].shape[1]))
        log(f"  {STREAM_REPLICAS:,} replicas, depth {depth}: {stats['n_cohorts']} cohorts (tail "
            f"{STREAM_REPLICAS % STREAM_COHORT} padded to {STREAM_COHORT}), {np.unique(dg).size} distinct digests, "
            f"each replica's equal to its stream's resident digest; sweep {secs:.3f} s, "
            f"{ops / secs:,.0f} merged ops/s (BASELINE's target: <1 s for 100k 10k-char replicas; no claim)")
        log(f"    {stage_line(stats)}")
        log(f"    peak device memory {peak / 2**30:.3f} GiB, {peak / depth / 2**30:.3f} GiB a slot; estimate a slot "
            f"(cohort x (state + the sorted merge's transients)) {est / 2**30:.3f} GiB, state alone "
            f"{STREAM_COHORT * per / 2**30:.3f} GiB")
    log(f"  depth 1 against depth 2 on {STREAM_REPLICAS:,} replicas (in turns 2, 1, 1, 2): depth 1 "
        f"{', '.join(f'{w:.3f}' for w in walls[1])} s, depth 2 {', '.join(f'{w:.3f}' for w in walls[2])} s")

    # State readback of the first cohort, and of the last two (the second
    # is the padded tail: a sweep of fewer rows than a cohort would shrink
    # its cohort instead of padding it).
    tail = STREAM_REPLICAS // STREAM_COHORT * STREAM_COHORT
    for lo, hi in ((0, STREAM_COHORT), (tail - STREAM_COHORT, STREAM_REPLICAS)):
        out, dg, stats, secs = stream_sweep("phase 17", stream_args(pop, lo, hi), launches,
                                            cohort=STREAM_COHORT, depth=2)
        same_rows("phase 17", out, lo, classes)
        padded = (hi - lo) % STREAM_COHORT != 0
        if not (dg == res_dg[np.arange(lo, hi) % STREAM_CLASSES]).all() or stats["padded_tail"] != padded:
            raise AssertionError(f"[phase 17] readback of rows {lo}:{hi}: digests or padding wrong")
        log(f"  readback of rows {lo}:{hi} ({stats['n_cohorts']} cohorts"
            f"{', the last a padded tail' if padded else ''}): states equal to the resident rows; {secs:.2f} s")
        del out
    log(f"  phase 17 kernel launches (the stream's sweeps): {launches}")
    return {"launches": launches}


def card_doc(actor: str) -> TorchDoc:
    return TorchDoc(actor, device=DEVICE)


def mixed_docs():
    engines = iter([card_doc, Doc, card_doc, Doc])
    return lambda actor: next(engines)(actor)


def status_leg(label: str, tmp: str, run) -> None:
    """One leg under the status surface (armed as ``PERITEXT_STATUS`` and
    ``PERITEXT_METRICS_INTERVAL`` arm it at import), then rendered by
    ``scripts/ops_top.py --once``."""
    path = os.path.join(tmp, f"{label}.status.json")
    telemetry.reset()
    telemetry.enable(status_path=path, metrics_interval=float(STATUS_INTERVAL))
    t = time.perf_counter()
    try:
        detail = run()
        telemetry.dump_status()
    finally:
        telemetry.reset()
    secs = time.perf_counter() - t
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "ops_top.py"), path, "--once"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"[phase 18 {label}] ops_top rc {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"  [{label}] {detail}; {secs:.1f} s; ops_top --once rc 0")


def fuzz_leg(**kw) -> str:
    out = fuzz(**kw)
    docs = [d for d in out["docs"] if isinstance(d, TorchDoc)]
    if not docs or any(d._uni.device.type != torch.device(DEVICE).type for d in docs):
        raise AssertionError(f"[phase 18] the fuzz's TorchDocs are not on {DEVICE}: {out['docs']}")
    extra = ""
    if out["serve_stats"]:
        extra += f", {out['serve_stats'].get('flushes', 0)} flushes"
    if out["migrate_stats"]:
        extra += f", migrations {out['migrate_stats']}"
    if out["evict_stats"]:
        extra += f", evictions {out['evict_stats']['evictions']} hydrations {out['evict_stats']['lifecycle']['hydrations']}"
    return f"{out['iterations']} iterations, final length {sum(len(s['text']) for s in out['final_spans'])}{extra}"


def bridge_script(rng, net, n: int) -> None:
    """``n`` random editor commands, a manual sync every 4."""
    names = sorted(net.editors)
    for k in range(n):
        editor = net[rng.choice(names)]
        length = len(editor.text())
        kind = rng.choice(["insert", "insert", "delete", "bold", "link", "comment"])
        a = rng.randrange(length) if length else 0
        b = min(length, a + 1 + rng.randrange(4))
        if kind == "insert" or length < 2:
            editor.insert(a, rng.choice(["x", "yz", "hello "]))
        elif kind == "delete":
            editor.delete(a, b - a)
        elif kind == "bold":
            editor.toggle_mark(a, b, "strong")
        elif kind == "link":
            editor.add_link(a, b, f"{rng.choice('abc')}.example")
        else:
            editor.add_comment(a, b, "note")
        if k % 4 == 3:
            net.sync_all()


def bridge_leg() -> str:
    """Three editors on card TorchDocs against oracle twins: manual sync,
    then interval-driven delivery on the queues' timer threads."""
    import random as _random

    actors = ["alice", "bob", "carol"]
    nets = {"card": EditorNetwork(actors, initial_text="a shared note", doc_factory=card_doc),
            "oracle": EditorNetwork(actors, initial_text="a shared note")}
    for net in nets.values():
        _random.seed(17)
        bridge_script(_random.Random(5), net, 24)
        net.sync_all()
    for a in actors:
        if nets["card"][a].spans() != nets["oracle"][a].spans() or nets["card"][a].text() != nets["oracle"][a].text():
            raise AssertionError(f"[phase 18 bridge] manual: {a}'s spans differ from its oracle twin's")
    # Interval-driven: the queues' timer threads deliver while the editors
    # type; each editor must end on the spans of an oracle twin that
    # ingests every change the editors made.
    card = nets["card"]
    card.start_all()
    try:
        for i, a in enumerate(actors):
            card[a].insert(i, f"[{a}]")
        card["bob"].toggle_mark(0, 5, "em")
        deadline = time.monotonic() + 60.0
        while not card.converged() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        card.stop_all()
    card.sync_all()
    changes = [card.genesis] + [c for a in actors for c in card[a].change_log]
    for a in actors:
        twin = Doc(a)
        apply_changes(twin, changes)
        if card[a].spans() != twin.get_text_with_formatting(["text"]):
            raise AssertionError(f"[phase 18 bridge] interval-driven: {a}'s spans differ from its oracle twin's")
    return f"3 editors, manual then interval-driven, {len(card['alice'].text())} chars, spans equal to oracle twins"


def phase_drivers() -> dict:
    """Phase 18: the reference's host-side drivers on TorchDocs on the card."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    t0 = time.perf_counter()
    reset_counts()
    status_leg("fuzz torch", tmp, lambda: fuzz_leg(iterations=FUZZ_ITERS, seed=1, doc_factory=card_doc))
    status_leg("fuzz mixed chaos", tmp, lambda: fuzz_leg(
        iterations=FUZZ_ITERS, seed=2, doc_factory=mixed_docs(), chaos=DEFAULT_CHAOS_SPEC))
    status_leg("fuzz serve", tmp, lambda: fuzz_leg(
        iterations=SERVE_FUZZ_ITERS, seed=3, doc_factory=card_doc, serve=True, chaos=DEFAULT_CHAOS_SPEC,
        device=DEVICE))
    status_leg("fuzz sharded", tmp, lambda: fuzz_leg(
        iterations=SERVE_FUZZ_ITERS, seed=4, doc_factory=card_doc, serve=True, serve_shards=4,
        migrate_every=3, evict_every=4, chaos=DEFAULT_CHAOS_SPEC, device=DEVICE))

    def replay_leg() -> str:
        queues = replay.load_trace(os.path.join(REPO, "traces", "fail-seed3.json"))["queues"]
        spans = replay.assert_replay_converges(queues, card_doc)
        if spans != replay.assert_replay_converges(queues):
            raise AssertionError("[phase 18 replay] the card's replay differs from the oracle's")
        return f"traces/fail-seed3.json: {sum(map(len, queues.values()))} changes, 3 TorchDocs converge to the oracle's spans"

    status_leg("replay", tmp, replay_leg)
    status_leg("bridge", tmp, bridge_leg)

    # The CLI, with the status surface armed from the environment.
    path = os.path.join(tmp, "cli.status.json")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "peritext_tpu_torch.fuzz", str(FUZZ_ITERS), "5", "--engine", "torch",
         "--device", DEVICE, "--report-every", "0", "--trace-dir", tmp],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PERITEXT_STATUS=path, PERITEXT_METRICS_INTERVAL=STATUS_INTERVAL),
    )
    if proc.returncode != 0 or f"ok: {FUZZ_ITERS} iterations" not in proc.stdout:
        raise AssertionError(f"[phase 18 cli] rc {proc.returncode}: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    top = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "ops_top.py"), path, "--once"],
                         capture_output=True, text=True, timeout=60)
    if top.returncode != 0:
        raise AssertionError(f"[phase 18 cli] ops_top rc {top.returncode}: {top.stderr[-2000:]}")
    log(f"  [cli] python -m peritext_tpu_torch.fuzz {FUZZ_ITERS} 5 --engine torch --device {DEVICE} under "
        f"PERITEXT_STATUS: {proc.stdout.strip().splitlines()[-1]}; {time.perf_counter() - t:.1f} s; "
        "ops_top --once rc 0")
    launches = dict(cuda_kernels.LAUNCHES)
    reset_counts()
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s; kernel launches {launches}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    started = t = time.perf_counter()
    paths = _build.build_all()
    log(f"phase 1: built {sorted(paths)} in {time.perf_counter() - t:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                log(f"  nvcc[{name}] {line.strip()}")
    card = card_line()

    # No fallback may hide the device: degradation is off but for the legs
    # that test it, and every phase holds its resilience counts.
    os.environ["PERITEXT_DEGRADE"] = "0"
    faults.reset()
    health.reset()
    telemetry.reset()
    tally_resilience()

    torch.cuda.reset_peak_memory_stats()
    with resilience("phase 2"):
        results = phase_bench_shape(REPLICAS, ROUNDS, runs=10)
    log_peak("phase 2")
    with resilience("phase 3"):
        phase_large_shape(REPLICAS, runs=10)
    log_peak("phase 3")
    with resilience("phase 4"):
        main = phase_main_path("phase 4", REPLICAS, DOC_LEN, WRITERS, ROUNDS, 2048, 1024,
                               samples=8, seed=1, scan=True)
    log_peak("phase 4")
    with resilience("phase 5"):
        past = phase_main_path("phase 5", 64, 8300, 2, 2, 8192, 256, samples=8, seed=2, scan=True)
    if past["capacity"] != LARGE_CAPACITY or past["growths"] < 1 or past["max_length"] <= 8192:
        raise AssertionError(f"phase 5 did not grow past 8192 elements: {past}")
    del past["uni"]
    log_peak("phase 5")
    count_plain_calls()
    with resilience("phase 6"):
        patch_run = phase_patch_path(REPLICAS, 64, main["round_seconds"], samples=8)
    log_peak("phase 6")
    with resilience("phase 7"):
        phase_doc(edits=200, sync_every=10)
    log_peak("phase 7")
    with resilience("phase 8"):
        sorted_run = phase_sorted_path(main, 2048, 1024, samples=8)
    del main["uni"]
    torch.cuda.empty_cache()
    log_peak("phase 8")
    with resilience("phase 9"):
        window = phase_window(REPLICAS, 64, samples=8)
    log_peak("phase 9")
    with resilience("phase 10"):
        serving = phase_serving(REPLICAS, THREADED_SESSIONS, samples=8)
    log_peak("phase 10")
    resilient = phase_resilience(serving, samples=8)
    del serving["uni"]
    torch.cuda.empty_cache()
    log_peak("phase 11")
    with resilience("phase 12"):
        patched_sorted = phase_patched_sorted(patch_run, REPLICAS)
    del patch_run["states"], patch_run["outs"]
    torch.cuda.empty_cache()
    log_peak("phase 12")
    with resilience("phase 13"):
        patched_window = phase_patched_window(window, REPLICAS, samples=8)
    log_peak("phase 13")
    with resilience("phase 14"):
        served_sorted = phase_serving_sorted(serving, REPLICAS)
    log_peak("phase 14")
    with resilience("phase 15"):
        capacity = phase_capacity(CAPACITY_REPLICAS, samples=8)
    log_peak("phase 15")
    t = time.perf_counter()
    with resilience("phase 16"):
        sharded = phase_sharded(serving)
    log_peak("phase 16")
    log(f"phase 16 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with resilience("phase 17"):
        streamed = phase_stream()
    log_peak("phase 17")
    log(f"phase 17 took {time.perf_counter() - t:.1f} s")
    with resilience("phase 18"):
        drivers = phase_drivers()
    log_peak("phase 18")
    runs = (main, past, sorted_run, window, serving, resilient, patched_sorted, patched_window, served_sorted,
            capacity, sharded, streamed, drivers)
    launches = {name: sum(run["launches"].get(name, 0) for run in runs) for name in results}
    log("phase 19: resilience counts (launch_retries, fastfails, degraded_batches) per phase and leg: " + "; ".join(
        f"{lbl} {got['launch_retries']}/{got['fastfails']}/{got['degraded_batches']}" for lbl, got in PHASE_TALLIES))
    log(f"  kernel launches summed over phases 4, 5 and 8-18: {launches}; the script so far "
        f"{time.perf_counter() - started:.1f} s")

    replaces = {
        "text_phase": "peritext_tpu/ops/pallas_kernels.py:152",
        "mark_phase": "peritext_tpu/ops/pallas_kernels.py:331",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"peritext_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
