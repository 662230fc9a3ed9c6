#!/usr/bin/env python3
"""Drive the PyTorch port of peritext_tpu on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build both CUDA kernels from ``peritext_tpu_torch/csrc`` with nvcc and
   print what the compiler reports, the card and its power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   benchmark's shape (1024 replicas, a 1000-char document, 4 concurrent
   writer streams of 64 ops with marks; C = 2048, M = 1024): outputs must
   be byte-equal.  Print each one's time beside the plain version's, and
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
12. Print the resilience counts of every phase (the script runs under
   ``PERITEXT_DEGRADE=0`` but for legs (b) and (c); launch retries,
   fast-fails and degraded batches must be 0 outside the legs that inject
   them, which assert their exact counts), the kernels' JSON summary
   (launches summed over phases 4, 5 and 8-11; ``ms`` per wrapper call
   between CUDA events, ``device_ms`` the kernel alone with a cold L2,
   both at phase 2), the card, and as the last line ``{"ok": true,
   "device": {...}}``.  Peak device memory is printed after every phase.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from peritext_tpu_torch import TorchDoc, TorchUniverse, state_to_numpy
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
)
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import FIELDS, map_state
from peritext_tpu_torch.oracle import Doc, accumulate_patches
from peritext_tpu_torch.runtime import ChangeLog, ServePlane, ServeShedError, faults, health, telemetry
from peritext_tpu_torch.runtime import checkpoint as ckpt
from peritext_tpu_torch.runtime.sync import causal_order

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


def profile_patched_call(label: str, names, wl: dict, cut: int, ms: dict) -> None:
    """Round ``cut + 1`` once more on a fresh universe, under torch.profiler:
    the device time of the patched call against the unprofiled calls'
    median loop and total, and the kernels that take most of it."""
    uni = load_universe(names, wl, cut, WRITERS, 2048, 1024)
    batch = [wl["rounds"][cut][r % WRITERS] for r in range(len(names))]
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
    calls = []
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
    return {"patched_ms": ms, "merge_ms": merge_ms, "a2a_ms": 1e3 * a2a_s}


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
           "scan_round_seconds": scan_times, "full_round_seconds": full_times}
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

    # Manual leg: every session submits rounds 1-2, one change at a time.
    plane = ServePlane(uni, start=False, batch_target=replicas)
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
    manual_s = time.perf_counter() - t
    no_kernel_or_plain_calls(label)
    manual_stats = dict(plane.stats)
    plane.close()
    for r, s in enumerate(sessions):
        if s.patch_log != per_round[r % WRITERS][0] + per_round[r % WRITERS][1]:
            raise AssertionError(f"[{label}] session {r}'s patches differ from its observer's")
    log(f"  manual leg: {replicas} sessions, rounds 1-2, {n_subs} submissions in {manual_s:.3f} s "
        f"({n_subs / manual_s:.1f} submissions/s); {len(flush_ms)} flushes, flush ms "
        f"{median_p95(flush_ms)}; every session's patches equal its observer's")
    log(f"  manual plane stats: {manual_stats}")

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
            "threaded": threaded}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
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
        phase_patch_path(REPLICAS, 64, main["round_seconds"], samples=8)
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
    runs = (main, past, sorted_run, window, serving, resilient)
    launches = {name: sum(run["launches"].get(name, 0) for run in runs) for name in results}
    log("phase 12: resilience counts (launch_retries, fastfails, degraded_batches) per phase and leg: " + "; ".join(
        f"{lbl} {got['launch_retries']}/{got['fastfails']}/{got['degraded_batches']}" for lbl, got in PHASE_TALLIES))
    log(f"  kernel launches summed over phases 4, 5 and 8-11: {launches}")

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
