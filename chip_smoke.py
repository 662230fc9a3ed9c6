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
10. Print the kernels' JSON summary (launches summed over phases 4, 5, 8
   and 9; ``ms`` per wrapper call between CUDA events, ``device_ms`` the
   kernel alone with a cold L2, both at phase 2), the card, and as the
   last line ``{"ok": true, "device": {...}}``.  Peak device memory is
   printed after every phase.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
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
    text_row_mix,
)
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import FIELDS, map_state
from peritext_tpu_torch.oracle import Doc, accumulate_patches
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

    torch.cuda.reset_peak_memory_stats()
    results = phase_bench_shape(REPLICAS, ROUNDS, runs=10)
    log_peak("phase 2")
    phase_large_shape(REPLICAS, runs=10)
    log_peak("phase 3")
    main = phase_main_path("phase 4", REPLICAS, DOC_LEN, WRITERS, ROUNDS, 2048, 1024,
                           samples=8, seed=1, scan=True)
    log_peak("phase 4")
    past = phase_main_path("phase 5", 64, 8300, 2, 2, 8192, 256, samples=8, seed=2, scan=True)
    if past["capacity"] != LARGE_CAPACITY or past["growths"] < 1 or past["max_length"] <= 8192:
        raise AssertionError(f"phase 5 did not grow past 8192 elements: {past}")
    del past["uni"]
    log_peak("phase 5")
    count_plain_calls()
    phase_patch_path(REPLICAS, 64, main["round_seconds"], samples=8)
    log_peak("phase 6")
    phase_doc(edits=200, sync_every=10)
    log_peak("phase 7")
    sorted_run = phase_sorted_path(main, 2048, 1024, samples=8)
    del main["uni"]
    torch.cuda.empty_cache()
    log_peak("phase 8")
    window = phase_window(REPLICAS, 64, samples=8)
    log_peak("phase 9")
    launches = {name: sum(run["launches"][name] for run in (main, past, sorted_run, window))
                for name in results}

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
