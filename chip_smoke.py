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
4. The main path: ``TorchUniverse.apply_changes`` on 1024 replicas ingests
   the genesis change, 8 chained rounds in which replica r takes writer
   r % 4's 64 new ops, then an all-to-all merge of the other writers'
   histories.  Every replica's digest must agree, the texts and sampled
   spans must equal an oracle Doc that merged all four writers, and both
   kernels' launch counts must equal the merges the universe ran.
5. The main path past 8192 characters: 64 replicas start at C = 8192,
   ingest an 8300-char genesis (growing to C = 16384), 2 chained rounds of
   2 writers and the all-to-all merge, with the checks of phase 4.
6. Print the kernels' JSON summary (launches summed over phases 4 and 5;
   ``ms`` per wrapper call between CUDA events, ``device_ms`` the kernel
   alone with a cold L2, both at phase 2), the card, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.bench.bounds import bound, nbytes, text_phase_bytes
from peritext_tpu_torch.bench.timing import call_ms, device_ms
from peritext_tpu_torch.bench.workloads import (
    build_device_batch,
    insert_heavy_text_ops,
    make_merge_workload,
    make_writer_rounds,
    text_row_mix,
)
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.oracle import Doc

DOC_LEN = 1000
OPS_PER_ROUND = 64
WRITERS = 4
REPLICAS = 1024
ROUNDS = 8
# The JAX latency bench's 10k-character shape (time_merge_latency).
LARGE_DOC_LEN = 10_000
LARGE_CAPACITY = 16384
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_main_path(label: str, replicas: int, doc_len: int, writers: int, rounds: int,
                    capacity: int, max_marks: int, samples: int, seed: int) -> dict:
    t0 = time.perf_counter()
    wl = make_writer_rounds(doc_len, OPS_PER_ROUND, writers, rounds, True, seed=seed)
    oracle = Doc("oracle")
    oracle.apply_change(wl["genesis"])
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(writers)]
    for w in range(writers):
        for c in history[w]:
            oracle.apply_change(c)
    expect_spans = oracle.get_text_with_formatting(["text"])
    expect_text = "".join(s["text"] for s in expect_spans)
    log(f"{label}: workload + oracle built in {time.perf_counter() - t0:.2f} s (host)")

    names = [f"replica{i}" for i in range(replicas)]
    uni = TorchUniverse(names, capacity=capacity, max_mark_ops=max_marks, device=DEVICE)
    cuda_kernels.reset_launch_counts()
    batches = [[[wl["genesis"]]] * replicas]
    batches += [[rnd[r % writers] for r in range(replicas)] for rnd in wl["rounds"]]
    batches.append([
        [c for w in range(writers) if w != r % writers for c in history[w]]
        for r in range(replicas)
    ])
    times = []
    for batch in batches:
        t = time.perf_counter()
        uni.apply_changes(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = dict(cuda_kernels.LAUNCHES)
    merges = uni.stats["launches"]
    if merges <= 0 or any(n != merges for n in launches.values()):
        raise AssertionError(f"[{label}] launch counts {launches} != universe merges {merges}")

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
    log(f"  merged ops/s {ops / total:.1f} over {total:.3f} s (host clock, each merge synchronized); "
        f"host control plane {uni.stats['host_seconds']:.4f} s of it")
    log(f"  capacity={uni.capacity} (growths {uni.stats['capacity_growths']}) "
        f"max_mark_ops={uni.max_mark_ops} max length={max(uni.lengths)} "
        f"state bytes on device={state_bytes} text chars={len(expect_text)} "
        f"spans={len(expect_spans)} digest={int(digests[0])}")
    return {"launches": launches, "capacity": uni.capacity, "max_length": max(uni.lengths),
            "growths": uni.stats["capacity_growths"]}


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

    results = phase_bench_shape(REPLICAS, ROUNDS, runs=10)
    phase_large_shape(REPLICAS, runs=10)
    main = phase_main_path("phase 4", REPLICAS, DOC_LEN, WRITERS, ROUNDS, 2048, 1024,
                           samples=8, seed=1)
    past = phase_main_path("phase 5", 64, 8300, 2, 2, 8192, 256, samples=8, seed=2)
    if past["capacity"] != LARGE_CAPACITY or past["growths"] < 1 or past["max_length"] <= 8192:
        raise AssertionError(f"phase 5 did not grow past 8192 elements: {past}")
    launches = {name: main["launches"][name] + past["launches"][name] for name in results}

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
