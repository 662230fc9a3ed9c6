#!/usr/bin/env python3
"""Drive the PyTorch port of peritext_tpu on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build both CUDA kernels from ``peritext_tpu_torch/csrc`` with nvcc and
   print what the compiler reports, the card and its power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   benchmark's shape (1024 replicas, a 1000-char document, 4 concurrent
   writer streams of 64 ops with marks; C = 2048, M = 1024): outputs must
   be byte-equal.  Print each one's time beside the plain version's.
3. The main path: ``TorchUniverse.apply_changes`` on 1024 replicas ingests
   the genesis change, 8 chained rounds in which replica r takes writer
   r % 4's 64 new ops, then an all-to-all merge of the other writers'
   histories.  Every replica's digest must agree, the texts and sampled
   spans must equal an oracle Doc that merged all four writers, and both
   kernels' launch counts must equal the merges the universe ran.
4. Print the kernels' JSON summary, the card, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.bench.workloads import (
    build_device_batch,
    make_merge_workload,
    make_writer_rounds,
)
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.oracle import Doc

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the CUDA-core rate (no
# tensor cores) that bounds the kernels' integer compares and moves.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

DOC_LEN = 1000
OPS_PER_ROUND = 64
WRITERS = 4
REPLICAS = 1024
ROUNDS = 8
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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


def bound(bytes_moved: int, ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(replicas: int, rounds: int, runs: int) -> dict:
    capacity = 1
    while capacity < DOC_LEN + (rounds + 1) * OPS_PER_ROUND + 8:
        capacity *= 2
    max_marks = 64
    while max_marks < (rounds + 1) * OPS_PER_ROUND + 32:
        max_marks *= 2
    wl = make_merge_workload(DOC_LEN, OPS_PER_ROUND, WRITERS, True, seed=0)
    b = build_device_batch(wl, replicas, capacity, max_marks, device=DEVICE)
    st, text_ops, char_buf, mark_ops, ranks = (
        b["states"], b["text_ops"], b["char_buf"], b["mark_ops"], b["ranks"]
    )
    log(f"phase 2: R={replicas} C={capacity} M={max_marks} text rows={text_ops.shape[1]} "
        f"mark rows={mark_ops.shape[1]}")
    results = {}

    text_in = (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text_ops, ranks, char_buf)
    got = cuda_kernels.text_phase(*text_in)
    want = K.text_phase_plain(*text_in)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"text_phase differs from its plain version: max abs err {err}")
    live_rows = int((text_ops[:, :, K.K_KIND] != K.KIND_PAD).sum().item())
    t_bound, t_by = bound(nbytes(*text_in) + nbytes(*got), 4 * live_rows * capacity)
    results["text_phase"] = {
        "err": err,
        "ms": time_ms(lambda: cuda_kernels.text_phase(*text_in), runs),
        "plain_ms": time_ms(lambda: K.text_phase_plain(*text_in), max(2, runs // 4)),
        "bound_ms": t_bound,
        "bound_by": t_by,
    }

    ec, ea, _, _, oi, ln = got
    bnd_def, bnd_mask = K._permute_boundaries(st.bnd_def, st.bnd_mask, oi)
    mark_in = (bnd_def, bnd_mask, ec, ea, ln, st.mark_count, mark_ops)
    got_m = cuda_kernels.mark_phase(*mark_in)
    want_m = K.mark_phase_plain(*mark_in)
    torch.cuda.synchronize()
    err = max_abs_err(got_m, want_m)
    if err != 0:
        raise AssertionError(f"mark_phase differs from its plain version: max abs err {err}")
    if not (want_m[1] != bnd_mask).any():
        raise AssertionError("the mark phase changed no mask word: the check proves nothing")
    live_marks = int((mark_ops[:, :, K.K_KIND] == K.KIND_MARK).sum().item())
    m_bound, m_by = bound(nbytes(*mark_in) + nbytes(*got_m), 8 * live_marks * capacity)
    results["mark_phase"] = {
        "err": err,
        "ms": time_ms(lambda: cuda_kernels.mark_phase(*mark_in), runs),
        "plain_ms": time_ms(lambda: K.mark_phase_plain(*mark_in), max(2, runs // 4)),
        "bound_ms": m_bound,
        "bound_by": m_by,
    }

    merge_in = (st, text_ops, mark_ops, ranks, char_buf)
    full = cuda_kernels.merge_step_full(*merge_in)
    plain = K.merge_step_plain(*merge_in)
    torch.cuda.synchronize()
    err = max_abs_err([getattr(full, f) for f in FIELDS], [getattr(plain, f) for f in FIELDS])
    if err != 0:
        raise AssertionError(f"merge_step_full differs from merge_step_plain: max abs err {err}")
    full_ms = time_ms(lambda: cuda_kernels.merge_step_full(*merge_in), runs)
    plain_ms = time_ms(lambda: K.merge_step_plain(*merge_in), max(2, runs // 4))
    # The two plain-torch stages between and after the kernels.
    permute_ms = time_ms(lambda: K._permute_boundaries(st.bnd_def, st.bnd_mask, oi), runs)
    table_ms = time_ms(lambda: K.append_mark_table(st, mark_ops), runs)
    log(f"  merge_step_full stages: text {results['text_phase']['ms']:.4f} ms, permute "
        f"{permute_ms:.4f} ms, mark {results['mark_phase']['ms']:.4f} ms, table {table_ms:.4f} ms")
    for name, r in results.items():
        log(f"  {name}: byte-equal to plain; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  merge_step_full: byte-equal to merge_step_plain on all {len(FIELDS)} fields; "
        f"{full_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return results


def phase_main_path(replicas: int, rounds: int, samples: int) -> dict:
    t0 = time.perf_counter()
    wl = make_writer_rounds(DOC_LEN, OPS_PER_ROUND, WRITERS, rounds, True, seed=1)
    oracle = Doc("oracle")
    oracle.apply_change(wl["genesis"])
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(WRITERS)]
    for w in range(WRITERS):
        for c in history[w]:
            oracle.apply_change(c)
    expect_spans = oracle.get_text_with_formatting(["text"])
    expect_text = "".join(s["text"] for s in expect_spans)
    log(f"phase 3: workload + oracle built in {time.perf_counter() - t0:.2f} s (host)")

    names = [f"replica{i}" for i in range(replicas)]
    uni = TorchUniverse(names, capacity=2048, max_mark_ops=1024, device=DEVICE)
    cuda_kernels.reset_launch_counts()
    batches = [[[wl["genesis"]]] * replicas]
    batches += [[rnd[r % WRITERS] for r in range(replicas)] for rnd in wl["rounds"]]
    batches.append([
        [c for w in range(WRITERS) if w != r % WRITERS for c in history[w]]
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
        raise AssertionError(f"launch counts {launches} != universe merges {merges}")

    digests = uni.digests()
    if len(set(digests.tolist())) != 1:
        raise AssertionError(f"replicas disagree: {len(set(digests.tolist()))} distinct digests")
    texts = uni.texts()
    bad = [r for r, t in enumerate(texts) if t != expect_text]
    if bad:
        raise AssertionError(f"{len(bad)} replicas' text differs from the oracle's (first {bad[0]})")
    step = max(1, replicas // samples)
    for r in list(range(0, replicas, step))[:samples] + [replicas - 1]:
        if uni.spans(r) != expect_spans:
            raise AssertionError(f"replica {r}'s spans differ from the oracle's")
    if not any(s["marks"] for s in expect_spans):
        raise AssertionError("the merged document carries no marks: the check proves nothing")

    state_bytes = nbytes(*(getattr(uni.states, f) for f in FIELDS))
    total = sum(times)
    ops = uni.stats["ops_applied"]
    log(f"  merges={merges} launches={launches} ops_applied={ops} changes={uni.stats['changes_ingested']}")
    log(f"  round seconds (genesis, {rounds} rounds, all-to-all): "
        + " ".join(f"{t:.4f}" for t in times))
    log(f"  merged ops/s {ops / total:.1f} over {total:.3f} s (host clock, each merge synchronized); "
        f"host control plane {uni.stats['host_seconds']:.4f} s of it")
    log(f"  capacity={uni.capacity} max_mark_ops={uni.max_mark_ops} "
        f"state bytes on device={state_bytes} text chars={len(expect_text)} "
        f"spans={len(expect_spans)} digest={int(digests[0])}")
    return launches


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

    results = phase_kernels(REPLICAS, ROUNDS, runs=10)
    launches = phase_main_path(REPLICAS, ROUNDS, samples=8)

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
