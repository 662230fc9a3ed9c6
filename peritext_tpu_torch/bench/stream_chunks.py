"""Time ``stream_merge_sorted``'s digest-only sweep over BASELINE config 5's
population (``chip_smoke.py`` phase 17's: a 10,000-char genesis, 4 writer
streams of 64 ops with marks, seed 5, C = 16384, M = 128, replica r taking
stream r % 4) at depth 2, 1, 1, 2 for each digest chunk size, on one card.

    python3 -m peritext_tpu_torch.bench.stream_chunks [--log2-chunks 24,26,27]
        [--replicas 100000] [--cohort 4096]

``--log2-chunks`` sets ``parallel.stream.DIGEST_CHUNK_ELEMS`` (in [C, M']
entries) for each group of sweeps.  Per sweep it prints one JSON line: the
chunk, the depth, the sweep's seconds, its distinct digests, and each
per-cohort timing's median (host staging, enqueue and drain ms; H2D,
merge, digest and D2H ms from CUDA events).  Every sweep must give the
same digests.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from peritext_tpu_torch.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu_torch.ops.encode import prepare_sorted_batch
from peritext_tpu_torch.ops.state import state_to_numpy
from peritext_tpu_torch.parallel import stream

CLASSES = 4


def population(replicas: int, device: str = "cuda") -> tuple:
    wl = make_merge_workload(doc_len=10_000, ops_per_merge=64, num_streams=CLASSES, with_marks=True, seed=5)
    b = build_device_batch(wl, CLASSES, 16384, 128, device=device)
    sp = prepare_sorted_batch([b["text_ops"][r].cpu().numpy() for r in range(CLASSES)])
    genesis = state_to_numpy(b["states"])
    pick = np.arange(replicas) % CLASSES
    states = {f: np.broadcast_to(a[:1], (replicas,) + a.shape[1:]) for f, a in genesis.items()}
    return (states, sp["text"][pick], sp["rounds"][pick], sp["num_rounds"], b["mark_ops"].cpu().numpy()[pick],
            b["ranks"].cpu().numpy(), sp["bufs"][pick], sp["maxk"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-chunks", default="24,26,27")
    ap.add_argument("--replicas", type=int, default=100_000)
    ap.add_argument("--cohort", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_chunks: no CUDA device", file=sys.stderr)
        return 2
    pop = population(args.replicas)
    want = None
    for log2 in (int(x) for x in args.log2_chunks.split(",")):
        stream.DIGEST_CHUNK_ELEMS = 1 << log2
        for depth in (2, 1, 1, 2):
            t = time.perf_counter()
            _, dg, stats = stream.stream_merge_sorted(*pop, cohort=args.cohort, depth=depth,
                                                      readback_states=False, device="cuda")
            secs = time.perf_counter() - t
            if want is None:
                want = dg
            if stats["route"] != "kernels" or not np.array_equal(dg, want):
                raise AssertionError(f"chunk 2**{log2}, depth {depth}: route {stats['route']} or digests differ")
            row = {"log2_chunk": log2, "depth": depth, "sweep_s": secs, "cohorts": stats["n_cohorts"],
                   "distinct_digests": int(np.unique(dg).size)}
            for key in ("stage_s", "enqueue_s", "drain_s", "h2d_ms", "merge_ms", "digest_ms", "d2h_ms"):
                med = statistics.median(tm[key] for tm in stats["timings"])
                row[key[:-2] + "_ms" if key.endswith("_s") else key] = 1e3 * med if key.endswith("_s") else med
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
