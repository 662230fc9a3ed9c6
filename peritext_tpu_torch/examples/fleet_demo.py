"""Fleet demo: the north-star workload through the port's public batched API.

    python -m peritext_tpu_torch.examples.fleet_demo [--replicas N] [--rounds K]
        [--device cuda|cpu] [--cohort C]

Counterpart of ``examples/fleet_demo.py``.  Document replicas resident on
the card as one ``TorchUniverse`` ingest concurrent edit streams, one
launch per round (the two hand kernels), and are convergence-checked with
one batched digest.  Replica i merges writer stream (i + round) % 4 each
round, so replicas with equal i % 4 share a history and must share a
digest.  A fleet past what the card holds resident (``cohort_for_budget``
on its free memory), or any fleet given ``--cohort``, keeps its states on
the host and streams cohorts through the card (``stream_merge_sorted``)
with the same rounds and the same check.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu_torch.ops.encode import prepare_sorted_batch
from peritext_tpu_torch.ops.state import resolve_device
from peritext_tpu_torch.parallel import cohort_for_budget, stream_merge_sorted

CAPACITY, MAX_MARKS = 1024, 256


def check_classes(digests: np.ndarray, classes: int) -> None:
    """Replicas on one stream schedule (i % classes) must share a digest."""
    schedules: Dict[int, set] = {}
    for i, digest in enumerate(digests):
        schedules.setdefault(i % classes, set()).add(int(digest))
    for schedule, unique in sorted(schedules.items()):
        status = "CONVERGED" if len(unique) == 1 else f"DIVERGED ({len(unique)} states)"
        print(f"schedule class {schedule}: {status}")
    if any(len(u) != 1 for u in schedules.values()):
        raise SystemExit("fleet diverged!")


def resident(workload, replicas: int, rounds: int, device) -> None:
    streams = workload["streams"]
    names = [f"replica-{i:05d}" for i in range(replicas)]
    uni = TorchUniverse(names, capacity=CAPACITY, max_mark_ops=MAX_MARKS, device=device)
    t0 = time.perf_counter()
    uni.apply_changes({name: [workload["genesis"]] for name in names})
    print(f"genesis: {replicas} replicas bootstrapped in {time.perf_counter() - t0:.2f}s")
    host_before_rounds = uni.stats["host_seconds"]
    total_ops, wall = 0, 0.0
    for rnd in range(rounds):
        batch = {}
        for i, name in enumerate(names):
            batch[name] = streams[(i + rnd) % len(streams)]
            total_ops += sum(len(c["ops"]) for c in batch[name])
        t0 = time.perf_counter()
        uni.apply_changes(batch)
        if uni.device.type == "cuda":
            torch.cuda.synchronize(uni.device)
        dt = time.perf_counter() - t0
        print(f"round {rnd}: merged {len(streams)} streams across {replicas} replicas in {dt:.2f}s")
        wall += dt
    check_classes(uni.digests(), len(streams))
    spans = uni.spans(names[0])
    text = "".join(s["text"] for s in spans)
    host_s = uni.stats["host_seconds"] - host_before_rounds
    dev_s = max(wall - host_s, 0.0)
    print(
        f"\nfleet consistent: {replicas} replicas, {total_ops} ops merged; replica-0: {len(text)} chars "
        f"in {len(spans)} spans ({sum(1 for s in spans if s['marks'])} marked)\n"
        f"time split: host {host_s:.3f}s, device {dev_s:.3f}s of {wall:.3f}s synchronized "
        f"({'host-bound' if host_s > dev_s else 'device-bound'})"
    )


def streamed(workload, replicas: int, rounds: int, device, cohort: int) -> None:
    classes = len(workload["streams"])
    batch = build_device_batch(workload, classes, CAPACITY, MAX_MARKS)
    sp = prepare_sorted_batch([batch["text_ops"][r].numpy() for r in range(classes)])
    genesis = state_to_numpy(batch["states"])
    population = {f: np.ascontiguousarray(np.broadcast_to(a[:1], (replicas,) + a.shape[1:]))
                  for f, a in genesis.items()}
    marks = batch["mark_ops"].numpy()
    ranks = batch["ranks"].numpy()
    print(f"streaming {replicas} replicas in cohorts of {cohort} (host population "
          f"{sum(a.nbytes for a in population.values()) / 2**20:.1f} MiB)")
    digests = None
    for rnd in range(rounds):
        pick = (np.arange(replicas) + rnd) % classes
        t0 = time.perf_counter()
        population, digests, stats = stream_merge_sorted(
            population, sp["text"][pick], sp["rounds"][pick], sp["num_rounds"], marks[pick], ranks,
            sp["bufs"][pick], sp["maxk"], cohort=cohort, device=device,
        )
        print(f"round {rnd}: {stats['n_cohorts']} cohorts on the {stats['route']} route in "
              f"{time.perf_counter() - t0:.2f}s")
    check_classes(digests, classes)
    print(f"\nfleet consistent: {replicas} replicas streamed through {device}")


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--replicas", type=int, default=256)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--cohort", type=int, default=0,
                        help="stream in cohorts of this size (default: stream only a fleet past what "
                        "the card holds, in cohorts sized from its free memory)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # Four distinct writer streams over a shared 400-char genesis document.
    workload = make_merge_workload(doc_len=400, ops_per_merge=48, num_streams=4, seed=7)
    free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else None
    fits = free is None or args.replicas <= cohort_for_budget(CAPACITY, MAX_MARKS, 64, free, depth=1)
    if args.cohort or not fits:
        cohort = args.cohort or min(args.replicas, cohort_for_budget(CAPACITY, MAX_MARKS, 64, free or 2**30))
        streamed(workload, args.replicas, args.rounds, device, cohort)
    else:
        resident(workload, args.replicas, args.rounds, device)


if __name__ == "__main__":
    main()
