"""Epochs of merges on a ``TorchUniverse`` resident on the cell's device
mesh: the whole population on the cards, sharded by replica.

Each epoch drops the previous fleet, so that at most one is alive, then
opens a new universe of the configuration's replicas laid out over the
mesh from its construction (``mesh=``; the configuration's ``mesh`` shape
over the cell's cards, or over as many ``"cpu"`` entries on the CPU),
merges the genesis, the traffic's rounds, in which replica r takes writer
r % writers' concurrent batch, and the all-to-all, in which each replica
takes the other writers' histories, then takes every replica's digest and
the global digest, their sum reduced across the cards.
Epochs replay workloads authored in set-up from the traffic's structure
seeds, their content drawn from the run's seed (``gen/relabel.py``), in an
order drawn from the seed; each workload is warmed once.  The window runs
whole epochs back to back until ``seconds`` have passed and every workload
has run.

``delivered_ops`` counts every internal op of every change delivered to
every replica, from the changes, as ``epochs.py`` counts them.  On the
cards, a run without ``trace`` has the profiler follow the devices alone
over the whole window: its ``device_busy_s`` is the cards' busy seconds
summed.  A run with ``trace`` profiles ``trace_epochs`` epochs in full
after a third of the window instead, the merge spy on
``ops.cuda_kernels`` (every replica group's merge calls its
``merge_step_full``), and keeps the port's telemetry over them: the
``mesh.digest`` spans of each epoch and the bytes of ``mesh.p2p_bytes``.

Telemetry is on over the window and the check.  After the window every
replica's digest of every epoch is compared with the reference's digest
of its writer class for that epoch's workload, and every epoch's global
digest with the sum of those (mod 2**32); the last universe's text of
every replica, read card by card, and the spans of replicas drawn from the
seed in every writer class, with the first and last replica of every
card, are compared with the reference's replay.  The state stays on the
cards: a byte of it gathered onto one entry (``mesh.gather_bytes``) over
the window and the check fails the run.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import multiprocessing
import random
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from portbench import core
from portbench.drivers._trace import Slice, warm_profiler
from portbench.drivers.epochs import author, class_order, device_entry, epoch_batches, note, settle, text_ops
from portbench.gen.relabel import Relabel
from portbench.reference.digest import attr_numbers, digest
from portbench.reference.doc import Doc

DIGEST = "span.mesh.digest.seconds"


def _totals(telemetry) -> Dict[str, float]:
    """The port's counters, and each span's summed seconds under its
    histogram's name (``span.<name>.seconds``)."""
    snap = telemetry.snapshot()
    return {**snap["counters"], **{k: h["sum"] for k, h in snap["histograms"].items() if k.startswith("span.")}}


def _since(before: Dict[str, float], after: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str, clock: core.Clock,
        program: Optional[Callable[..., Any]] = None) -> Dict[str, Any]:
    import torch

    from peritext_tpu_torch import TorchUniverse
    from peritext_tpu_torch.ops import cuda_kernels
    from peritext_tpu_torch.parallel.mesh import make_mesh
    from peritext_tpu_torch.runtime import telemetry

    cfg, tr = cell["config"], cell["traffic"]
    replicas, writers = cfg["replicas"], cfg["writers"]
    shape = tuple(cfg["mesh"])
    cuda = device == "cuda"
    rng = random.Random(seed)
    relabel = Relabel(rng)
    workloads = [relabel(author(cfg, tr["rounds"], s)) for s in tr["structure_seeds"]]
    plans = [epoch_batches(wl, replicas, writers) for wl in workloads]
    count = {id(c): text_ops(c) for wl in workloads
             for c in [wl["genesis"]] + [c for rnd in wl["rounds"] for stream in rnd for c in stream]}
    ops = [sum(count[id(c)] for batch in plan for row in batch for c in row) for plan in plans]
    names = [f"replica{i}" for i in range(replicas)]
    entries = shape[0] * shape[1]
    mesh = make_mesh([torch.device("cuda", i) for i in range(entries)] if cuda else ["cpu"] * entries, *shape)
    fleet: List[Any] = [None]  # the one universe alive

    def epoch(w: int, sl: Optional[Slice] = None) -> Tuple[np.ndarray, int]:
        """The epoch's digests after the all-to-all, and the global digest."""
        fleet[0] = None  # dropped before the next is allocated
        if program is not None:
            uni = fleet[0] = program(names, cfg)
        else:
            uni = fleet[0] = TorchUniverse(names, capacity=cfg["capacity"], max_mark_ops=cfg["max_mark_ops"],
                                           mesh=mesh)
        span = sl.span if sl is not None else lambda name: contextlib.nullcontext()

        for batch in plans[w]:
            with span("apply_changes"):
                uni.apply_changes(batch)
        with span("digests"):
            return np.asarray(uni.digests(), np.uint32), uni.global_digest

    for w in range(len(plans)):
        epoch(w)
    fleet[0] = None
    order = list(range(len(plans)))
    rng.shuffle(order)
    if trace or cuda:
        warm_profiler(device)
    settle()
    was_on = telemetry.enabled
    telemetry.enable()
    at_start = _totals(telemetry)
    setup_s = clock.since()

    epoch_digests: List[Tuple[int, Tuple[np.ndarray, int]]] = []
    epoch_s: List[float] = []
    host_s: List[float] = []  # the ingest counters, read where the profiler is off: it slows the host
    launches = 0
    layers: Dict[str, Any] = {}
    sl = Slice(False, device)
    whole = Slice(cuda and not trace, device, host=False, cards=cell["chips"])
    trace_from = seconds / 3
    delivered = epochs = 0
    try:
        with whole:
            t_start = time.perf_counter()
            while True:
                w = order[epochs % len(order)]
                if trace and not layers and time.perf_counter() - t_start >= trace_from:
                    sl = Slice(True, device, cuda_kernels, cards=cell["chips"])
                    per_epoch = []
                    traced_merges = 0
                    with sl:
                        for i in range(tr["trace_epochs"]):
                            w = order[(epochs + i) % len(order)]
                            before = _totals(telemetry)
                            epoch_digests.append((w, epoch(w, sl)))
                            per_epoch.append(_since(before, _totals(telemetry)))
                            traced_merges += fleet[0].stats["launches"]
                            delivered += ops[w]
                    epochs += tr["trace_epochs"]
                    totals = {k: sum(e.get(k, 0) for e in per_epoch) for e in per_epoch for k in e}
                    mesh_seen = any(k.startswith("span.mesh.") for k in totals)  # the port's mesh spans
                    layers = {"telemetry": totals, "traced_merges": traced_merges,
                              "digest_s": [e[DIGEST] for e in per_epoch if DIGEST in e],
                              "p2p_bytes": totals.get("mesh.p2p_bytes", 0) if mesh_seen else None}
                else:
                    t_epoch = time.perf_counter()
                    epoch_digests.append((w, epoch(w)))
                    epoch_s.append(time.perf_counter() - t_epoch)
                    host_s.append(fleet[0].stats["host_seconds"])
                    launches += fleet[0].stats["launches"]
                    delivered += ops[w]
                    epochs += 1
                if time.perf_counter() - t_start >= seconds and epochs >= len(order):
                    break
            window_s = time.perf_counter() - t_start
        peaks = core.card_memory_peaks(cell["chips"]) if cuda else [0]
        note("epoch seconds", epoch_s)
        note("epoch host seconds", host_s)
        checks = check(fleet[0], epoch_digests, workloads, cfg, rng)
        fleet[0] = None
        gathered = _since(at_start, _totals(telemetry)).get("mesh.gather_bytes", 0)
        checks.append(core.Check("home_gather_bytes", gathered, 0))
    finally:
        if not was_on:
            telemetry.disable()
    if sl.profile is not None:
        layers.update({"host_seconds": sum(host_s), "launches": launches, "merge_bytes": sl.spy.bytes_moved(),
                       "merges": len(sl.spy.calls)})
    busy = whole.profile["busy_s"] if whole.profile is not None else None
    if busy is not None:
        print(f"portbench: the cards were busy {busy:.6f} device-seconds of the {window_s:.3f} s window",
              file=sys.stderr)
    return {"setup_s": setup_s, "window_s": window_s, "delivered_ops": delivered, "device_busy_s": busy,
            "attempted": epochs, "failed": 0, "checks": checks, "profile": sl.profile, "layers": layers,
            "device": device_entry(device, cell["chips"], peaks)}


def class_spans(wl: Dict[str, Any], writers: int) -> List[Any]:
    """Each writer class's spans after the all-to-all, replayed by the
    reference in the order the class's replicas receive the changes (the
    genesis integrated once and copied)."""
    base = Doc("reference")
    base.apply_change(wl["genesis"])
    final = []
    for k in range(writers):
        d = copy.deepcopy(base)
        for c in class_order(wl, writers, k)[1:]:
            d.apply_change(c)
        final.append(d.get_text_with_formatting(["text"]))
    return final


def check(uni: Any, epoch_digests: List[Tuple[int, Tuple[np.ndarray, int]]],
          workloads: List[Dict[str, Any]], cfg: Dict[str, Any], rng: random.Random) -> List[core.Check]:
    """Every epoch's digests and global digest, and the last universe's
    texts and sampled spans, against the reference."""
    writers, replicas = cfg["writers"], cfg["replicas"]
    per_card = replicas // cfg["mesh"][0]
    # One process a workload: the reference integrates a 10,000-char genesis in seconds.
    with concurrent.futures.ProcessPoolExecutor(len(workloads), mp_context=multiprocessing.get_context("spawn")) as pool:
        want = list(pool.map(class_spans, workloads, [writers] * len(workloads)))
    numbers = [attr_numbers([wl["genesis"]] + [c for rnd in wl["rounds"] for s in rnd for c in s])
               for wl in workloads]
    cls = np.arange(replicas) % writers
    ref = [np.array([digest(sp, numbers[w]) for sp in want[w]], np.uint32)[cls] for w in range(len(workloads))]
    digest_bad = sum(int((got != ref[w]).sum()) for w, (got, _) in epoch_digests)
    global_bad = sum(total != int(ref[w].sum(dtype=np.uint64)) & 0xFFFFFFFF for w, (_, total) in epoch_digests)
    last = epoch_digests[-1][0]
    want_text = ["".join(s["text"] for s in sp) for sp in want[last]]
    text_bad = sum(t != want_text[r % writers] for r, t in enumerate(uni.texts()))
    per_class = max(1, cfg["span_samples"] // writers)
    edges = {r for i in range(cfg["mesh"][0]) for r in (i * per_card, (i + 1) * per_card - 1)}
    sample = sorted(edges | {r for k in range(writers)
                             for r in rng.sample(range(k, replicas, writers),
                                                 min(per_class, len(range(k, replicas, writers))))})
    span_bad = sum(uni.spans(r) != want[last][r % writers] for r in sample)
    unchecked = len(workloads) - len({w for w, _ in epoch_digests})
    return [core.Check("digest_mismatch_replicas", digest_bad, 0),
            core.Check("global_digest_mismatch", global_bad, 0),
            core.Check("text_mismatch_replicas", text_bad, 0),
            core.Check("span_mismatch_replicas", span_bad, 0),
            core.Check("workloads_unchecked", unchecked, 0)]
