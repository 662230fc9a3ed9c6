"""Epochs of merges on ``TorchUniverse.apply_changes``.

Each epoch opens a fleet (a new universe of the configuration's replicas),
merges the genesis, then the traffic's rounds, in which replica r takes
writer r % writers' concurrent batch, then the all-to-all: each replica
takes the other writers' histories.  Epochs replay workloads authored in
set-up from the traffic's structure seeds, their content drawn from the
run's seed (``gen/relabel.py``), in an order drawn from the seed; each
workload is warmed once.  The
window runs whole epochs until ``seconds`` have passed.

The record's ``delivered_ops`` counts every internal op of every change
delivered to every replica (each inserted and deleted character, each mark
op), from the changes themselves.  On the card, a run without ``trace``
has the profiler follow the device alone over the whole window: its
``device_busy_s`` is the union of the window's kernels, copies and sets.
A run with ``trace`` profiles a slice of epochs in full instead, and its
``plain_ops`` / ``plain_s`` are the ops and seconds of the other epochs.
After the window the last universe of each workload is checked: every
replica's text, and the spans of replicas drawn from the seed in every
writer class, against the reference's replay of that class's changes in
the order it received them.
"""
from __future__ import annotations

import copy
import random
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from portbench import core
from portbench.drivers._trace import Slice, warm_profiler
from portbench.gen.fuzzmix import make_writer_rounds
from portbench.gen.relabel import Relabel
from portbench.gen.wire import wire_fuzz_rounds
from portbench.reference.doc import Doc

TEXT_ACTIONS = ("set", "del", "addMark", "removeMark")


def text_ops(change: Dict[str, Any]) -> int:
    """Internal ops on the text: characters inserted and deleted, marks."""
    return sum(op["action"] in TEXT_ACTIONS for op in change["ops"])


def author(cfg: Dict[str, Any], rounds: int, seed: int) -> Dict[str, Any]:
    """One workload of the configuration: its genesis and ``rounds`` rounds
    of its writers' concurrent batches."""
    args = (cfg["doc_len"], cfg["ops_per_round"], cfg["writers"], rounds)
    if cfg["generator"] == "wire":
        return wire_fuzz_rounds(*args, seed=seed)
    return make_writer_rounds(*args, with_marks=True, seed=seed)


def epoch_batches(wl: Dict[str, Any], replicas: int, writers: int) -> List[List[List[Dict[str, Any]]]]:
    """Genesis, the rounds, and the all-to-all of the other writers'
    histories (``chip_smoke.main_path_batches``)."""
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(writers)]
    batches = [[[wl["genesis"]]] * replicas]
    batches += [[rnd[r % writers] for r in range(replicas)] for rnd in wl["rounds"]]
    batches.append([[c for w in range(writers) if w != r % writers for c in history[w]]
                    for r in range(replicas)])
    return batches


def class_order(wl: Dict[str, Any], writers: int, k: int) -> List[Dict[str, Any]]:
    """Writer class ``k``'s changes in the order its replicas receive them."""
    own = [c for rnd in wl["rounds"] for c in rnd[k]]
    others = [c for w in range(writers) if w != k for rnd in wl["rounds"] for c in rnd[w]]
    return [wl["genesis"]] + own + others


def expected(wl: Dict[str, Any], writers: int, doc_cls=Doc) -> List[List[Dict[str, Any]]]:
    """Each writer class's spans, replayed by the reference (the genesis
    integrated once and copied)."""
    base = doc_cls("reference")
    base.apply_change(wl["genesis"])
    out = []
    for k in range(writers):
        d = copy.deepcopy(base)
        for c in class_order(wl, writers, k)[1:]:
            d.apply_change(c)
        out.append(d.get_text_with_formatting(["text"]))
    return out


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str, clock: core.Clock,
        program: Optional[Callable[..., Any]] = None) -> Dict[str, Any]:
    import torch

    import peritext_tpu_torch.ops.universe as universe_mod
    from peritext_tpu_torch import TorchUniverse

    cfg, tr = cell["config"], cell["traffic"]
    replicas, writers = cfg["replicas"], cfg["writers"]
    rng = random.Random(seed)
    relabel = Relabel(rng)
    workloads = [relabel(author(cfg, tr["rounds"], s)) for s in tr["structure_seeds"]]
    plans = [epoch_batches(wl, replicas, writers) for wl in workloads]
    # Each change counted once and summed per delivery: a plan delivers millions of ops at 10,000 replicas.
    count = {id(c): text_ops(c) for wl in workloads
             for c in [wl["genesis"]] + [c for rnd in wl["rounds"] for stream in rnd for c in stream]}
    ops = [sum(count[id(c)] for batch in plan for row in batch for c in row) for plan in plans]
    names = [f"replica{i}" for i in range(replicas)]
    cuda = device == "cuda"

    def open_fleet():
        if program is not None:
            return program(names, cfg)
        return TorchUniverse(names, capacity=cfg["capacity"], max_mark_ops=cfg["max_mark_ops"], device=device)

    def epoch(w: int, sl: Optional[Slice] = None):
        uni = open_fleet()
        for batch in plans[w]:
            if sl is None:
                uni.apply_changes(batch)
            else:
                with sl.span("apply_changes"):
                    uni.apply_changes(batch)
        if cuda:
            torch.cuda.synchronize()
        return uni

    for w in range(len(plans)):
        epoch(w)
    order = list(range(len(plans)))
    rng.shuffle(order)
    if trace or cuda:
        warm_profiler(device)
    settle()
    setup_s = clock.since()

    kept: Dict[int, Any] = {}
    traced_epochs = launches = 0
    epoch_s: List[float] = []
    host_s: List[float] = []  # the ingest counters, read where the profiler is off: it slows the host
    sl = Slice(False, device)
    whole = Slice(cuda and not trace, device, host=False, cards=cell["chips"])
    trace_from = seconds / 3
    delivered = epochs = plain_ops = 0
    with whole:
        t_start = time.perf_counter()
        while True:
            w = order[epochs % len(order)]
            if trace and not traced_epochs and time.perf_counter() - t_start >= trace_from:
                sl = Slice(True, device, universe_mod, cards=cell["chips"])
                with sl:
                    unis = [epoch(order[(epochs + i) % len(order)], sl) for i in range(tr["trace_epochs"])]
                for i, uni in enumerate(unis):
                    delivered += ops[order[(epochs + i) % len(order)]]
                    kept[order[(epochs + i) % len(order)]] = uni
                traced_epochs = len(unis)
                epochs += len(unis)
                del unis
            else:
                t_epoch = time.perf_counter()
                uni = kept[w] = epoch(w)
                epoch_s.append(time.perf_counter() - t_epoch)
                host_s.append(uni.stats["host_seconds"])
                launches += uni.stats["launches"]
                delivered += ops[w]
                plain_ops += ops[w]
                epochs += 1
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
    peaks = core.card_memory_peaks(cell["chips"]) if cuda else [0]
    note("epoch seconds", epoch_s)
    note("epoch host seconds", host_s)

    checks = check(kept, workloads, cfg, rng)
    kept.clear()
    layers: Dict[str, Any] = {}
    if sl.profile is not None:
        layers = {"host_seconds": sum(host_s), "launches": launches, "merge_bytes": sl.spy.bytes_moved(),
                  "merges": len(sl.spy.calls), "plain_ops": plain_ops, "plain_s": sum(epoch_s)}
    busy = whole.profile["busy_s"] if whole.profile is not None else None
    if busy is not None:
        print(f"portbench: the device was busy {busy:.6f} s of the {window_s:.3f} s window", file=sys.stderr)
    return {"setup_s": setup_s, "window_s": window_s, "delivered_ops": delivered, "device_busy_s": busy,
            "attempted": epochs,
            "failed": 0, "checks": checks, "profile": sl.profile, "layers": layers,
            "device": device_entry(device, cell["chips"], peaks)}


def check(kept: Dict[int, Any], workloads: List[Dict[str, Any]], cfg: Dict[str, Any],
          rng: random.Random) -> List[core.Check]:
    """Texts of every replica and spans of sampled replicas, per kept
    universe, against the reference."""
    writers, replicas = cfg["writers"], cfg["replicas"]
    per_class = max(1, cfg["span_samples"] // writers)
    sample = sorted({0, replicas - 1} | {r for k in range(writers)
                                          for r in rng.sample(range(k, replicas, writers),
                                                              min(per_class, len(range(k, replicas, writers))))})
    text_bad = span_bad = compared = 0
    for w, uni in sorted(kept.items()):
        want = expected(workloads[w], writers)
        want_text = ["".join(s["text"] for s in sp) for sp in want]
        texts = uni.texts()
        text_bad += sum(t != want_text[r % writers] for r, t in enumerate(texts))
        span_bad += sum(uni.spans(r) != want[r % writers] for r in sample)
        compared += 1
    return [core.Check("text_mismatch_replicas", text_bad, 0),
            core.Check("span_mismatch_replicas", span_bad, 0),
            core.Check("workloads_unchecked", len(workloads) - compared, 0)]


def settle() -> None:
    """End of set-up: collect, then freeze what set-up made (the harness's
    workloads above all), so that the window's full collections scan the
    program's objects and not the harness's.  Without it a full collection
    took 0.09-0.16 s, 7-8 times in a 20 s window of ``fleet-c2k.merge``."""
    import gc

    gc.collect()
    gc.freeze()


def note(what: str, xs: List[float]) -> None:
    """A line on standard error about the window's steps, for the reader of a run."""
    import statistics

    if xs:
        q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
        print(f"portbench: {len(xs)} {what}: min {min(xs):.4f} q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f} "
              f"max {max(xs):.4f}; first {', '.join(f'{x:.4f}' for x in xs[:3])}", file=sys.stderr)


def device_entry(device: str, chips: int, peaks: List[int]) -> Dict[str, Any]:
    """The result's device: ``memory_peak_bytes`` is the fullest card's
    peak, ``memory_peak_bytes_per_card`` each card's."""
    import torch

    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    return {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": chips,
            "memory_peak_bytes": int(max(peaks)), "memory_peak_bytes_per_card": [int(p) for p in peaks]}
