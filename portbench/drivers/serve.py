"""Served edits: open-loop submissions to a ``ServePlane`` over a universe.

The configuration's replicas hold ``replicas / writers`` documents, one
session a replica: replica ``d * writers + w`` is writer w's copy of
document d.  Each document replays one of a small pool of edit scripts
(``gen/fuzzmix.py``, actors of its own per script; shapes from the
traffic's structure seeds, content from the run's seed), its writers' ops
cut into changes of ``ops_per_change`` ops.  A change event goes to its
writer's session and, as the reference's Publisher fans it out, to the
co-writers' sessions: one submission each.

Events arrive open-loop: ``rate`` submissions a second on average, at
times drawn uniformly in the window from the seed (a Poisson process held
to its mean count, so every seed brings the same amount of work), each to
a document and a writer drawn from the seed.  Set-up loads the genesis,
starts the plane on its scheduler thread, serves ``warm_seconds`` of the
same traffic and waits until the plane is idle.  Each submission is timed from when it was due to when it
resolved; one that fails or never resolves counts as never resolving.

After the window the plane drains and closes; the sessions of documents
drawn from the seed, with the longest streams among them, are replayed by
the reference: each submission's patches and each replica's final spans
must equal the reference's.
"""
from __future__ import annotations

import copy
import math
import random
import time
from typing import Any, Dict, List, Optional

from portbench import core
from portbench.drivers._trace import Slice, warm_profiler
from portbench.drivers.epochs import device_entry, note, settle
from portbench.gen.fuzzmix import make_writer_rounds, split_rounds
from portbench.gen.relabel import Relabel
from portbench.reference.doc import Doc

STATS = ("patch_loop_seconds", "patch_assemble_seconds")
PLANE = ("flushes", "flushed_changes")


def scripts(cfg: Dict[str, Any], tr: Dict[str, Any], rng: random.Random) -> List[Dict[str, Any]]:
    """The pool of edit scripts: a genesis and each writer's changes, their
    shape from the traffic's structure seeds, their content from ``rng``."""
    out = []
    relabel = Relabel(rng)
    for p, s in enumerate(tr["structure_seeds"]):
        wl = relabel(make_writer_rounds(cfg["doc_len"], cfg["ops_per_round"], cfg["writers"], tr["script_rounds"],
                                        with_marks=True, seed=s, prefix=f"s{p}."))
        rounds = split_rounds(wl["rounds"], tr["ops_per_change"])
        out.append({"genesis": wl["genesis"],
                    "writers": [[c for rnd in rounds for c in rnd[w]] for w in range(cfg["writers"])]})
    return out


def arrivals(n_docs: int, writers: int, per_writer: int, events: int, span_s: float,
             rng: random.Random) -> List[tuple]:
    """``events`` change events at uniform times in [0, ``span_s``), each
    (time, document, writer, index of the writer's change)."""
    times = sorted(rng.random() * span_s for _ in range(events))
    nxt = [[0] * writers for _ in range(n_docs)]
    open_docs = list(range(n_docs))
    out = []
    for t in times:
        while True:
            d = rng.choice(open_docs)
            free = [w for w in range(writers) if nxt[d][w] < per_writer]
            if free:
                break
            open_docs.remove(d)
            if not open_docs:
                raise ValueError("the edit scripts ran out of changes: give the traffic more script rounds")
        w = rng.choice(free)
        out.append((t, d, w, nxt[d][w]))
        nxt[d][w] += 1
    return out


def drain(plane: Any, timeout: float) -> int:
    """Wait until the plane is idle: 0, or 1 if it did not get there."""
    try:
        plane.flush_and_wait(timeout=timeout)
    except TimeoutError:
        return 1
    return 0


class Served:
    """One submission as the harness saw it."""

    __slots__ = ("due", "session", "change", "sub", "error")

    def __init__(self, due: float, session: int, change: Dict[str, Any]):
        self.due, self.session, self.change, self.sub, self.error = due, session, change, None, None


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str, clock: core.Clock,
        program: Optional[Any] = None, rate: Optional[float] = None) -> Dict[str, Any]:
    from peritext_tpu_torch import TorchUniverse
    from peritext_tpu_torch.runtime.serve import ServePlane

    cfg, tr = cell["config"], cell["traffic"]
    writers, replicas = cfg["writers"], cfg["replicas"]
    n_docs = replicas // writers
    rate = tr["rate"] if rate is None else rate
    rng = random.Random(seed)
    pool = scripts(cfg, tr, rng)
    per_writer = len(pool[0]["writers"][0])
    names = [f"doc{d}.w{w}" for d in range(n_docs) for w in range(writers)]
    cuda = device == "cuda"
    if program is not None:
        uni = program(names, cfg)
    else:
        uni = TorchUniverse(names, capacity=cfg["capacity"], max_mark_ops=cfg["max_mark_ops"], device=device)
    uni.apply_changes([[pool[d % len(pool)]["genesis"]] for d in range(n_docs) for _ in range(writers)])
    plane = ServePlane(uni, batch_target=tr["batch_target"], deadline_ms=tr["deadline_ms"])
    sessions = [plane.session(f"s{r}", replica=names[r]) for r in range(replicas)]
    warm, span = tr["warm_seconds"], tr["warm_seconds"] + seconds
    events = arrivals(n_docs, writers, per_writer, round(rate / writers * span), span, rng)
    served: List[Served] = []
    lateness: List[float] = []
    backlog: List[int] = []  # submissions pending, once a second
    next_sample = [math.inf]

    def submit_until(t_base: float, end: float, i: int) -> int:
        while i < len(events) and events[i][0] < end:
            t, d, w, k = events[i]
            due = t_base + t
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            lateness.append(max(0.0, time.perf_counter() - due))
            change = pool[d % len(pool)]["writers"][w][k]
            for r in range(d * writers, (d + 1) * writers):
                s = Served(due, r, change)
                try:
                    s.sub = sessions[r].submit([change])
                except Exception as exc:  # a refused submission counts as failed
                    s.error = exc
                served.append(s)
            i += 1
            if time.perf_counter() >= next_sample[0]:
                next_sample[0] += 1.0
                backlog.append(sum(1 for s in served if s.sub is not None and not s.sub.done()))
        return i

    def counters() -> Dict[str, float]:
        return {**{k: uni.stats[k] for k in STATS}, **{k: plane.stats[k] for k in PLANE}}

    i = submit_until(time.perf_counter(), warm, 0)
    # The first flushes of a process are slow; what they leave pending is
    # served before the window opens, so the window starts from an idle plane.
    stuck = drain(plane, tr["drain_timeout_s"])
    first = len(served)
    lateness.clear()
    if trace:
        warm_profiler(device)
    settle()
    setup_s = clock.since()
    t_base = time.perf_counter() - warm  # the window's events are due from now on
    next_sample[0] = time.perf_counter() + 1.0

    c0 = counters()
    traced = {k: 0.0 for k in STATS + PLANE}
    sl = Slice(False, device)
    trace_from, trace_len = warm + seconds / 3, min(tr["trace_seconds"], seconds / 3)
    if trace:
        i = submit_until(t_base, trace_from, i)
        sl = Slice(True, device, cards=cell["chips"])
        a = counters()
        with sl:
            with sl.span("submit"):
                i = submit_until(t_base, trace_from + trace_len, i)
        b = counters()
        traced = {k: b[k] - a[k] for k in traced}
    i = submit_until(t_base, span, i)
    window_s = time.perf_counter() - (t_base + warm)
    stuck += drain(plane, tr["drain_timeout_s"])  # what is left pending is rejected by close(): failed
    c1 = counters()
    plane.close()
    peaks = core.card_memory_peaks(cell["chips"]) if cuda else [0]

    note("backlog samples (pending submissions, once a second)", backlog)
    note("generator lateness seconds", lateness)
    timed = served[first:]
    lat, failed = [], 0
    for s in timed:
        if s.error is None and s.sub is not None and s.sub.done() and s.sub._error is None:
            lat.append(s.sub.t_done - s.due)
        else:
            failed += 1
            lat.append(math.inf)
    layers = {k: c1[k] - c0[k] - traced[k] for k in traced} if sl.profile is not None else {}
    checks = check(served, pool, uni, cfg, tr, rng) + [core.Check("drains_timed_out", stuck, 0)]
    return {"setup_s": setup_s, "window_s": window_s, "latencies_s": lat, "attempted": len(timed),
            "failed": failed, "checks": checks, "profile": sl.profile, "layers": layers,
            "lateness_s": lateness, "backlog": backlog, "device": device_entry(device, cell["chips"], peaks)}


def check(served: List[Served], pool: List[Dict[str, Any]], uni: Any, cfg: Dict[str, Any], tr: Dict[str, Any],
          rng: random.Random) -> List[core.Check]:
    """Replay sampled documents' sessions in the reference: every
    submission's patches and every replica's final spans."""
    writers = cfg["writers"]
    n_docs = cfg["replicas"] // writers
    by_session: Dict[int, List[Served]] = {}
    for s in served:
        by_session.setdefault(s.session, []).append(s)
    longest = sorted(range(n_docs), key=lambda d: -len(by_session.get(d * writers, [])))[:2]
    docs = sorted(set(rng.sample(range(n_docs), min(n_docs, tr["check_docs"]))) | set(longest))
    bases = {}
    patch_bad = span_bad = 0
    for d in docs:
        p = d % len(pool)
        if p not in bases:
            bases[p] = Doc("reference")
            bases[p].apply_change(pool[p]["genesis"])
        for r in range(d * writers, (d + 1) * writers):
            ref = copy.deepcopy(bases[p])
            for s in by_session.get(r, []):
                want = ref.apply_change(s.change)
                got = None
                if s.sub is not None and s.sub.done() and s.sub._error is None:
                    got = s.sub.result()
                patch_bad += got != want
            span_bad += uni.spans(r) != ref.get_text_with_formatting(["text"])
    return [core.Check("patch_mismatch_submissions", patch_bad, 0),
            core.Check("span_mismatch_replicas", span_bad, 0)]
