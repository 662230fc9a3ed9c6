"""Sweeps of a replica population larger than the card through
``parallel.stream_merge_sorted``.

Set-up authors the configuration's genesis and one concurrent batch per
writer (``gen/wire.py``) from the traffic's structure seed, their content
drawn from the run's seed (``gen/relabel.py``), encodes them as the stream's callers do (the
port's ``ops.encode``; the genesis merged on one replica by the port) and
lays out the population: replica r holds the genesis and takes writer
r % writers' batch.  One warm sweep runs in set-up.  The window runs whole
sweeps back to back, digests only and no states read back, until
``seconds`` have passed.

After the window every replica's digest of every sweep is compared with
the reference's digest of its writer class, and the same entry reads back
the states of the first cohort and of the last two (the padded tail among
them), whose visible text is compared with the reference's.
"""
from __future__ import annotations

import copy
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np

from portbench import core
from portbench.drivers._trace import Slice, warm_profiler
from portbench.drivers.epochs import device_entry, note, settle
from portbench.gen.relabel import Relabel
from portbench.gen.wire import wire_fuzz_rounds
from portbench.reference.doc import Doc
from portbench.reference.digest import attr_numbers, digest


class PortStream:
    """The program: the population encoded for the stream, and its sweeps."""

    def __init__(self, wl: Dict[str, Any], cfg: Dict[str, Any], tr: Dict[str, Any], device: str):
        import torch

        from peritext_tpu_torch.ids import ActorRegistry
        from peritext_tpu_torch.ops import cuda_kernels
        from peritext_tpu_torch.ops import kernels as K
        from peritext_tpu_torch.ops.encode import (AttrRegistry, bucket_length, encode_changes, fuse_insert_runs,
                                                   pad_buffer, pad_rows, prepare_sorted_batch, split_rows)
        from peritext_tpu_torch.ops.state import make_empty_state, map_state, state_to_numpy

        self.device, self.cfg, self.tr = device, cfg, tr
        c, m, n = cfg["capacity"], cfg["max_mark_ops"], cfg["population"]
        actors, attrs = ActorRegistry(), AttrRegistry()
        g_rows, _, _ = encode_changes([wl["genesis"]], actors, attrs)
        text_obj = wl["genesis"]["ops"][0]["opId"]
        texts, marks = [], []
        for stream in wl["rounds"][0]:
            rows, _, _ = encode_changes(stream, actors, attrs, text_obj=text_obj)
            t, mk = split_rows(rows)
            texts.append(t)
            marks.append(mk)
        ranks = np.zeros(64, np.int32)
        ranks[: len(actors)] = actors.ranks()
        g_text, g_marks = split_rows(g_rows)
        fr, fb, _ = fuse_insert_runs(g_text)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        one = map_state(lambda x: x.unsqueeze(0), make_empty_state(c, m, device))
        base = cuda_kernels.merge_step_full(one, to(fr[None]), to(pad_rows(g_marks, max(g_marks.shape[0], 1))[None]),
                                            to(ranks), to(pad_buffer(fb, max(fb.shape[0], K.MAX_RUN_LEN))[None]))
        self.genesis = state_to_numpy(base)
        sp = prepare_sorted_batch(texts, max_run=K.MAX_RUN_LEN)
        mark_pad = bucket_length(max(max(mk.shape[0] for mk in marks), 1))
        g_marks = np.stack([pad_rows(mk, mark_pad) for mk in marks])
        pick = np.arange(n) % len(texts)
        self.n = n
        self.args = (
            {f: np.broadcast_to(a[:1], (n,) + a.shape[1:]) for f, a in self.genesis.items()},
            np.ascontiguousarray(sp["text"][pick]), np.ascontiguousarray(sp["rounds"][pick]), sp["num_rounds"],
            np.ascontiguousarray(g_marks[pick]), ranks, np.ascontiguousarray(sp["bufs"][pick]), sp["maxk"],
        )

    def _call(self, lo: int, hi: int, readback: bool):
        from peritext_tpu_torch.parallel.stream import stream_merge_sorted

        states, text, rounds, num_rounds, marks, ranks, bufs, maxk = self.args
        kw = {} if self.tr.get("depth") is None else {"depth": self.tr["depth"]}
        return stream_merge_sorted({f: a[lo:hi] for f, a in states.items()}, text[lo:hi], rounds[lo:hi],
                                   num_rounds, marks[lo:hi], ranks, bufs[lo:hi], maxk, cohort=self.tr["cohort"],
                                   readback_states=readback, device=self.device, **kw)

    def sweep(self):
        """One sweep of the whole population: (digests, stats)."""
        _, dg, stats = self._call(0, self.n, False)
        return dg, stats

    def readback(self, lo: int, hi: int):
        """Rows [lo, hi) swept with their states read back: (visible texts,
        digests)."""
        out, dg, _ = self._call(lo, hi, True)
        texts = []
        for r in range(hi - lo):
            n = int(out["length"][r])
            keep = ~out["deleted"][r, :n]
            texts.append("".join(map(chr, out["chars"][r, :n][keep].tolist())))
        return texts, dg


def reference(wl: Dict[str, Any], doc_cls=Doc) -> Dict[str, Any]:
    """Each writer class's text and digest, replayed by the reference; the
    attribute numbers follow the order the changes were handed over
    (genesis, then each writer's batch)."""
    numbers = attr_numbers([wl["genesis"]] + [c for stream in wl["rounds"][0] for c in stream])
    base = doc_cls("reference")
    base.apply_change(wl["genesis"])
    texts, digests = [], []
    for stream in wl["rounds"][0]:
        d = copy.deepcopy(base)
        for c in stream:
            d.apply_change(c)
        spans = d.get_text_with_formatting(["text"])
        texts.append("".join(s["text"] for s in spans))
        digests.append(digest(spans, numbers))
    return {"texts": texts, "digests": np.array(digests, np.uint32)}


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str, clock: core.Clock,
        program: Optional[Any] = None) -> Dict[str, Any]:
    import torch

    import peritext_tpu_torch.parallel.stream as stream_mod

    cfg, tr = cell["config"], cell["traffic"]
    rng = random.Random(seed)
    wl = Relabel(rng)(wire_fuzz_rounds(cfg["doc_len"], cfg["ops_per_round"], cfg["writers"], 1,
                                       seed=tr["structure_seed"]))
    prog = (program or PortStream)(wl, cfg, tr, device)
    cuda = device == "cuda"
    prog.sweep()
    if cuda:
        torch.cuda.synchronize()
    if trace:
        warm_profiler(device)
    settle()
    setup_s = clock.since()

    sweeps: List[np.ndarray] = []
    untraced = None
    sweep_s: List[float] = []
    sl = Slice(False, device)
    layers: Dict[str, Any] = {}
    t_start = time.perf_counter()
    while True:
        if trace and len(sweeps) == 1:
            sl = Slice(True, device, stream_mod, cards=cell["chips"])
            with sl:
                with sl.span("stream_merge_sorted"):
                    dg, stats = prog.sweep()
            layers = {"merge_bytes": sl.spy.bytes_moved(), "merges": len(sl.spy.calls)}
        else:
            t_sweep = time.perf_counter()
            dg, stats = prog.sweep()
            sweep_s.append(time.perf_counter() - t_sweep)
            if not sweeps:
                # Host stage times are read where the profiler is off.
                untraced = stats.get("timings")
        sweeps.append(dg)
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    peaks = core.card_memory_peaks(cell["chips"]) if cuda else [0]
    if layers:
        layers["timings"] = untraced
    note("sweep seconds", sweep_s)

    ref = reference(wl)
    cls = np.arange(prog.n) % cfg["writers"]
    want = ref["digests"][cls]
    digest_bad = int(sum((np.asarray(dg, np.uint32) != want).sum() for dg in sweeps))
    cohort = tr["cohort"]
    tail = prog.n // cohort * cohort
    text_bad = dg_bad = 0
    for lo, hi in ((0, min(cohort, prog.n)), (max(0, tail - cohort), prog.n)):
        texts, dg = prog.readback(lo, hi)
        text_bad += sum(t != ref["texts"][(lo + i) % cfg["writers"]] for i, t in enumerate(texts))
        dg_bad += int((np.asarray(dg, np.uint32) != want[lo:hi]).sum())
    del prog
    checks = [core.Check("digest_mismatch_replicas", digest_bad, 0),
              core.Check("readback_text_mismatch_rows", text_bad, 0),
              core.Check("readback_digest_mismatch_rows", dg_bad, 0)]
    return {"setup_s": setup_s, "window_s": window_s, "swept_replicas": len(sweeps) * int(cls.size),
            "attempted": len(sweeps), "failed": 0, "checks": checks, "profile": sl.profile, "layers": layers,
            "device": device_entry(device, cell["chips"], peaks)}
