"""The control and the planted faults: runs in which ``correct`` must come
out false.

    python3 -m portbench.control --workload <name> --seeds a,b,c --seconds <s> --plant <what>

``--plant control`` puts the reference's control (``reference/control.py``:
typed characters take no formatting) in the program's place: a universe
(``ControlUniverse``) or a stream (``ControlStream``) that replays every
replica's changes with it.  The other plants leave the port in place and
break its timed path underneath (``plant``): ``unchanged``, a merge that
returns its state unchanged; ``half``, a merge or a flush that leaves out
the second half of its replicas; ``altered``, one character of one merged
replica, or one served patch, changed where it is produced.  One chip
holds each cell, so no exchange between chips can be left out.  Prints
each run's checks; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import sys
from typing import Any, Dict, List, Sequence

import numpy as np

from portbench.reference.control import ControlDoc
from portbench.reference.digest import attr_numbers, digest
from portbench.reference.doc import op_from_wire

PLANTS = ("control", "unchanged", "half", "altered")


def _key(change: Dict[str, Any]) -> tuple:
    return (change["actor"], change["seq"])


class _Node:
    """A document state that replicas share until their batches differ."""

    __slots__ = ("doc", "children", "spans")

    def __init__(self, doc):
        self.doc, self.children, self.spans = doc, {}, None


class ControlUniverse:
    """The control in a universe's place: every replica's changes replayed
    by ``ControlDoc``.  Replicas that have taken the same batches share one
    document, so each distinct batch is replayed once."""

    def __init__(self, names: Sequence[str], cfg: Dict[str, Any]):
        self.replica_ids = list(names)
        self.index_of = {n: i for i, n in enumerate(self.replica_ids)}
        self.capacity = cfg["capacity"]
        self.stats = {"host_seconds": 0.0, "launches": 0, "patch_loop_seconds": 0.0,
                      "patch_assemble_seconds": 0.0}
        root = _Node(ControlDoc("control"))
        self._at: List[_Node] = [root] * len(self.replica_ids)

    def _take(self, r: int, changes: Sequence[Dict[str, Any]]) -> list:
        """Replica r takes a batch; returns (op position, patch) pairs."""
        if not changes:
            return []
        node, key = self._at[r], tuple(_key(c) for c in changes)
        if key not in node.children:
            d, pairs, pos = copy.deepcopy(node.doc), [], 0
            for c in changes:
                last = d.clock.get(c["actor"], 0)
                if c["seq"] != last + 1:
                    raise ValueError(f"control: expected seq {last + 1}, got {c['seq']}")
                d.clock[c["actor"]] = c["seq"]
                d.max_op = max(d.max_op, c["startOp"] + len(c["ops"]) - 1)
                pairs += [(pos + j, p) for j, op in enumerate(c["ops"]) for p in d._apply_op(op_from_wire(op))]
                pos += len(c["ops"])
            node.children[key] = (_Node(d), pairs)
        child, pairs = node.children[key]
        self._at[r] = child
        return pairs

    @property
    def clocks(self) -> List[Dict[str, int]]:
        return [n.doc.clock for n in self._at]

    def apply_changes(self, per_replica) -> None:
        for r, changes in enumerate(per_replica):
            self._take(r, changes)

    def apply_changes_with_patches(self, per_replica: Dict[str, List[Dict[str, Any]]], with_positions: bool = False):
        out = {}
        for name, changes in per_replica.items():
            pairs = self._take(self.index_of[name], changes)
            out[name] = list(pairs) if with_positions else [p for _, p in pairs]
        return out

    def _read(self, r: int) -> List[Dict[str, Any]]:
        node = self._at[r]
        if node.spans is None:  # read once a shared document: thousands of replicas share each
            node.spans = node.doc.get_text_with_formatting(["text"])
        return node.spans

    def spans(self, r: int) -> List[Dict[str, Any]]:
        return copy.deepcopy(self._read(r))

    def texts(self) -> List[str]:
        return ["".join(s["text"] for s in self._read(r)) for r in range(len(self.replica_ids))]


class ControlStream:
    """The control in the stream's place: each writer class replayed by
    ``ControlDoc``, its digest given to every replica of the class."""

    def __init__(self, wl: Dict[str, Any], cfg: Dict[str, Any], tr: Dict[str, Any], device: str):
        numbers = attr_numbers([wl["genesis"]] + [c for s in wl["rounds"][0] for c in s])
        self.n, self.texts, digests = cfg["population"], [], []
        for stream in wl["rounds"][0]:
            d = ControlDoc("control")
            for c in [wl["genesis"]] + stream:
                d.apply_change(c)
            spans = d.get_text_with_formatting(["text"])
            self.texts.append("".join(s["text"] for s in spans))
            digests.append(digest(spans, numbers))
        self.digests = np.array(digests, np.uint32)[np.arange(self.n) % len(digests)]

    def sweep(self):
        return self.digests.copy(), {}

    def readback(self, lo: int, hi: int):
        return [self.texts[r % len(self.texts)] for r in range(lo, hi)], self.digests[lo:hi].copy()


def _merge_fault(orig, what: str):
    def merged(states, text_ops, mark_ops, ranks, char_buf=None):
        out = orig(states, text_ops, mark_ops, ranks, char_buf)
        if what == "unchanged":
            return states
        if what == "half":
            keep = states.elem_ctr.shape[0] // 2
            return dataclasses.replace(out, **{f.name: _splice(getattr(out, f.name), getattr(states, f.name), keep)
                                               for f in dataclasses.fields(out)})
        chars = out.chars.clone()
        chars[0, 0] += 1
        return dataclasses.replace(out, chars=chars)
    return merged


def _splice(new, old, keep: int):
    """``new``'s first ``keep`` replicas, ``old``'s after them."""
    out = new.clone()
    out[keep:] = old[keep:]
    return out


def _flush_fault(orig, what: str):
    def flushed(self, per_replica, with_positions: bool = False):
        if what == "half":
            names = list(per_replica)
            out = orig(self, {n: per_replica[n] for n in names[: len(names) // 2]}, with_positions)
            return dict(out, **{n: [] for n in names[len(names) // 2:]})
        before = self.states
        out = orig(self, per_replica, with_positions)
        if what == "unchanged":
            self.states = before
            return out
        for pairs in out.values():
            for i, item in enumerate(pairs):
                pos, patch = item if with_positions else (None, item)
                if patch.get("action") == "insert":
                    patch = dict(patch, values=[v + "!" for v in patch["values"]])
                    pairs[i] = (pos, patch) if with_positions else patch
                    return out
        return out
    return flushed


@contextlib.contextmanager
def plant(what: str):
    """Break the port's timed path underneath (not ``control``)."""
    import peritext_tpu_torch.ops.universe as universe_mod
    import peritext_tpu_torch.parallel.stream as stream_mod
    from peritext_tpu_torch import TorchUniverse

    saved = [(universe_mod, "merge_step_full", universe_mod.merge_step_full),
             (stream_mod, "merge_step_full", stream_mod.merge_step_full),
             (TorchUniverse, "apply_changes_with_patches", TorchUniverse.apply_changes_with_patches)]
    try:
        for mod in (universe_mod, stream_mod):
            mod.merge_step_full = _merge_fault(mod.merge_step_full, what)
        TorchUniverse.apply_changes_with_patches = _flush_fault(TorchUniverse.apply_changes_with_patches, what)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def run_planted(cell: Dict[str, Any], seed: int, seconds: float, what: str, device: str) -> Dict[str, Any]:
    """One run of ``cell`` with ``what`` planted; returns the run's line."""
    from portbench.run import run_cell

    if what == "control":
        driver = cell["traffic"]["driver"]
        prog = ControlStream if driver == "sweep" else (lambda names, cfg: ControlUniverse(names, cfg))
        return run_cell(cell, seed, seconds, False, device, program=prog)["line"]
    with plant(what):
        return run_cell(cell, seed, seconds, False, device)["line"]


def main(argv=None) -> int:
    from portbench import core

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plant", choices=PLANTS, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run_planted(cell, seed, args.seconds, args.plant, args.device)
        print(json.dumps({"workload": args.workload, "plant": args.plant, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
