"""Trace capture and replay — the framework's first-class debug artifact.

Two trace formats:

1. **Change-log traces** (the reference's ``traces/*.json`` failure dumps,
   written by test/fuzz.ts:16-20): ``{"queues": {actor: [Change, ...]}, ...}``.
   :func:`replay_change_log` reconstructs fresh replicas purely from the raw
   changes, which exercises the whole remote-ingestion path.

2. **Event traces** (the reference's playback.ts ``Trace``): a stream of
   input operations tagged with an editor id, interleaved with ``sync``
   events.  :func:`execute_trace` drives a set of replicas through the
   stream; :func:`concurrent_spec_to_trace` expands a concurrent-edit spec
   into keystroke-granular events (playback.ts:13-52 testToTrace /
   simulateTypingForInputOp).

A copy of ``peritext_tpu/replay.py`` over the port's oracle, log and sync.
Every entry point takes a ``doc_factory``: ``functools.partial(TorchDoc,
device="cuda")`` replays a trace on the card.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime.log import ChangeLog
from peritext_tpu_torch.runtime.sync import apply_changes


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def replay_change_log(
    queues: Dict[str, List[Dict[str, Any]]],
    doc_factory=Doc,
) -> Dict[str, Any]:
    """Rebuild one replica per actor from raw change queues.

    Every replica ingests *all* changes (its own included) through the causal
    retry loop, exactly as a replica recovering from a change log would.
    Returns per-actor docs and their materialized spans.
    """
    all_changes: List[Dict[str, Any]] = []
    for changes in queues.values():
        all_changes.extend(changes)

    docs: Dict[str, Any] = {}
    spans: Dict[str, Any] = {}
    for actor in queues:
        doc = doc_factory(actor)
        apply_changes(doc, list(all_changes))
        docs[actor] = doc
        spans[actor] = doc.get_text_with_formatting(["text"])
    return {"docs": docs, "spans": spans}


def assert_replay_converges(queues: Dict[str, List[Dict[str, Any]]], doc_factory=Doc) -> Any:
    """Replay a change log and assert all reconstructed replicas agree."""
    result = replay_change_log(queues, doc_factory)
    spans = list(result["spans"].values())
    clocks = [dict(doc.clock) for doc in result["docs"].values()]
    for other in spans[1:]:
        assert other == spans[0], f"replay diverged: {other} != {spans[0]}"
    for other in clocks[1:]:
        assert other == clocks[0], f"clock diverged: {other} != {clocks[0]}"
    return spans[0]


# ---------------------------------------------------------------------------
# Event traces (reference playback.ts)
# ---------------------------------------------------------------------------


def simulate_typing_for_input_op(editor_id: str, op: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand an insert into per-keystroke events (playback.ts:39-52)."""
    if op["action"] == "insert":
        return [
            {
                **op,
                "editorId": editor_id,
                "path": ["text"],
                "values": [value],
                "index": op["index"] + i,
            }
            for i, value in enumerate(op["values"])
        ]
    return [{**op, "editorId": editor_id, "path": ["text"]}]


def concurrent_spec_to_trace(
    initial_text: str,
    input_ops1: Sequence[Dict[str, Any]],
    input_ops2: Sequence[Dict[str, Any]],
    editors: Sequence[str] = ("alice", "bob"),
) -> List[Dict[str, Any]]:
    """Reference playback.ts:13-37 (testToTrace)."""
    trace: List[Dict[str, Any]] = [
        {"editorId": editors[0], "path": [], "action": "makeList", "key": "text"},
        {"action": "sync"},
        {
            "editorId": editors[0],
            "path": ["text"],
            "action": "insert",
            "index": 0,
            "values": list(initial_text),
        },
        {"action": "sync"},
    ]
    for op in input_ops1:
        trace.extend(simulate_typing_for_input_op(editors[0], op))
    for op in input_ops2:
        trace.extend(simulate_typing_for_input_op(editors[1], op))
    trace.append({"action": "sync"})
    return trace


class TraceSession:
    """Drives named replicas through an event trace with batched syncing.

    The playback engine (playback.ts:82-121) minus the DOM: each editor has a
    doc and an outbound queue; ``sync`` flushes every queue through a shared
    change log and anti-entropy delivery.
    """

    def __init__(self, editor_ids: Sequence[str], doc_factory=Doc) -> None:
        self.docs: Dict[str, Any] = {e: doc_factory(e) for e in editor_ids}
        self.log = ChangeLog()
        self.pending: Dict[str, List[Dict[str, Any]]] = {e: [] for e in editor_ids}
        self.patches: Dict[str, List[Dict[str, Any]]] = {e: [] for e in editor_ids}

    def apply_event(self, event: Dict[str, Any]) -> None:
        action = event["action"]
        if action == "sync":
            self.sync()
            return
        if action == "restart":  # playback.ts:102 — a demo-loop no-op here
            return
        editor_id = event["editorId"]
        doc = self.docs[editor_id]
        op = {k: v for k, v in event.items() if k not in ("editorId", "delay")}
        change, patches = doc.change([op])
        self.patches[editor_id].extend(patches)
        self.pending[editor_id].append(change)

    def sync(self) -> None:
        for editor_id, changes in self.pending.items():
            for change in changes:
                self.log.record(change)
            self.pending[editor_id] = []
        for editor_id, doc in self.docs.items():
            missing = self.log.missing_changes(self.log.clock(), doc.clock)
            self.patches[editor_id].extend(apply_changes(doc, missing))

    def run(self, trace: Sequence[Dict[str, Any]]) -> None:
        for event in trace:
            self.apply_event(event)

    def spans(self, editor_id: Optional[str] = None) -> Any:
        if editor_id is not None:
            return self.docs[editor_id].get_text_with_formatting(["text"])
        return {e: d.get_text_with_formatting(["text"]) for e, d in self.docs.items()}
