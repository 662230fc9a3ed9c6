"""Editor-facing bridge: live editing sessions over the CRDT.

The equivalent of the reference's ProseMirror bridge (bridge.ts:198-344)
with the editor toolkit abstracted away: an :class:`Editor` wires a document
replica to an outbound :class:`ChangeQueue` and a shared :class:`Publisher`,
translates editor transactions into input operations
(`applyProsemirrorTransactionToMicromergeDoc`, bridge.ts:417-539), and
surfaces remote changes as incremental patches through a callback
(`extendProsemirrorTransactionWithMicromergePatch`, bridge.ts:132-195 — here
the callback consumes the framework's Patch dicts directly).

Editor "steps" mirror ProseMirror's step vocabulary:
- ``("replace", from_pos, to_pos, text)``  -> delete + insert input ops
- ``("add_mark", from_pos, to_pos, mark_type, attrs)`` -> addMark
- ``("remove_mark", from_pos, to_pos, mark_type, attrs)`` -> removeMark

A copy of ``peritext_tpu/bridge.py`` over the port's publisher, queue,
sync and oracle.  An editor takes any document with the oracle ``Doc``'s
interface, and :class:`EditorNetwork` takes a ``doc_factory``:
``functools.partial(TorchDoc, device="cuda")`` edits on the card.
"""
from __future__ import annotations

import logging
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import ChangeQueue, Publisher, faults
from peritext_tpu_torch.runtime.sync import apply_available
from peritext_tpu_torch.schema import MARK_SPEC

Patch = Dict[str, Any]
Step = Tuple

_log = logging.getLogger(__name__)


def describe_op(op: Dict[str, Any]) -> str:
    """Human-readable one-liner for an internal op (the live op-log panel,
    reference describeOp, bridge.ts:90-104)."""
    action = op.get("action")
    op_id = op.get("opId", "?")
    if action == "set" and op.get("insert"):
        after = op.get("elemId") or "HEAD"
        return f"{op_id}: insert {op.get('value')!r} after {after}"
    if action == "del":
        return f"{op_id}: delete {op.get('elemId')}"
    if action in ("addMark", "removeMark"):
        def side(b):
            if b.get("type") in ("startOfText", "endOfText"):
                return b["type"]
            return f"{b['type']}({b.get('elemId')})"

        attrs = f" {op['attrs']}" if op.get("attrs") else ""
        return (
            f"{op_id}: {action} {op.get('markType')}{attrs} "
            f"from {side(op['start'])} to {side(op['end'])}"
        )
    if action in ("makeList", "makeMap"):
        return f"{op_id}: {action} {op.get('key')!r}"
    if action == "set":
        return f"{op_id}: set {op.get('key')!r} = {op.get('value')!r}"
    return f"{op_id}: {action}"


class Comment:
    """Side-table entry for a comment body (reference comment.ts:1-12).

    The document stores only mark ids; comment content lives beside it.
    """

    __slots__ = ("id", "actor", "content")

    def __init__(self, comment_id: str, actor: str, content: str):
        self.id = comment_id
        self.actor = actor
        self.content = content

    def __repr__(self) -> str:  # pragma: no cover
        return f"Comment({self.id!r}, {self.actor!r}, {self.content!r})"


def initialize_docs(
    docs: Sequence[Doc], initial_ops: Optional[Sequence[Dict[str, Any]]] = None
) -> Dict[str, Any]:
    """Bootstrap replicas from a single genesis change on docs[0].

    Reference bridge.ts:106-120: all replicas share one makeList change so
    root structure can never diverge.
    """
    ops: List[Dict[str, Any]] = [{"path": [], "action": "makeList", "key": "text"}]
    if initial_ops:
        ops.extend(initial_ops)
    change, _ = docs[0].change(ops)
    for doc in docs[1:]:
        doc.apply_change(change)
    return change


class Editor:
    """One user's live editing session (reference createEditor, bridge.ts:198).

    Local steps -> input ops -> a local change (applied immediately, local
    patches surfaced) -> enqueued for batched publish.  Remote changes arrive
    via the publisher subscription, pass the causal gate, and surface as
    patches through ``on_patch`` / ``on_remote_patch``.
    """

    def __init__(
        self,
        doc: Doc,
        publisher: Publisher,
        *,
        interval: float = 0.01,
        editable: bool = True,
        on_patch: Optional[Callable[[Patch], None]] = None,
        on_remote_patch: Optional[Callable[[Patch], None]] = None,
        lock: Optional["threading.RLock"] = None,
    ) -> None:
        self.doc = doc
        self.publisher = publisher
        self.editable = editable
        self.on_patch = on_patch
        self.on_remote_patch = on_remote_patch
        self.comments: Dict[str, Comment] = {}
        self.change_log: List[Dict[str, Any]] = []
        # Causally-unready remote changes waiting for their dependencies
        # (the delivery retry buffer; see _receive_changes).
        self._pending: List[Dict[str, Any]] = []
        # Doc mutation guard for interval-driven mode: the queue timer
        # delivers remote changes on its own thread while the caller may be
        # mid-change() (or mid-read) on the same docs.  Defaults to the
        # PUBLISHER's lock so every editor on one publisher shares it by
        # construction — delivery happens inside a flush, so per-editor
        # locks would deadlock (A's flush holding A wanting B while B's
        # flush holds B wanting A).  RLock: a local change can publish
        # inline through its own flush.
        self.lock = lock if lock is not None else publisher.lock
        self.queue = ChangeQueue(
            handle_flush=self._publish_changes,
            interval=interval,
            flush_lock=self.lock,
            # Stable chaos stream key: injected queue_flush faults stay
            # per-editor and reproducible regardless of construction order.
            name=doc.actor_id,
        )
        publisher.subscribe(doc.actor_id, self._receive_changes)

    # -- outbound ----------------------------------------------------------

    def _publish_changes(self, changes: List[Dict[str, Any]]) -> None:
        if changes:
            with self.lock:
                self.publisher.publish(self.doc.actor_id, changes)

    def apply_steps(self, steps: Sequence[Step]) -> List[Patch]:
        """Translate editor steps into one transactional change."""
        if not self.editable:
            raise PermissionError("editor is read-only")
        input_ops: List[Dict[str, Any]] = []
        for step in steps:
            input_ops.extend(self._step_to_ops(step))
        if not input_ops:
            return []
        with self.lock:
            change, patches = self.doc.change(input_ops)
            self.change_log.append(change)
            self.queue.enqueue(change)
        if self.on_patch:
            for patch in patches:
                self.on_patch(patch)
        return patches

    def _step_to_ops(self, step: Step) -> List[Dict[str, Any]]:
        kind = step[0]
        if kind == "replace":
            _, from_pos, to_pos, text = step
            ops: List[Dict[str, Any]] = []
            if to_pos > from_pos:
                ops.append(
                    {"path": ["text"], "action": "delete", "index": from_pos, "count": to_pos - from_pos}
                )
            if text:
                ops.append(
                    {"path": ["text"], "action": "insert", "index": from_pos, "values": list(text)}
                )
            return ops
        if kind in ("add_mark", "remove_mark"):
            _, from_pos, to_pos, mark_type, *rest = step
            attrs = rest[0] if rest else None
            if MARK_SPEC[mark_type].attr_keys and kind == "add_mark" and not attrs:
                raise ValueError(f"{mark_type} marks require attrs")
            op = {
                "path": ["text"],
                "action": "addMark" if kind == "add_mark" else "removeMark",
                "startIndex": from_pos,
                "endIndex": to_pos,
                "markType": mark_type,
            }
            if attrs:
                op["attrs"] = dict(attrs)
            return [op]
        raise ValueError(f"Unknown step kind: {kind}")

    # -- convenience commands (reference keymap, bridge.ts:35-68) -----------

    def insert(self, index: int, text: str) -> List[Patch]:
        return self.apply_steps([("replace", index, index, text)])

    def delete(self, index: int, count: int) -> List[Patch]:
        return self.apply_steps([("replace", index, index + count, "")])

    def toggle_mark(self, from_pos: int, to_pos: int, mark_type: str) -> List[Patch]:
        """Mod-B/Mod-I analog: add the boolean mark over the range."""
        return self.apply_steps([("add_mark", from_pos, to_pos, mark_type)])

    def add_comment(self, from_pos: int, to_pos: int, content: str) -> str:
        """Mod-E analog: comment with a fresh id; body goes to the side table."""
        comment_id = f"comment-{random.getrandbits(32):08x}"
        self.comments[comment_id] = Comment(comment_id, self.doc.actor_id, content)
        self.apply_steps([("add_mark", from_pos, to_pos, "comment", {"id": comment_id})])
        return comment_id

    def add_link(self, from_pos: int, to_pos: int, url: str) -> List[Patch]:
        """Mod-K analog."""
        return self.apply_steps([("add_mark", from_pos, to_pos, "link", {"url": url})])

    # -- inbound -----------------------------------------------------------

    def _receive_changes(self, changes: Sequence[Dict[str, Any]]) -> None:
        err: Optional[BaseException] = None
        with self.lock:
            # Gap-tolerant retry buffer (the reference applyChanges queue,
            # test/merge.ts:4-23, kept across deliveries): under chaotic
            # delivery a dropped or held-back change must not turn every
            # later publish into an exception inside the subscriber callback
            # — causally-unready changes wait here and apply as soon as
            # their dependencies arrive; duplicates drop idempotently.
            queued = self._pending + list(changes)
            try:
                patches, self._pending = apply_available(self.doc, queued)
            except Exception as exc:
                # A non-causal mid-batch failure: changes before the failing
                # one DID apply — their patches (tagged on the exception by
                # apply_available) must still reach the view callbacks, or a
                # patch-driven consumer permanently misses content the doc
                # now contains (redelivery dedupes them).  The unapplied
                # remainder stays buffered for the next delivery — EXCEPT a
                # permanently-failing (non-transient) poison change, which
                # sits at the buffer's head and would otherwise wedge the
                # whole inbound path forever; it is dropped and surfaced.
                patches = list(getattr(exc, "applied_patches", ()))
                remaining = list(getattr(exc, "unapplied", queued))
                if (
                    remaining
                    and hasattr(exc, "unapplied")
                    and not faults.retryable(exc)
                ):
                    poison = remaining.pop(0)
                    _log.warning(
                        "dropping permanently-failing change %s@%s from the "
                        "delivery buffer (%s: %s)",
                        poison.get("actor"),
                        poison.get("seq"),
                        type(exc).__name__,
                        exc,
                    )
                self._pending = remaining
                err = exc
        for patch in patches:
            if self.on_patch:
                self.on_patch(patch)
            if self.on_remote_patch:
                self.on_remote_patch(patch)
        if err is not None:
            raise err

    # -- views ---------------------------------------------------------------

    def spans(self) -> List[Dict[str, Any]]:
        with self.lock:
            return self.doc.get_text_with_formatting(["text"])

    def text(self) -> str:
        with self.lock:
            return "".join(self.doc.root.get("text", []))

    def sync(self) -> None:
        """Manual flush (the demo Sync button, index.ts:124-128)."""
        self.queue.flush()


# -- editor document model (the reference's node schema + doc builder) -------
#
# Reference schema.ts:10-20 declares ``doc > paragraph+ > text*`` and
# bridge.ts:394-414 (prosemirrorDocFromCRDT) builds the editor document from
# the CRDT spans; bridge.ts:355-362 maps editor positions to content
# positions.  The toolkit is abstracted, so the document is plain dicts with
# the same node shapes.

NODE_SCHEMA = {"doc": ("paragraph+",), "paragraph": ("text*",)}


def editor_doc_from_spans(spans: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Build the editor document tree from formatted spans.

    Paragraph breaks are newline characters in the text stream (the
    reference renders one paragraph because its demo content has none);
    each paragraph holds text nodes carrying their mark maps.  An empty
    document is a single empty paragraph (the reference's empty-doc special
    case, bridge.ts:402-407).
    """
    paragraphs: List[List[Dict[str, Any]]] = [[]]
    for span in spans:
        parts = span["text"].split("\n")
        for i, part in enumerate(parts):
            if i > 0:
                paragraphs.append([])
            if part:
                paragraphs[-1].append(
                    {"type": "text", "text": part, "marks": dict(span["marks"])}
                )
    return {
        "type": "doc",
        "content": [
            {"type": "paragraph", "content": para} for para in paragraphs
        ],
    }


def editor_doc_text(doc: Dict[str, Any]) -> str:
    """Inverse view: the document's plain text with paragraph breaks."""
    return "\n".join(
        "".join(node["text"] for node in para["content"])
        for para in doc["content"]
    )


def content_pos_from_editor_pos(pos: int, doc: Dict[str, Any]) -> int:
    """Editor position -> CRDT content index.

    The reference's contentPosFromProsemirrorPos (bridge.ts:355-362) is the
    single-paragraph special case (pos - 1, clamped — its demo content has
    no paragraph breaks).  The general mapping walks the node tree: each
    paragraph costs one opening and one closing token in editor-position
    space, while in content space paragraphs join with one newline
    character.  Out-of-range positions clamp to the document ends.
    """
    paragraphs = doc["content"]
    editor = 0  # editor position just before this paragraph's opening token
    content = 0  # content index of this paragraph's first character
    total = sum(
        sum(len(n["text"]) for n in p["content"]) for p in paragraphs
    ) + max(len(paragraphs) - 1, 0)
    for para in paragraphs:
        length = sum(len(n["text"]) for n in para["content"])
        start = editor + 1  # inside the paragraph, after its opening token
        if pos <= start + length:
            return min(content + max(pos - start, 0), total)
        editor += length + 2
        content += length + 1  # the separating newline
    return total


class RemoteChangeHighlighter:
    """Flash remote edits with temporary highlight marks.

    The reference essay demo (essay-demo.ts:47-75) hooks
    ``onRemotePatchApplied`` and overlays demo-only ``highlightChange``
    marks (schema.ts:99-121) on the *view* for a moment — the highlights
    never enter the CRDT.  This is that flow with the toolkit abstracted:
    remote patches record flash ranges, ``spans()`` renders the editor's
    spans with the highlight overlaid, and ``tick()`` expires flashes (the
    reference uses a timeout).
    """

    MARK = "highlightChange"

    def __init__(self, editor: Editor, duration_ticks: int = 1) -> None:
        # Note the overlay mark never enters the CRDT, so it is NOT
        # registered in the mark schema (registration is for marks that
        # produce mark *ops* — schema.register_mark_type covers that path).
        self.editor = editor
        self.duration = duration_ticks
        self.flashes: List[Dict[str, int]] = []
        # Map ranges through every patch (local and remote, the way PM maps
        # decorations through all transactions); record flashes on remote
        # ones.  Editor fires on_patch before on_remote_patch, so a remote
        # patch maps earlier flashes first, then records its own.
        self._prev_patch_hook = editor.on_patch
        self._prev_remote_hook = editor.on_remote_patch
        editor.on_patch = self._on_any_patch
        editor.on_remote_patch = self._on_remote_patch

    @staticmethod
    def _patch_range(patch: Patch) -> Optional[Tuple[int, int]]:
        action = patch.get("action")
        if action == "insert":
            return patch["index"], patch["index"] + len(patch["values"])
        if action in ("addMark", "removeMark"):
            return patch["startIndex"], patch["endIndex"]
        return None  # deletes leave nothing on screen to flash

    def _map_through(self, patch: Patch) -> None:
        """Remap recorded flash ranges through an incoming patch, the way
        the reference maps decorations through ProseMirror transactions —
        a later insert/delete in the same sync shifts earlier flashes."""
        action = patch.get("action")
        if action == "insert":
            at, n = patch["index"], len(patch["values"])
            for f in self.flashes:
                if f["start"] >= at:
                    f["start"] += n
                if f["end"] > at:
                    f["end"] += n
        elif action == "delete":
            at, n = patch["index"], patch.get("count", 1)
            for f in self.flashes:
                f["start"] -= min(n, max(0, f["start"] - at))
                f["end"] -= min(n, max(0, f["end"] - at))
            self.flashes = [f for f in self.flashes if f["end"] > f["start"]]

    def _on_any_patch(self, patch: Patch) -> None:
        if self._prev_patch_hook:
            self._prev_patch_hook(patch)
        self._map_through(patch)

    def _on_remote_patch(self, patch: Patch) -> None:
        if self._prev_remote_hook:
            self._prev_remote_hook(patch)
        rng = self._patch_range(patch)
        if rng and rng[1] > rng[0]:
            self.flashes.append({"start": rng[0], "end": rng[1], "ttl": self.duration})

    def tick(self) -> None:
        """Advance the flash clock; expired highlights disappear."""
        for flash in self.flashes:
            flash["ttl"] -= 1
        self.flashes = [f for f in self.flashes if f["ttl"] > 0]

    def spans(self) -> List[Dict[str, Any]]:
        """The editor's spans with active flashes overlaid (view-only)."""
        base = self.editor.spans()
        if not self.flashes:
            return base
        out: List[Dict[str, Any]] = []
        pos = 0
        for span in base:
            text = span["text"]
            # Split this span at every flash boundary inside it.
            cuts = {0, len(text)}
            for f in self.flashes:
                for edge in (f["start"], f["end"]):
                    if pos < edge < pos + len(text):
                        cuts.add(edge - pos)
            edges = sorted(cuts)
            for a, b in zip(edges, edges[1:]):
                lit = any(
                    f["start"] < pos + b and pos + a < f["end"] for f in self.flashes
                )
                marks = dict(span["marks"])
                if lit:
                    marks[self.MARK] = {"active": True}
                if out and out[-1]["marks"] == marks:
                    out[-1]["text"] += text[a:b]
                else:
                    out.append({"marks": marks, "text": text[a:b]})
            pos += len(text)
        return out


class EditorNetwork:
    """A set of editors on one shared publisher (the live-demo topology),
    their documents made by ``doc_factory`` (the oracle ``Doc`` unless
    given)."""

    def __init__(
        self,
        actor_ids: Sequence[str],
        initial_text: str = "",
        doc_factory: Callable[[str], Any] = Doc,
        **editor_kwargs,
    ):
        self.publisher: Publisher = Publisher()
        docs = [doc_factory(actor) for actor in actor_ids]
        initial_ops = (
            [{"path": ["text"], "action": "insert", "index": 0, "values": list(initial_text)}]
            if initial_text
            else None
        )
        self.genesis = initialize_docs(docs, initial_ops)
        # Editors default to the shared publisher lock, so the whole fleet
        # serializes on one RLock by construction.
        self.editors: Dict[str, Editor] = {
            doc.actor_id: Editor(doc, self.publisher, **editor_kwargs) for doc in docs
        }

    def __getitem__(self, actor_id: str) -> Editor:
        return self.editors[actor_id]

    def sync_all(self) -> None:
        for editor in self.editors.values():
            editor.sync()

    def start_all(self) -> None:
        """Switch every editor to interval-driven flushing — the reference's
        latency simulator (changeQueue.ts:17-19: the flush interval is the
        simulated network delay; index.ts runs with it before the demo drops
        to manual sync)."""
        for editor in self.editors.values():
            editor.queue.start()

    def stop_all(self) -> None:
        """Back to manual-sync mode (queue.drop, index.ts:119-121)."""
        for editor in self.editors.values():
            editor.queue.drop()

    def converged(self) -> bool:
        spans = [e.spans() for e in self.editors.values()]
        return all(s == spans[0] for s in spans[1:])
