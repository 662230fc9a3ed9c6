"""Exact-semantics rich-text CRDT document (scalar reference engine).

Re-expresses the semantics of the reference implementation:

- list CRDT (RGA with tombstones):  reference src/micromerge.ts
- rich-text mark engine:            reference src/peritext.ts

This is *not* a port of the reference's class structure; it is a from-scratch
Python engine that reproduces the observable semantics: the
``InputOperation`` -> ``Change``/``Patch`` contract, the wire format, and the
flattened ``FormatSpanWithText`` output.  Every behavior is cited back to the
reference file:line it must agree with, because this module is the oracle the
device kernels are differential-tested against.

Representation choices (deliberately different from the reference):

- Operation ids stay ``"ctr@actor"`` strings at this layer (wire compatible),
  but mark-operation *sets* are sets of op-id strings plus a doc-level op
  table (``self.mark_ops``), instead of sets of object references.  Set
  membership by op id is equivalent: the reference only ever inserts each
  freshly-created op object once per set (peritext.ts:238-244).
- ``ROOT`` is represented as ``None`` (the reference uses a JS Symbol which
  serializes to an *absent* ``obj`` key in trace JSON; we mirror that in
  :func:`op_to_wire` / :func:`op_from_wire`).
- ``opsToMarks`` iterates ops in ascending (counter, actor) order, so
  last-writer-wins falls out of overwrite order. The reference iterates in
  set-insertion order with explicit op-id comparisons (peritext.ts:294-326);
  both compute the same map for ``allowMultiple == false`` marks.  For
  ``allowMultiple`` marks (comments) the reference's result is
  insertion-order dependent when adds and removes of the same comment id
  race; we resolve each comment id by op-id LWW, which is deterministic and
  agrees with the reference on every behavior its tests/fuzzer exercise
  (the reference fuzzer never issues comment removals — its
  ``removeMarkChange`` builds an ``addMark`` op, fuzz.ts:78-84).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from peritext_tpu_torch.ids import compare_op_ids, make_op_id, op_sort_key
from peritext_tpu_torch.schema import MARK_SPEC

# Sentinels.  ROOT is the document root object id; HEAD is the "insert at
# start of list" reference element (micromerge.ts:17-19).  Both serialize as
# an absent key on the wire.
ROOT = None
HEAD = None

# Patches hardcode the text path (reference micromerge.ts:643,592 emit
# ``path: ["text"]`` for every list patch regardless of the actual object).
CONTENT_KEY = "text"

Json = Any
MarkMap = Dict[str, Any]
Patch = Dict[str, Any]
Change = Dict[str, Any]
Operation = Dict[str, Any]


class ListItem:
    """Metadata for one RGA element (reference ListItemMetadata, micromerge.ts:237-253).

    ``mark_ops_before`` / ``mark_ops_after`` are ``None`` (no boundary here —
    formatting inherits from the left) or a set of mark-op ids (an explicit
    boundary; may be empty, which clears formatting).  The None/empty
    distinction is load-bearing: see peritext.ts:183 (``||`` on undefined)
    and peritext.ts:372-376.
    """

    __slots__ = ("elem_id", "value_id", "deleted", "mark_ops_before", "mark_ops_after")

    def __init__(self, elem_id: str, value_id: str, deleted: bool = False):
        self.elem_id = elem_id
        self.value_id = value_id
        self.deleted = deleted
        self.mark_ops_before: Optional[Set[str]] = None
        self.mark_ops_after: Optional[Set[str]] = None

    def get_side(self, side: str) -> Optional[Set[str]]:
        return self.mark_ops_before if side == "before" else self.mark_ops_after

    def set_side(self, side: str, ops: Set[str]) -> None:
        if side == "before":
            self.mark_ops_before = ops
        else:
            self.mark_ops_after = ops


class MapMeta:
    """CRDT metadata for a map object (reference MapMetadata, micromerge.ts:217-234)."""

    __slots__ = ("key_ops", "children")

    def __init__(self) -> None:
        self.key_ops: Dict[str, str] = {}  # key -> opId that last set it
        self.children: Dict[str, Optional[str]] = {}  # key -> child object id


# ---------------------------------------------------------------------------
# Mark resolution (reference peritext.ts:294-330)
# ---------------------------------------------------------------------------


def ops_to_marks(op_ids: Set[str], mark_ops: Dict[str, Operation]) -> MarkMap:
    """Resolve a set of mark ops into an effective mark map.

    Reference peritext.ts:294-326 (opsToMarks).  Non-``allowMultiple`` marks
    resolve last-writer-wins by op id; ``allowMultiple`` marks (comments)
    keep an id-sorted list of attrs.  Iterating in ascending op-id order and
    overwriting makes LWW fall out naturally and is order-deterministic.
    """
    mark_map: MarkMap = {}
    comment_state: Dict[str, Dict[str, Tuple[bool, Dict[str, Any]]]] = {}
    for op_id in sorted(op_ids, key=op_sort_key):
        op = mark_ops[op_id]
        mark_type = op["markType"]
        if not MARK_SPEC[mark_type].allow_multiple:
            if op["action"] == "addMark":
                attrs = op.get("attrs")
                mark_map[mark_type] = dict(attrs) if attrs else {"active": True}
            else:
                mark_map.pop(mark_type, None)
        else:
            per_id = comment_state.setdefault(mark_type, {})
            attrs = dict(op.get("attrs") or {})
            per_id[attrs.get("id")] = (op["action"] == "addMark", attrs)
    for mark_type, per_id in comment_state.items():
        values = [attrs for (_id, (active, attrs)) in sorted(per_id.items(), key=lambda kv: kv[0]) if active]
        if values:
            mark_map[mark_type] = values
        elif mark_type in mark_map:  # pragma: no cover - defensive
            del mark_map[mark_type]
    return mark_map


def find_closest_mark_ops_to_left(
    metadata: List[ListItem], index: int, side: str
) -> Set[str]:
    """Nearest explicit boundary set at or left of (index, side), exclusive.

    Reference peritext.ts:405-436 (findClosestMarkOpsToLeft).  Returns a
    fresh set (never a shared reference).
    """
    if side == "after" and metadata[index].mark_ops_before is not None:
        return set(metadata[index].mark_ops_before)
    for i in range(index - 1, -1, -1):
        after = metadata[i].mark_ops_after
        if after is not None:
            return set(after)
        before = metadata[i].mark_ops_before
        if before is not None:
            return set(before)
    return set()


def get_active_marks_at_index(
    metadata: List[ListItem], index: int, mark_ops: Dict[str, Operation]
) -> MarkMap:
    """Marks inherited by an insertion at metadata position ``index``.

    Reference peritext.ts:328-330.
    """
    return ops_to_marks(find_closest_mark_ops_to_left(metadata, index, "before"), mark_ops)


# ---------------------------------------------------------------------------
# Flattening (reference peritext.ts:337-395, 438-455)
# ---------------------------------------------------------------------------


def add_characters_to_spans(
    characters: List[str], marks: MarkMap, spans: List[Dict[str, Any]]
) -> None:
    """Append chars to the span list, coalescing equal-mark runs.

    Reference peritext.ts:438-455 (addCharactersToSpans).
    """
    if not characters:
        return
    if spans and spans[-1]["marks"] == marks:
        spans[-1]["text"] += "".join(characters)
    else:
        spans.append({"marks": marks, "text": "".join(characters)})


def get_text_with_formatting(
    text: Sequence[str], metadata: List[ListItem], mark_ops: Dict[str, Operation]
) -> List[Dict[str, Any]]:
    """Batch codepath: materialize the document as formatted spans.

    Reference peritext.ts:337-395 (getTextWithFormatting).  Marks inherit
    left-to-right until the next explicit boundary; the "before" set of a
    character takes precedence over the previous character's "after" set.
    """
    spans: List[Dict[str, Any]] = []
    characters: List[str] = []
    marks: MarkMap = {}
    visible = 0
    for index, item in enumerate(metadata):
        new_marks: Optional[MarkMap] = None
        if item.mark_ops_before is not None:
            new_marks = ops_to_marks(item.mark_ops_before, mark_ops)
        elif index > 0 and metadata[index - 1].mark_ops_after is not None:
            new_marks = ops_to_marks(metadata[index - 1].mark_ops_after, mark_ops)
        if new_marks is not None:
            add_characters_to_spans(characters, marks, spans)
            characters = []
            marks = new_marks
        if not item.deleted:
            characters.append(text[visible])
            visible += 1
    add_characters_to_spans(characters, marks, spans)
    return spans


# ---------------------------------------------------------------------------
# Index <-> element id resolution (reference micromerge.ts:731-805)
# ---------------------------------------------------------------------------


def get_list_element_id(
    metadata: List[ListItem], index: int, look_after_tombstones: bool = False
) -> str:
    """Element id of the ``index``-th visible element.

    Reference micromerge.ts:762-805 (getListElementId).  With
    ``look_after_tombstones``, peeks past trailing tombstones that carry a
    ``markOpsAfter`` boundary so that new characters land *after* a span-end
    anchored on a tombstone (the non-growing-mark rule; motivating test:
    "handles growth behavior for spans where the boundary is a tombstone",
    reference test/micromerge.ts:520-566).
    """
    visible = -1
    for meta_index, item in enumerate(metadata):
        if item.deleted:
            continue
        visible += 1
        if visible != index:
            continue
        if look_after_tombstones:
            elem_index = meta_index
            peek = meta_index + 1
            latest_after_tombstone: Optional[int] = None
            while peek < len(metadata) and metadata[peek].deleted:
                if metadata[peek].mark_ops_after is not None:
                    latest_after_tombstone = peek
                peek += 1
            if latest_after_tombstone:  # faithful: falsy 0 not taken (micromerge.ts:794)
                elem_index = latest_after_tombstone
            return metadata[elem_index].elem_id
        return item.elem_id
    raise IndexError(f"List index out of bounds: {index}")


# ---------------------------------------------------------------------------
# Mark op generation + application (reference peritext.ts:154-281, 458-501)
# ---------------------------------------------------------------------------


def change_mark(
    input_op: Dict[str, Any],
    obj_id: Optional[str],
    metadata: List[ListItem],
    obj: List[str],
) -> Operation:
    """Translate an addMark/removeMark input op into an anchored internal op.

    Reference peritext.ts:458-501 (changeMark).  Start never grows
    (``startGrows`` hardcoded false, peritext.ts:466); the end grows iff the
    mark type is ``inclusive`` (peritext.ts:467).  A growing end anchors on
    the *next* character's "before" slot (or endOfText); a non-growing end
    anchors on the last covered character's "after" slot.
    """
    start_index = input_op["startIndex"]
    end_index = input_op["endIndex"]
    end_grows = MARK_SPEC[input_op["markType"]].inclusive

    start = {"type": "before", "elemId": get_list_element_id(metadata, start_index)}

    if end_grows and end_index >= len(obj):
        end: Dict[str, Any] = {"type": "endOfText"}
    elif end_grows:
        end = {"type": "before", "elemId": get_list_element_id(metadata, end_index)}
    else:
        end = {"type": "after", "elemId": get_list_element_id(metadata, end_index - 1)}

    op: Operation = {
        "action": input_op["action"],
        "obj": obj_id,
        "start": start,
        "end": end,
        "markType": input_op["markType"],
    }
    if input_op.get("attrs"):
        op["attrs"] = dict(input_op["attrs"])
    return op


def _boundary_matches(boundary: Dict[str, Any], side: str, elem_id: str) -> bool:
    return boundary["type"] == side and boundary.get("elemId") == elem_id


def apply_add_remove_mark(
    op: Operation,
    text: List[str],
    metadata: List[ListItem],
    mark_ops: Dict[str, Operation],
) -> List[Patch]:
    """The mark merge kernel: write the op into boundary sets, emit patches.

    Reference peritext.ts:154-223 (applyAddRemoveMark) plus its helpers
    calculateOpsForPosition (225-249), beginPartialPatch (251-267) and
    finishPartialPatch (269-281).  Walks the 2n boundary slots left-to-right
    with a BEFORE/DURING/AFTER state machine, carrying the inherited op set.

    Key subtlety preserved from the reference: the carried ``current_ops``
    is *not* updated with the op being applied — writes store
    ``current ∪ {op}`` (or ``∖`` at the end slot) but the carry keeps the old
    value (peritext.ts:181-186), so the end-slot write materializes the *old*
    inherited set.
    """
    patches: List[Patch] = []
    visible_index = 0
    current_ops: Set[str] = set()
    op_state = "BEFORE"
    partial_patch: Optional[Dict[str, Any]] = None
    obj_length = len(text)
    op_id = op["opId"]

    def finish_partial(partial: Dict[str, Any], end_index: int) -> None:
        # Reference finishPartialPatch: drop zero-width patches and patches
        # entirely beyond the visible text (peritext.ts:269-281).
        if end_index > partial["startIndex"] and partial["startIndex"] < obj_length:
            patch = dict(partial)
            patch["endIndex"] = min(end_index, obj_length)
            patches.append(patch)

    def begin_partial(visible: int) -> Dict[str, Any]:
        partial = {
            "action": op["action"],
            "markType": op["markType"],
            "path": ["text"],
            "startIndex": visible,
        }
        if op["action"] == "addMark" and op["markType"] in ("link", "comment"):
            partial["attrs"] = dict(op["attrs"])
        return partial

    done = False
    for item in metadata:
        for side in ("before", "after"):
            stored = item.get_side(side)
            if stored is not None:
                current_ops = stored

            # calculateOpsForPosition (peritext.ts:225-249)
            changed: Optional[Set[str]] = None
            if _boundary_matches(op["start"], side, item.elem_id):
                op_state = "DURING"
                changed = current_ops | {op_id}
            elif _boundary_matches(op["end"], side, item.elem_id):
                op_state = "AFTER"
                changed = current_ops - {op_id}
            elif op_state == "DURING" and stored is not None:
                changed = current_ops | {op_id}

            if changed is not None:
                item.set_side(side, changed)

            if side == "after" and not item.deleted:
                visible_index += 1

            if changed is not None:
                if partial_patch is not None:
                    finish_partial(partial_patch, visible_index)
                    partial_patch = None
                if op_state == "DURING" and ops_to_marks(current_ops, mark_ops) != ops_to_marks(
                    changed, mark_ops
                ):
                    partial_patch = begin_partial(visible_index)

            if op_state == "AFTER":
                done = True
                break
        if done:
            break

    if partial_patch is not None:
        finish_partial(partial_patch, visible_index)

    return patches


# ---------------------------------------------------------------------------
# Wire format (reference micromerge.ts:60-71 and traces/*.json)
# ---------------------------------------------------------------------------


def op_to_wire(op: Operation) -> Dict[str, Any]:
    """JSON-representation of an internal op, matching the reference traces.

    ``ROOT`` obj and ``HEAD`` elemId are JS Symbols in the reference and
    vanish under JSON.stringify, so we omit those keys.
    """
    return {k: v for k, v in op.items() if not (k in ("obj", "elemId") and v is None)}


def op_from_wire(op: Dict[str, Any]) -> Operation:
    op = dict(op)
    op.setdefault("obj", None)
    if op.get("insert") and "elemId" not in op:
        op["elemId"] = None
    return op


# ---------------------------------------------------------------------------
# The object graph (reference micromerge.ts:534-608's per-object dispatch)
# ---------------------------------------------------------------------------


class ObjectStore:
    """The CRDT object graph of one replica: objects + metadata keyed by
    creating op id, plus the doc-global mark-op table.

    Extracted from :class:`Doc` so the device engine can host the *same*
    semantics for its structural plane: every object except the
    device-resident text list (maps, nested lists, comment tables) applies
    ops through this store, exactly as the reference dispatches per object
    (micromerge.ts:534-608).  ``device_objects`` registers object ids whose
    list state lives elsewhere (the device DocState); routing an op for one of
    those here is a caller bug and raises.
    """

    def __init__(self) -> None:
        self.objects: Dict[Optional[str], Any] = {ROOT: {}}
        self.metadata: Dict[Optional[str], Any] = {ROOT: MapMeta()}
        self.mark_ops: Dict[str, Operation] = {}
        self.device_objects: Set[str] = set()

    # -- path resolution (reference micromerge.ts:446-463) ------------------

    def get_object_id_for_path(self, path: Sequence[str]) -> Optional[str]:
        object_id: Optional[str] = ROOT
        for path_elem in path:
            meta = self.metadata.get(object_id)
            if meta is None:
                raise KeyError(f"No object at path {path!r}")
            if isinstance(meta, list):
                raise KeyError(f"Object {path_elem} in path {path!r} is a list")
            child = meta.children.get(path_elem)
            if child is None:
                raise KeyError(f"Child not found: {path_elem}")
            object_id = child
        return object_id

    # -- op dispatch (reference micromerge.ts:534-608) ----------------------

    def apply_op(self, op: Operation) -> List[Patch]:
        obj_id = op.get("obj", None)
        if obj_id is not None and obj_id in self.device_objects:
            raise ValueError(
                f"op {op.get('opId')!r} targets device-resident object "
                f"{obj_id!r}; its list ops must route through the device "
                f"engine, not the host store"
            )
        metadata = self.metadata.get(obj_id, None)
        obj = self.objects.get(obj_id, None)
        if metadata is None or obj is None:
            raise KeyError(f"Object does not exist: {obj_id}")

        action = op["action"]
        if action == "makeMap":
            self.objects[op["opId"]] = {}
            self.metadata[op["opId"]] = MapMeta()
        elif action == "makeList":
            self.objects[op["opId"]] = []
            self.metadata[op["opId"]] = []

        if isinstance(metadata, list):
            if action == "set":
                if "elemId" not in op:
                    raise ValueError("Must specify elemId when calling set on an array")
                return self.apply_list_insert(op)
            if action == "del":
                if "elemId" not in op:
                    raise ValueError("Must specify elemId when calling del on an array")
                return self.apply_list_update(op)
            if action in ("addMark", "removeMark"):
                self.mark_ops[op["opId"]] = op
                return apply_add_remove_mark(op, obj, metadata, self.mark_ops)
            raise NotImplementedError(f"{action} on a list")

        # Map object: last-writer-wins by op id (micromerge.ts:578-602).
        key = op.get("key")
        if key is None:
            raise ValueError("Must specify key when calling set or del on a map")
        key_meta = metadata.key_ops.get(key)
        if key_meta is None or compare_op_ids(key_meta, op["opId"]) == -1:
            metadata.key_ops[key] = op["opId"]
            if action == "del":
                obj.pop(key, None)
            elif action == "makeList":
                obj[key] = self.objects[op["opId"]]
                metadata.children[key] = op["opId"]
                # Reference emits a makeList patch with hardcoded path
                # (micromerge.ts:592).
                return [{**op_to_wire(op), "path": ["text"]}]
            elif action == "makeMap":
                # Reference has a known bug here: no patch emitted
                # (micromerge.ts:594).  We are faithful to it.
                obj[key] = self.objects[op["opId"]]
                metadata.children[key] = op["opId"]
            elif action == "set":
                obj[key] = op["value"]
            else:
                raise NotImplementedError(action)
        return []

    # -- RGA insert (reference micromerge.ts:614-672) -----------------------

    def apply_list_insert(self, op: Operation) -> List[Patch]:
        metadata: List[ListItem] = self.metadata[op["obj"]]
        obj: List[str] = self.objects[op["obj"]]

        # Find the reference element; insert after it.
        if op.get("elemId") is None:
            index, visible = -1, 0
        else:
            index, visible = self.find_list_element(op["obj"], op["elemId"])
        if index >= 0 and not metadata[index].deleted:
            visible += 1
        index += 1

        # Convergence rule for concurrent same-position inserts: skip right
        # past any elements with elemId greater than this op's id
        # (micromerge.ts:630-635).
        op_id = op["opId"]
        while index < len(metadata) and compare_op_ids(op_id, metadata[index].elem_id) < 0:
            if not metadata[index].deleted:
                visible += 1
            index += 1

        metadata.insert(index, ListItem(elem_id=op_id, value_id=op_id))
        value = op["value"]
        if not isinstance(value, str):
            raise TypeError("Expected value inserted into text to be a string")
        obj.insert(visible, value)

        marks = get_active_marks_at_index(metadata, index, self.mark_ops)
        return [
            {
                "path": [CONTENT_KEY],
                "action": "insert",
                "index": visible,
                "values": [value],
                "marks": marks,
            }
        ]

    # -- delete (reference micromerge.ts:677-724) ---------------------------

    def apply_list_update(self, op: Operation) -> List[Patch]:
        index, visible = self.find_list_element(op["obj"], op["elemId"])
        metadata: List[ListItem] = self.metadata[op["obj"]]
        item = metadata[index]
        if op["action"] == "del":
            if not item.deleted:
                item.deleted = True
                self.objects[op["obj"]].pop(visible)
                return [
                    {
                        "path": [CONTENT_KEY],
                        "action": "delete",
                        "index": visible,
                        "count": 1,
                    }
                ]
        return []

    def find_list_element(
        self, object_id: Optional[str], elem_id: str
    ) -> Tuple[int, int]:
        """Reference micromerge.ts:731-755 (findListElement)."""
        meta = self.metadata.get(object_id)
        if not isinstance(meta, list):
            raise TypeError("Expected array metadata for find_list_element")
        visible = 0
        for index, item in enumerate(meta):
            if item.elem_id == elem_id:
                return index, visible
            if not item.deleted:
                visible += 1
        raise KeyError(f"List element not found: {elem_id}")

    def is_linked(self, obj_id: Optional[str], key: str) -> bool:
        """True while ``key`` in map ``obj_id`` still holds its bound child
        object.  ``children`` entries outlive del/LWW-overwrite (the
        reference never prunes them, micromerge.ts:592-600), so every view
        that materializes a child through ``children`` must gate on the
        *live* map value — this is that single shared predicate (used by
        the snapshot serializer below and TpuDoc.root)."""
        meta = self.metadata.get(obj_id)
        if not isinstance(meta, MapMeta):
            return False
        cid = meta.children.get(key)
        if cid is None:
            return False
        obj = self.objects.get(obj_id)
        return (
            isinstance(obj, dict)
            and key in obj
            and obj[key] is self.objects.get(cid)
        )

    # -- snapshot serialization (runtime/checkpoint.py sidecars) ------------

    def to_json(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of the object graph.

        ROOT (None) keys map to ""; child-object values inside maps are
        re-linked from ``children`` on load rather than serialized inline.
        """
        objects: Dict[str, Any] = {}
        for obj_id, meta in self.metadata.items():
            key = "" if obj_id is None else obj_id
            if isinstance(meta, list):
                objects[key] = {
                    "type": "list",
                    "values": list(self.objects[obj_id]),
                    "items": [
                        [
                            it.elem_id,
                            it.value_id,
                            it.deleted,
                            sorted(it.mark_ops_before)
                            if it.mark_ops_before is not None
                            else None,
                            sorted(it.mark_ops_after)
                            if it.mark_ops_after is not None
                            else None,
                        ]
                        for it in meta
                    ],
                }
            else:
                obj = self.objects[obj_id]
                # ``children`` entries outlive del/LWW-overwrite (the
                # reference never prunes them, micromerge.ts:592-600), so
                # record which keys *currently* hold their child object —
                # only those re-link on load; a deleted key must not
                # resurrect and an overwritten one keeps its plain value.
                linked = sorted(
                    k for k in meta.children if self.is_linked(obj_id, k)
                )
                objects[key] = {
                    "type": "map",
                    "values": {k: v for k, v in obj.items() if k not in linked},
                    "key_ops": dict(meta.key_ops),
                    "children": dict(meta.children),
                    "linked": linked,
                }
        return {
            "objects": objects,
            "mark_ops": {k: dict(v) for k, v in self.mark_ops.items()},
            "device_objects": sorted(self.device_objects),
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "ObjectStore":
        store = cls()
        store.objects.clear()
        store.metadata.clear()
        # Pass 1: create every object and its metadata.
        for key, entry in data["objects"].items():
            obj_id = None if key == "" else key
            if entry["type"] == "list":
                meta: Any = []
                for elem_id, value_id, deleted, before, after in entry["items"]:
                    item = ListItem(elem_id=elem_id, value_id=value_id, deleted=deleted)
                    item.mark_ops_before = set(before) if before is not None else None
                    item.mark_ops_after = set(after) if after is not None else None
                    meta.append(item)
                store.objects[obj_id] = list(entry["values"])
                store.metadata[obj_id] = meta
            else:
                m = MapMeta()
                m.key_ops = dict(entry["key_ops"])
                m.children = dict(entry["children"])
                store.objects[obj_id] = dict(entry["values"])
                store.metadata[obj_id] = m
        # Pass 2: re-link child-object references inside map values — only
        # the keys that actually held their child at save time ("linked");
        # stale ``children`` entries (deleted or LWW-overwritten keys) must
        # not resurrect objects into the map.
        for key, entry in data["objects"].items():
            if entry["type"] == "map":
                obj_id = None if key == "" else key
                for child_key in entry["linked"]:
                    child_id = entry["children"][child_key]
                    if child_id in store.objects:
                        store.objects[obj_id][child_key] = store.objects[child_id]
        store.mark_ops = {k: dict(v) for k, v in data["mark_ops"].items()}
        store.device_objects = set(data.get("device_objects", ()))
        return store


# ---------------------------------------------------------------------------
# Local change generation against a store (reference micromerge.ts:308-441)
# ---------------------------------------------------------------------------


def generate_input_op(
    store: ObjectStore,
    input_op: Dict[str, Any],
    make_new_op,
) -> List[Patch]:
    """Expand one InputOperation into internal ops against ``store``.

    The body of the reference's change() loop (micromerge.ts:326-441),
    parameterized over ``make_new_op(op) -> (op_id, patches)`` — the
    caller allocates the op id, applies the op to its own state, and
    records the wire form.  Shared by :meth:`Doc.change` and the device
    engine's host-side generation path (TpuDoc), so the two can never
    diverge on generation semantics.
    """
    obj_id = store.get_object_id_for_path(input_op["path"])
    obj = store.objects.get(obj_id)
    meta = store.metadata.get(obj_id)
    if obj is None or meta is None:
        raise KeyError(f"Object doesn't exist: {obj_id}")
    action = input_op["action"]
    patches: List[Patch] = []

    if isinstance(obj, list) and isinstance(meta, list):
        if action == "insert":
            # One input op expands to one internal op per character,
            # chained so each op references the previous
            # (micromerge.ts:347-361).  The initial reference element
            # uses the tombstone-peek rule.
            elem_id = (
                HEAD
                if input_op["index"] == 0
                else get_list_element_id(
                    meta, input_op["index"] - 1, look_after_tombstones=True
                )
            )
            for value in input_op["values"]:
                elem_id, new_patches = make_new_op(
                    {
                        "action": "set",
                        "obj": obj_id,
                        "elemId": elem_id,
                        "insert": True,
                        "value": value,
                    }
                )
                patches.extend(new_patches)
        elif action == "delete":
            # Constant-index repeated deletion (micromerge.ts:362-392).
            for _ in range(input_op["count"]):
                elem_id = get_list_element_id(meta, input_op["index"])
                _, new_patches = make_new_op(
                    {"action": "del", "obj": obj_id, "elemId": elem_id}
                )
                patches.extend(new_patches)
        elif action in ("addMark", "removeMark"):
            partial_op = change_mark(input_op, obj_id, meta, obj)
            _, new_patches = make_new_op(partial_op)
            patches.extend(new_patches)
        elif action == "del":
            raise ValueError("Use the delete action for lists")
        else:
            raise NotImplementedError(f"{action} on a list")
    else:
        if action in ("makeList", "makeMap", "del"):
            _, new_patches = make_new_op(
                {"action": action, "obj": obj_id, "key": input_op["key"]}
            )
            patches.extend(new_patches)
        elif action == "set":
            _, new_patches = make_new_op(
                {
                    "action": "set",
                    "obj": obj_id,
                    "key": input_op["key"],
                    "value": input_op["value"],
                }
            )
            patches.extend(new_patches)
        else:
            raise TypeError(f"Not a list: {input_op['path']}")
    return patches


# ---------------------------------------------------------------------------
# The document
# ---------------------------------------------------------------------------


class Doc:
    """A collaborative rich-text document replica (exact semantics).

    Equivalent surface to the reference ``Micromerge`` class
    (micromerge.ts:262-756): ``change()`` generates a :data:`Change` from
    input operations and applies it locally; ``apply_change()`` ingests a
    remote change behind a causal-readiness gate; ``get_text_with_formatting``
    materializes formatted spans; cursors resolve through tombstones.
    """

    CONTENT_KEY = CONTENT_KEY

    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.seq = 0
        self.max_op = 0
        self.clock: Dict[str, int] = {}
        # The object graph (objects/metadata keyed by creating op id,
        # ROOT is None) plus the doc-global mark-op table.
        self.store = ObjectStore()

    # -- store views (kept as attributes for the differential tests) --------

    @property
    def objects(self) -> Dict[Optional[str], Any]:
        return self.store.objects

    @property
    def metadata(self) -> Dict[Optional[str], Any]:
        return self.store.metadata

    @property
    def mark_ops(self) -> Dict[str, Operation]:
        return self.store.mark_ops

    # -- public accessors ---------------------------------------------------

    @property
    def root(self) -> Dict[str, Any]:
        return self.objects[ROOT]

    def get_object_id_for_path(self, path: Sequence[str]) -> Optional[str]:
        """Reference micromerge.ts:446-463 (getObjectIdForPath)."""
        return self.store.get_object_id_for_path(path)

    def get_text_with_formatting(self, path: Sequence[str]) -> List[Dict[str, Any]]:
        """Reference micromerge.ts:516-529."""
        object_id = self.get_object_id_for_path(path)
        text = self.objects.get(object_id)
        metadata = self.metadata.get(object_id)
        if not isinstance(text, list) or not isinstance(metadata, list):
            raise TypeError(f"Expected a list at object ID {object_id}")
        return get_text_with_formatting(text, metadata, self.mark_ops)

    # -- cursors (reference micromerge.ts:465-477) --------------------------

    def get_cursor(self, path: Sequence[str], index: int) -> Dict[str, Any]:
        object_id = self.get_object_id_for_path(path)
        return {
            "objectId": object_id,
            "elemId": get_list_element_id(self.metadata[object_id], index),
        }

    def resolve_cursor(self, cursor: Dict[str, Any]) -> int:
        _, visible = self._find_list_element(cursor["objectId"], cursor["elemId"])
        return visible

    # -- local change generation (reference micromerge.ts:308-441) ----------

    def change(self, input_ops: Sequence[Dict[str, Any]]) -> Tuple[Change, List[Patch]]:
        deps = dict(self.clock)
        # Resume from our own clock entry: a replica rebuilt by replaying a
        # log containing its own past changes (the durability model, SURVEY
        # §5) must not re-issue already-used sequence numbers — peers would
        # silently drop the colliding change.  In every reference-exercised
        # flow self.seq already equals clock[actor], so this is a no-op
        # there (micromerge.ts:318 bumps seq unconditionally).
        self.seq = max(self.seq, self.clock.get(self.actor_id, 0)) + 1
        self.clock[self.actor_id] = self.seq

        change: Change = {
            "actor": self.actor_id,
            "seq": self.seq,
            "deps": deps,
            "startOp": self.max_op + 1,
            "ops": [],
        }
        patches: List[Patch] = []
        for input_op in input_ops:
            patches.extend(
                generate_input_op(
                    self.store, input_op, lambda op: self._make_new_op(change, op)
                )
            )
        return change, patches

    def _make_new_op(
        self, change: Change, op: Operation
    ) -> Tuple[str, List[Patch]]:
        """Reference micromerge.ts:483-493 (makeNewOp)."""
        self.max_op += 1
        op_id = make_op_id(self.max_op, self.actor_id)
        op_with_id = {"opId": op_id, **op}
        patches = self._apply_op(op_with_id)
        # Changes carry wire-format ops (absent obj/elemId keys stand in for
        # the reference's ROOT/HEAD Symbols, which vanish under
        # JSON.stringify) so a change JSON-serializes byte-compatibly.
        change["ops"].append(op_to_wire(op_with_id))
        return op_id, patches

    # -- remote ingestion (reference micromerge.ts:499-514) -----------------

    def apply_change(self, change: Change) -> List[Patch]:
        """Causal gate + op application.  Raises ``ValueError`` on causal gaps
        (the reference throws RangeError, micromerge.ts:501-509)."""
        last_seq = self.clock.get(change["actor"], 0)
        if change["seq"] != last_seq + 1:
            raise ValueError(
                f"Expected sequence number {last_seq + 1}, got {change['seq']}"
            )
        for actor, dep in (change.get("deps") or {}).items():
            if self.clock.get(actor, 0) < dep:
                raise ValueError(f"Missing dependency: change {dep} by actor {actor}")
        self.clock[change["actor"]] = change["seq"]
        self.max_op = max(self.max_op, change["startOp"] + len(change["ops"]) - 1)

        patches: List[Patch] = []
        for op in change["ops"]:
            patches.extend(self._apply_op(op_from_wire(op)))
        return patches

    # -- op dispatch (reference micromerge.ts:534-608) ----------------------

    def _apply_op(self, op: Operation) -> List[Patch]:
        return self.store.apply_op(op)

    def _find_list_element(
        self, object_id: Optional[str], elem_id: str
    ) -> Tuple[int, int]:
        """Reference micromerge.ts:731-755 (findListElement)."""
        return self.store.find_list_element(object_id, elem_id)


# ---------------------------------------------------------------------------
# Patch-accumulation differential oracle (reference test/accumulatePatches.ts)
# ---------------------------------------------------------------------------


def accumulate_patches(patches: Sequence[Patch]) -> List[Dict[str, Any]]:
    """Naive per-character patch applier -> formatted spans.

    Faithful to reference test/accumulatePatches.ts:9-80, including its
    quirks (``removeMark`` deletes the whole mark entry regardless of type).
    Used to assert the incremental patch stream and the batch flatten agree.
    """
    chars: List[Dict[str, Any]] = []
    for patch in patches:
        if patch.get("path") != ["text"]:
            raise ValueError("accumulate_patches only supports the 'text' path")
        action = patch["action"]
        if action == "insert":
            for offset, character in enumerate(patch["values"]):
                chars.insert(
                    patch["index"] + offset,
                    {"character": character, "marks": dict(patch["marks"])},
                )
        elif action == "delete":
            del chars[patch["index"] : patch["index"] + patch["count"]]
        elif action == "addMark":
            for index in range(patch["startIndex"], patch["endIndex"]):
                marks = chars[index]["marks"]
                if patch["markType"] != "comment":
                    marks[patch["markType"]] = dict(patch.get("attrs") or {"active": True})
                else:
                    existing = marks.get("comment")
                    if existing is None:
                        marks["comment"] = [dict(patch["attrs"])]
                    elif not any(c["id"] == patch["attrs"]["id"] for c in existing):
                        marks["comment"] = sorted(
                            existing + [dict(patch["attrs"])], key=lambda c: c["id"]
                        )
        elif action == "removeMark":
            for index in range(patch["startIndex"], patch["endIndex"]):
                chars[index]["marks"].pop(patch["markType"], None)
        elif action == "makeList":
            pass
        else:
            raise ValueError(f"Unknown patch action: {action}")

    spans: List[Dict[str, Any]] = []
    for ch in chars:
        add_characters_to_spans([ch["character"]], ch["marks"], spans)
    return spans
