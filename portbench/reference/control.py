"""The control: the reference with one guarantee broken.

Peritext's formatting guarantee is that a character typed inside formatted
text takes the formatting around it (and, at the end of a bold or italic
span, extends it).  ``ControlDoc`` replays like the reference but gives
every inserted character an explicit empty mark boundary, so typed text
comes out plain and so does what follows it up to the next boundary.  Put
in the program's place, it must make every cell's check come out false;
the tests in ``portbench/tests`` hold it to that.
"""
from __future__ import annotations

from typing import List

from portbench.reference.doc import CONTENT_KEY, Doc, ListItem, ObjectStore, Operation, Patch
from portbench.reference.ids import compare_op_ids


class ControlStore(ObjectStore):
    def apply_list_insert(self, op: Operation) -> List[Patch]:
        metadata: List[ListItem] = self.metadata[op["obj"]]
        obj: List[str] = self.objects[op["obj"]]
        if op.get("elemId") is None:
            index, visible = -1, 0
        else:
            index, visible = self.find_list_element(op["obj"], op["elemId"])
        if index >= 0 and not metadata[index].deleted:
            visible += 1
        index += 1
        op_id = op["opId"]
        while index < len(metadata) and compare_op_ids(op_id, metadata[index].elem_id) < 0:
            if not metadata[index].deleted:
                visible += 1
            index += 1
        item = ListItem(elem_id=op_id, value_id=op_id)
        item.mark_ops_before = set()  # the broken guarantee: no inherited formatting
        metadata.insert(index, item)
        obj.insert(visible, op["value"])
        return [{"path": [CONTENT_KEY], "action": "insert", "index": visible, "values": [op["value"]], "marks": {}}]


class ControlDoc(Doc):
    def __init__(self, actor_id: str):
        super().__init__(actor_id)
        self.store = ControlStore()
