"""The plain reference on hand-worked Peritext cases, and its digest."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.reference.digest import U32, attr_numbers, digest
from portbench.reference.doc import Doc, ops_to_marks


def _pair(text: str):
    alice, bob = Doc("alice"), Doc("bob")
    genesis, _ = alice.change([{"path": [], "action": "makeList", "key": "text"},
                               {"path": ["text"], "action": "insert", "index": 0, "values": list(text)}])
    bob.apply_change(genesis)
    return alice, bob


def _merge(alice: Doc, bob: Doc, a_op, b_op):
    ca, _ = alice.change([a_op])
    cb, _ = bob.change([b_op])
    alice.apply_change(cb)
    bob.apply_change(ca)
    spans = alice.get_text_with_formatting(["text"])
    assert spans == bob.get_text_with_formatting(["text"])
    return spans


def _mark(action, start, end, mark_type, attrs=None):
    op = {"path": ["text"], "action": action, "startIndex": start, "endIndex": end, "markType": mark_type}
    if attrs:
        op["attrs"] = attrs
    return op


def test_bold_and_italic_overlap():
    spans = _merge(*_pair("The fox jumped"), _mark("addMark", 0, 7, "strong"), _mark("addMark", 4, 14, "em"))
    assert spans == [{"marks": {"strong": {"active": True}}, "text": "The "},
                     {"marks": {"strong": {"active": True}, "em": {"active": True}}, "text": "fox"},
                     {"marks": {"em": {"active": True}}, "text": " jumped"}]


def test_link_conflict_last_writer_wins():
    # Both links take op counter 1002 (the genesis used 1..1001); "bob" > "alice" wins the overlap.
    spans = _merge(*_pair("abcdefghij"), _mark("addMark", 0, 5, "link", {"url": "A.com"}),
                   _mark("addMark", 3, 8, "link", {"url": "B.com"}))
    assert spans == [{"marks": {"link": {"url": "A.com"}}, "text": "abc"},
                     {"marks": {"link": {"url": "B.com"}}, "text": "defgh"},
                     {"marks": {}, "text": "ij"}]


def test_comments_side_by_side():
    spans = _merge(*_pair("abcdefghij"), _mark("addMark", 0, 5, "comment", {"id": "c1"}),
                   _mark("addMark", 3, 8, "comment", {"id": "c2"}))
    assert spans == [{"marks": {"comment": [{"id": "c1"}]}, "text": "abc"},
                     {"marks": {"comment": [{"id": "c1"}, {"id": "c2"}]}, "text": "de"},
                     {"marks": {"comment": [{"id": "c2"}]}, "text": "fgh"},
                     {"marks": {}, "text": "ij"}]


@pytest.mark.parametrize("mark_type,grows", [("strong", True), ("link", False)])
def test_typing_at_a_marks_end(mark_type, grows):
    alice, bob = _pair("abcdef")
    attrs = {"url": "A.com"} if mark_type == "link" else None
    c1, _ = alice.change([_mark("addMark", 0, 3, mark_type, attrs)])
    c2, _ = alice.change([{"path": ["text"], "action": "insert", "index": 3, "values": ["X"]}])
    bob.apply_change(c1)
    bob.apply_change(c2)
    spans = bob.get_text_with_formatting(["text"])
    marked = spans[0]["text"]
    assert marked == ("abcX" if grows else "abc")


def test_digest_by_hand():
    spans = [{"marks": {}, "text": "ab"}, {"marks": {"strong": {"active": True}, "link": {"url": "A.com"}}, "text": "c"}]
    numbers = {'{"url": "A.com"}': 0}
    chars = sum((((ord(ch) * 2654435761) & U32) + i) & U32 for i, ch in enumerate("abc")) & U32
    per = ((0 * 1000003 + 0 * 8191 + 17) + (3 * 1000003 + 1 * 8191 + 17)) & U32
    marks = (per * (31 * 2 + 7)) & U32
    assert digest(spans, numbers) == (2166136261 ^ chars ^ ((31 * marks) & U32)) & U32


def test_attr_numbers_follow_first_appearance():
    changes = [{"ops": [{"action": "addMark", "attrs": {"id": "b"}}, {"action": "set"},
                        {"action": "addMark", "attrs": {"url": "A.com"}}]},
               {"ops": [{"action": "removeMark", "attrs": {"id": "b"}}, {"action": "addMark", "attrs": {"id": "a"}}]}]
    assert attr_numbers(changes) == {'{"id": "b"}': 0, '{"url": "A.com"}': 1, '{"id": "a"}': 2}


def test_digest_equals_the_ports_on_the_cpu():
    """The harness's digest rule and the port's ``convergence_digest``
    agree, so a sound sweep is judged correct."""
    torch = pytest.importorskip("torch")
    from portbench.drivers.sweep import PortStream, reference
    from portbench.gen.wire import wire_fuzz_rounds

    wl = wire_fuzz_rounds(400, 48, 4, 1, seed=11)
    cfg = {"capacity": 1024, "max_mark_ops": 128, "population": 9}
    prog = PortStream(wl, cfg, {"cohort": 4, "depth": None}, "cpu")
    dg, _ = prog.sweep()
    want = reference(wl)["digests"][np.arange(9) % 4]
    assert (np.asarray(dg, np.uint32) == want).all()
    assert torch.is_tensor(torch.zeros(1))


# -- ops_to_marks, pinned by hand ------------------------------------------------------------------
# The reference's ops_to_marks is a copy of the function the port's read-back
# calls, so a fault in it would show on both sides alike; these cases, worked
# out from Peritext's rules (peritext.ts opsToMarks), hold the copy to them.


def _op(action, mark_type, attrs=None):
    op = {"action": action, "markType": mark_type}
    if attrs:
        op["attrs"] = attrs
    return op


def test_ops_to_marks_last_writer_wins_by_op_id():
    ops = {"5@alice": _op("addMark", "strong"), "6@bob": _op("removeMark", "strong"),
           "6@alice": _op("addMark", "em"),
           # The counter decides before the actor, and compares as a number: 10 follows 9.
           "10@alice": _op("addMark", "link", {"url": "A.com"}), "9@bob": _op("addMark", "link", {"url": "B.com"})}
    assert ops_to_marks(set(ops), ops) == {"em": {"active": True}, "link": {"url": "A.com"}}
    # On equal counters the greater actor wins.
    tie = {"7@alice": _op("addMark", "link", {"url": "A.com"}), "7@bob": _op("addMark", "link", {"url": "B.com"})}
    assert ops_to_marks(set(tie), tie) == {"link": {"url": "B.com"}}


def test_ops_to_marks_add_after_remove_comes_back():
    ops = {"1@a": _op("addMark", "strong"), "2@a": _op("removeMark", "strong"), "3@a": _op("addMark", "strong")}
    assert ops_to_marks(set(ops), ops) == {"strong": {"active": True}}
    assert ops_to_marks({"1@a", "2@a"}, ops) == {}


def test_ops_to_marks_comments_are_a_set_by_id():
    ops = {"7@a": _op("addMark", "comment", {"id": "c2"}), "7@b": _op("addMark", "comment", {"id": "c1"}),
           "8@a": _op("removeMark", "comment", {"id": "c2"}),
           "3@z": _op("removeMark", "comment", {"id": "c1"}),  # before c1's add: c1 stays
           "9@a": _op("addMark", "comment", {"id": "c0"})}
    assert ops_to_marks(set(ops), ops) == {"comment": [{"id": "c0"}, {"id": "c1"}]}
    assert ops_to_marks({"7@a", "8@a"}, ops) == {}


def test_concurrent_bold_and_unbold():
    # Concurrent ops take one counter; "bob" > "alice", so bob's op wins where they overlap.
    bold = {"strong": {"active": True}}
    spans = _merge(*_pair("The fox jumped"), _mark("addMark", 0, 14, "strong"), _mark("removeMark", 4, 7, "strong"))
    assert spans == [{"marks": bold, "text": "The "}, {"marks": {}, "text": "fox"},
                     {"marks": bold, "text": " jumped"}]
    alice, bob = _pair("The fox jumped")
    c, _ = alice.change([_mark("addMark", 0, 14, "strong")])
    bob.apply_change(c)
    spans = _merge(alice, bob, _mark("removeMark", 4, 7, "strong"), _mark("addMark", 0, 14, "strong"))
    assert spans == [{"marks": bold, "text": "The fox jumped"}]


def test_comment_removed_while_another_is_added_over_it():
    alice, bob = _pair("abcdefghij")
    c, _ = alice.change([_mark("addMark", 0, 5, "comment", {"id": "c1"})])
    bob.apply_change(c)
    spans = _merge(alice, bob, _mark("removeMark", 0, 5, "comment", {"id": "c1"}),
                   _mark("addMark", 2, 7, "comment", {"id": "c2"}))
    assert spans == [{"marks": {}, "text": "ab"}, {"marks": {"comment": [{"id": "c2"}]}, "text": "cdefg"},
                     {"marks": {}, "text": "hij"}]
