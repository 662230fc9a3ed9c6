#!/usr/bin/env python3
"""Scripted essay playback demo — keystroke-granular trace execution.

Reference: the reference's src/essay-demo.ts + essay-demo-content.ts: a
looping scripted demo showing the four headline mark behaviors (bold/italic
overlap, link LWW conflict, comment coexistence, growth semantics), executed
as a keystroke-granular event trace with periodic syncs.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from peritext_tpu_torch.replay import TraceSession, simulate_typing_for_input_op  # noqa: E402

L0 = "Bold formatting can overlap with italic.\n"
L1 = "Links conflict when they overlap.\n"
L2 = "Comments can co-exist.\n"
L3 = "Bold grows; links do not"


def typing(editor, index, text):
    return simulate_typing_for_input_op(
        editor, {"action": "insert", "index": index, "values": list(text)}
    )


def mark(editor, action, start, end, mark_type, attrs=None):
    op = {
        "editorId": editor,
        "path": ["text"],
        "action": action,
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }
    if attrs:
        op["attrs"] = attrs
    return [op]


TRACE = (
    [{"editorId": "alice", "path": [], "action": "makeList", "key": "text"},
     {"action": "sync"}]
    # Bold/italic overlap merges commutatively.
    + typing("alice", 0, L0)
    + [{"action": "sync"}]
    + mark("alice", "addMark", 0, 27, "strong")
    + mark("bob", "addMark", 5, 40, "em")
    + [{"action": "sync"}]
    # Concurrent overlapping links: one winner by op-id LWW.
    + typing("alice", len(L0), L1)
    + [{"action": "sync"}]
    + mark("alice", "addMark", len(L0), len(L0) + 19, "link",
           {"url": "http://inkandswitch.com"})
    + mark("bob", "addMark", len(L0) + 15, len(L0) + 33, "link",
           {"url": "http://notion.so"})
    + [{"action": "sync"}]
    # Comments coexist as a multiset.
    + typing("bob", len(L0) + len(L1), L2)
    + [{"action": "sync"}]
    + mark("alice", "addMark", len(L0) + len(L1), len(L0) + len(L1) + 14,
           "comment", {"id": "comment-alice"})
    + mark("bob", "addMark", len(L0) + len(L1) + 9, len(L0) + len(L1) + 22,
           "comment", {"id": "comment-bob"})
    + [{"action": "sync"}]
    # Growth: typing at a bold span's end extends it; at a link's end doesn't.
    + typing("alice", len(L0) + len(L1) + len(L2), L3)
    + [{"action": "sync"}]
    + mark("alice", "addMark", len(L0) + len(L1) + len(L2),
           len(L0) + len(L1) + len(L2) + 4, "strong")
    + mark("alice", "addMark", len(L0) + len(L1) + len(L2) + 12,
           len(L0) + len(L1) + len(L2) + 17, "link", {"url": "http://x.com"})
    + [{"action": "sync"}]
    + typing("bob", len(L0) + len(L1) + len(L2) + 4, "er")      # grows bold
    + typing("bob", len(L0) + len(L1) + len(L2) + 19, "!")      # outside link
    + [{"action": "sync"}]
)


def flash_act():
    """The reference demo's remote-change flash (essay-demo.ts:47-75):
    remote edits light up with a temporary highlightChange overlay."""
    from peritext_tpu_torch.bridge import EditorNetwork, RemoteChangeHighlighter

    net = EditorNetwork(["alice", "bob"], initial_text="Watch remote edits flash.")
    flash = RemoteChangeHighlighter(net["alice"], duration_ticks=1)
    net["bob"].insert(6, "incoming ")
    net["bob"].toggle_mark(0, 5, "strong")
    net["bob"].sync()
    print("\nremote-change flash on alice's view:")
    for span in flash.spans():
        lit = " <-- flashing" if "highlightChange" in span["marks"] else ""
        print(f"  {span['text']!r:35}{lit}")
    flash.tick()
    assert flash.spans() == net["alice"].spans(), "flash failed to expire"
    assert net.converged(), "flash act diverged!"
    print("flash expired; views converged.")


def main():
    session = TraceSession(["alice", "bob"])
    session.run(TRACE)
    spans = session.spans()
    assert spans["alice"] == spans["bob"], "demo diverged!"
    print(f"executed {len(TRACE)} trace events; replicas converged.\n")
    for span in spans["alice"]:
        marks = ",".join(f"{k}={v}" for k, v in span["marks"].items())
        print(f"  {span['text']!r:45} {marks}")
    flash_act()


if __name__ == "__main__":
    main()
