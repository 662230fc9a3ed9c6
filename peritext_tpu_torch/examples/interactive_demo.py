#!/usr/bin/env python3
"""Interactive two-pane collaborative editor — index.ts:18-128, live.

Two editing sessions (alice, bob) share a Publisher with their outbound
queues in manual mode; a Sync action flushes both (the reference demo's
Sync button, index.ts:119-128).  Keystrokes drive the bridge's Editor step
vocabulary, and — the load-bearing part — each pane renders EXCLUSIVELY
from its accumulated Patch stream (never from doc.spans()), demonstrating
that the reference's incremental Patch protocol is sufficient for a real
interactive consumer (bridge.ts:132-195's contract).

Run interactively (any TTY):           python3 peritext_tpu_torch/examples/interactive_demo.py
Run the scripted session (CI/headless): python3 peritext_tpu_torch/examples/interactive_demo.py --script

Keys: type to insert · Backspace · arrows · Tab switch pane ·
Ctrl-A set selection anchor · Ctrl-B bold · Ctrl-T italic · Ctrl-L link ·
Ctrl-E comment · Ctrl-S sync · Ctrl-Q quit.
Mark keys apply from the anchor to the cursor (reference keymap Mod-b/i/e/k,
bridge.ts:35-68).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from peritext_tpu_torch.bridge import Editor, describe_op, initialize_docs  # noqa: E402
from peritext_tpu_torch.oracle import Doc, accumulate_patches  # noqa: E402
from peritext_tpu_torch.runtime import Publisher  # noqa: E402

ACTORS = ("alice", "bob")
SEED_TEXT = "The Peritext editor"


class Session:
    """One pane: an Editor plus a patch-accumulated view and a cursor."""

    def __init__(self, editor: Editor):
        self.editor = editor
        self.patches = []
        self.cursor = 0
        self.anchor = None
        editor.on_patch = self.patches.append

    # The pane's document, reconstructed from patches alone.
    def spans(self):
        return accumulate_patches(self.patches)

    def text(self) -> str:
        return "".join(s["text"] for s in self.spans())

    def clamp(self) -> None:
        self.cursor = max(0, min(self.cursor, len(self.text())))
        if self.anchor is not None:
            self.anchor = max(0, min(self.anchor, len(self.text())))

    def selection(self):
        if self.anchor is None or self.anchor == self.cursor:
            return None
        return min(self.anchor, self.cursor), max(self.anchor, self.cursor)

    def hold_cursor(self):
        """Stable cursor across a sync (reference getCursor/resolveCursor,
        micromerge.ts:465-477)."""
        n = len(self.text())
        if n == 0 or self.cursor == 0:
            return None
        at = min(self.cursor - 1, n - 1)
        return self.editor.doc.get_cursor(["text"], at)

    def restore_cursor(self, held) -> None:
        if held is None:
            self.cursor = 0
        else:
            self.cursor = self.editor.doc.resolve_cursor(held) + 1
        self.clamp()


def build_network():
    """Two editors over one Publisher, manual-sync, seeded like index.ts."""
    publisher = Publisher()
    docs = [Doc(a) for a in ACTORS]
    initialize_docs(
        docs,
        [{"path": ["text"], "action": "insert", "index": 0, "values": list(SEED_TEXT)}],
    )
    sessions = {}
    for doc in docs:
        ed = Editor(doc, publisher)
        ed.queue.drop()  # manual sync mode (index.ts:119-121)
        sessions[doc.actor_id] = Session(ed)
    # The genesis seeded doc state predates the patch streams; prime each
    # pane's accumulated view with one synthetic insert patch per char (the
    # same bootstrap an editor gets from initializeDocs' patches).
    for s in sessions.values():
        for i, ch in enumerate(SEED_TEXT):
            s.patches.append(
                {"path": ["text"], "action": "insert", "index": i,
                 "values": [ch], "marks": {}}
            )
        s.cursor = len(SEED_TEXT)
    return sessions


def sync_all(sessions) -> None:
    held = {name: s.hold_cursor() for name, s in sessions.items()}
    for s in sessions.values():
        s.editor.sync()
    for name, s in sessions.items():
        s.restore_cursor(held[name])


def converged(sessions) -> bool:
    views = [s.spans() for s in sessions.values()]
    return all(v == views[0] for v in views[1:])


# -- scripted session (headless; also the CI leg) ----------------------------

SCRIPT = [
    ("a", "ins", "Hello, "),           # alice types at her cursor (end moved to 0)
    ("a", "home", None),
    ("a", "ins", ">> "),
    ("b", "end", None),
    ("b", "ins", " -- bob was here"),
    ("a", "mark", ("strong", 3, 8)),
    ("b", "mark", ("em", 4, 12)),
    ("sync", None, None),
    ("check", True, None),
    ("a", "link", (0, 5, "https://peritext.example")),
    ("b", "comment", (2, 9, "what is this?")),
    ("check", False, None),            # not yet synced: views may diverge
    ("sync", None, None),
    ("check", True, None),
    ("b", "del", (0, 3)),
    ("sync", None, None),
    ("check", True, None),
]


def run_script(out=sys.stdout) -> None:
    sessions = build_network()
    name_of = {"a": "alice", "b": "bob"}
    for who, kind, arg in SCRIPT:
        if who == "sync":
            sync_all(sessions)
            print("== sync", file=out)
            continue
        if who == "check":
            ok = converged(sessions)
            if kind:  # convergence REQUIRED here
                assert ok, "panes diverged after sync"
                a = sessions["alice"]
                assert a.spans() == a.editor.spans(), (
                    "patch-accumulated view != batch flatten"
                )
                print(f"   converged: {sessions['alice'].text()!r}", file=out)
            continue
        s = sessions[name_of[who]]
        if kind == "ins":
            s.editor.insert(s.cursor, arg)
            s.cursor += len(arg)
        elif kind == "del":
            start, count = arg
            s.editor.delete(start, count)
        elif kind == "home":
            s.cursor = 0
        elif kind == "end":
            s.cursor = len(s.text())
        elif kind == "mark":
            mark, start, end = arg
            s.editor.toggle_mark(start, end, mark)
        elif kind == "link":
            start, end, url = arg
            s.editor.add_link(start, end, url)
        elif kind == "comment":
            start, end, content = arg
            s.editor.add_comment(start, end, content)
        s.clamp()
        print(f"{name_of[who]:>6} {kind}: {s.text()!r}", file=out)
    print("scripted session ok: two sessions converged via manual sync", file=out)


# -- curses UI ---------------------------------------------------------------

def run_curses() -> None:
    import curses

    sessions = build_network()
    names = list(sessions)
    focus = 0
    log = []

    def main(stdscr):
        nonlocal focus
        # Raw mode: ^S/^Q must reach us as keys, not XON/XOFF flow control.
        curses.raw()
        curses.curs_set(1)
        curses.start_color()
        curses.use_default_colors()
        curses.init_pair(1, curses.COLOR_CYAN, -1)     # link
        curses.init_pair(2, curses.COLOR_BLACK, curses.COLOR_YELLOW)  # comment
        italic = getattr(curses, "A_ITALIC", curses.A_UNDERLINE)

        def attrs_for(marks):
            a = 0
            if marks.get("strong"):
                a |= curses.A_BOLD
            if marks.get("em"):
                a |= italic
            if marks.get("link"):
                a |= curses.A_UNDERLINE | curses.color_pair(1)
            if marks.get("comment"):
                a |= curses.color_pair(2)
            return a

        def draw():
            stdscr.erase()
            h, w = stdscr.getmaxyx()
            pane_w = w // 2 - 1
            for i, name in enumerate(names):
                s = sessions[name]
                x0 = i * (pane_w + 2)
                marker = ">" if i == focus else " "
                pend = len(s.editor.queue)
                stdscr.addnstr(
                    0, x0, f"{marker} {name}  (pending {pend})", pane_w,
                    curses.A_REVERSE if i == focus else curses.A_DIM,
                )
                y, x = 2, 0
                pos = 0
                for span in s.spans():
                    a = attrs_for(span["marks"])
                    for ch in span["text"]:
                        if x >= pane_w:
                            y, x = y + 1, 0
                        if y < h - 6:
                            stdscr.addstr(y, x0 + x, ch, a)
                        x += 1
                        pos += 1
                sel = s.selection()
                if sel:
                    stdscr.addnstr(
                        h - 6, x0, f"sel {sel[0]}..{sel[1]}", pane_w, curses.A_DIM
                    )
            status = "CONVERGED" if converged(sessions) else "diverged (Ctrl-S to sync)"
            stdscr.addnstr(h - 5, 0, f"[{status}]", w - 1, curses.A_BOLD)
            stdscr.addnstr(
                h - 4, 0,
                "type · Bksp · arrows · Tab pane · ^A anchor · ^B bold · ^T italic"
                " · ^L link · ^E comment · ^S sync · ^Q quit",
                w - 1, curses.A_DIM,
            )
            for i, line in enumerate(log[-3:]):
                stdscr.addnstr(h - 3 + i, 0, line, w - 1, curses.A_DIM)
            s = sessions[names[focus]]
            pane_w2 = w // 2 - 1
            cy = 2 + s.cursor // pane_w2
            cx = focus * (pane_w2 + 2) + s.cursor % pane_w2
            stdscr.move(min(cy, h - 1), min(cx, w - 1))
            stdscr.refresh()

        while True:
            draw()
            ch = stdscr.get_wch()
            s = sessions[names[focus]]
            if ch == "\x11":  # ^Q
                break
            if ch == "\t":
                focus = (focus + 1) % len(names)
                continue
            if ch == "\x13":  # ^S -> the Sync button
                sync_all(sessions)
                log.append("sync: all queues flushed")
                continue
            if ch == "\x01":  # ^A
                s.anchor = s.cursor
                continue
            if ch in ("\x02", "\x14", "\x0c", "\x05"):  # ^B ^T ^L ^E
                sel = s.selection()
                if not sel:
                    log.append("select first: ^A at one end, cursor at the other")
                    continue
                start, end = sel
                if ch == "\x02":
                    s.editor.toggle_mark(start, end, "strong")
                elif ch == "\x14":
                    s.editor.toggle_mark(start, end, "em")
                elif ch == "\x0c":
                    s.editor.add_link(start, end, "https://peritext.example")
                else:
                    cid = s.editor.add_comment(start, end, "comment from the demo")
                    log.append(f"comment {cid}")
                change = s.editor.change_log[-1]
                log.append(describe_op(change["ops"][-1]))
                continue
            if ch in (curses.KEY_LEFT, curses.KEY_RIGHT, curses.KEY_HOME, curses.KEY_END):
                if ch == curses.KEY_LEFT:
                    s.cursor -= 1
                elif ch == curses.KEY_RIGHT:
                    s.cursor += 1
                elif ch == curses.KEY_HOME:
                    s.cursor = 0
                else:
                    s.cursor = len(s.text())
                s.clamp()
                continue
            if ch in (curses.KEY_BACKSPACE, "\x7f", "\x08"):
                if s.cursor > 0:
                    s.editor.delete(s.cursor - 1, 1)
                    s.cursor -= 1
                continue
            if isinstance(ch, str) and ch.isprintable():
                s.editor.insert(s.cursor, ch)
                s.cursor += 1
                change = s.editor.change_log[-1]
                if change["ops"]:
                    log.append(describe_op(change["ops"][-1]))

    curses.wrapper(main)


if __name__ == "__main__":
    if "--script" in sys.argv or not sys.stdout.isatty():
        run_script()
    else:
        run_curses()
