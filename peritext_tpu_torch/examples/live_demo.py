#!/usr/bin/env python3
"""Two-editor live demo with manual sync — the index.ts demo, terminal style.

Reference: the reference's src/index.ts — alice and bob share a Publisher;
their queues are dropped to manual mode and a "Sync" action flushes both.
This script seeds the same document (one of each mark) and walks a short
concurrent-editing session, rendering formatted spans and the op log after
each step.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from peritext_tpu_torch.bridge import EditorNetwork, describe_op  # noqa: E402

BOLD, DIM, RESET, ITALIC, UNDER = "\033[1m", "\033[2m", "\033[0m", "\033[3m", "\033[4m"


def render(spans):
    out = []
    for span in spans:
        text = span["text"]
        marks = span["marks"]
        prefix = ""
        if marks.get("strong"):
            prefix += BOLD
        if marks.get("em"):
            prefix += ITALIC
        if marks.get("link"):
            prefix += UNDER
        suffix = RESET if prefix else ""
        note = ""
        if marks.get("comment"):
            note = f"{DIM}[{','.join(c['id'] for c in marks['comment'])}]{RESET}"
        out.append(f"{prefix}{text}{suffix}{note}")
    return "".join(out)


def show(net, label):
    print(f"--- {label}")
    for name, editor in net.editors.items():
        print(f"  {name:>5}: {render(editor.spans())}")


def main():
    # Seed matches the reference demo: bold+italic+comment+link present.
    # The queue interval is the latency knob (changeQueue.ts:17-19) for the
    # final auto-flush act; until then queues stay in manual mode.
    latency = float(os.environ.get("LIVE_LATENCY", "0.05"))
    net = EditorNetwork(
        ["alice", "bob"], initial_text="The Peritext editor", interval=latency
    )
    net["alice"].toggle_mark(0, 3, "strong")
    net["alice"].toggle_mark(4, 12, "em")
    net["alice"].add_comment(4, 12, "seeded comment")
    net["alice"].add_link(13, 19, "https://inkandswitch.com/peritext")
    net.sync_all()
    show(net, "seeded, synced")

    # Concurrent session: offline edits on both sides.
    net["alice"].insert(19, " rocks")
    net["alice"].toggle_mark(13, 25, "strong")
    net["bob"].delete(0, 4)
    net["bob"].insert(0, "A ")
    show(net, "concurrent edits (not yet synced)")

    net.sync_all()
    show(net, "after sync (converged)")
    assert net.converged()

    print("--- op log (alice)")
    for change in net["alice"].change_log:
        for op in change["ops"]:
            print("   ", describe_op(op))

    # Latency-simulation act: switch the queues to interval-driven flushing
    # (the reference's simulated network delay, changeQueue.ts:17-19) and
    # watch edits propagate on the timer instead of a Sync click.
    import time

    net.start_all()
    try:
        net["alice"].insert(len(net["alice"].text()), " (live)")
        net["bob"].toggle_mark(0, 1, "em")
        deadline = time.monotonic() + max(5.0, latency * 100)
        while not net.converged() and time.monotonic() < deadline:
            time.sleep(latency / 2)
    finally:
        net.stop_all()
    show(net, f"after {latency * 1e3:.0f}ms-interval auto-flush (no Sync click)")
    assert net.converged()


if __name__ == "__main__":
    main()
