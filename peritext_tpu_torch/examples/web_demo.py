#!/usr/bin/env python3
"""Browser two-pane collaborative editor — the reference's index.html
experience against the real engine, with zero dependencies.

Reference: the reference's index.html + src/index.ts:18-128 — alice and bob
side by side, outbound queues in manual mode, a Sync button flushing both.
Here a stdlib HTTP server holds the two bridge Editors (one shared
Publisher); the page (peritext_tpu_torch/examples/web/index.html) drives them through the
bridge step vocabulary and renders EXCLUSIVELY from the accumulated Patch
stream (a JS port of test/accumulatePatches.ts) — the same load-bearing
claim the curses client makes, now over HTTP in a real browser.

    python3 peritext_tpu_torch/examples/web_demo.py [--port 8700]   # then open two tabs
    python3 peritext_tpu_torch/examples/web_demo.py --script        # headless CI self-drive

Protocol (JSON):
    GET  /patches/<actor>?since=N -> {"patches": [...], "next": M}
    POST /edit/<actor>   {"action": "insert"|"delete"|"toggleMark"|
                          "comment"|"link", ...}  -> {"ok": true}
    POST /sync           -> {"ok": true}           (the Sync button)
    GET  /oplog          -> {"ops": [...]}         (the demo op panel)
"""
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from peritext_tpu_torch.bridge import Editor, describe_op, initialize_docs  # noqa: E402
from peritext_tpu_torch.oracle import Doc  # noqa: E402
from peritext_tpu_torch.runtime import Publisher  # noqa: E402

ACTORS = ("alice", "bob")
SEED_TEXT = "The Peritext editor"
WEB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web")


class DemoState:
    """The server-side session: two editors, per-actor patch journals."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        publisher = Publisher()
        docs = [Doc(a) for a in ACTORS]
        initialize_docs(
            docs,
            [
                {"path": ["text"], "action": "insert", "index": 0,
                 "values": list(SEED_TEXT)},
                {"path": ["text"], "action": "addMark", "startIndex": 0,
                 "endIndex": 3, "markType": "strong"},
                {"path": ["text"], "action": "addMark", "startIndex": 4,
                 "endIndex": 12, "markType": "em"},
            ],
        )
        self.journals = {a: [] for a in ACTORS}
        self.editors = {}
        for doc in docs:
            actor = doc.actor_id
            editor = Editor(doc, publisher, on_patch=self.journals[actor].append)
            self.editors[actor] = editor
        # The genesis ops reached each doc before journals existed; replay
        # them into the journal as the seed patch so a fresh tab can build
        # the doc from patches alone.
        for actor in ACTORS:
            spans = self.editors[actor].spans()
            index = 0
            for span in spans:
                self.journals[actor].append(
                    {
                        "path": ["text"], "action": "insert", "index": index,
                        "values": list(span["text"]),
                        "marks": span["marks"],
                    }
                )
                index += len(span["text"])

    def edit(self, actor: str, body: dict) -> None:
        editor = self.editors[actor]
        action = body["action"]
        if action == "insert":
            editor.insert(int(body["index"]), str(body["text"]))
        elif action == "delete":
            editor.delete(int(body["index"]), int(body.get("count", 1)))
        elif action == "toggleMark":
            editor.toggle_mark(int(body["from"]), int(body["to"]), body["markType"])
        elif action == "comment":
            editor.add_comment(int(body["from"]), int(body["to"]), body.get("content", ""))
        elif action == "link":
            editor.add_link(int(body["from"]), int(body["to"]), body.get("url", ""))
        else:
            raise ValueError(f"unknown action {action!r}")

    def sync(self) -> None:
        for editor in self.editors.values():
            editor.sync()

    def oplog(self):
        out = []
        for actor in ACTORS:
            for change in self.editors[actor].change_log:
                for op in change["ops"]:
                    out.append(f"{actor}: {describe_op(op)}")
        return out


class Handler(BaseHTTPRequestHandler):
    state: DemoState = None  # set by serve()

    def _json(self, payload, status=200) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args) -> None:  # quiet CI logs
        pass

    def do_GET(self) -> None:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if not parts:
            try:
                with open(os.path.join(WEB_DIR, "index.html"), "rb") as f:
                    data = f.read()
            except OSError:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if parts[0] == "patches" and len(parts) == 2 and parts[1] in ACTORS:
            since = int(parse_qs(url.query).get("since", ["0"])[0])
            with self.state.lock:
                journal = self.state.journals[parts[1]]
                payload = {"patches": journal[since:], "next": len(journal)}
            self._json(payload)
            return
        if parts[0] == "oplog":
            with self.state.lock:
                self._json({"ops": self.state.oplog()})
            return
        self.send_error(404)

    def do_POST(self) -> None:
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        length = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(length) or b"{}")
        try:
            if parts and parts[0] == "edit" and len(parts) == 2 and parts[1] in ACTORS:
                with self.state.lock:
                    self.state.edit(parts[1], body)
                self._json({"ok": True})
                return
            if parts and parts[0] == "sync":
                with self.state.lock:
                    self.state.sync()
                self._json({"ok": True})
                return
        except Exception as err:  # surface engine errors to the page
            self._json({"ok": False, "error": str(err)}, status=400)
            return
        self.send_error(404)


def serve(port: int):
    Handler.state = DemoState()
    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def script_mode() -> int:
    """Headless self-drive: two 'tabs' (pollers) edit concurrently, Sync,
    and both patch-accumulated renderings must converge — the browser
    protocol exercised end-to-end without a browser."""
    from urllib.request import Request, urlopen

    from peritext_tpu_torch.oracle import accumulate_patches

    server = serve(0)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"

    def call(path, body=None):
        req = Request(
            base + path,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    class Tab:
        def __init__(self, actor):
            self.actor = actor
            self.patches = []
            self.next = 0

        def poll(self):
            out = call(f"/patches/{self.actor}?since={self.next}")
            self.patches.extend(out["patches"])
            self.next = out["next"]

        def spans(self):
            return accumulate_patches(self.patches)

        def text(self):
            return "".join(s["text"] for s in self.spans())

    alice, bob = Tab("alice"), Tab("bob")
    alice.poll(), bob.poll()
    assert alice.text() == SEED_TEXT, alice.text()

    # Concurrent offline edits (the index.ts demo session).
    call("/edit/alice", {"action": "insert", "index": len(SEED_TEXT), "text": " rocks"})
    call("/edit/alice", {"action": "toggleMark", "from": 13, "to": 25, "markType": "strong"})
    call("/edit/bob", {"action": "delete", "index": 0, "count": 4})
    call("/edit/bob", {"action": "insert", "index": 0, "text": "A "})
    alice.poll(), bob.poll()
    assert alice.text() != bob.text(), "edits should be local before Sync"

    call("/sync", {})
    alice.poll(), bob.poll()
    assert alice.text() == bob.text(), (alice.text(), bob.text())
    assert alice.spans() == bob.spans(), "patch-accumulated spans diverged"
    ops = call("/oplog")["ops"]
    assert ops, "op log empty"
    server.shutdown()
    print(
        f"web_demo --script ok: tabs converged via Patch protocol over HTTP "
        f"({len(alice.patches)} patches/tab); text={alice.text()!r}"
    )
    return 0


def main() -> int:
    if "--script" in sys.argv:
        return script_mode()
    port = 8700
    if "--port" in sys.argv:
        port = int(sys.argv[sys.argv.index("--port") + 1])
    server = serve(port)
    print(f"web demo at http://127.0.0.1:{port}/ — open two tabs, edit, press Sync")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
