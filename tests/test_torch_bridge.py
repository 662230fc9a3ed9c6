"""The port's editor bridge (peritext_tpu_torch/bridge.py): the cases of
tests/test_bridge.py, each on editors over the oracle Doc and over
TorchDoc on the CPU, and each held against the JAX package's bridge
driven by the same steps (spans, texts and patch streams compared
exactly)."""
import functools
import random
import time

import pytest

from peritext_tpu import bridge as jbridge
from peritext_tpu_torch import TorchDoc
from peritext_tpu_torch.bridge import (
    Editor,
    EditorNetwork,
    RemoteChangeHighlighter,
    content_pos_from_editor_pos,
    editor_doc_from_spans,
    editor_doc_text,
    initialize_docs,
)
from peritext_tpu_torch.oracle import Doc, accumulate_patches
from peritext_tpu_torch.runtime import Publisher

B = {"active": True}
ENGINES = {"oracle": Doc, "torch": functools.partial(TorchDoc, device="cpu")}


@pytest.fixture(params=sorted(ENGINES))
def make_doc(request):
    return ENGINES[request.param]


def networks(make_doc, actors=("alice", "bob"), text="The Peritext editor", **kw):
    """The port's network on ``make_doc`` documents and the JAX package's
    (oracle) network on the same actors and genesis."""
    return (EditorNetwork(actors, initial_text=text, doc_factory=make_doc, **kw),
            jbridge.EditorNetwork(actors, initial_text=text, **kw))


def both(nets, steps):
    """Run ``steps(net)`` on both networks (the same seed for comment ids)
    and assert every editor's spans agree across the packages."""
    out = []
    for net in nets:
        random.seed(1234)
        out.append(steps(net))
    port, ref = nets
    for actor in port.editors:
        assert port[actor].spans() == ref[actor].spans(), actor
        assert port[actor].text() == ref[actor].text(), actor
    return out


def test_live_demo_topology_two_editors(make_doc):
    nets = networks(make_doc)

    def steps(net):
        net["alice"].apply_steps([("add_mark", 4, 12, "strong")])
        net["bob"].insert(19, "!")
        assert not net.converged()  # queued, not yet flushed (manual sync)
        net.sync_all()
        assert net.converged()

    both(nets, steps)
    assert nets[0]["alice"].spans() == [
        {"marks": {}, "text": "The "},
        {"marks": {"strong": B}, "text": "Peritext"},
        {"marks": {}, "text": " editor!"},
    ]


def test_replace_step_maps_to_delete_plus_insert(make_doc):
    nets = networks(make_doc, text="hello world")

    def steps(net):
        net["alice"].apply_steps([("replace", 0, 5, "goodbye")])
        net.sync_all()

    both(nets, steps)
    assert nets[0]["bob"].text() == "goodbye world"


def test_patch_callbacks_reconstruct_document(make_doc):
    streams = {}
    for pkg, mk, pub_cls, init, editor_cls in (
        ("port", make_doc, Publisher, initialize_docs, Editor),
        ("jax", jbridge.Doc, jbridge.Publisher, jbridge.initialize_docs, jbridge.Editor),
    ):
        patches = {"alice": [], "bob": []}
        pub = pub_cls()
        docs = [mk("alice"), mk("bob")]
        init(docs)
        editors = {d.actor_id: editor_cls(d, pub, on_patch=lambda p, k=d.actor_id: patches[k].append(p))
                   for d in docs}
        editors["alice"].insert(0, "Hi there")
        editors["alice"].apply_steps([("add_mark", 0, 2, "em")])
        editors["bob"].sync()
        editors["alice"].sync()
        for k, e in editors.items():
            assert accumulate_patches(patches[k]) == e.spans(), (pkg, k)
        assert editors["alice"].spans() == editors["bob"].spans()
        streams[pkg] = patches
    assert streams["port"] == streams["jax"]


def test_remote_patch_hook_fires_only_for_remote_changes(make_doc):
    remotes = []

    def steps(net):
        remote = []
        net["b"].on_remote_patch = remote.append
        net["a"].insert(1, "y")
        assert remote == []
        net.sync_all()
        assert len(remote) == 1 and remote[0]["action"] == "insert"
        remotes.append(remote)

    both(networks(make_doc, actors=("a", "b"), text="x"), steps)
    assert remotes[0] == remotes[1]


def test_comment_command_and_side_table(make_doc):
    def steps(net):
        cid = net["alice"].add_comment(0, 6, "typo here?")
        net.sync_all()
        assert net["bob"].spans()[0]["marks"] == {"comment": [{"id": cid}]}
        assert net["alice"].comments[cid].content == "typo here?"
        assert net["alice"].comments[cid].actor == "alice"
        return cid

    port_id, jax_id = both(networks(make_doc, text="review me"), steps)
    assert port_id == jax_id


def test_link_command_and_lww(make_doc):
    def steps(net):
        net["alice"].add_link(0, 5, "a.example")
        net["bob"].add_link(0, 5, "b.example")
        net.sync_all()
        assert net.converged()
        return net["alice"].spans()[0]["marks"]["link"]["url"]

    port_url, jax_url = both(networks(make_doc, text="click here"), steps)
    assert port_url == jax_url in ("a.example", "b.example")


def test_readonly_editor_rejects_steps(make_doc):
    docs = [make_doc("solo")]
    initialize_docs(docs)
    viewer = Editor(docs[0], Publisher(), editable=False)
    with pytest.raises(PermissionError):
        viewer.insert(0, "nope")


def test_comment_requires_attrs(make_doc):
    net, _ = networks(make_doc)
    with pytest.raises(ValueError, match="require attrs"):
        net["alice"].apply_steps([("add_mark", 0, 3, "comment")])


def test_remote_change_highlight_flow(make_doc):
    """Remote patches overlay temporary highlightChange marks on the view,
    local edits don't, and flashes expire on tick."""
    views = []
    for net, flasher in ((networks(make_doc, text="collaborative text")[0], RemoteChangeHighlighter),
                         (jbridge.EditorNetwork(["alice", "bob"], initial_text="collaborative text"),
                          jbridge.RemoteChangeHighlighter)):
        alice, bob = net["alice"], net["bob"]
        flash = flasher(alice, duration_ticks=1)
        alice.insert(0, ">> ")
        alice.sync()
        assert all("highlightChange" not in s["marks"] for s in flash.spans())
        bob.insert(3, "NEW ")
        bob.toggle_mark(3, 7, "strong")
        bob.sync()
        lit = [s for s in flash.spans() if "highlightChange" in s["marks"]]
        assert lit and "".join(s["text"] for s in lit) == "NEW "
        assert all("highlightChange" not in s["marks"] for s in alice.spans())
        views.append(flash.spans())
        flash.tick()
        assert flash.spans() == alice.spans()
    assert views[0] == views[1]


def test_remote_highlight_ranges_remap_through_later_patches(make_doc):
    net, _ = networks(make_doc, text="0123456789")
    alice = net["alice"]
    flash = RemoteChangeHighlighter(alice, duration_ticks=5)
    net["bob"].insert(5, "AB")
    net["bob"].insert(0, "X")
    net["bob"].sync()
    lit = "".join(s["text"] for s in flash.spans() if "highlightChange" in s["marks"])
    assert sorted(lit) == ["A", "B", "X"], lit
    alice.insert(0, "local ")
    lit2 = "".join(s["text"] for s in flash.spans() if "highlightChange" in s["marks"])
    assert sorted(lit2) == ["A", "B", "X"], lit2


def test_editor_doc_model_matches_jax():
    """The doc > paragraph+ > text* builder, its text view and the
    position mapping give the JAX bridge's results."""
    spans = [
        {"marks": {"strong": {"active": True}}, "text": "Title\nbo"},
        {"marks": {}, "text": "dy text"},
    ]
    for sp in (spans, [], [{"marks": {}, "text": "abcdef"}]):
        doc = editor_doc_from_spans(sp)
        assert doc == jbridge.editor_doc_from_spans(sp)
        assert editor_doc_text(doc) == jbridge.editor_doc_text(doc)
        for pos in (0, 1, 5, 6, 8, 12, 99):
            assert content_pos_from_editor_pos(pos, doc) == jbridge.content_pos_from_editor_pos(pos, doc)
    assert editor_doc_text(editor_doc_from_spans(spans)) == "Title\nbody text"


def test_editor_doc_round_trips_live_session(make_doc):
    net, _ = networks(make_doc, actors=("a", "b"), text="one\ntwo")
    net["a"].toggle_mark(0, 3, "strong")
    net["a"].sync()
    doc = editor_doc_from_spans(net["b"].spans())
    assert editor_doc_text(doc) == "one\ntwo"
    assert doc["content"][0]["content"][0]["marks"] == {"strong": {"active": True}}


def test_interval_driven_latency_simulation(make_doc):
    """The queue's flush interval is the latency simulator: edits stay local
    until the timer fires on its own thread, then the fleet converges with
    no manual sync, to the spans of a JAX network given the same edits."""
    net, ref = networks(make_doc, text="shared", interval=0.05)
    try:
        net.start_all()
        net["alice"].insert(6, " doc")
        net["bob"].toggle_mark(0, 6, "strong")
        bob_text = net["bob"].text()
        if len(net["alice"].queue):
            assert bob_text == "shared"
        deadline = time.monotonic() + 10.0
        while not net.converged() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert net.converged()
        assert net["bob"].text() == "shared doc"
    finally:
        net.stop_all()
    ref["alice"].insert(6, " doc")
    ref["bob"].toggle_mark(0, 6, "strong")
    ref.sync_all()
    assert net["alice"].spans() == ref["alice"].spans() == ref["bob"].spans()
