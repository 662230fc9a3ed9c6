"""TorchDoc (device="cpu") as a drop-in peer of the oracle Doc and of the
JAX package's TpuDoc: the scenarios of tests/test_tpu_doc.py, a rollback
when the device step fails, and the JAX package's fuzz harness over groups
that mix all three engines, flat and nested.  Exact equality throughout
(changes, patches, spans and clocks are strings and integers)."""
import functools

import pytest
import torch

from peritext_tpu.fuzz import fuzz
from peritext_tpu.ops import TpuDoc
from peritext_tpu.testing import DEFAULT_TEXT
from peritext_tpu_torch import TorchDoc, state_to_numpy
from peritext_tpu_torch.bench.workloads import doc_session
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.oracle import Doc, accumulate_patches

B = {"active": True}
CpuDoc = functools.partial(TorchDoc, device="cpu")
CpuDoc.__name__ = "TorchDoc"


def seeded_pair(text=DEFAULT_TEXT):
    """One oracle doc and one TorchDoc bootstrapped from the same genesis."""
    oracle = Doc("doc1")
    genesis, _ = oracle.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list(text)},
    ])
    doc = CpuDoc("doc2")
    patches = doc.apply_change(genesis)
    return oracle, doc, genesis, patches


def test_genesis_patches_equal_the_oracles():
    oracle, doc, genesis, patches = seeded_pair()
    assert patches == Doc("doc3").apply_change(genesis)
    assert accumulate_patches(patches[1:]) == doc.get_text_with_formatting(["text"])


def test_change_generation_matches_oracle_wire_format():
    _, doc, _, _ = seeded_pair("AB")
    ops = [
        {"path": ["text"], "action": "insert", "index": 1, "values": ["x", "y"]},
        {"path": ["text"], "action": "delete", "index": 0, "count": 1},
        {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 2, "markType": "strong"},
        {"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 3,
         "markType": "link", "attrs": {"url": "x.com"}},
        {"path": ["text"], "action": "removeMark", "startIndex": 0, "endIndex": 3, "markType": "em"},
    ]
    # A shadow oracle with the same actor id generates the reference wire
    # ops from an identical genesis.
    shadow = Doc("doc2")
    g, _ = Doc("doc1").change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": ["A", "B"]},
    ])
    shadow.apply_change(g)
    expected_change, expected_patches = shadow.change(ops)
    actual_change, actual_patches = doc.change(ops)
    assert actual_change == expected_change
    assert actual_patches == expected_patches


def test_round_trip_between_engines():
    oracle, doc, _, _ = seeded_pair()
    change_o, _ = oracle.change(
        [{"path": ["text"], "action": "addMark", "startIndex": 4, "endIndex": 12, "markType": "strong"}]
    )
    change_t, _ = doc.change([{"path": ["text"], "action": "insert", "index": 12, "values": ["!"]}])
    oracle.apply_change(change_t)
    doc.apply_change(change_o)
    assert doc.get_text_with_formatting(["text"]) == oracle.get_text_with_formatting(["text"]) == [
        {"marks": {}, "text": "The "},
        {"marks": {"strong": B}, "text": "Peritext!"},
        {"marks": {}, "text": " editor"},
    ]


def test_tombstone_peek_insert_generation():
    """The growth-behavior-with-tombstone-boundary case, generated locally
    (reference test/micromerge.ts:520-566)."""
    doc = CpuDoc("solo")
    shadow = Doc("solo")
    steps = [
        [{"path": [], "action": "makeList", "key": "text"}],
        [{"path": ["text"], "action": "insert", "index": 0, "values": list("ABCDE")}],
        [
            {"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 4,
             "markType": "link", "attrs": {"url": "inkandswitch.com"}},
            {"path": ["text"], "action": "delete", "index": 1, "count": 1},
            {"path": ["text"], "action": "delete", "index": 2, "count": 1},
            {"path": ["text"], "action": "insert", "index": 2, "values": ["F"]},
        ],
    ]
    for ops in steps:
        assert doc.change(ops) == shadow.change(ops)
    assert doc.get_text_with_formatting(["text"]) == [
        {"marks": {}, "text": "A"},
        {"marks": {"link": {"url": "inkandswitch.com"}}, "text": "C"},
        {"marks": {}, "text": "FE"},
    ]


def test_causal_gate_parity():
    _, doc, genesis, _ = seeded_pair()
    with pytest.raises(ValueError, match="Expected sequence number"):
        doc.apply_change(genesis)  # duplicate
    with pytest.raises(ValueError, match="Expected sequence number"):
        doc.apply_change({"actor": "ghost", "seq": 2, "deps": {}, "startOp": 9, "ops": []})
    with pytest.raises(ValueError, match="Missing dependency"):
        doc.apply_change({"actor": "ghost", "seq": 1, "deps": {"doc1": 5}, "startOp": 9, "ops": []})


def test_cursor_api():
    _, doc, _, _ = seeded_pair()
    cursor = doc.get_cursor(["text"], 5)
    doc.change([{"path": ["text"], "action": "insert", "index": 0, "values": list("abc")}])
    assert doc.resolve_cursor(cursor) == 8
    doc.change([{"path": ["text"], "action": "delete", "index": 8, "count": 1}])
    assert doc.resolve_cursor(cursor) == 8  # a deleted target stays where it was
    with pytest.raises(IndexError):
        doc.get_cursor(["text"], 99)


def test_root_map_lww_matches_oracle():
    """Concurrent root-key writes resolve LWW by op id (micromerge.ts:
    578-602); delivery order must not matter."""
    author = Doc("zz")
    genesis, _ = author.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("0123456789")},
    ])
    high, _ = author.change([{"path": [], "action": "set", "key": "title", "value": "X"}])
    for engine in (Doc, CpuDoc):
        peer = engine("me")
        peer.apply_change(genesis)
        peer.change([{"path": [], "action": "set", "key": "title", "value": "Y"}])
        peer.apply_change(high)  # the higher op id wins over the local Y
        assert peer.root.get("title") == "X", engine.__name__
        peer2 = engine("me")
        peer2.apply_change(genesis)
        peer2.apply_change(high)
        peer2.change([{"path": [], "action": "set", "key": "title", "value": "Y"}])
        assert peer2.root.get("title") == "Y", engine.__name__
        assert "".join(peer2.root["text"]) == "0123456789"


@pytest.mark.parametrize("engine", [Doc, CpuDoc])
def test_seq_resumes_after_log_replay_recovery(engine):
    """A replica rebuilt from a log holding its own changes authors with
    fresh sequence numbers."""
    author = Doc("alice")
    genesis, _ = author.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("hi")},
    ])
    rebuilt = engine("alice")
    rebuilt.apply_change(genesis)
    change, _ = rebuilt.change([{"path": ["text"], "action": "insert", "index": 2, "values": ["!"]}])
    assert change["seq"] == 2
    peer = Doc("bob")
    peer.apply_change(genesis)
    peer.apply_change(change)
    assert "".join(peer.root["text"]) == "hi!"


def _failing_step(monkeypatch, fail_on):
    """Make the ``fail_on``-th device step from now raise a RuntimeError."""
    calls = {"n": 0}
    real = K.apply_ops_patched

    def step(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == fail_on:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "apply_ops_patched", step)
    return calls


def test_device_failure_rolls_the_change_back(monkeypatch):
    """The second device step of a change raises: seq, max_op, clock,
    lengths, the host store and the state are as before the change, and
    the next change is the oracle's."""
    oracle, doc, _, _ = seeded_pair()
    first, _ = doc.change([{"path": ["text"], "action": "insert", "index": 0, "values": ["<"]}])
    oracle.apply_change(first)
    before =(doc.seq, doc.max_op, doc.clock, list(doc._uni.lengths), list(doc._uni.mark_counts),
              doc.root, doc.get_text_with_formatting(["text"]))
    state = state_to_numpy(doc._uni.states)
    calls = _failing_step(monkeypatch, fail_on=2)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        doc.change([
            {"path": ["text"], "action": "insert", "index": 3, "values": list("xyz")},
            {"path": [], "action": "set", "key": "title", "value": "T"},
            {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 5, "markType": "em"},
        ])
    assert calls["n"] == 2
    after = (doc.seq, doc.max_op, doc.clock, list(doc._uni.lengths), list(doc._uni.mark_counts),
             doc.root, doc.get_text_with_formatting(["text"]))
    assert after == before
    now = state_to_numpy(doc._uni.states)
    assert all((now[f] == state[f]).all() for f in state)
    monkeypatch.undo()
    # The stream stays contiguous: the next change applies at a peer, which
    # emits the patches the doc returned.
    change, patches = doc.change([
        {"path": ["text"], "action": "insert", "index": 3, "values": list("xyz")},
        {"path": [], "action": "set", "key": "title", "value": "T"},
    ])
    assert change["seq"] == 2 and change["startOp"] == before[1] + 1
    assert oracle.apply_change(change) == patches
    assert oracle.get_text_with_formatting(["text"]) == doc.get_text_with_formatting(["text"])
    assert oracle.root["title"] == doc.root["title"] == "T"


def test_semantic_errors_pass_through_without_rollback():
    _, doc, _, _ = seeded_pair("abc")
    with pytest.raises(IndexError, match="out of bounds"):
        doc.change([{"path": ["text"], "action": "delete", "index": 2, "count": 5}])
    # As in TpuDoc and the oracle, a semantic error keeps what was staged.
    assert doc.seq == 1 and doc.clock["doc2"] == 1


def test_without_a_gpu_torchdoc_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDoc("a")


@pytest.mark.parametrize("seed", [0, 7])
def test_fuzz_torchdoc_only(seed):
    fuzz(iterations=20, seed=seed, doc_factory=CpuDoc, initial_text="ABCDE")


def test_fuzz_three_engines():
    """Oracle, TorchDoc and TpuDoc replicas interoperating in one group."""
    engines = iter([Doc, CpuDoc, TpuDoc])
    fuzz(iterations=20, seed=3, doc_factory=lambda actor: next(engines)(actor), initial_text="ABCDE")


def test_fuzz_three_engines_nested_objects():
    engines = iter([CpuDoc, Doc, TpuDoc])
    fuzz(iterations=20, seed=9, doc_factory=lambda actor: next(engines)(actor), nested=True)


def test_doc_session_holds_torchdocs_against_oracle_twins():
    """The session chip_smoke runs on the card (phase 7), small: two
    TorchDocs and an oracle Doc, 30 edits, a sync every 6."""
    genesis, _ = Doc("base").change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("a session of edits")},
    ])
    docs = [CpuDoc("t1"), CpuDoc("t2"), Doc("o1")]
    out = doc_session(docs, genesis, edits=30, sync_every=6, seed=5)
    assert len(out["change_ms"]) == 30 and out["changes"] == 31
    assert len(out["apply_ms"]) == 2 * 30  # each change reaches the two other docs
    assert any(span["marks"] for span in out["spans"])
