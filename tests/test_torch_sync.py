"""The port's anti-entropy sync (peritext_tpu_torch/runtime/sync.py) against
the JAX package's on the same seeded change batches: shuffled, duplicated
and gapped deliveries through ``apply_changes`` and ``apply_available``,
``causal_sort``, ``sync_pair`` over both packages' change logs, and the ids
a ``ConvergenceError`` carries.  Changes and patches are plain dicts, so
the comparison is exact; the receiving replicas are the oracle Doc and a
TorchDoc on the CPU."""
import functools
import random

import pytest

from peritext_tpu.oracle import Doc as JDoc
from peritext_tpu.runtime import sync as jsync
from peritext_tpu.runtime.log import ChangeLog as JChangeLog
from peritext_tpu_torch import TorchDoc
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import ChangeLog, sync, telemetry

CpuDoc = functools.partial(TorchDoc, device="cpu")


def history(seed: int, actors=("a", "b", "c"), edits: int = 24):
    """A seeded multi-writer history with cross-actor deps: each edit goes
    to a random writer, which first merges a random peer's changes."""
    rng = random.Random(seed)
    docs = {a: JDoc(a) for a in actors}
    genesis, _ = docs[actors[0]].change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("seeded sync")},
    ])
    changes = [genesis]
    for d in list(docs.values())[1:]:
        d.apply_change(genesis)
    for _ in range(edits):
        a = rng.choice(actors)
        peer = rng.choice(actors)
        for c in changes:
            if c["seq"] > docs[a].clock.get(c["actor"], 0) and c["actor"] == peer:
                try:
                    docs[a].apply_change(c)
                except ValueError:
                    break
        text = "".join(docs[a].root["text"])
        if rng.random() < 0.6 or len(text) < 2:
            op = {"path": ["text"], "action": "insert", "index": rng.randrange(len(text) + 1),
                  "values": list(rng.choice(["x", "yz", "!"]))}
        elif rng.random() < 0.5:
            start = rng.randrange(len(text) - 1)
            op = {"path": ["text"], "action": "addMark", "startIndex": start,
                  "endIndex": start + 1 + rng.randrange(len(text) - start - 1), "markType": "strong"}
        else:
            op = {"path": ["text"], "action": "delete", "index": rng.randrange(len(text)), "count": 1}
        change, _ = docs[a].change([op])
        changes.append(change)
    return changes


def chaos(changes, seed: int, gaps: bool):
    """Shuffle, duplicate a third, and (``gaps``) drop every copy of two
    changes that later changes of their actor depend on."""
    rng = random.Random(seed)
    out = list(changes) + [c for c in changes if rng.random() < 0.33]
    if gaps:
        last = {}
        for c in changes:
            last[c["actor"]] = max(last.get(c["actor"], 0), c["seq"])
        inner = [(c["actor"], c["seq"]) for c in changes[1:] if c["seq"] < last[c["actor"]]]
        dropped = set(rng.sample(inner, 2))
        out = [c for c in out if (c["actor"], c["seq"]) not in dropped]
    rng.shuffle(out)
    return out


@pytest.fixture(autouse=True)
def clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.mark.parametrize("engine", ["oracle", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_changes_and_available_match_jax(seed, engine):
    """Shuffled and duplicated deliveries apply in the JAX retry loop's
    order with its patches; a gapped batch leaves the same pending ids."""
    changes = history(seed)
    make = Doc if engine == "oracle" else CpuDoc
    full = chaos(changes, seed, gaps=False)
    port, ref = make("recv"), JDoc("recv")
    assert sync.apply_changes(port, full) == jsync.apply_changes(ref, full)
    assert port.clock == ref.clock
    assert port.get_text_with_formatting(["text"]) == ref.get_text_with_formatting(["text"])

    gapped = chaos(changes, seed + 100, gaps=True)
    port, ref = make("recv"), JDoc("recv")
    got_patches, got_pending = sync.apply_available(port, gapped)
    want_patches, want_pending = jsync.apply_available(ref, gapped)
    assert got_patches == want_patches
    assert [(c["actor"], c["seq"]) for c in got_pending] == [(c["actor"], c["seq"]) for c in want_pending]
    assert got_pending, "two dropped changes must leave their dependents pending"
    assert port.clock == ref.clock
    # allow_gaps applies the same ready prefix and leaves the rest unapplied.
    port2, ref2 = make("recv"), JDoc("recv")
    assert sync.apply_changes(port2, gapped, allow_gaps=True) == jsync.apply_changes(ref2, gapped, allow_gaps=True)


@pytest.mark.parametrize("seed", [0, 3])
def test_convergence_error_carries_the_jax_ids(seed):
    gapped = chaos(history(seed), seed + 7, gaps=True)
    with pytest.raises(sync.ConvergenceError) as got:
        sync.apply_changes(Doc("recv"), gapped)
    with pytest.raises(jsync.ConvergenceError) as want:
        jsync.apply_changes(JDoc("recv"), gapped)
    assert got.value.pending_ids == want.value.pending_ids
    assert str(got.value) == str(want.value)
    assert [c["seq"] for c in got.value.pending] == [c["seq"] for c in want.value.pending]


@pytest.mark.parametrize("seed", [0, 4, 5])
def test_causal_sort_and_order_match_jax(seed):
    changes = chaos(history(seed), seed, gaps=False)
    unique = list({(c["actor"], c["seq"]): c for c in changes}.values())
    random.Random(seed).shuffle(unique)
    assert sync.causal_sort(unique) == jsync.causal_sort(unique)
    assert sync.causal_order(unique) == jsync.causal_order(unique)
    # Without the genesis every change waits on it: both raise.
    headless = [c for c in unique if (c["actor"], c["seq"]) != ("a", 1)]
    for sort in (sync.causal_sort, jsync.causal_sort):
        with pytest.raises(ValueError, match=f"{len(headless)} changes have unsatisfiable"):
            sort(headless)


@pytest.mark.parametrize("engine", ["oracle", "torch"])
def test_sync_pair_matches_jax(engine):
    """Two replicas that saw different halves of a history sync through
    each package's change log to the same patches and spans."""
    changes = history(6)
    make = Doc if engine == "oracle" else CpuDoc
    log, jlog = ChangeLog(), JChangeLog()
    for c in changes:
        log.record(c)
        jlog.record(c)
    half = len(changes) // 2
    pair, jpair = (make("left"), make("right")), (JDoc("left"), JDoc("right"))
    for docs, apply in ((pair, sync.apply_changes), (jpair, jsync.apply_changes)):
        apply(docs[0], changes[:half])
        apply(docs[1], [changes[0]] + changes[half:], allow_gaps=True)
    got = sync.sync_pair(log, *pair)
    want = jsync.sync_pair(jlog, *jpair)
    assert got == want
    assert pair[0].clock == pair[1].clock == jpair[0].clock
    assert pair[0].get_text_with_formatting(["text"]) == jpair[1].get_text_with_formatting(["text"])


def test_deferred_changes_are_counted():
    """The ``sync.deferred`` counter and ``sync.apply`` span feed the port's
    telemetry as they feed the JAX package's."""
    gapped = chaos(history(8), 9, gaps=True)
    telemetry.enable()
    _, pending = sync.apply_available(Doc("recv"), gapped)
    snap = telemetry.snapshot()
    assert snap["counters"]["sync.deferred"] == len(pending) > 0
    assert "span.sync.apply.seconds" in snap["histograms"]
