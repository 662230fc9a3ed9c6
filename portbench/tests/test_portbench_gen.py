"""The generators: the same seed gives the same changes, and the changes
are sound (every replica order the harness uses converges)."""
from __future__ import annotations

import random

import pytest

from portbench.drivers.epochs import class_order, epoch_batches, text_ops
from portbench.drivers.serve import arrivals
from portbench.gen.fuzzmix import make_writer_rounds, split_rounds
from portbench.gen.wire import wire_fuzz_rounds
from portbench.reference.doc import Doc

BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("gen", ["fuzzmix", "wire"])
def test_same_seed_same_changes(gen):
    make = (lambda s: make_writer_rounds(200, 32, 4, 3, seed=s)) if gen == "fuzzmix" else \
        (lambda s: wire_fuzz_rounds(500, 32, 4, 3, seed=s))
    assert make(BIG_SEED) == make(BIG_SEED)
    assert make(BIG_SEED) != make(BIG_SEED + 1)


@pytest.mark.parametrize("gen", ["fuzzmix", "wire"])
def test_rounds_budget_and_convergence(gen):
    wl = make_writer_rounds(300, 32, 4, 3, seed=7) if gen == "fuzzmix" else wire_fuzz_rounds(600, 32, 4, 3, seed=7)
    for rnd in wl["rounds"]:
        for changes in rnd:
            assert sum(text_ops(c) for c in changes) == 32
    spans = []
    for k in range(4):
        d = Doc("r")
        for c in class_order(wl, 4, k):
            d.apply_change(c)
        spans.append(d.get_text_with_formatting(["text"]))
    assert all(s == spans[0] for s in spans)
    assert any(s["marks"] for s in spans[0])


def test_epoch_batches_deliver_every_change_once():
    wl = make_writer_rounds(100, 16, 4, 2, seed=3)
    batches = epoch_batches(wl, 8, 4)
    for r in range(8):
        got = [(c["actor"], c["seq"]) for batch in batches for c in batch[r]]
        assert len(got) == len(set(got)) == 1 + sum(len(rnd[w]) for rnd in wl["rounds"] for w in range(4))


def test_split_rounds_keeps_ops():
    wl = make_writer_rounds(100, 16, 4, 2, seed=4)
    split = split_rounds(wl["rounds"], 8)
    for w in range(4):
        before = [op for rnd in wl["rounds"] for c in rnd[w] for op in c["ops"]]
        after = [op for rnd in split for c in rnd[w] for op in c["ops"]]
        assert before == after
        assert all(len(c["ops"]) <= 8 for rnd in split for c in rnd[w])


def test_arrivals_same_seed_same_schedule():
    a = arrivals(16, 4, 8, 100, 5.0, random.Random(BIG_SEED))
    assert a == arrivals(16, 4, 8, 100, 5.0, random.Random(BIG_SEED))
    assert len(a) == 100 and all(0 <= t < 5.0 for t, *_ in a)
    assert [t for t, *_ in a] == sorted(t for t, *_ in a)
    seen = {}
    for _, d, w, k in a:  # each writer's changes in order, none twice
        assert k == seen.get((d, w), -1) + 1
        seen[(d, w)] = k


def test_relabel_keeps_the_shape_and_changes_the_content():
    from portbench.gen.relabel import Relabel

    wl = make_writer_rounds(200, 32, 4, 2, seed=9)
    a, b = Relabel(random.Random(1))(wl), Relabel(random.Random(2))(wl)
    assert a == Relabel(random.Random(1))(wl) and a != b
    for x in (a, b):
        for rnd, rnd0 in zip(x["rounds"], wl["rounds"]):
            for w in range(4):
                assert [[(op["action"], op.get("elemId"), op["opId"]) for op in c["ops"]] for c in rnd[w]] == \
                    [[(op["action"], op.get("elemId"), op["opId"]) for op in c["ops"]] for c in rnd0[w]]
    spans = []
    for x in (wl, a):
        d = Doc("r")
        for c in class_order(x, 4, 0):
            d.apply_change(c)
        spans.append(d.get_text_with_formatting(["text"]))
    assert [len(s["text"]) for s in spans[0]] == [len(s["text"]) for s in spans[1]]
