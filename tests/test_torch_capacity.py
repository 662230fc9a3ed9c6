"""The capacity route and the kernels' limit.  The kernels hold C <= 16384
in one block and, as thread-block clusters, up to C = 131072
(``cuda_kernels.kernel_capacity_limit``).  A universe past the limit
merges on the sorted route with no depth cap, counted in
``stats["capacity_routes"]``, and stays byte-equal to ``TpuUniverse``,
which merges at any capacity.

Two replicas grow from C = 256 to 32768 through a 16,400-character
genesis, then take concurrent edits with marks and a batch eleven rounds
deep (changes written out in wire format, element ids named).  Under the
real limit the port's default and scan routes merge every batch through
the kernels (their plain twins on the CPU) with no capacity route.  Under
a limit lowered to 16384 the port runs on its default route and under
``PERITEXT_MERGE_PATH=scan`` and ``=sorted``, each against
``TpuUniverse`` on the matching route: every state field, digests, texts
and spans equal (tolerance 0), the route counted from the shapes on the
CPU as on the card, and the kernels' merge never called above the limit.
"""
import os

import numpy as np
import pytest

from peritext_tpu.ops import TpuUniverse
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import WireAuthor
from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import universe as port_universe
from peritext_tpu_torch.ops.state import FIELDS

GENESIS_CHARS = 16_400


def test_kernel_capacity_limit_matches_the_wrappers_bounds():
    """The limit is where both kernels' shared-memory footprints still fit
    one block of a cluster of MAX_CLUSTER blocks, at any mask width the
    universe uses."""
    blocks = cuda_kernels.MAX_CLUSTER
    for words in (1, 2, 32, 512):
        limit = cuda_kernels.kernel_capacity_limit(words)
        assert limit == 131072
        for fits, cap in ((True, limit), (False, 2 * limit)):
            ok = (cuda_kernels.text_phase_smem_bytes(cap, blocks) <= cuda_kernels.MAX_SHARED_BYTES
                  and cuda_kernels.mark_phase_smem_bytes(cap, words, blocks)
                  <= cuda_kernels.MAX_SHARED_BYTES)
            assert ok == fits


def _history():
    """Genesis past 16384 characters, then rounds of concurrent edits with
    marks, and a chain of single-character inserts alternating between two
    actors (each after the other's last one: eleven rounds deep)."""
    a, b = WireAuthor("alice"), WireAuthor("bob")
    text = "1@alice"
    body = ("capacity route " * (GENESIS_CHARS // 15 + 1))[:GENESIS_CHARS]

    def genesis_ops(new_id):
        ops = [{"opId": new_id(), "action": "makeList", "obj": None, "key": "text"}]
        prev = None
        for ch in body:
            op = {"opId": new_id(), "action": "set", "obj": text, "insert": True, "value": ch}
            if prev is not None:
                op["elemId"] = prev
            ops.append(op)
            prev = op["opId"]
        return ops

    genesis = a.change(genesis_ops)
    b.saw(genesis)

    def elem(i):  # the i-th genesis character
        return f"{i + 2}@alice"

    def insert(after, chars):
        def ops(new_id):
            out, prev = [], after
            for ch in chars:
                out.append({"opId": new_id(), "action": "set", "obj": text, "insert": True,
                            "value": ch, "elemId": prev})
                prev = out[-1]["opId"]
            return out
        return ops

    rounds = []
    for i in range(3):
        ca = a.change(lambda new_id, i=i: insert(elem(100 + 40 * i), "ab")(new_id) + [
            {"opId": new_id(), "action": "addMark", "obj": text, "markType": "strong",
             "start": {"type": "before", "elemId": elem(90)},
             "end": {"type": "after", "elemId": elem(16_300)}},
        ])
        cb = b.change(lambda new_id, i=i: [
            {"opId": new_id(), "action": "del", "obj": text, "elemId": elem(16_000 - i - k)}
            for k in range(3)
        ] + [
            {"opId": new_id(), "action": "addMark", "obj": text, "markType": "comment",
             "attrs": {"id": f"c{i}"}, "start": {"type": "before", "elemId": elem(15_000)},
             "end": {"type": "before", "elemId": elem(15_050)}},
        ])
        a.saw(cb)
        b.saw(ca)
        rounds.append([ca, cb])
    chain, after = [], elem(5000)
    for i in range(11):
        doc, other = (a, b) if i % 2 == 0 else (b, a)
        c = doc.change(insert(after, str(i % 10)))
        other.saw(c)
        after = c["ops"][0]["opId"]
        chain.append(c)
    rounds.append(chain)
    return genesis, rounds


_REFS = {}


def _reference(jax_route, genesis, rounds, names):
    """TpuUniverse over the same history, once per JAX route ("scan" or
    "sorted", its default)."""
    if jax_route not in _REFS:
        saved = os.environ.pop("PERITEXT_MERGE_PATH", None)
        if jax_route == "scan":
            os.environ["PERITEXT_MERGE_PATH"] = "scan"
        try:
            ref = TpuUniverse(names)
            for batch in [[genesis]] + rounds:
                ref.apply_changes({n: batch for n in names})
        finally:
            os.environ.pop("PERITEXT_MERGE_PATH", None)
            if saved is not None:
                os.environ["PERITEXT_MERGE_PATH"] = saved
        _REFS[jax_route] = ref
    return _REFS[jax_route]


def _fields(uni):
    if isinstance(uni, TorchUniverse):
        return state_to_numpy(uni.states)
    return {f: np.asarray(getattr(uni.states, f)) for f in FIELDS}


def _port_run(route, monkeypatch):
    """The port's universe over the history on the CPU, on ``route``, with
    the capacities of the kernels' merges it ran."""
    for name in ("PERITEXT_MERGE_PATH", "PERITEXT_SORTED_MAX_ROUNDS", "PERITEXT_MERGE_WINDOW",
                 "PERITEXT_SORTED_CHUNK", "PERITEXT_FAULTS"):
        monkeypatch.delenv(name, raising=False)
    if route != "default":
        monkeypatch.setenv("PERITEXT_MERGE_PATH", route)
    kernel_merges = []
    real = port_universe.merge_step_full

    def counting(*args, **kw):
        kernel_merges.append(args[0].capacity)
        return real(*args, **kw)

    monkeypatch.setattr(port_universe, "merge_step_full", counting)
    genesis, rounds = _history()
    names = ["r0", "r1"]
    port = TorchUniverse(names, device="cpu")
    for batch in [[genesis]] + rounds:
        port.apply_changes({n: batch for n in names})
    return port, kernel_merges, genesis, rounds, names


def _assert_equal(port, ref):
    got, want = _fields(port), _fields(ref)
    for f in FIELDS:
        assert (got[f] == want[f]).all(), f"state field {f} diverged"
    assert (port.digests() == np.asarray(ref.digests())).all()
    assert port.texts() == ref.texts()
    assert port.spans_batch() == ref.spans_batch()
    assert port.stats["degraded_batches"] == 0


@pytest.mark.parametrize("route", ["default", "scan"])
def test_universe_past_16384_takes_the_kernels_and_matches_tpu_universe(route, monkeypatch):
    """Under the real limit every merge at C = 32768 runs the kernels'
    merge (their cluster form on the card), none the capacity route, and
    the states equal ``TpuUniverse``'s exact per-op merge."""
    port, kernel_merges, genesis, rounds, names = _port_run(route, monkeypatch)
    ref = _reference("scan", genesis, rounds, names)
    assert port.capacity == ref.capacity == 32768
    assert kernel_merges == [32768] * (1 + len(rounds))
    assert port.stats["capacity_routes"] == 0
    assert port.stats["scan_fallbacks"] == 0
    _assert_equal(port, ref)


@pytest.mark.parametrize("route", ["default", "scan", "sorted"])
def test_universe_grows_past_the_kernels_and_matches_tpu_universe(route, monkeypatch):
    """Past a limit lowered to 16384 (the route is taken only past C =
    131072 now) every merge takes the capacity route."""
    monkeypatch.setattr(port_universe, "kernel_capacity_limit", lambda words: 16384)
    port, kernel_merges, genesis, rounds, names = _port_run(route, monkeypatch)
    ref = _reference("scan" if route == "scan" else "sorted", genesis, rounds, names)
    assert port.capacity == ref.capacity == 32768
    # Every merge ran above the limit (the genesis grew the table first).
    assert kernel_merges == []
    merges = 1 + len(rounds)
    if route == "sorted":
        # Only the deep batch would have gone to the kernels.
        assert port.stats["capacity_routes"] == 1
        assert port.stats["scan_fallbacks"] == 0
        assert ref.stats["scan_fallbacks"] == 1
    else:
        assert port.stats["capacity_routes"] == merges
    assert port.stats["launches"] == merges
    _assert_equal(port, ref)
