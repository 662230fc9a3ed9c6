"""The three splice modes of the port's sorted placement
(``sorted_merge._SPLICE_MODE``: "sort", "scatter", "roll") against the JAX
package's ``kernels._SPLICE_MODE`` under the same mode, byte for byte.

Each mode is held against JAX's on ``place_text_batch``,
``merge_step_sorted_batch``, ``merge_step_sorted_windowed_batch`` and
``merge_step_sorted_patched_batch`` (every state field, the window's
verdict and planes, the patch records), over three workloads: the seeded
workload of ``tests/test_sorted_merge.py``'s splice test (seed 11), an
insert-run-heavy batch, and a capacity-tight batch that overfills C.  The
JAX package reads its mode at trace time, so each switch clears JAX's
caches and the calls retrace.  Tolerance is 0: every field is an integer
or bool.  A bad ``PERITEXT_SPLICE`` raises at import, in a subprocess.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ops import TpuUniverse
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops import window as JW
from peritext_tpu.ops.encode import prepare_sorted_batch, split_rows
from peritext_tpu.oracle import Doc
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu_torch import state_to_numpy
from peritext_tpu_torch.bench.workloads import insert_heavy_text_ops
from peritext_tpu_torch.ops import sorted_merge
from peritext_tpu_torch.ops import sorted_patched as SP
from peritext_tpu_torch.ops.state import DocState, state_from_numpy

REPO = Path(__file__).resolve().parents[1]
FIELDS = [f.name for f in dataclasses.fields(DocState)]
MODES = ("sort", "scatter", "roll")
WORKLOADS = ("seed11", "insert_runs", "capacity_tight")


@pytest.fixture
def splice(monkeypatch):
    """Set both packages' splice mode; JAX's jitted merges retrace."""

    def set_mode(mode):
        monkeypatch.setattr(JK, "_SPLICE_MODE", mode)
        monkeypatch.setattr(sorted_merge, "_SPLICE_MODE", mode)
        jax.clear_caches()

    yield set_mode
    monkeypatch.undo()
    jax.clear_caches()


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _port_state(jax_state):
    return state_from_numpy({f: np.asarray(getattr(jax_state, f)) for f in FIELDS}, device="cpu")


def _assert_fields(ref, got, context):
    got = state_to_numpy(got)
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        assert got[f].dtype == want.dtype and got[f].shape == want.shape, f"{context}: {f}"
        assert (got[f] == want).all(), f"{context}: field {f} diverged"


def _workload(name):
    """``(jax states, text_ops, round_of, num_rounds, mark_ops, ranks,
    char_buf, maxk)`` as numpy, three or six replicas."""
    if name == "seed11":
        wl = make_merge_workload(doc_len=60, ops_per_merge=24, num_streams=3, with_marks=True, seed=11)
        b = build_device_batch(wl, num_replicas=3, capacity=128, max_mark_ops=64)
        sp = prepare_sorted_batch([np.asarray(b["text_ops"][r]) for r in range(3)], max_run=0)
        return (b["states"], sp["text"], sp["rounds"], sp["num_rounds"], np.asarray(b["mark_ops"]),
                np.asarray(b["ranks"]), sp["bufs"], sp["maxk"])
    # Random rows (a quarter each of pads, inserts, deletes and runs of up
    # to 64 chars; HEAD, absent and live references) in three rounds.
    # "insert_runs" has room for them; "capacity_tight" leaves a little
    # over one round's worth, so most replicas overfill C.
    seed, capacity = (3, 512) if name == "insert_runs" else (1, 160)
    wl = make_merge_workload(doc_len=100, ops_per_merge=24, num_streams=4, with_marks=True, seed=seed)
    b = build_device_batch(wl, num_replicas=6, capacity=capacity, max_mark_ops=64)
    ops, char_buf = insert_heavy_text_ops(np.random.default_rng(seed), _port_state(b["states"]), 24, 128)
    rounds = np.random.default_rng(seed + 7).integers(0, 3, size=ops.shape[:2]).astype(np.int32)
    return (b["states"], ops.numpy(), rounds, 3, np.asarray(b["mark_ops"]), np.asarray(b["ranks"]),
            char_buf.numpy(), 64)


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("mode", MODES)
def test_place_text_batch_matches_jax(splice, mode, name):
    """The placement alone: element planes, orig-index plane and length."""
    st, ops, rounds, nr, _, ranks, buf, maxk = _workload(name)
    splice(mode)
    ref = jax.vmap(
        lambda ec, ea, dl, ch, ln, t, ro, b: JK.place_text_batch(
            ec, ea, dl, ch, ln, t, ro, jnp.int32(nr), jnp.asarray(ranks), b, maxk)
    )(st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, jnp.asarray(ops), jnp.asarray(rounds),
      jnp.asarray(buf))
    pst = _port_state(st)
    got = sorted_merge.place_text_batch(
        pst.elem_ctr, pst.elem_act, pst.deleted, pst.chars, pst.length, _port(ops), _port(rounds), nr,
        _port(ranks), _port(buf), maxk,
    )
    for i, (want, out) in enumerate(zip(ref, got)):
        want, out = np.asarray(want), out.numpy()
        assert out.dtype == want.dtype and (out == want).all(), f"{mode}/{name}: plane {i}"
    if name == "capacity_tight":
        assert (got[-1] > st.elem_ctr.shape[1]).any()  # overfilled C


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("mode", MODES)
def test_merge_step_sorted_batch_matches_jax(splice, mode, name):
    """The whole sorted merge (placement and mark phase), all 13 fields."""
    st, ops, rounds, nr, marks, ranks, buf, maxk = _workload(name)
    splice(mode)
    args = (ops, rounds, nr, marks, ranks, buf, maxk)
    ref = JK.merge_step_sorted_batch(st, *map(_jax, args))
    got = sorted_merge.merge_step_sorted_batch(_port_state(st), *map(_port, args))
    _assert_fields(ref, got, f"{mode}/{name}")


@pytest.mark.parametrize("mode", MODES)
def test_windowed_batch_matches_jax(splice, mode):
    """The windowed merge on a 400-char document with one edit planned
    into a window: states, the device verdict and the window planes."""
    genesis_doc = Doc("alice")
    genesis, _ = genesis_doc.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("windowed splice! " * 24)},
    ])
    tpu = TpuUniverse(["r1", "r2"], capacity=1024, max_mark_ops=64)
    tpu.apply_changes({r: [genesis] for r in ("r1", "r2")})
    local = Doc("bob")
    local.apply_change(genesis)
    edit, _ = local.change([
        {"path": ["text"], "action": "insert", "index": 300, "values": list("xyz")},
        {"path": ["text"], "action": "insert", "index": 310, "values": list("run of chars")},
        {"path": ["text"], "action": "addMark", "startIndex": 298, "endIndex": 305, "markType": "em"},
        {"path": ["text"], "action": "delete", "index": 296, "count": 2},
    ])
    prep = tpu._prepare([[edit], [edit]])
    g = prep["groups"][0]
    text_rows, mark_rows = split_rows(g["rows"])
    plan = JW.plan_windows(tpu._mirrors(), [g["rows"]] * 2, [g["inserts"]] * 2, tpu._ranks_host(),
                           tpu.capacity, 64)
    assert plan is not None
    sp = prepare_sorted_batch([text_rows] * 2, max_run=0)
    args = (plan["starts"], plan["hulls"], sp["text"], sp["rounds"], sp["num_rounds"],
            np.stack([mark_rows] * 2), tpu._ranks_host(), sp["bufs"], sp["maxk"], plan["w_cap"])
    splice(mode)
    ref, ref_rec = JK.merge_step_sorted_windowed_batch(tpu.states, *map(_jax, args))
    got, rec = sorted_merge.merge_step_sorted_windowed_batch(_port_state(tpu.states), *map(_port, args))
    assert np.asarray(ref_rec["wok"]).all()
    assert sorted(rec) == sorted(ref_rec)
    for k, v in rec.items():
        want = np.asarray(ref_rec[k])
        assert v.numpy().dtype == want.dtype and (v.numpy() == want).all(), k
    _assert_fields(ref, got, f"{mode}/windowed")


@pytest.mark.parametrize("name", ("seed11", "insert_runs"))
@pytest.mark.parametrize("mode", MODES)
def test_patched_sorted_batch_matches_jax(splice, mode, name):
    """The patched sorted merge (delta scan, compact readback): states and
    every patch record.  Text and mark rows interleave in delivery order."""
    st, ops, rounds, nr, marks, ranks, buf, maxk = _workload(name)
    text_pos = np.where(ops[..., JK.K_KIND] != JK.KIND_PAD,
                        2 * np.arange(ops.shape[1])[None, :], 1 << 30).astype(np.int32)
    n_valid = (marks[..., JK.K_KIND] == JK.KIND_MARK).sum(axis=1)
    mark_time = np.where(np.arange(marks.shape[1])[None, :] < n_valid[:, None],
                         2 * np.arange(marks.shape[1])[None, :] + 1, 1 << 30).astype(np.int32)
    args = (ops, rounds, nr, marks, ranks, buf, allow_multiple_array(), text_pos, mark_time, maxk)
    kw = dict(readback="compact", span_cap=8, cand_cap=64)
    splice(mode)
    ref_st, ref = JK.merge_step_sorted_patched_batch(st, *map(_jax, args), mode="delta", **kw)
    got_st, rec = SP.merge_step_sorted_patched_batch(_port_state(st), *map(_port, args), **kw)
    _assert_fields(ref_st, got_st, f"{mode}/{name}/patched")
    assert sorted(rec) == sorted(ref)
    for k, v in ref.items():
        want = np.asarray(jax.device_get(v))
        g = rec[k].numpy()
        if want.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == want.shape and (g == want.astype(g.dtype)).all(), f"{mode}/{name}: record {k}"


def test_bad_splice_mode_raises_at_import():
    env = dict(os.environ, PERITEXT_SPLICE="bitonic", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", "import peritext_tpu_torch.ops.sorted_merge"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "ValueError: PERITEXT_SPLICE='bitonic': must be 'sort', 'scatter' or 'roll'" in proc.stderr
