"""The resident cell, ``essay-c16k-x4.resident``, at a small size on a mesh
of four ``"cpu"`` entries: a sound run is correct and reports what its
readers read; the reference's control in the program's place, and each of
four faults planted in the mesh path (one card's merge left out, one
card's digests read from its state before the last merge, one character
altered on the last card, the global digest left unreduced), are not."""
from __future__ import annotations

import numpy as np
import pytest

import peritext_tpu_torch.ops.universe as universe_mod
import peritext_tpu_torch.parallel.mesh as mesh_mod
from peritext_tpu_torch.ops.state import FIELDS, DocState
from portbench import core
from portbench.control import ControlUniverse
from portbench.reference.digest import attr_numbers, digest
from portbench.run import run_cell

NAME = "essay-c16k-x4.resident"
SMALL = ({"replicas": 64, "doc_len": 120, "capacity": 256, "max_mark_ops": 32, "ops_per_round": 16,
          "span_samples": 8}, {"rounds": 2})
SEED = 2**31 + 12345


def small_cell():
    cell = core.load_cell(NAME)
    cell["config"].update(SMALL[0])
    cell["traffic"].update(SMALL[1])
    return cell


class ControlFleet(ControlUniverse):
    """The control with the digests the driver reads: the reference's
    digest of each replica's control spans, attribute dicts numbered in
    the order the program interns them (first seen, replica by replica),
    and their sum as the global digest."""

    def __init__(self, names, cfg):
        super().__init__(names, cfg)
        self.numbers = {}
        self.global_digest = None

    def apply_changes(self, per_replica) -> None:
        for key in attr_numbers([c for changes in per_replica for c in changes]):
            self.numbers.setdefault(key, len(self.numbers))
        super().apply_changes(per_replica)

    def digests(self) -> np.ndarray:
        out = np.array([digest(self._read(r), self.numbers) for r in range(len(self.replica_ids))], np.uint32)
        self.global_digest = int(out.sum(dtype=np.uint64)) & 0xFFFFFFFF
        return out


def _with_group(new, old, k: int):
    """``new`` with replica group ``k``'s shards taken from ``old``."""
    shards = new.shards.copy()
    shards[k, :] = old.shards[k, :]
    return mesh_mod.ShardedTensor(new.mesh, new.spec, shards, new.shape)


def _last_group_from(new: DocState, old: DocState) -> DocState:
    return DocState(**{f: _with_group(getattr(new, f), getattr(old, f), -1) for f in FIELDS})


def _plant(monkeypatch, what: str) -> None:
    real_merge, real_digests = universe_mod.sharded_merge_step, mesh_mod.group_digests
    before: list = [None]  # the last merge's input state

    def left_out(states, *args):
        return _last_group_from(real_merge(states, *args), states)

    def merge_keeping_input(states, *args):
        before[0] = states
        return real_merge(states, *args)

    def stale(states, ranks, multi):
        return real_digests(_last_group_from(states, before[0]), ranks, multi)

    def altered(states, *args):
        out = real_merge(states, *args)
        row = out.length.shards[-1, 0][0]
        visible = (~out.deleted.shards[-1, 0][0, :row]).nonzero()
        if len(visible):
            out.chars.shards[-1, 0][0, int(visible[0])] += 1
        return out

    def unreduced(states, ranks, multi):
        groups, _ = real_digests(states, ranks, multi)
        return groups, groups[0].sum() & 0xFFFFFFFF

    if what == "stale":
        monkeypatch.setattr(universe_mod, "sharded_merge_step", merge_keeping_input)
        monkeypatch.setattr(mesh_mod, "group_digests", stale)
    elif what == "unreduced":
        monkeypatch.setattr(mesh_mod, "group_digests", unreduced)
    else:
        monkeypatch.setattr(universe_mod, "sharded_merge_step", left_out if what == "left_out" else altered)


def test_sound_run_is_correct():
    out = run_cell(small_cell(), SEED, 0.5, False, "cpu")
    line, rec = out["line"], out["rec"]
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"digest_mismatch_replicas", "global_digest_mismatch", "text_mismatch_replicas",
                                   "span_mismatch_replicas", "workloads_unchecked", "home_gather_bytes"}
    assert rec["attempted"] >= 2 and rec["delivered_ops"] > 0
    assert set(line["metrics"]) == {"setup_s"}  # the device's rate is read on the cards alone


def test_traced_run_reads_its_layers():
    out = run_cell(small_cell(), SEED + 1, 0.5, True, "cpu")
    line, layers = out["line"], out["rec"]["layers"]
    assert line["correct"], line["checks"]
    merges = 1 + SMALL[1]["rounds"] + 1  # the genesis, the rounds, the all-to-all
    assert layers["traced_merges"] == 2 * merges and layers["merges"] == 4 * 2 * merges
    # Per digest (one an epoch), three cards' sums of 8 B reach the first card; the merges move nothing.
    assert layers["p2p_bytes"] == 2 * 3 * 8
    assert len(layers["digest_s"]) == 2 and all(s > 0 for s in layers["digest_s"])
    metrics = line["metrics"]
    assert metrics["cross_card_mb_per_merge.resident"]["value"] == pytest.approx(48 / 1e6 / 8)
    assert metrics["digest_ms_per_epoch.resident"]["value"] > 0
    assert metrics["ingest_host_ms_per_merge.resident"]["value"] > 0


def test_control_in_the_programs_place_is_not_correct():
    line = run_cell(small_cell(), SEED, 0.5, False, "cpu", program=ControlFleet)["line"]
    assert not line["correct"]
    checks = line["checks"]
    assert checks["digest_mismatch_replicas"]["value"] > 0 and checks["span_mismatch_replicas"]["value"] > 0


@pytest.mark.parametrize("what, caught_by", [("left_out", "text_mismatch_replicas"),
                                             ("stale", "digest_mismatch_replicas"),
                                             ("altered", "text_mismatch_replicas"),
                                             ("unreduced", "global_digest_mismatch")])
def test_planted_fault_in_the_mesh_path_is_not_correct(what, caught_by, monkeypatch):
    _plant(monkeypatch, what)
    line = run_cell(small_cell(), SEED, 0.5, False, "cpu")["line"]
    assert not line["correct"] and line["checks"][caught_by]["value"] > 0, line["checks"]
