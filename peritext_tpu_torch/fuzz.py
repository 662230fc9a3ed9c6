"""Generative convergence fuzzer.

Reference: test/fuzz.ts — N replicas, random ops, random pairwise
anti-entropy syncs, asserting after every sync that (a) the accumulated patch
stream equals the batch flatten on both replicas and (b) the pair converged
(equal clocks, equal spans).  Failures serialize a full reproducible state
(queues + syncs), which :func:`peritext_tpu_torch.replay.replay_change_log` can
re-execute.

Differences from the reference fuzzer, on purpose:
- Seeded/deterministic (reference uses Math.random with no seed).
- Comment removeMark is generated *as a removeMark* with a known id.  (The
  reference's removeMarkChange constructs an addMark by mistake, fuzz.ts:78 —
  so comment removal was never actually fuzzed upstream.)  Comment-remove
  convergence holds under this engine's per-id LWW semantics.
- Also drives the engine under test via ``doc_factory`` so the same harness
  differential-tests the port's engine (``TorchDoc``, and ``TorchUniverse``
  behind the serving planes) against the oracle.

A copy of ``peritext_tpu/fuzz.py`` over the port's oracle, runtime and
engines.  Two things differ from the JAX module: the CLI's ``--platform``
is ``--device`` (``fuzz(device=)`` places the universes its serve modes
build, on the card unless told otherwise), and ``clear_caches_every`` has
no counterpart, because the port compiles nothing per shape.

    python -m peritext_tpu_torch.fuzz N SEED --engine {oracle,torch,mixed} [--device cuda]
"""
from __future__ import annotations

import itertools
import json
import math
import os
import random
from typing import Any, Callable, Dict, List, Optional

from peritext_tpu_torch.oracle import Doc, accumulate_patches
from peritext_tpu_torch.runtime.faults import FaultPlan
from peritext_tpu_torch.runtime.log import ChangeLog
from peritext_tpu_torch.runtime.sync import apply_changes
from peritext_tpu_torch.testing import generate_docs

MARK_TYPES = ["strong", "em", "link", "comment"]
EXAMPLE_URLS = [f"{c}.com" for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"]

# Delivery chaos applied by --chaos between replicas: a quarter of messages
# dropped, a fifth duplicated, a quarter held back/reordered.  Convergence is
# asserted at fault-free quiesce points (every ``chaos_quiesce`` iterations),
# where full anti-entropy from the durable log must restore byte-identical
# replicas — the paper's claim under adversarial delivery.
DEFAULT_CHAOS_SPEC = "pubsub_deliver:drop=0.25,dup=0.2,reorder=0.25"


class FuzzError(AssertionError):
    def __init__(self, message: str, state: Dict[str, Any]):
        super().__init__(message)
        self.state = state

    def save(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.state, f)


def _text_len(doc: Any) -> int:
    """Visible length of the list at path ["text"] — robust to the root
    'text' key being LWW-overwritten with a plain value (the path still
    resolves through the unpruned ``children`` entry, micromerge.ts:592-600,
    so list ops keep targeting the original device list)."""
    t = doc.root.get("text")
    if isinstance(t, list):
        return len(t)
    return sum(len(s["text"]) for s in doc.get_text_with_formatting(["text"]))


def _random_add_mark(rng: random.Random, doc: Doc, comment_history: List[str]) -> Dict[str, Any]:
    length = _text_len(doc)
    start = rng.randrange(length)
    end = start + rng.randrange(length - start) + 1
    mark_type = rng.choice(MARK_TYPES)
    op: Dict[str, Any] = {
        "path": ["text"],
        "action": "addMark",
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }
    if mark_type == "link":
        op["attrs"] = {"url": rng.choice(EXAMPLE_URLS)}
    elif mark_type == "comment":
        comment_id = f"comment-{rng.randrange(1 << 16):04x}"
        comment_history.append(comment_id)
        op["attrs"] = {"id": comment_id}
    return op


def _random_remove_mark(
    rng: random.Random, doc: Doc, comment_history: List[str], allow_comment_remove: bool
) -> Dict[str, Any]:
    length = _text_len(doc)
    start = rng.randrange(length)
    end = start + rng.randrange(length - start) + 1
    choices = [t for t in MARK_TYPES if allow_comment_remove or t != "comment"]
    mark_type = rng.choice(choices)
    op: Dict[str, Any] = {
        "path": ["text"],
        "action": "removeMark",
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }
    if mark_type == "comment":
        if not comment_history:
            op["markType"] = "strong"
        else:
            op["attrs"] = {"id": rng.choice(comment_history)}
    return op


def _random_insert(rng: random.Random, doc: Doc, max_chars: int) -> Optional[Dict[str, Any]]:
    length = _text_len(doc)
    index = rng.randrange(length) if length else 0
    num = rng.randrange(max_chars)
    values = [rng.choice("0123456789abcdef") for _ in range(num)]
    return {"path": ["text"], "action": "insert", "index": index, "values": values}


def _random_delete(rng: random.Random, doc: Doc) -> Optional[Dict[str, Any]]:
    length = _text_len(doc)
    # Faithful to the reference's bounds (fuzz.ts:128-129), which never
    # delete the entire document (a noted real bug when you do).
    index = rng.randrange(length) + 1
    count = math.ceil(rng.random() * (length - index))
    if count <= 0:
        return None
    return {"path": ["text"], "action": "delete", "index": index, "count": count}


# -- growth-biased workload --------------------------------------------------
#
# The reference-shaped ops above keep fuzz docs at 1-6 chars forever (the
# delete takes a random fraction of the WHOLE tail), so the chunk valves,
# PATCH_GROUP_K overflow fallback, capacity growth, and winner-cache
# invalidation only ever face toy documents.  The growth profile biases
# insert:delete > 1, types longer runs, occasionally pastes 100+ chars, and
# bounds deletes to editor-sized chunks, so soaked documents reach and hold
# realistic lengths while the same convergence/patch asserts run.


def _random_growth_insert(
    rng: random.Random, doc: Doc, max_chars: int
) -> Optional[Dict[str, Any]]:
    length = _text_len(doc)
    index = rng.randrange(length) if length else 0
    if rng.random() < 0.05:  # paste
        num = 100 + rng.randrange(300)
    else:
        num = 1 + rng.randrange(max_chars)
    values = [rng.choice("0123456789abcdef") for _ in range(num)]
    return {"path": ["text"], "action": "insert", "index": index, "values": values}


def _random_bounded_delete(rng: random.Random, doc: Doc) -> Optional[Dict[str, Any]]:
    length = _text_len(doc)
    if length < 2:
        return None
    index = rng.randrange(length - 1) + 1
    count = min(1 + rng.randrange(20), length - index)
    if count <= 0:
        return None
    return {"path": ["text"], "action": "delete", "index": index, "count": count}


# -- nested-object fuzzing (the host structural plane) -----------------------

_NESTED_KEYS = ["k0", "k1", "k2", "list0", "list1"]


def _discover_objects(root: Dict[str, Any]) -> Dict[str, List[List[str]]]:
    """Walk a materialized root view for nested maps and lists (public
    surface only, so the same discovery drives oracle Docs and TorchDocs).
    The root text list is excluded — the classic generators own it.  Takes
    the root snapshot rather than the doc: materializing ``doc.root`` on a
    TorchDoc costs a device text readback, so callers snapshot once."""
    maps: List[List[str]] = [[]]
    lists: List[List[str]] = []

    def walk(value: Dict[str, Any], path: List[str]) -> None:
        for key, child in value.items():
            if isinstance(child, dict):
                maps.append(path + [key])
                if len(path) < 2:
                    walk(child, path + [key])
            elif isinstance(child, list) and (path or key != "text"):
                lists.append(path + [key])

    walk(root, [])
    return {"maps": maps, "lists": lists}


def _random_structural(rng: random.Random, doc: Any) -> Optional[Dict[str, Any]]:
    """One random op against the host structural plane: create/set/del on a
    map, or insert/delete/mark on a nested list."""
    root = doc.root
    objs = _discover_objects(root)
    kind = rng.choice(["makeMap", "makeList", "set", "del", "list_edit", "list_mark"])
    if kind in ("makeMap", "makeList", "set", "del"):
        path = rng.choice(objs["maps"])
        keys = _NESTED_KEYS
        if kind in ("set", "del"):
            # Include 'text' so set/del races the device binding on the root
            # map — exactly where a stale root-view gate would hide (the
            # generators above stay robust via _text_len).
            keys = _NESTED_KEYS + ["text"]
        key = rng.choice(keys)
        if kind == "set":
            return {"path": path, "action": "set", "key": key, "value": rng.randrange(100)}
        if kind == "del":
            return {"path": path, "action": "del", "key": key}
        return {"path": path, "action": kind, "key": key}
    if not objs["lists"]:
        return None
    path = rng.choice(objs["lists"])
    # Resolve the list through the same root snapshot to bound indices.
    node: Any = root
    for p in path:
        node = node[p]
    length = len(node)
    if kind == "list_edit":
        if length and rng.random() < 0.4:
            index = rng.randrange(length)
            return {"path": path, "action": "delete", "index": index, "count": 1}
        index = rng.randrange(length + 1) if length else 0
        values = [rng.choice("uvwxyz") for _ in range(rng.randrange(2) + 1)]
        return {"path": path, "action": "insert", "index": index, "values": values}
    if length == 0:
        return None
    start = rng.randrange(length)
    end = start + rng.randrange(length - start) + 1
    mark_type = rng.choice(["strong", "em"])
    return {
        "path": path,
        "action": rng.choice(["addMark", "removeMark"]),
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }


def fuzz(
    iterations: int = 200,
    seed: int = 0,
    num_docs: int = 3,
    initial_text: str = "ABCDE",
    max_insert_chars: int = 2,
    allow_comment_remove: bool = False,
    doc_factory: Callable[[str], Any] = Doc,
    check_patches: bool = True,
    nested: bool = False,
    report_every: int = 0,
    growth: bool = False,
    growth_target: int = 2000,
    chaos: Optional[str] = None,
    chaos_quiesce: int = 8,
    serve: bool = False,
    serve_shards: int = 1,
    migrate_every: int = 0,
    evict_every: int = 0,
    device: Any = None,
) -> Dict[str, Any]:
    """Run the fuzz loop; raises :class:`FuzzError` with a replayable state.

    ``iterations=0`` runs unbounded (the reference's ``while(true)``,
    fuzz.ts:167) — stop it externally; progress lines (``report_every``) are
    the soak record.

    With ``growth``, the op mix switches to the growth-biased profile
    (3:1 insert:delete, longer runs, occasional 100-400-char pastes,
    bounded deletes) so documents reach and sustain realistic lengths —
    the regime that actually exercises capacity growth, the chunk valves,
    and group-cap fallbacks under adversarial schedules.

    With ``chaos`` (a fault spec, e.g. :data:`DEFAULT_CHAOS_SPEC`), every
    pairwise sync's deliveries run through the spec's ``pubsub_deliver``
    schedule — drops, duplicates and reorders, seeded from ``seed`` — and
    causally-unready survivors are left pending instead of asserted.  Every
    ``chaos_quiesce`` iterations a fault-free full anti-entropy pass from
    the durable log quiesces the fleet, and the standard convergence and
    patch/batch asserts must then hold for *every* replica.  An installed
    process-wide fault plan (``faults.install`` / ``PERITEXT_FAULTS``) can
    additionally inject device-launch faults, driving the engine's
    retry/degradation machinery under the same differential asserts.

    With ``serve``, the same change traffic also drives a **serving plane**
    (runtime/serve.py) fronting a TorchUniverse with one session per fuzz
    replica — session weights, priorities, the batch target and the
    deadline are drawn from the run's rng, so every seed exercises a
    different admission schedule.  Each session submits exactly what its
    doc received (local generations + deliveries, post-chaos-filter), the
    plane steps once per iteration (manual mode — deterministic), and at
    every check point the serve replicas must match the docs span-for-span
    while each session's accumulated patch stream must reconstruct its
    replica (``accumulate_patches``) — the serving-plane byte-identity
    claim under the same adversarial schedules as the engines.

    With ``migrate_every`` (sharded serve mode only), every N iterations a
    random session live-migrates to a random other shard through the full
    elastic protocol (runtime/elastic.py) — under chaos an installed fault
    plan's ``shard_migrate`` site can fail any protocol step, and the
    rollback must keep every quiesce's convergence and byte-identity
    asserts green.

    With ``evict_every`` (sharded serve mode only), every N iterations a
    random session either **evicts** — durable checkpoint, device row
    freed (runtime/lifecycle.py) — or, if already cold, **hydrates**
    back through the full crash-safe protocol.  Cold sessions whose doc
    generates traffic hydrate transparently on submit (the cold-start
    path the lifecycle exists to serve).  Under chaos an installed fault
    plan's ``doc_evict``/``doc_hydrate`` sites can fail any protocol
    step; rollback must leave a failed evict resident and a failed
    hydrate cold — the quiesce's warm-all pass retries from the durable
    checkpoint — with every convergence and byte-identity assert green.
    Combined with ``migrate_every``, migration racing eviction must
    serialize: the elastic plane refuses cold sessions and the lifecycle
    refuses parked (migrating) ones, both tolerated as skips.

    With ``nested``, a share of iterations drive the host structural plane
    (nested makeMap/makeList/set/del, second-list edits and marks) and every
    sync additionally asserts root-view and nested-list-span convergence.
    Patch/batch checking is forced off in that mode: the reference hardcodes
    ``path: ["text"]`` on every list patch (micromerge.ts:643), so a stream
    mixing lists is inherently ambiguous to accumulate — a reference quirk,
    not an engine gap (deterministic patch-interleaving coverage lives in
    tests/test_nested_objects.py).

    ``device`` places the universes the serve modes build (``None``: the
    card; a sharded plane then spans every visible card); oracle and
    ``doc_factory`` replicas are the caller's.
    """
    rng = random.Random(seed)
    if nested:
        check_patches = False
    if chaos and chaos_quiesce < 1:
        raise ValueError(f"chaos_quiesce must be >= 1, got {chaos_quiesce}")
    if migrate_every and not (serve and serve_shards > 1):
        raise ValueError("migrate_every requires serve mode with shards > 1")
    if evict_every and not (serve and serve_shards > 1):
        raise ValueError("evict_every requires serve mode with shards > 1")
    chaos_plan = FaultPlan.from_spec(chaos, seed=seed) if chaos else None
    docs, all_patches, initial_change = generate_docs(initial_text, num_docs)
    if doc_factory is not Doc:
        # Rebuild replicas with the engine under test from the genesis change.
        docs = [doc_factory(d.actor_id) for d in docs]
        all_patches = [list(apply_changes(d, [initial_change])) for d in docs]
    log = ChangeLog()
    log.record(initial_change)
    comment_history: List[str] = []
    syncs: List[Dict[str, Any]] = []

    serve_plane = None
    serve_sessions: Dict[str, Any] = {}
    lifecycle = None
    lifecycle_errors: tuple = ()
    if serve and serve_shards > 1:
        # Sharded mode (runtime/serve_shard.py): the fuzz replicas are
        # replicas of the SAME document, spread round-robin across
        # ``serve_shards`` universe shards as one ``doc`` replication
        # group — the plane's own cross-shard pubsub fan-out and
        # anti-entropy run under the same chaotic schedules as the
        # engines, and every quiesce asserts byte-identical convergence
        # across shards.
        from peritext_tpu_torch.runtime.serve_shard import ShardedServePlane

        serve_plane = ShardedServePlane(
            serve_shards,
            devices=None if device is None else [device],
            start=False,  # manual stepping keeps the fuzz deterministic
            batch_target=2 ** rng.randrange(2, 6),
            deadline_ms=float(rng.choice([1, 5, 25])),
            quantum=rng.choice([2, 4, 8]),
        )
        for d in docs:
            serve_sessions[d.actor_id] = serve_plane.session(
                f"s-{d.actor_id}",
                replica=d.actor_id,
                doc="fuzz-doc",
                weight=rng.choice([1, 2, 4]),
                priority=rng.choice(["interactive", "bulk"]),
                record_stream=check_patches,
            )
        for d in docs:
            serve_sessions[d.actor_id].submit([initial_change])
        if serve_plane.drain() != 0:
            raise RuntimeError("sharded plane failed to drain the genesis change")
        if evict_every:
            from peritext_tpu_torch.runtime.lifecycle import (
                DocLifecycle,
                EvictionError,
                HydrationError,
            )

            # Manual ticking (start=False) keeps the fuzz deterministic;
            # the evict_every block below IS the policy loop.
            lifecycle = DocLifecycle(serve_plane, start=False, keep=2)
            lifecycle_errors = (EvictionError, HydrationError)
    elif serve:
        from peritext_tpu_torch.ops.universe import TorchUniverse
        from peritext_tpu_torch.runtime.serve import ServePlane

        serve_uni = TorchUniverse([d.actor_id for d in docs], device=device)
        serve_plane = ServePlane(
            serve_uni,
            start=False,  # manual stepping keeps the fuzz deterministic
            batch_target=2 ** rng.randrange(2, 6),
            deadline_ms=float(rng.choice([1, 5, 25])),
            quantum=rng.choice([2, 4, 8]),
        )
        for d in docs:
            serve_sessions[d.actor_id] = serve_plane.session(
                f"s-{d.actor_id}",
                replica=d.actor_id,
                weight=rng.choice([1, 2, 4]),
                priority=rng.choice(["interactive", "bulk"]),
                record_stream=True,
            )
        for d in docs:
            serve_sessions[d.actor_id].submit([initial_change])
        if serve_plane.drain() != 0:
            raise RuntimeError("serving plane failed to drain the genesis change")

    def serve_submit(actor_id: str, changes) -> None:
        if serve_plane is not None and changes:
            try:
                serve_sessions[actor_id].submit(list(changes))
            except lifecycle_errors:
                # An injected doc_hydrate fault failed the transparent
                # cold-start mid-submit; the session stays cold and the
                # durable log redelivers at the next quiesce's warm-all
                # pass (rollback left nothing half-applied).
                evict_stats["cold_submit_failures"] += 1

    def serve_warm_all() -> None:
        """Hydrate every cold session before a quiesce: plane.clock()/
        spans() read the device row, and the catch-up redelivery bypasses
        the cold trap via ``._inner``.  Hydration under an installed
        fault plan can fail (``doc_hydrate`` site) — retry from the
        durable checkpoint; a session that stays cold past the budget is
        a real availability bug."""
        if lifecycle is None:
            return
        for d in docs:
            sess = serve_sessions[d.actor_id]
            for _ in range(8):
                if not sess._cold:
                    break
                try:
                    lifecycle.hydrate(f"s-{d.actor_id}")
                except lifecycle_errors:
                    continue
            else:
                fail(
                    f"session s-{d.actor_id} still cold after 8 hydration "
                    "attempts",
                    {"evict_stats": dict(evict_stats)},
                )

    def serve_check(docs_synced: bool = True) -> None:
        """Catch each serve replica up to ITS doc's clock (dedup-idempotent
        redelivery from the durable log — under chaos the session's lane
        may be missing dropped deliveries the doc will only see at
        quiesce), drain, and assert byte-identity: serve spans == doc
        spans per replica, and each session's accumulated patch stream
        reconstructs its replica.

        Sharded mode instead catches every session up to the LOG frontier
        (the plane's own cross-shard fan-out already out-runs individual
        docs), runs the plane's anti-entropy, and asserts byte-identical
        convergence ACROSS shards; the serve-vs-doc comparison only
        applies when the docs themselves are at the frontier
        (``docs_synced`` — the chaos quiesce)."""
        if serve_plane is None:
            return
        if serve_shards > 1:
            serve_warm_all()
            frontier = log.clock()
            for d in docs:
                missing = log.missing_changes(
                    frontier, serve_plane.clock(d.actor_id)
                )
                if missing:
                    # Catch-up redelivery, not client traffic: bypass the
                    # doc-group fan-out (every sibling is caught up from
                    # the same durable log on its own line — publishing
                    # the suffix N-1 more times would be O(N^2) pure
                    # duplicates through the chaos site).
                    serve_sessions[d.actor_id]._inner.submit(missing)
            serve_plane.anti_entropy()
        else:
            for d in docs:
                serve_submit(
                    d.actor_id,
                    log.missing_changes(dict(d.clock), serve_uni.clock(d.actor_id)),
                )
        leftover = serve_plane.drain()
        if leftover:
            fail(
                f"serving plane left {leftover} submission(s) undeliverable",
                {"serve_stats": dict(serve_plane.stats)},
            )
        if serve_shards > 1:
            first_spans = None
            for d in docs:
                s_spans = serve_plane.spans(d.actor_id)
                if first_spans is None:
                    first_spans = s_spans
                elif s_spans != first_spans:
                    fail(
                        f"cross-shard span divergence on {d.actor_id} "
                        f"(shard {serve_plane.shard_of(d.actor_id)})",
                        {"left": first_spans, "right": s_spans},
                    )
                if docs_synced:
                    doc_spans = d.get_text_with_formatting(["text"])
                    if s_spans != doc_spans:
                        fail(
                            f"serve/doc span divergence on {d.actor_id}",
                            {"serveDoc": s_spans, "batchDoc": doc_spans},
                        )
                if check_patches:
                    accumulated = accumulate_patches(
                        serve_sessions[d.actor_id].patch_log
                    )
                    if accumulated != s_spans:
                        fail(
                            f"serve patch/batch de-sync on {d.actor_id}",
                            {"patchDoc": accumulated, "batchDoc": s_spans},
                        )
            return
        serve_spans = serve_uni.spans_batch()
        for i, d in enumerate(docs):
            doc_spans = d.get_text_with_formatting(["text"])
            if serve_spans[i] != doc_spans:
                fail(
                    f"serve/doc span divergence on {d.actor_id}",
                    {"serveDoc": serve_spans[i], "batchDoc": doc_spans},
                )
            if check_patches:
                accumulated = accumulate_patches(
                    serve_sessions[d.actor_id].patch_log
                )
                if accumulated != serve_spans[i]:
                    fail(
                        f"serve patch/batch de-sync on {d.actor_id}",
                        {"patchDoc": accumulated, "batchDoc": serve_spans[i]},
                    )

    def fail(message: str, extra: Dict[str, Any]) -> None:
        state = {
            "queues": {a: log.changes_for(a) for a in log.actors},
            "syncs": syncs,
            **extra,
        }
        raise FuzzError(message, state)

    def check_pair(a: int, b: int) -> None:
        a_spans = docs[a].get_text_with_formatting(["text"])
        b_spans = docs[b].get_text_with_formatting(["text"])
        if check_patches:
            for side, spans in ((a, a_spans), (b, b_spans)):
                accumulated = accumulate_patches(all_patches[side])
                if accumulated != spans:
                    fail(
                        f"patch/batch de-sync on {docs[side].actor_id}",
                        {"patchDoc": accumulated, "batchDoc": spans},
                    )
        if docs[a].clock != docs[b].clock:
            fail("clock divergence", {"left": dict(docs[a].clock), "right": dict(docs[b].clock)})
        if a_spans != b_spans:
            fail("span divergence", {"left": a_spans, "right": b_spans})
        if nested:
            a_root = docs[a].root
            b_root = docs[b].root
            if a_root != b_root:
                fail(
                    "root-view divergence",
                    {"left": repr(a_root), "right": repr(b_root)},
                )
            # Marked nested lists: spans must agree too (marks are
            # invisible in the plain root view).  Reuses the snapshot
            # just compared.
            for path in _discover_objects(a_root)["lists"]:
                ls = docs[a].get_text_with_formatting(path)
                rs = docs[b].get_text_with_formatting(path)
                if ls != rs:
                    fail(
                        f"nested span divergence at {path}",
                        {"left": ls, "right": rs},
                    )

    def quiesce_and_check() -> None:
        """Fault-free full anti-entropy from the durable log, then the
        standard convergence/patch asserts for EVERY replica."""
        frontier = log.clock()
        for i, d in enumerate(docs):
            all_patches[i].extend(
                apply_changes(d, log.missing_changes(frontier, d.clock))
            )
        for i in range(1, len(docs)):
            check_pair(0, i)
        serve_check()

    done = 0
    max_doc_len = 0
    migrate_stats = {
        "attempts": 0, "migrations": 0, "rollbacks": 0, "skipped_cold": 0,
    }
    evict_stats = {
        "attempts": 0, "evictions": 0, "hydrations": 0, "rollbacks": 0,
        "skipped": 0, "cold_submit_failures": 0,
    }
    # True while chaotic syncs have happened since the last fault-free
    # quiesce (drives both the heartbeat wording and the mandatory final
    # quiesce — `done % chaos_quiesce` alone misses a no-op last iteration).
    chaos_unverified = False
    for done in itertools.count(1) if iterations == 0 else range(1, iterations + 1):
        target = rng.randrange(len(docs))
        doc = docs[target]
        if growth:
            # 3:1 insert bias until the doc reaches the sustain target,
            # then 1:2 so the soak HOLDS a realistic length indefinitely
            # (unbounded growth would slow the O(n) oracle + patch checks
            # to a crawl and stop exercising delete/valve paths).
            if _text_len(doc) < growth_target:
                kinds = ["insert", "insert", "insert", "remove", "addMark", "removeMark"]
            else:
                kinds = ["insert", "remove", "remove", "addMark", "removeMark"]
        else:
            kinds = ["insert", "remove", "addMark", "removeMark"]
        if nested:
            kinds += ["structural", "structural"]
        op_kind = rng.choice(kinds)
        if op_kind == "insert":
            op = (
                _random_growth_insert(rng, doc, max(max_insert_chars, 8) * 2)
                if growth
                else _random_insert(rng, doc, max_insert_chars)
            )
        elif op_kind == "remove":
            op = (
                _random_bounded_delete(rng, doc)
                if growth
                else _random_delete(rng, doc)
            )
        elif op_kind == "addMark":
            op = _random_add_mark(rng, doc, comment_history)
        elif op_kind == "structural":
            op = _random_structural(rng, doc)
        else:
            op = _random_remove_mark(rng, doc, comment_history, allow_comment_remove)
        if op is None:
            continue
        change, patches = doc.change([op])
        log.record(change)
        all_patches[target].extend(patches)
        serve_submit(doc.actor_id, [change])
        max_doc_len = max(max_doc_len, _text_len(doc))

        left = rng.randrange(len(docs))
        right = rng.randrange(len(docs))
        while right == left:
            right = rng.randrange(len(docs))
        syncs.append({"left": docs[left].actor_id, "right": docs[right].actor_id})

        if chaos_plan is not None:
            # Chaotic delivery: each direction's missing-changes stream runs
            # through the pubsub_deliver schedule (per-receiver holdback
            # buffers), and causal gaps are tolerated — the durable log
            # redelivers on a later sync.
            to_right = chaos_plan.filter_stream(
                "pubsub_deliver",
                log.missing_changes(docs[left].clock, docs[right].clock),
                stream=docs[right].actor_id,
            )
            to_left = chaos_plan.filter_stream(
                "pubsub_deliver",
                log.missing_changes(docs[right].clock, docs[left].clock),
                stream=docs[left].actor_id,
            )
            all_patches[right].extend(apply_changes(docs[right], to_right, allow_gaps=True))
            all_patches[left].extend(apply_changes(docs[left], to_left, allow_gaps=True))
            # The serving plane sees exactly what the docs saw (the
            # post-filter streams); causally-unready submissions defer in
            # the session lanes until redelivery makes them ready.
            serve_submit(docs[right].actor_id, to_right)
            serve_submit(docs[left].actor_id, to_left)
            if serve_plane is not None:
                serve_plane.step()
            # Convergence is only claimable at quiesce points; other
            # iterations stay chaotic and unverified.
            chaos_unverified = True
            verified = done % chaos_quiesce == 0
            if verified:
                quiesce_and_check()
                chaos_unverified = False
        else:
            to_right = log.missing_changes(docs[left].clock, docs[right].clock)
            to_left = log.missing_changes(docs[right].clock, docs[left].clock)
            all_patches[right].extend(apply_changes(docs[right], to_right))
            all_patches[left].extend(apply_changes(docs[left], to_left))
            serve_submit(docs[right].actor_id, to_right)
            serve_submit(docs[left].actor_id, to_left)
            if serve_plane is not None:
                serve_plane.step()
                if done % chaos_quiesce == 0:
                    serve_check(docs_synced=False)
            check_pair(left, right)
            verified = True
        if migrate_every and done % migrate_every == 0:
            # Live migration under fire: every N iterations a
            # random session moves to a random OTHER shard mid-stream via
            # the full elastic protocol (drain -> export -> provision ->
            # import -> commit).  Under chaos an installed fault plan's
            # ``shard_migrate`` site can fail any step — the rollback must
            # leave the source shard authoritative, and the next quiesce's
            # cross-shard convergence + byte-identity asserts hold either
            # way.
            from peritext_tpu_torch.runtime import elastic as _elastic

            victim = docs[rng.randrange(len(docs))]
            sess = serve_sessions[victim.actor_id]
            target_shard = (sess.shard + rng.randrange(1, serve_shards)) % serve_shards
            migrate_stats["attempts"] += 1
            try:
                _elastic.migrate_session(serve_plane, f"s-{victim.actor_id}", target_shard)
                migrate_stats["migrations"] += 1
            except _elastic.MigrationError:
                migrate_stats["rollbacks"] += 1
            except ValueError:
                if not evict_every:
                    raise
                # Migration racing eviction: the elastic plane refuses an
                # evicted (cold) session outright — the defined
                # serialization with the lifecycle, not a failure.
                migrate_stats["skipped_cold"] += 1
        if evict_every and done % evict_every == 0:
            # Multi-tenant lifecycle under fire: every N
            # iterations a random session either evicts (durable
            # checkpoint + device row freed) or, if already cold,
            # hydrates back through the full crash-safe protocol
            # (runtime/lifecycle.py).  Under chaos an installed fault
            # plan's doc_evict/doc_hydrate sites can fail any step — a
            # failed evict rolls back resident, a failed hydrate stays
            # cold for the quiesce's warm-all retry, and the convergence
            # + byte-identity asserts must hold either way.
            victim = docs[rng.randrange(len(docs))]
            vsess = serve_sessions[victim.actor_id]
            evict_stats["attempts"] += 1
            try:
                if vsess._cold:
                    lifecycle.hydrate(f"s-{victim.actor_id}")
                    evict_stats["hydrations"] += 1
                else:
                    lifecycle.evict(f"s-{victim.actor_id}")
                    evict_stats["evictions"] += 1
            except lifecycle_errors:
                evict_stats["rollbacks"] += 1
            except ValueError:
                # Racing a live migration (parked session): the
                # lifecycle serializes by refusing, not deadlocking.
                evict_stats["skipped"] += 1
        # Progress AFTER the iteration's checks: a soak line only claims
        # "ok" for iterations that actually converged — chaotic
        # non-quiesce iterations still emit a heartbeat (a wedged soak must
        # stay distinguishable from a slow one) but say so.
        if report_every and done % report_every == 0:
            length = sum(
                len(s["text"]) for s in docs[0].get_text_with_formatting(["text"])
            )
            if verified:
                print(f"fuzz: {done} iterations ok, doc length {length}", flush=True)
            else:
                print(
                    f"fuzz: {done} iterations (chaotic; convergence pending "
                    f"next quiesce), doc length {length}",
                    flush=True,
                )

    if chaos_plan is not None and chaos_unverified:
        # Final quiesce: the run must never end on unchecked chaotic
        # iterations (or with deliveries still in the holdback buffers) —
        # a success return means every replica converged at the end.
        quiesce_and_check()
    elif chaos_plan is None:
        # The serving plane must end drained and byte-identical too.
        serve_check(docs_synced=False)

    # Windowed-merge engagement across every device-backed replica (the
    # frontier-bounded path): aggregated TorchUniverse stats, so a
    # growth run's footer can report how often edits stayed O(window).
    window_stats = {"launches": 0, "windowed_launches": 0, "window_fallbacks": 0}
    for d in docs:
        uni = getattr(d, "_uni", None)
        if uni is not None:
            for k in window_stats:
                window_stats[k] += int(uni.stats.get(k, 0))

    return {
        "docs": docs,
        "log": log,
        "patches": all_patches,
        "iterations": done,
        "max_doc_len": max_doc_len,
        "window_stats": window_stats,
        "final_spans": docs[0].get_text_with_formatting(["text"]),
        "serve_stats": dict(serve_plane.stats) if serve_plane is not None else None,
        "migrate_stats": migrate_stats if migrate_every else None,
        "evict_stats": dict(evict_stats, lifecycle=dict(lifecycle.stats))
        if evict_every
        else None,
    }


def _main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Convergence fuzzer (reference: test/fuzz.ts). "
        "iters=0 runs unbounded, like the reference's while(true)."
    )
    parser.add_argument("iters", nargs="?", type=int, default=1000)
    parser.add_argument("seed", nargs="?", type=int, default=0)
    parser.add_argument(
        "--engine", choices=["oracle", "torch", "mixed"], default="oracle",
        help="doc factory under test (torch = all TorchDoc; mixed = alternating "
        "oracle/TorchDoc replicas — the strongest cross-engine differential)",
    )
    parser.add_argument("--nested", action="store_true", help="also fuzz nested objects")
    parser.add_argument(
        "--serve", action="store_true",
        help="also drive the serving plane (runtime/serve.py): one session "
        "per replica with rng-drawn weights/priorities/deadlines, stepped "
        "per iteration, byte-identity asserted at every check point",
    )
    parser.add_argument(
        "--shards", type=int, default=1,
        help="with --serve: partition the sessions across this many "
        "universe shards (runtime/serve_shard.py) as one cross-shard "
        "document group — the plane's pubsub fan-out + anti-entropy run "
        "under the same chaotic delivery, and every quiesce asserts "
        "byte-identical convergence across shards",
    )
    parser.add_argument(
        "--migrate-every", type=int, default=0, metavar="N",
        help="with --serve --shards K: live-migrate a random session to a "
        "random other shard every N iterations via the full elastic "
        "protocol (runtime/elastic.py); under --chaos a fault plan's "
        "shard_migrate site can fail any step and the rollback must keep "
        "every quiesce's convergence + byte-identity asserts green "
        "(0 = never)",
    )
    parser.add_argument(
        "--evict-every", type=int, default=0, metavar="N",
        help="with --serve --shards K: every N iterations a random session "
        "evicts (durable checkpoint, device row freed) or hydrates back "
        "through the full lifecycle protocol (runtime/lifecycle.py); cold "
        "sessions also hydrate transparently on submit; under --chaos a "
        "fault plan's doc_evict/doc_hydrate sites can fail any step and "
        "rollback must keep every quiesce's convergence + byte-identity "
        "asserts green (0 = never)",
    )
    parser.add_argument(
        "--chaos", nargs="?", const=DEFAULT_CHAOS_SPEC, default=None, metavar="SPEC",
        help="chaotic delivery between replicas (fault spec; bare flag uses "
        f"{DEFAULT_CHAOS_SPEC!r}); convergence asserted at fault-free "
        "quiesce points",
    )
    parser.add_argument(
        "--chaos-quiesce", type=int, default=8,
        help="iterations between fault-free quiesce/assert passes under --chaos",
    )
    parser.add_argument(
        "--growth", action="store_true",
        help="growth-biased op profile: docs reach/sustain 1k+ chars "
        "(exercises capacity growth, chunk valves, group-cap fallbacks)",
    )
    parser.add_argument(
        "--growth-target", type=int, default=2000,
        help="doc length the growth profile sustains (insert-biased below, "
        "delete-biased above)",
    )
    parser.add_argument(
        "--report-every", type=int, default=1000,
        help="progress line every N iterations (0 = silent)",
    )
    parser.add_argument(
        "--trace-dir", default="traces", help="where failure traces are written"
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device of the TorchDocs (--engine torch/mixed) and of the "
        "serving planes' universes (default: the card; 'cpu' runs the "
        "kernels' plain versions)",
    )
    args = parser.parse_args()

    if args.engine in ("torch", "mixed"):
        from peritext_tpu_torch.ops.doc import TorchDoc

        def torch_doc(actor_id: str) -> Any:
            return TorchDoc(actor_id, device=args.device)

        if args.engine == "mixed":
            flip = itertools.cycle([torch_doc, Doc])

            def factory(actor_id: str) -> Any:
                return next(flip)(actor_id)

        else:
            factory: Callable[[str], Any] = torch_doc
    else:
        factory = Doc
    if args.chaos or args.serve:
        # Chaos/serve runs are self-describing: the registry collects the
        # mirrored fault tallies (faults.<site>.<key>) plus the resilience
        # counters, and the run prints one summary line at the end —
        # PERITEXT_TRACE/PERITEXT_METRICS additionally activate the tracer
        # and the exit dump as usual.
        from peritext_tpu_torch.runtime import telemetry

        telemetry.enable()
    try:
        result = fuzz(
            iterations=args.iters,
            seed=args.seed,
            doc_factory=factory,
            nested=args.nested,
            report_every=args.report_every,
            growth=args.growth,
            growth_target=args.growth_target,
            chaos=args.chaos,
            chaos_quiesce=args.chaos_quiesce,
            serve=args.serve or args.shards > 1,
            serve_shards=args.shards,
            migrate_every=args.migrate_every,
            evict_every=args.evict_every,
            device=args.device,
        )
    except FuzzError as err:
        path = os.path.join(args.trace_dir, f"fail-seed{args.seed}.json")
        err.save(path)
        if args.chaos or args.serve:
            _print_telemetry_summary()
        print(f"FAILED: {err}; trace written to {path}")
        raise
    if args.chaos or args.serve:
        _print_telemetry_summary()
    print(
        f"ok: {result['iterations']} iterations, final doc length "
        f"{sum(len(s['text']) for s in result['final_spans'])}"
    )
    if result.get("migrate_stats"):
        ms = result["migrate_stats"]
        print(
            f"migrate: {ms['migrations']}/{ms['attempts']} sessions moved "
            f"live ({ms['rollbacks']} rolled back, {ms['skipped_cold']} "
            f"skipped cold)",
            flush=True,
        )
    if result.get("evict_stats"):
        es = result["evict_stats"]
        lc = es["lifecycle"]
        print(
            f"lifecycle: {es['evictions']} evicted / {es['hydrations']} "
            f"explicitly hydrated over {es['attempts']} attempts "
            f"({es['rollbacks']} rolled back, {es['skipped']} skipped racing "
            f"migration, {es['cold_submit_failures']} cold submits failed "
            f"over to quiesce); protocol totals: "
            f"{lc['evictions']} evictions, {lc['hydrations']} hydrations, "
            f"{lc['corrupt_fallbacks']} corrupt fallbacks, "
            f"{lc['full_replays']} full replays, "
            f"{lc['replayed_changes']} changes replayed",
            flush=True,
        )
    if args.growth:
        ws = result["window_stats"]
        engaged = (
            100.0 * ws["windowed_launches"] / ws["launches"]
            if ws["launches"]
            else 0.0
        )
        print(
            f"growth: sustained {sum(len(s['text']) for s in result['final_spans'])} "
            f"chars (max {result['max_doc_len']}), windowed merge "
            f"{ws['windowed_launches']}/{ws['launches']} launches "
            f"({engaged:.0f}%), census fallbacks {ws['window_fallbacks']}",
            flush=True,
        )


def _print_telemetry_summary() -> None:
    import json

    from peritext_tpu_torch.runtime import health, slo, telemetry

    summary = telemetry.summary()
    summary.pop("slo", None)  # the dedicated slo: line below supersedes it
    # Causal health rides along with the tallies: the e2e latency
    # percentiles appear whenever the engine under test fed them (TorchDoc /
    # queue / pubsub seams), and the flight-recorder counts are always
    # stated — a soak that silently overwrote its ring is a soak whose
    # post-mortem window shrank, which the operator should see.
    rec_n, rec_dropped = telemetry.recorder_stats()
    summary.setdefault("recorder_events", rec_n)
    summary.setdefault("recorder_dropped", rec_dropped)
    # The serving-plane tallies get their own diffable line (the admission/
    # batching/shed behavior of a --serve run, incl. the admit-to-applied
    # percentiles riding in the e2e block above).
    serve_summary = summary.pop("serve", None)
    print("telemetry: " + json.dumps(summary, sort_keys=True), flush=True)
    if serve_summary:
        print("serve: " + json.dumps(serve_summary, sort_keys=True), flush=True)
    health_summary = health.summary()
    if health_summary:
        print("health: " + json.dumps(health_summary, sort_keys=True), flush=True)
    # SLO verdicts get their own diffable footer line whenever a
    # PERITEXT_SLO plan was active for the run.
    slo_summary = slo.summary()
    if slo_summary:
        print("slo: " + json.dumps(slo_summary, sort_keys=True), flush=True)


if __name__ == "__main__":
    _main()
