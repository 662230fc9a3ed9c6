"""Test fixtures shared by the port's tests and fuzzer.

Mirrors the reference's fixtures: generateDocs (test/generateDocs.ts:11-42)
and the concurrent-write harness shape (test/micromerge.ts:46-86).  A copy
of ``peritext_tpu/testing.py`` over the port's oracle.  The environment
pins name the variables the port reads; the port's patch routes differ
from the JAX package's (the per-op loop is its default, the sorted patch
route and its window sit behind ``PERITEXT_MERGE_PATH=sorted``), so
:func:`patch_path_env` and :func:`window_env` select that route.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

from peritext_tpu_torch.oracle import Doc, accumulate_patches

DEFAULT_TEXT = "The Peritext editor"

# Every env knob that selects the patch route (``universe._merge_path`` and
# ``_patch_path``).  An honest sorted-vs-scan A/B pins ALL of these for
# each leg; keep this list in sync with universe.apply_changes_with_patches.
SCAN_FORCING_KNOBS = ("PERITEXT_PATCH_PATH", "PERITEXT_MERGE_PATH")


@contextmanager
def patch_readback_env(mode: Optional[str] = None):
    """Pin the patch-record readback format (PERITEXT_PATCH_READBACK) for
    a measurement or differential leg.

    ``mode=None`` clears the knob (the compact default becomes active
    regardless of ambient CI env); ``"planes"`` / ``"compact"`` pin that
    format.  The caller's environment is restored on exit.
    """
    saved = os.environ.get("PERITEXT_PATCH_READBACK")
    os.environ.pop("PERITEXT_PATCH_READBACK", None)
    if mode:
        os.environ["PERITEXT_PATCH_READBACK"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PERITEXT_PATCH_READBACK", None)
        else:
            os.environ["PERITEXT_PATCH_READBACK"] = saved


@contextmanager
def window_env(on: bool, min_cap: Optional[str] = None):
    """Pin the frontier-bounded window-merge knobs for one leg.

    ``on`` sets PERITEXT_MERGE_WINDOW (the windowed-vs-full A/B switch);
    ``min_cap`` optionally pins PERITEXT_MERGE_WINDOW_MIN (tests lower it
    so small documents engage).  Also selects the sorted route with the
    delta scan (:func:`patch_path_env` with no mode), where the window
    runs — a windowed leg under the default route would silently measure
    the kernels.  Restores the caller's env on exit.
    """
    saved = {
        k: os.environ.get(k)
        for k in ("PERITEXT_MERGE_WINDOW", "PERITEXT_MERGE_WINDOW_MIN")
    }
    os.environ["PERITEXT_MERGE_WINDOW"] = "1" if on else "0"
    if min_cap is not None:
        os.environ["PERITEXT_MERGE_WINDOW_MIN"] = min_cap
    try:
        with patch_path_env(None):
            yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextmanager
def patch_path_env(mode: Optional[str] = None):
    """Pin the patch route for a measurement or differential leg.

    Both modes put the universe on the sorted route
    (``PERITEXT_MERGE_PATH=sorted``): ``mode=None`` leaves the
    compact-delta mark scan in charge (``PERITEXT_PATCH_PATH`` cleared,
    whatever the ambient environment says); ``mode="scan"`` forces the
    per-op loop.  The caller's environment is restored on exit.
    """
    saved = {k: os.environ.get(k) for k in SCAN_FORCING_KNOBS}
    for k in SCAN_FORCING_KNOBS:
        os.environ.pop(k, None)
    os.environ["PERITEXT_MERGE_PATH"] = "sorted"
    if mode:
        os.environ["PERITEXT_PATCH_PATH"] = mode
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def generate_docs(
    text: str = DEFAULT_TEXT, count: int = 2
) -> Tuple[List[Doc], List[List[Dict[str, Any]]], Dict[str, Any]]:
    """N synced replicas bootstrapped from a single genesis change.

    Reference test/generateDocs.ts:11-42: doc1 originates one change holding
    makeList + the initial insert; every other replica applies it, so all
    replicas share root structure (also the initializeDocs rule,
    bridge.ts:106-120).
    """
    docs = [Doc(f"doc{i + 1}") for i in range(count)]
    patches: List[List[Dict[str, Any]]] = [[] for _ in range(count)]
    initial_change, initial_patches = docs[0].change(
        [
            {"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list(text)},
        ]
    )
    patches[0] = initial_patches
    for i in range(1, count):
        patches[i] = docs[i].apply_change(initial_change)
    return docs, patches, initial_change


def run_concurrent(
    *,
    initial_text: str = DEFAULT_TEXT,
    pre_ops: Optional[Sequence[Dict[str, Any]]] = None,
    input_ops1: Sequence[Dict[str, Any]] = (),
    input_ops2: Sequence[Dict[str, Any]] = (),
) -> Dict[str, Any]:
    """Concurrently apply two op sequences to two replicas and cross-sync.

    Reference test harness testConcurrentWrites (test/micromerge.ts:46-86).
    Returns the materialized spans from both replicas' batch codepaths and
    from both replicas' accumulated patch streams; callers assert all four
    equal the expected spans (the dual-path-equivalence invariant).
    """
    docs, patches, _ = generate_docs(initial_text)
    doc1, doc2 = docs
    patches1, patches2 = patches

    def with_path(ops: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [{**op, "path": ["text"]} for op in ops]

    if pre_ops:
        change0, p0 = doc1.change(with_path(pre_ops))
        patches1 = patches1 + p0
        patches2 = patches2 + doc2.apply_change(change0)

    change1, p1 = doc1.change(with_path(input_ops1))
    patches1 = patches1 + p1
    change2, p2 = doc2.change(with_path(input_ops2))
    patches2 = patches2 + p2

    patches2 = patches2 + doc2.apply_change(change1)
    patches1 = patches1 + doc1.apply_change(change2)

    return {
        "docs": (doc1, doc2),
        "batch1": doc1.get_text_with_formatting(["text"]),
        "batch2": doc2.get_text_with_formatting(["text"]),
        "patch1": accumulate_patches(patches1),
        "patch2": accumulate_patches(patches2),
        "patches": (patches1, patches2),
    }


def assert_converges(result: Dict[str, Any], expected: Sequence[Dict[str, Any]]) -> None:
    expected = list(expected)
    assert result["batch1"] == expected, f"doc1 batch: {result['batch1']} != {expected}"
    assert result["batch2"] == expected, f"doc2 batch: {result['batch2']} != {expected}"
    assert result["patch1"] == expected, f"doc1 patches: {result['patch1']} != {expected}"
    assert result["patch2"] == expected, f"doc2 patches: {result['patch2']} != {expected}"
