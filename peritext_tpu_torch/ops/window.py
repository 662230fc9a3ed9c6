"""Host-side window census for the frontier-bounded merge.

The port's copy of ``peritext_tpu/ops/window.py``, bound to the port's op
layout (``ops/kernels.py``) and ``encode.bucket_length``; it is numpy only
and gives the same plans.

Computes, per replica and per gated batch, the contiguous element window
[lo, hi] that the batch's device merge can possibly read or write — the
window conditions (i)-(iv) documented on the kernel side
(``peritext_tpu/ops/kernels.py``, "Frontier-bounded window merge").  Inputs are the
universe's *causal mirror*: per-replica numpy copies of the committed
element ids, tombstone flags and boundary definedness, themselves read
back from device state (never host-replayed), so the census reasons about
ground truth.

The census is deliberately conservative: whenever it cannot bound an op —
a reference id it cannot find, an empty (genesis) document — it returns
None and the universe takes the full-table path.  The kernel additionally
re-verifies membership on device (sorted_merge._window_ok), so even a census
bug degrades to a relaunch, never to corruption.

Cost: a handful of O(n) vectorized numpy passes per (replica, batch) plus
O(ops) python — host work stays proportional to the document the way a
memcpy is, while the device merge drops from O(capacity) to O(window).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.encode import bucket_length

Mirror = Dict[str, np.ndarray]  # keys: ctr, act, deleted, bnd_def


def make_mirror(
    ctr: np.ndarray, act: np.ndarray, deleted: np.ndarray, bnd_def: np.ndarray
) -> Mirror:
    return {
        "ctr": np.ascontiguousarray(ctr, np.int32),
        "act": np.ascontiguousarray(act, np.int32),
        "deleted": np.ascontiguousarray(deleted, bool),
        "bnd_def": np.ascontiguousarray(bnd_def, bool),
    }


def _id_keys(ctr: np.ndarray, act: np.ndarray) -> np.ndarray:
    """Order-irrelevant lookup keys: (ctr, actor-id) packed into int64."""
    return (ctr.astype(np.int64) << 32) | act.astype(np.int64)


def _cmp_keys(ctr: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """RGA comparison keys: (ctr, actor-RANK) packed into int64 — the skip
    rule's lexicographic id order (kernels._rga_insert_position)."""
    return (ctr.astype(np.int64) << 32) | rank.astype(np.int64)


def _skip_stop(m: Mirror, ranks: np.ndarray, start: int, id_min: int) -> int:
    """First position j >= start where the element id does NOT exceed
    ``id_min`` — the furthest any batch insert's skip run can reach
    (micromerge.ts:630-635 with the smallest batch id).  Chunked scan with
    comparison keys built per chunk: O(run + 64), not O(document)."""
    ctr, act = m["ctr"], m["act"]
    n = ctr.shape[0]
    j = start
    while j < n:
        sl = slice(j, j + 64)
        keys = _cmp_keys(ctr[sl], ranks[act[sl]])
        hit = np.flatnonzero(keys <= id_min)
        if hit.size:
            return j + int(hit[0])
        j += keys.shape[0]
    return n


class _Lookup:
    """Position lookup over a mirror's element ids.

    Small batches (the windowed path's bread and butter: a handful of
    distinct references) use one memoized vectorized scan per distinct id
    — O(n) at memcpy speed, no O(n log n) sort.  Batches with many
    distinct references amortize an argsort + binary searches instead."""

    _SCAN_LIMIT = 16

    def __init__(self, m: Mirror, expected_queries: int):
        self.m = m
        self.sorted = expected_queries > self._SCAN_LIMIT
        self.memo: Dict[Tuple[int, int], int] = {}
        if self.sorted:
            keys = _id_keys(m["ctr"], m["act"])
            self.order = np.argsort(keys, kind="stable")
            self.skeys = keys[self.order]

    def pos(self, ctr: int, act: int) -> int:
        key = (int(ctr), int(act))
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        if self.sorted:
            q = (key[0] << 32) | key[1]
            i = int(np.searchsorted(self.skeys, q))
            p = (
                int(self.order[i])
                if i < self.skeys.shape[0] and self.skeys[i] == q
                else -1
            )
        else:
            idx = np.flatnonzero(
                (self.m["ctr"] == key[0]) & (self.m["act"] == key[1])
            )
            p = int(idx[0]) if idx.size else -1
        self.memo[key] = p
        return p


def replica_window(
    m: Mirror, rows: np.ndarray, ranks: np.ndarray
) -> Optional[Tuple[int, int]]:
    """Contiguous window hull [lo, hi] (element coords, inclusive) for one
    replica's gated op rows, or None when the census cannot bound it
    (genesis, an unresolvable reference).  ``rows`` are the PRE-fusion
    encoded rows in causal order; ``ranks`` the interned-actor rank table.
    """
    n = int(m["ctr"].shape[0])
    if rows.shape[0] == 0:
        return (0, -1)  # empty hull: the windowed launch passes through
    if n == 0:
        return None  # genesis: full-table path

    kinds = rows[:, K.K_KIND]
    is_ins = kinds == K.KIND_INSERT
    lookup = _Lookup(m, expected_queries=int(rows.shape[0]))
    dpos = np.flatnonzero(m["bnd_def"])

    def def_at_or_before(slot: int) -> int:
        i = int(np.searchsorted(dpos, slot, side="right")) - 1
        return int(dpos[i]) if i >= 0 else -1

    ins_rows = rows[is_ins]
    if ins_rows.shape[0]:
        id_min = int(
            _cmp_keys(ins_rows[:, K.K_CTR], ranks[ins_rows[:, K.K_ACT]]).min()
        )
    else:
        id_min = 0

    los: List[int] = []
    his: List[int] = []

    def add(lo: int, hi: int) -> None:
        los.append(max(0, lo))
        his.append(min(n - 1, max(hi, lo)))

    # Batch-created ids -> the interval index of their chain's root insert,
    # so later anchors on batch elements inherit a sound position range.
    created: Dict[Tuple[int, int], int] = {}
    # memoized per-anchor skip stops (same ref => same far stop with id_min)
    stop_memo: Dict[int, int] = {}

    for row in rows:
        kind = int(row[K.K_KIND])
        if kind == K.KIND_INSERT:
            rc, ra = int(row[K.K_REF_CTR]), int(row[K.K_REF_ACT])
            key = (int(row[K.K_CTR]), int(row[K.K_ACT]))
            if (rc, ra) in created:
                created[key] = created[(rc, ra)]
                continue  # chained: covered by its root's interval
            if rc == 0 and ra == 0:
                a = -1
            else:
                a = lookup.pos(rc, ra)
                if a < 0:
                    return None  # unresolvable reference: full path
            stop = stop_memo.get(a)
            if stop is None:
                stop = _skip_stop(m, ranks, a + 1, id_min)
                stop_memo[a] = stop
            lo = max(a, 0)
            # Inherited-marks source: the nearest defined slot left of the
            # insertion gap (gap slots are >= 2a+2, so <= 2a+1 bounds it;
            # anything defined between rides inside the hull).
            if a >= 0:
                src = def_at_or_before(2 * a + 1)
                if src >= 0:
                    lo = min(lo, src // 2)
            created[key] = len(los)
            add(lo, stop)
        elif kind == K.KIND_DELETE:
            rc, ra = int(row[K.K_REF_CTR]), int(row[K.K_REF_ACT])
            p = lookup.pos(rc, ra)
            if p < 0:
                if (rc, ra) in created:
                    continue  # deleting a batch-born element: in window
                return None
            add(p, p)
        elif kind == K.KIND_MARK:
            sc, sa = int(row[K.K_SCTR]), int(row[K.K_SACT])
            ekind = int(row[K.K_EKIND])
            ps = lookup.pos(sc, sa)
            if ps >= 0:
                s_min = s_max = ps
                s_slot = 2 * ps + int(row[K.K_SKIND])
            elif (sc, sa) in created:
                gi = created[(sc, sa)]
                s_min, s_max = los[gi], his[gi]
                s_slot = None  # batch-created: exact slot unknown pre-merge
            else:
                return None
            end_of_text = ekind == 2
            e_slot: Optional[int] = None
            if not end_of_text:
                ec_, ea_ = int(row[K.K_ECTR]), int(row[K.K_EACT])
                # Same-slot anchors collapse to endOfText behavior in the
                # walk (peritext.ts:236-241): slot equality is possible
                # only on the same element (parity argument), so it is
                # decidable from ids + boundary kinds alone.
                if (ec_, ea_) == (sc, sa) and int(row[K.K_SKIND]) == min(ekind, 1):
                    end_of_text = True
                else:
                    pe = lookup.pos(ec_, ea_)
                    if pe >= 0:
                        e_min = e_max = pe
                        e_slot = 2 * pe + min(ekind, 1)
                    elif (ec_, ea_) in created:
                        gi = created[(ec_, ea_)]
                        e_min, e_max = los[gi], his[gi]
                    else:
                        return None
            if end_of_text:
                e_min, e_max = s_min, n - 1
            lo = min(s_min, e_min)
            hi = max(s_max, e_max)

            # Carried-currentOps sources of the anchor writes
            # (peritext.ts:181-186): each write copies the nearest defined
            # slot AT OR LEFT OF its own anchor slot.  The query must be
            # the EXACT anchor slot — a before-anchor (2p) must not be
            # bounded via 2p+1, whose defined after-slot is not a valid
            # carry source and would hide the true (further-left) one.
            # For batch-created anchors the slot is unknown pre-merge;
            # defined slots at or above 2*s_min ride in the hull, so the
            # sound extension is the nearest defined slot STRICTLY LEFT of
            # the hull's slot floor.
            def extend(lo_now: int, slot: Optional[int], elem_min: int) -> int:
                q = slot if slot is not None else 2 * elem_min - 1
                src = def_at_or_before(q)
                return min(lo_now, src // 2) if src >= 0 else lo_now
            lo = extend(lo, s_slot, s_min)
            if not end_of_text:
                lo = extend(lo, e_slot, e_min)
            add(lo, hi)

    if not los:
        return (0, -1)
    return (min(los), max(his))


def plan_windows(
    mirrors: List[Optional[Mirror]],
    rows_of: List[np.ndarray],
    inserts_of: List[int],
    ranks: np.ndarray,
    capacity: int,
    min_cap: int,
    census_keys: Optional[List[Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Fleet window plan: per-replica hulls + one shared pow2 ``w_cap``.

    Returns None (full-table path) when any replica's census fails, when
    the bucketed window would cover more than half the table (no win), or
    when the table is below ``min_cap`` (gather/scatter overhead dominates
    tiny documents).  Otherwise a dict with int32 arrays ``starts``,
    ``hulls``, ``vis_base``, ``vis_after`` and the static ``w_cap``.

    ``census_keys`` (optional, one hashable per replica) memoizes the
    per-replica census: replicas with equal keys — the universe passes
    (mirror class, gate group) — share one replica_window pass, so a
    converged fleet ingesting a shared stream pays O(1) censuses, not
    O(replicas).
    """
    if capacity < min_cap:
        return None
    n_rep = len(mirrors)
    lo_hi: List[Tuple[int, int]] = []
    memo: Dict[Any, Optional[Tuple[int, int]]] = {}
    for r in range(n_rep):
        m = mirrors[r]
        if m is None:
            return None
        key = None if census_keys is None else census_keys[r]
        if key is not None and key in memo:
            res = memo[key]
        else:
            res = replica_window(m, rows_of[r], ranks)
            if key is not None:
                memo[key] = res
        if res is None:
            return None
        lo_hi.append(res)

    hulls = [hi - lo + 1 for lo, hi in lo_hi]
    needs = [h + int(inserts_of[r]) for r, h in enumerate(hulls)]
    w_cap = bucket_length(max(max(needs), 1), minimum=64)
    los = [lo for lo, _ in lo_hi]
    # Clamp so the dynamic-slice gather stays in range (start + w_cap <= C);
    # widening leftward is always sound.  Growing w_cap loosens the clamp,
    # which can grow a hull, so iterate to the (monotone, bounded) fixpoint.
    while True:
        if 2 * w_cap > capacity:
            return None
        for r, (lo, hi) in enumerate(lo_hi):
            lo_c = min(lo, capacity - w_cap)
            los[r] = lo_c
            hulls[r] = hi - lo_c + 1 if hi >= lo_c else 0
            needs[r] = hulls[r] + int(inserts_of[r])
        new_cap = bucket_length(max(max(needs), 1), minimum=64)
        if new_cap == w_cap:
            break
        w_cap = new_cap

    vis_base = np.zeros(n_rep, np.int32)
    vis_after = np.zeros(n_rep, np.int32)
    for r, m in enumerate(mirrors):
        vis = ~m["deleted"]
        lo = los[r]
        hull = hulls[r]
        total = int(vis.sum())
        before = int(vis[:lo].sum())
        in_hull = int(vis[lo : lo + hull].sum())
        vis_base[r] = before
        vis_after[r] = total - before - in_hull
    return {
        "starts": np.asarray(los, np.int32),
        "hulls": np.asarray(hulls, np.int32),
        "vis_base": vis_base,
        "vis_after": vis_after,
        "w_cap": int(w_cap),
    }


def splice_mirror(
    m: Mirror,
    lo: int,
    hull: int,
    new_hull: int,
    w_ctr: np.ndarray,
    w_act: np.ndarray,
    w_del: np.ndarray,
    w_def: np.ndarray,
) -> Mirror:
    """Update a mirror from a windowed launch's post-merge window readback
    (kernels wrec planes): replace [lo, lo+hull) with the merged window's
    first ``new_hull`` rows.  The mirror stays a pure device readback."""
    return {
        "ctr": np.concatenate(
            [m["ctr"][:lo], w_ctr[:new_hull].astype(np.int32), m["ctr"][lo + hull :]]
        ),
        "act": np.concatenate(
            [m["act"][:lo], w_act[:new_hull].astype(np.int32), m["act"][lo + hull :]]
        ),
        "deleted": np.concatenate(
            [m["deleted"][:lo], w_del[:new_hull].astype(bool), m["deleted"][lo + hull :]]
        ),
        "bnd_def": np.concatenate(
            [
                m["bnd_def"][: 2 * lo],
                w_def[: 2 * new_hull].astype(bool),
                m["bnd_def"][2 * (lo + hull) :],
            ]
        ),
    }
