"""Explicit sequence-parallel kernels: per-shard bodies and explicit
exchanges between the seq shards of a replica group.

Counterpart of ``peritext_tpu/parallel/shard.py``.  JAX writes each body
once under ``shard_map`` and reaches the other shards through
collectives over the ``seq`` axis; here a body runs on each shard's local
tensors in turn, on the shard's mesh device, and each collective is an
explicit exchange among the group's shards:

- ``ppermute`` by d: shard j receives shard j - d's tensor, moved to its
  device, and zeros where the ring has no source (j < d);
- ``pmin``: the elementwise minimum over the group's shards, on each;
- ``all_gather``: the group's shards' tensors stacked on a new axis 1.

Every body takes the replica rows of its group at once ([Rl, ...] local
tensors: JAX's ``vmap`` over replicas written out).  The results are
byte-identical to the unsharded ``flatten_sources`` / ``place_text_batch``
/ ``merge_step_sorted_batch`` and to the JAX package's ``shard_map`` forms
(``tests/test_torch_shard_map.py``).  Inputs are ``ShardedTensor`` fields
(``mesh.shard_states``) or plain tensors, which are split over the mesh
as JAX's ``in_specs`` split them; outputs are ``ShardedTensor``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from peritext_tpu_torch.ops.kernels import (
    K_ACT,
    K_CTR,
    K_KIND,
    K_PAYLOAD,
    K_REF_ACT,
    K_REF_CTR,
    K_RUN_LEN,
    KIND_DELETE,
    KIND_INSERT,
    KIND_INSERT_RUN,
    _gather_clamped,
)
from peritext_tpu_torch.ops.sorted_merge import _CHUNK_ELEMS, _replica_step, _sorted_tail
from peritext_tpu_torch.ops.state import FIELDS, DocState, map_state
from peritext_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTensor,
    from_group_states,
    group_rows,
    group_state,
    shard_states,
)

_PLANE = ("replica", "seq")
_ROWS = ("replica", None)
_OPS = ("replica", None, None)


# ---------------------------------------------------------------------------
# The group's collectives
# ---------------------------------------------------------------------------


def _ppermute(xs: Sequence[torch.Tensor], devs, d: int) -> List[torch.Tensor]:
    """Shard j gets shard j - d's tensor on its device; zeros for j < d."""
    return [xs[j - d].to(devs[j]) if j >= d else torch.zeros_like(xs[j]) for j in range(len(xs))]


def _pmin(xs: Sequence[torch.Tensor], devs) -> List[torch.Tensor]:
    low = xs[0]
    for x in xs[1:]:
        low = torch.minimum(low, x.to(low.device))
    return [low.to(dev) for dev in devs]


def _all_gather(xs: Sequence[torch.Tensor], devs) -> List[torch.Tensor]:
    return [torch.stack([x.to(dev) for x in xs], dim=1) for dev in devs]


def _row_at(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[r, idx[r, k]]`` for [Rl, N, W] rows and [Rl, K] indices;
    zeros where the index is -1."""
    got = torch.gather(rows, 1, idx.clamp(min=0)[..., None].expand(-1, -1, rows.shape[2]))
    return torch.where((idx >= 0)[..., None], got, 0)


def _local(x: Any, mesh: Mesh, spec) -> ShardedTensor:
    return x if isinstance(x, ShardedTensor) else ShardedTensor.split(torch.as_tensor(x), mesh, spec)


def _replicated(x: torch.Tensor, devs) -> List[torch.Tensor]:
    return [x.to(dev) for dev in devs]


# ---------------------------------------------------------------------------
# flatten_sources
# ---------------------------------------------------------------------------


def _flatten_group(bnd_def, bnd_mask, length, devs):
    """One replica group's flatten over its seq shards (JAX's
    ``_sharded_flatten_local``): local resolution, a one-element halo to
    the right neighbour, a local prefix, and each shard's last deciding row
    gathered across the group so each shard takes the nearest preceding
    one.  Lists over the shards in, (mask, has) lists out."""
    seq_size = len(devs)
    c_local = bnd_def[0].shape[1] // 2
    parts = []
    for j in range(seq_size):
        ar_local = torch.arange(c_local, device=devs[j])
        live = (j * c_local + ar_local)[None, :] < length[j][:, None]
        parts.append({
            "ar": ar_local,
            "before_def": bnd_def[j][:, 0::2] & live,
            "after_def": bnd_def[j][:, 1::2] & live,
            "before_rows": bnd_mask[j][:, 0::2],
            "after_rows": bnd_mask[j][:, 1::2],
        })
    halo_def = _ppermute([p["after_def"][:, -1] for p in parts], devs, 1)
    halo_row = _ppermute([p["after_rows"][:, -1] for p in parts], devs, 1)

    summaries, summary_has = [], []
    for j, p in enumerate(parts):
        prev_after_def = torch.cat([halo_def[j][:, None], p["after_def"][:, :-1]], dim=1)
        prev_after_rows = torch.cat([halo_row[j][:, None], p["after_rows"][:, :-1]], dim=1)
        # Element-level decision: own before slot wins, else the previous
        # element's after slot.
        d_has = p["before_def"] | prev_after_def
        d_rows = torch.where(p["before_def"][..., None], p["before_rows"], prev_after_rows)
        decided = torch.where(d_has, p["ar"], -1)
        src = torch.cummax(decided, dim=1).values
        p["local_rows"] = _row_at(d_rows, src)
        p["local_has"] = src >= 0
        last_idx = decided.max(dim=1).values
        summaries.append(_row_at(d_rows, last_idx[:, None])[:, 0])
        summary_has.append(last_idx >= 0)
    all_rows = _all_gather(summaries, devs)  # [Rl, S, W]
    all_has = _all_gather(summary_has, devs)  # [Rl, S]

    masks, has = [], []
    for j, p in enumerate(parts):
        s_idx = torch.arange(seq_size, device=devs[j])
        prev_shards = all_has[j] & (s_idx < j)
        pick = torch.where(prev_shards, s_idx, -1).max(dim=1).values
        incoming_row = _row_at(all_rows[j], pick[:, None])[:, 0]
        masks.append(torch.where(p["local_has"][..., None], p["local_rows"], incoming_row[:, None, :]))
        has.append(p["local_has"] | (pick >= 0)[:, None])
    return masks, has


def flatten_sources_sp(mesh: Mesh) -> Callable:
    """Sequence-parallel flatten over (replica, seq) (JAX's
    ``flatten_sources_sp``): ``(deleted [R, C], bnd_def [R, 2C], bnd_mask
    [R, 2C, W], length [R]) -> (mask [R, C, W], has [R, C])``, sharded over
    (replica, seq) and equal to ``kernels.flatten_sources``."""

    def fn(deleted, bnd_def, bnd_mask, length):
        bnd_def = _local(bnd_def, mesh, _PLANE)
        bnd_mask = _local(bnd_mask, mesh, _PLANE + (None,))
        length = _local(length, mesh, ("replica",))
        masks, has = [], []
        for i in range(mesh.shape["replica"]):
            m, h = _flatten_group(bnd_def.shards[i], bnd_mask.shards[i], length.shards[i], mesh.devices[i])
            masks.append(m)
            has.append(h)
        return _from_shards(masks, mesh, _PLANE + (None,)), _from_shards(has, mesh, _PLANE)

    return fn


def _from_shards(per_group: Sequence[Sequence[torch.Tensor]], mesh: Mesh, spec) -> ShardedTensor:
    """A ``ShardedTensor`` of per-shard results, ``per_group[i][j]`` the
    block of mesh device [i, j]."""
    shards = np.empty((mesh.shape["replica"], mesh.shape["seq"]), dtype=object)
    for i, row in enumerate(per_group):
        for j, x in enumerate(row):
            shards[i, j] = x
    shape = list(shards[0, 0].shape)
    for d, axis in enumerate(spec):
        if axis is not None:
            shape[d] *= mesh.shape[axis]
    return ShardedTensor(mesh, spec, shards, tuple(shape))


# ---------------------------------------------------------------------------
# Sort-based placement
# ---------------------------------------------------------------------------


def _placement_round_group(carry, rnd: int, text_ops, round_of, ranks, char_buf, devs,
                           *, halo: int, maxk: int, c_global: int):
    """One placement round on one replica group's seq shards (JAX's
    ``_placement_round_local``).  Anchor resolution and the skip-run stop
    are local candidates reduced with ``pmin`` over the group; block
    ordering is the same [L] / [L, L] math on every shard; the splice
    pulls the whole shards within ``halo`` to the left (elements only move
    right, by at most the round's insert budget) and scatters locally.
    ``carry`` holds one (ec, ea, dl, ch, oi, length) tuple a shard; the op
    tensors one copy a shard."""
    seq_size = len(devs)
    c_local = carry[0][0].shape[1]
    big = 2 * c_global + 2
    st = []
    for j in range(seq_size):
        ec, ea, dl, ch, oi, ln = carry[j]
        ops, dev = text_ops[j], devs[j]
        gpos = j * c_local + torch.arange(c_local, device=dev)
        kind = ops[..., K_KIND]
        active = round_of[j] == rnd
        is_run = kind == KIND_INSERT_RUN
        is_ins = active & ((kind == KIND_INSERT) | is_run)
        is_del = active & (kind == KIND_DELETE)
        alive = gpos[None, :] < ln[:, None]
        ref_ctr, ref_act = ops[..., K_REF_CTR], ops[..., K_REF_ACT]
        ref_match = (
            alive[:, None, :] & (ec[:, None, :] == ref_ctr[:, :, None]) & (ea[:, None, :] == ref_act[:, :, None])
        )  # [Rl, L, Cl]
        # Deletes are shard-local.
        dl = dl | (ref_match & is_del[:, :, None]).any(dim=1)
        st.append({
            "gpos": gpos, "is_run": is_run, "is_ins": is_ins, "alive": alive, "dl": dl,
            "is_head": (ref_ctr == 0) & (ref_act == 0),
            "first": torch.where(ref_match, gpos, big).amin(dim=2),
        })
    global_first = _pmin([s["first"] for s in st], devs)
    for j, s in enumerate(st):
        ec, ea = carry[j][0], carry[j][1]
        ops = text_ops[j]
        # The unsharded path's argmax(all-False) == 0 fallback, reproduced.
        idx = torch.where(s["is_head"], -1, torch.where(global_first[j] >= big, 0, global_first[j]))
        ctr_i = ops[..., K_CTR]
        rank_i = _gather_clamped(ranks[j], ops[..., K_ACT].reshape(-1)).reshape(ctr_i.shape)
        elem_rank = _gather_clamped(ranks[j], ea.reshape(-1)).reshape(ea.shape)
        gt = (ec[:, None, :] > ctr_i[:, :, None]) | (
            (ec[:, None, :] == ctr_i[:, :, None]) & (elem_rank[:, None, :] > rank_i[:, :, None])
        )
        stop = (s["gpos"] > idx[:, :, None]) & ~(s["alive"][:, None, :] & gt)
        s["t"] = torch.where(stop, s["gpos"], big).amin(dim=2)
        s["ctr_i"], s["rank_i"] = ctr_i, rank_i
    t_all = _pmin([s["t"] for s in st], devs)

    # Elements only move right, by at most the round's insert budget
    # (<= halo): each shard pulls the ceil(halo / Cl) whole shards to its
    # left, one ppermute hop per shard width.
    hops = min(-(-halo // c_local), seq_size - 1) if seq_size > 1 else 0
    region = hops * c_local
    planes = [[carry[j][p] for j in range(seq_size)] for p in range(5)]
    planes[2] = [s["dl"].to(torch.int32) for s in st]
    halos = [
        [torch.cat(parts, dim=1) for parts in zip(*(_ppermute(pl, devs, d) for d in range(hops, 0, -1)))]
        if hops else [pl[j][:, :0] for j in range(seq_size)]
        for pl in planes
    ]
    out = []
    for j, s in enumerate(st):
        ops, dev, ln = text_ops[j], devs[j], carry[j][5]
        lo = j * c_local
        t = torch.where(t_all[j] >= big, c_global, t_all[j])
        ctr_i, rank_i, is_ins = s["ctr_i"].long(), s["rank_i"].long(), s["is_ins"]
        k = torch.where(s["is_run"], ops[..., K_RUN_LEN], 1).long() * is_ins  # [Rl, L]
        id_gt = (ctr_i[:, None, :] > ctr_i[:, :, None]) | (
            (ctr_i[:, None, :] == ctr_i[:, :, None]) & (rank_i[:, None, :] > rank_i[:, :, None])
        )
        before = (t[:, None, :] < t[:, :, None]) | ((t[:, None, :] == t[:, :, None]) & id_gt)
        blk_s = t + (k[:, None, :] * before).sum(dim=2)

        src_gpos = lo - region + torch.arange(region + c_local, device=dev)
        src_ok = (src_gpos >= 0)[None, :] & (src_gpos[None, :] < ln[:, None])
        shift = (k[:, :, None] * (t[:, :, None] <= src_gpos[None, None, :])).sum(dim=1)
        # Out-of-shard destinations land in a spare column that is cut off
        # (JAX drops them); negative ones are sent there before the scatter.
        dest_local = src_gpos + shift - lo
        dest_local = torch.where(src_ok & (dest_local >= 0), dest_local, c_local).clamp(max=c_local)
        off = torch.arange(maxk, device=dev)
        in_block = off < k[:, :, None]
        dest_ops = blk_s[:, :, None] + off - lo
        dest_ops = torch.where(in_block & (dest_ops >= 0), dest_ops, c_local).clamp(max=c_local)
        dest_ops = dest_ops.reshape(dest_ops.shape[0], -1)

        buf = char_buf[j]
        buf_idx = (ops[..., K_PAYLOAD, None].long() + off).clamp(0, buf.shape[1] - 1)
        run_chars = torch.gather(buf, 1, buf_idx.reshape(buf.shape[0], -1)).reshape(buf_idx.shape)
        block_ctr = ops[..., K_CTR, None] + off.to(torch.int32)
        blocks = (
            block_ctr,
            ops[..., K_ACT, None].expand(block_ctr.shape),
            torch.zeros_like(block_ctr),
            torch.where(s["is_run"][..., None], run_chars, ops[..., K_PAYLOAD, None]),
            torch.full_like(block_ctr, -1),
        )

        def splice(own, halo_vals, fill, block_vals):
            src = torch.cat([halo_vals, own], dim=1)
            res = torch.full((own.shape[0], c_local + 1), fill, dtype=own.dtype, device=dev)
            res.scatter_(1, dest_local, src)
            res.scatter_(1, dest_ops, block_vals.reshape(dest_ops.shape).to(own.dtype))
            return res[:, :c_local].contiguous()

        new = [splice(planes[p][j], halos[p][j], fill, blocks[p])
               for p, fill in zip(range(5), (0, 0, 0, 0, -1))]
        new[2] = new[2].bool()
        out.append((*new, (ln + k.sum(dim=1)).to(torch.int32)))
    return out


def _place_group(ec, ea, dl, ch, ln, text_ops, round_of, num_rounds: int, ranks, char_buf, devs,
                 *, halo: int, maxk: int):
    """Every round of one replica group's placement (lists over shards)."""
    seq_size = len(devs)
    c_local = ec[0].shape[1]
    carry = []
    for j in range(seq_size):
        oi = (j * c_local + torch.arange(c_local, dtype=torch.int32, device=devs[j])).expand(ec[j].shape)
        carry.append((ec[j], ea[j], dl[j], ch[j], oi.contiguous(), ln[j]))
    for rnd in range(num_rounds):
        carry = _placement_round_group(
            carry, rnd, text_ops, round_of, ranks, char_buf, devs,
            halo=halo, maxk=maxk, c_global=c_local * seq_size,
        )
    return carry


def place_text_sp(mesh: Mesh, halo: int, maxk: int) -> Callable:
    """Sequence-parallel sort-based text placement (JAX's
    ``place_text_sp``), the sharded form of ``sorted_merge.place_text_batch``:
    per-shard work and memory scale as C / S while the exchanges are
    [L]-sized minima plus ceil(halo / (C / S)) whole-shard pulls a round.
    ``halo`` must be at least the largest single-round insert budget.
    Returns ``(ec, ea, dl, ch, ln, text_ops, round_of, num_rounds, ranks,
    char_buf) -> (ec, ea, dl, ch, oi, length)``, the planes sharded over
    (replica, seq) and ``length`` over ``replica``.  A group's rows run in
    slices that keep each [rows, L, C / S] transient under
    ``sorted_merge._CHUNK_ELEMS`` elements; rows are independent."""
    seq_size = mesh.shape["seq"]

    def fn(ec, ea, dl, ch, ln, text_ops, round_of, num_rounds, ranks, char_buf):
        num_rounds = int(num_rounds)
        ec, ea, dl, ch = (_local(x, mesh, _PLANE) for x in (ec, ea, dl, ch))
        ln = _local(ln, mesh, ("replica",))
        text_ops = _local(text_ops, mesh, _OPS)
        round_of, char_buf = (_local(x, mesh, _ROWS) for x in (round_of, char_buf))
        c_local = ec.shards[0, 0].shape[1]
        n_ops = text_ops.shape[1]
        region = c_local * min(-(-halo // c_local), seq_size - 1) if seq_size > 1 else 0
        step = max(1, _CHUNK_ELEMS // max(n_ops * (region + c_local) + n_ops * max(n_ops, maxk), 1))
        results = []
        for i in range(mesh.shape["replica"]):
            devs = mesh.devices[i]
            group_ranks = _replicated(torch.as_tensor(ranks), devs)
            rows = ec.shards[i, 0].shape[0]
            pieces = []
            for lo in range(0, rows, step):
                sl = slice(lo, lo + step)

                def part(x):
                    return [x.shards[i, j][sl] for j in range(seq_size)]

                pieces.append(_place_group(
                    part(ec), part(ea), part(dl), part(ch), part(ln), part(text_ops), part(round_of),
                    num_rounds, group_ranks, part(char_buf), devs,
                    halo=halo, maxk=maxk,
                ))
            results.append([
                tuple(torch.cat([p[j][q] for p in pieces]) for q in range(6)) for j in range(seq_size)
            ])
        planes = tuple(
            _from_shards([[results[i][j][q] for j in range(seq_size)] for i in range(mesh.shape["replica"])],
                         mesh, _PLANE)
            for q in range(5)
        )
        lengths = [[results[i][j][5] for j in range(seq_size)] for i in range(mesh.shape["replica"])]
        return (*planes, _from_shards(lengths, mesh, ("replica",)))

    return fn


def merge_step_sorted_sp(mesh: Mesh, halo: int, maxk: int) -> Callable:
    """The full sorted merge for the long-document regime (JAX's
    ``merge_step_sorted_sp``): ``place_text_sp``, then the batched mark
    phase with the boundary permute and the table append
    (``sorted_merge._sorted_tail``) on each replica group's rows gathered
    on its device and split back, the explicit counterpart of JAX's
    GSPMD-sharded tail.  ``(states, text_ops, round_of, num_rounds,
    mark_ops, ranks, char_buf) -> states`` laid over (replica, seq); equal
    to ``sorted_merge.merge_step_sorted_batch`` on the gathered arrays."""
    place = place_text_sp(mesh, halo=halo, maxk=maxk)

    def step(states: DocState, text_ops, round_of, num_rounds, mark_ops, ranks, char_buf) -> DocState:
        states = shard_states(states, mesh, shard_seq=True)
        placed = place(states.elem_ctr, states.elem_act, states.deleted, states.chars, states.length,
                       text_ops, round_of, num_rounds, ranks, char_buf)
        outs = []
        for i in range(mesh.shape["replica"]):
            g = group_state(states, i)
            ec, ea, dl, ch, oi, ln = (x.group(i) for x in placed)
            marks = group_rows(mark_ops, mesh, i)
            step_rows = _replica_step(g.capacity, g.bnd_mask.shape[-1], text_ops.shape[1], marks.shape[1], maxk)
            slices = [slice(lo, lo + step_rows) for lo in range(0, ec.shape[0], step_rows)]
            tails = [
                _sorted_tail(map_state(lambda x: x[sl], g), ec[sl], ea[sl], dl[sl], ch[sl], oi[sl], ln[sl], marks[sl])
                for sl in slices
            ]
            outs.append(DocState(**{f: torch.cat([getattr(t, f) for t in tails]) for f in FIELDS}))
        return from_group_states(outs, mesh, shard_seq=True)

    return step
