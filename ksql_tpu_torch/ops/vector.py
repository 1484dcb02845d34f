"""Vector aggregates on the card: the collect, top-K and histogram folds.

The port of the vector branches of ``ksql_tpu/ops/hash_store.py``'s
``scatter_combine`` (B18, and B19's ``_vec_remove``): ``_vec_collect`` with
``_batch_membership`` and ``_slot_ranks``, ``_vec_hist``, ``_vec_topk``
(with ``_sort_desc`` and ``_desc_key``) and ``_vec_remove``.  A vector aggregate keeps per slot a group of components
(``hash_store.AggComponent``): a collect group is ``vec_count`` (int64,
the logical count), ``vec_data`` (``[capacity + 1, K]`` values) and
``vec_valid`` (``[capacity + 1, K]`` int8 element null bits); a histogram
group adds ``hist_count`` (int64 per-element counts); a top-K is one
``topk`` column of width K, sorted descending, the dtype floor marking an
empty entry.  :func:`fold_vectors` walks a layout's component list as the
reference does (groups of 3 for collect, 4 for a histogram, 1 for a
top-K) after K3 has folded the scalar components.

Four hand-written CUDA kernels (``csrc/``) carry the folds, with K13
``seg_sort`` (``ops/session.py``) for K20's orders:

* K20 ``vec_collect`` (modes ``append``, ``set``, ``ring`` and ``hist``,
  the histogram's phase 1): the first occurrence of each (slot, value,
  null bit) in the batch (K13 on ``(slot * 2 + bit, value key)``) and its
  membership in the slot's stored prefix, read once a slot into a hash
  table in shared memory; the arrival-stable rank of each row within its
  slot (K13 on the slot), the writes, the dump row's last-row-wins cells
  and the count adds.
* K21 ``vec_topk`` (modes ``plain`` and ``distinct``): one cooperative
  launch groups the rows by slot (tickets, no sort); a warp (a block for a
  hot slot) takes each slot's first K candidates by successive minima
  (distinct: past equal values) and merges them with the stored K by rank
  counting, as XLA sorts; the last group to finish merges the dump row.
* K22 ``vec_hist``: the histogram's phase 2, each row's signed head
  ``atomicAdd``-ed at its value's entry (negative on a table
  aggregation's undo side).
* K23 ``vec_remove``: COLLECT_LIST's undo in a table aggregation
  (``_vec_remove``): one cooperative launch groups the undo rows by slot
  (no sort), and a block per touched slot matches them against the
  slot's stored prefix in a hash table in shared memory and compacts the
  slot's row left.

As in ``ops/hash_store.py``, each wrapper launches its kernels for CUDA
tensors and counts the call in ``<wrapper>.launches`` and
``<wrapper>.mode_launches[mode]``; for CPU tensors it runs the plain torch
twin beside it (``*_plain``), which is also the kernels' oracle on the
card.  The store is updated in place.

XLA's rules the twins keep, and the kernels with them: a scatter-set with
duplicate indices leaves the LAST row's value (so the dump row holds the
highest row aimed at each of its cells); a sort of doubles orders by the
value with -0.0 equal to +0.0 and every NaN equal and above +inf, stably;
float equality (``==``) is IEEE's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import StoreLayout, _expect, _stream, init_bits
from ksql_tpu_torch.ops.session import seg_sort

INT64_MAX = (1 << 63) - 1
#: mode codes shared with csrc/vec_collect.cu
COLLECT_MODES = {"append": 0, "set": 1, "ring": 2, "hist": 3}


# ------------------------------------------------------------ sort helpers
def _sort_key(v: torch.Tensor) -> torch.Tensor:
    """An int64 key whose ascending order is XLA's sort order of ``v``:
    the value itself for ints; for doubles the IEEE total order of the
    value with -0.0 made +0.0 and every NaN made the largest key."""
    if not v.is_floating_point():
        return v.to(torch.int64)
    bits = torch.where(v == 0, torch.zeros_like(v), v).view(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ INT64_MAX)
    return torch.where(torch.isnan(v), torch.full_like(key, INT64_MAX), key)


def _desc_key(vals: torch.Tensor) -> torch.Tensor:
    """A monotone-decreasing sort key (no overflow at the dtype's min):
    the reference's ``_desc_key``."""
    return -vals if vals.is_floating_point() else ~vals


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: stable, the LAST key primary."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(_sort_key(k)[order], stable=True)]
    return order


def _sort_desc(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sort(x, axis=-1)[..., ::-1]``: a stable ascending sort, then
    reversed (equal keys come out in reverse order)."""
    order = torch.argsort(_sort_key(x), dim=-1, stable=True)
    return torch.gather(x, -1, order).flip(-1)


def _run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Per sorted position, the position where its run of equal keys
    starts (the reference's ``cummax`` of the run heads)."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, device=sorted_keys.device)
    head = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.cummax(torch.where(head, idx, torch.full_like(idx, -1)), 0).values


def _set_last(col: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, cols=None) -> None:
    """``col.at[rows, cols].set(vals)`` (``cols`` None: whole rows of a 2-D
    ``col``) with XLA's duplicate rule: the last row aimed at a cell wins."""
    width = col.shape[1]
    flat = rows.long() if cols is None else rows.long() * width + cols.long()
    order = torch.argsort(flat, stable=True)
    fs = flat[order]
    last = torch.ones_like(fs, dtype=torch.bool)
    last[:-1] = fs[1:] != fs[:-1]
    keep = order[last]
    if cols is None:
        col[flat[keep]] = vals[keep]
    else:
        col.view(-1)[flat[keep]] = vals[keep]


# ------------------------------------------------------------- the twins
def slot_ranks_plain(eff: torch.Tensor) -> torch.Tensor:
    """Arrival-stable rank of each row within its slot group (the
    reference's ``_slot_ranks``; rows at the dump slot get ranks too)."""
    order = torch.argsort(eff, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=eff.device) - _run_starts(eff[order])
    return rank.to(torch.int32)


def batch_membership_plain(cnt, data, vbit, K, eff0, vals, vbits):
    """The reference's ``_batch_membership``: per row, whether its (value,
    null bit) is in its slot's stored prefix, and whether it is the first
    occurrence of its (slot, value, bit) in the batch."""
    e = eff0.long()
    occ = torch.arange(K, device=e.device)[None, :] < torch.clamp(cnt[e], max=K)[:, None]
    eq = (data[e] == vals[:, None]) & (vbit[e] == vbits[:, None])
    member = (eq & occ).any(1)
    order = _lexsort([vbits, vals, eff0])
    so_eff, so_v, so_b = eff0[order], vals[order], vbits[order]
    diff = torch.ones_like(member)
    diff[1:] = (so_eff[1:] != so_eff[:-1]) | (so_v[1:] != so_v[:-1]) | (so_b[1:] != so_b[:-1])
    firsts = torch.empty_like(member)
    firsts[order] = diff
    return member, firsts


def vec_collect_plain(store, layout: StoreLayout, j: int, contribs, slots, mode: str) -> None:
    """Plain twin of K20 — see :func:`vec_collect`."""
    K = layout.components[j + 1].width
    dump = layout.capacity
    cnt_col, data_col, vbit_col = store[f"a{j}"], store[f"a{j + 1}"], store[f"a{j + 2}"]
    vals = contribs[j + 1].to(data_col.dtype)
    vbits = contribs[j + 2].to(vbit_col.dtype)
    dump_t = torch.full_like(slots, dump)
    contributing = (contribs[j] > 0) & (slots != dump)
    if mode in ("set", "hist"):
        eff0 = torch.where(contributing, slots, dump_t)
        member, firsts = batch_membership_plain(cnt_col, data_col, vbit_col, K, eff0, vals, vbits)
        new = contributing & ~member & firsts
    else:
        new = contributing
    eff = torch.where(new, slots, dump_t).long()
    pos = cnt_col[eff].to(torch.int32) + slot_ranks_plain(eff)
    if mode == "ring":
        # >K contributions to one slot in a batch wrap the ring: only the
        # LAST K write, so the positions stay distinct
        n_slot = torch.zeros(dump + 1, dtype=torch.int32, device=eff.device)
        n_slot.index_add_(0, eff, new.to(torch.int32))
        end_pos = cnt_col[eff].to(torch.int32) + n_slot[eff]
        write = new & (pos >= end_pos - K)
        tgt_pos = torch.remainder(pos, K)
    else:  # append / set / hist: capped at K
        write = new & (pos < K)
        tgt_pos = torch.clamp(pos, 0, K - 1)
    tgt_slot = torch.where(write, eff, torch.full_like(eff, dump))
    _set_last(data_col, tgt_slot, vals, tgt_pos)
    _set_last(vbit_col, tgt_slot, vbits, tgt_pos)
    # append/set/ring keep the logical total past K; hist counts its writes
    cnt_col.index_add_(0, eff, (write if mode == "hist" else new).to(cnt_col.dtype))


def vec_remove_plain(store, layout: StoreLayout, j: int, contribs, slots) -> None:
    """Plain twin of K23 — see :func:`vec_remove`.  Step for step the
    reference's ``_vec_remove``."""
    K = layout.components[j + 1].width
    dump = layout.capacity
    cnt_col, data_col, vbit_col = store[f"a{j}"], store[f"a{j + 1}"], store[f"a{j + 2}"]
    head = contribs[j]
    vals = contribs[j + 1].to(data_col.dtype)
    vbits = contribs[j + 2].to(vbit_col.dtype)
    n = vals.shape[0]
    dev = vals.device
    pos_idx = torch.arange(K, device=dev)
    rowidx = torch.arange(n, device=dev)
    removing = (head < 0) & (slots != dump)
    eff = torch.where(removing, slots, torch.full_like(slots, dump)).long()
    # rank among the undo rows of one (slot, value, bit): the r-th claims
    # the r-th stored occurrence (runs by IEEE ==: ±0.0 one run, NaN alone)
    order = _lexsort([rowidx, vbits, vals, eff])
    so_eff, so_v, so_b = eff[order], vals[order], vbits[order]
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = (so_eff[1:] != so_eff[:-1]) | (so_v[1:] != so_v[:-1]) | (so_b[1:] != so_b[:-1])
    run_start = torch.cummax(torch.where(new_run, rowidx, torch.zeros_like(rowidx)), 0).values
    row_rank = torch.empty_like(rowidx)
    row_rank[order] = rowidx - run_start
    occ = pos_idx[None, :] < torch.clamp(cnt_col[eff], max=K)[:, None]
    match = (data_col[eff] == vals[:, None]) & (vbit_col[eff] == vbits[:, None]) & occ
    pos_rank = torch.cumsum(match.to(torch.int64), 1) - 1
    claim = match & (pos_rank == row_rank[:, None]) & removing[:, None]
    # the slot's lowest undo row gathers every claim of the slot
    first = torch.full((dump + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, eff, torch.where(removing, rowidx, torch.full_like(rowidx, n)), "amin")
    wrow = torch.where(removing, first[eff], torch.full_like(rowidx, n))
    rem = torch.zeros((n + 1, K), dtype=torch.int32, device=dev)
    rem.index_add_(0, wrow, claim.to(torch.int32))
    rem = rem[:n] > 0
    is_winner = removing & (first[eff] == rowidx)
    # a winner rewrites its slot compacted; every other row the dump row's
    # compaction (no claims: its cells past min(count, K) become 0)
    effw = torch.where(is_winner, slots, torch.full_like(slots, dump)).long()
    cnt_w = torch.clamp(cnt_col[effw], max=K)
    cur_d = data_col[effw]
    cur_b = vbit_col[effw]
    keep = ~rem & (pos_idx[None, :] < cnt_w[:, None])
    new_pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    tgt_pos = torch.where(keep, new_pos, torch.full_like(new_pos, K - 1))
    # a scatter-ADD into zeros, as the reference's: a stored -0.0 comes back +0.0
    out_d = torch.zeros((n, K), dtype=cur_d.dtype, device=dev)
    out_d.scatter_add_(1, tgt_pos, torch.where(keep, cur_d, torch.zeros_like(cur_d)))
    out_b = torch.zeros((n, K), dtype=cur_b.dtype, device=dev)
    out_b.scatter_add_(1, tgt_pos, torch.where(keep, cur_b, torch.zeros_like(cur_b)))
    n_removed = (rem & (pos_idx[None, :] < cnt_w[:, None])).sum(1)
    _set_last(data_col, effw, out_d)
    _set_last(vbit_col, effw, out_b)
    cnt_col.index_add_(0, effw, -n_removed.to(cnt_col.dtype))


def vec_hist_plain(store, layout: StoreLayout, j: int, contribs, slots) -> None:
    """Plain twin of K22 — see :func:`vec_hist`."""
    K = layout.components[j + 1].width
    dump = layout.capacity
    cnt_col, data_col, vbit_col, num_col = (store[f"a{j + t}"] for t in range(4))
    head = contribs[j].to(num_col.dtype)
    vals = contribs[j + 1].to(data_col.dtype)
    vbits = contribs[j + 2].to(vbit_col.dtype)
    contributing = (head != 0) & (slots != dump)
    eff2 = torch.where(contributing, slots, torch.full_like(slots, dump)).long()
    occ = torch.arange(K, device=eff2.device)[None, :] < torch.clamp(cnt_col[eff2], max=K)[:, None]
    eq = (data_col[eff2] == vals[:, None]) & (vbit_col[eff2] == vbits[:, None]) & occ
    found = eq.any(1)
    pos2 = torch.argmax(eq.to(torch.int8), 1)  # the first match (0 when none)
    t_slot = torch.where(contributing & found, eff2, torch.full_like(eff2, dump))
    num_col.view(-1).index_add_(0, t_slot * K + pos2, head)


def vec_topk_plain(store, layout: StoreLayout, j: int, contrib, slots) -> None:
    """Plain twin of K21 — see :func:`vec_topk`."""
    comp = layout.components[j]
    K = comp.width
    dump = layout.capacity
    col = store[f"a{j}"]
    vals = contrib.to(col.dtype)
    n = vals.shape[0]
    dev = vals.device
    sent = torch.tensor(comp.init, dtype=col.dtype, device=dev)
    idx = torch.arange(n, device=dev)
    eff = torch.where((vals != sent) & (slots != dump), slots, torch.full_like(slots, dump)).long()
    order = _lexsort([idx, _desc_key(vals), eff])
    so_eff, so_v = eff[order], vals[order]
    if comp.mode == "distinct":
        # in-batch dedup BEFORE windowing: duplicates would otherwise take
        # candidate places and hide distinct values ranked past K
        dup = torch.zeros(n, dtype=torch.bool, device=dev)
        dup[1:] = (so_eff[1:] == so_eff[:-1]) & (so_v[1:] == so_v[:-1])
        so_eff = torch.where(dup, torch.full_like(so_eff, dump), so_eff)
        so_v = torch.where(dup, sent, so_v)
        order2 = _lexsort([idx, _desc_key(so_v), so_eff])
        so_eff, so_v = so_eff[order2], so_v[order2]
    winner = (_run_starts(so_eff) == idx) & (so_eff != dump)
    offs = idx[:, None] + torch.arange(K, device=dev)[None, :]
    gidx = torch.clamp(offs, max=n - 1)
    cand = torch.where((so_eff[gidx] == so_eff[:, None]) & (offs < n), so_v[gidx], sent)
    allv = torch.cat([cand, col[so_eff]], dim=1)
    if comp.mode == "distinct":
        s = _sort_desc(allv)
        dup = torch.zeros_like(s, dtype=torch.bool)
        dup[:, 1:] = s[:, 1:] == s[:, :-1]
        allv = torch.where(dup, sent, s)
    top = _sort_desc(allv)[:, :K]
    _set_last(col, torch.where(winner, so_eff, torch.full_like(so_eff, dump)), top)


# -------------------------------------------------------- the kernels
def _elem(t: torch.Tensor):
    return t.element_size(), int(t.is_floating_point())


def vec_collect(store: Dict[str, torch.Tensor], layout: StoreLayout, j: int,
                contribs: Sequence[torch.Tensor], slots: torch.Tensor, mode: str) -> None:
    """K20 (replaces ``ops/hash_store.py:_vec_collect``, ``_batch_membership``
    and ``_slot_ranks``, and phase 1 of ``_vec_hist``): fold a batch into
    the collect group at component ``j`` (count, values, null bits), in
    place.  A row contributes when its head ``contribs[j] > 0`` and its
    slot is not the dump slot.  ``set`` and ``hist`` keep a row only when
    its (value, bit) is not in the slot's stored prefix (float equality for
    doubles: -0.0 == +0.0, NaN equals nothing) and it is the batch's first
    occurrence; the kept rows of a slot take positions ``count + rank`` in
    arrival order: capped at K (``append``, ``set``, ``hist``) or the last
    K modulo K (``ring``).  Rows that do not write aim at the dump row,
    where the last one per cell wins.  The count adds the kept rows
    (``hist``: the written ones).  Launches: keys, [K13, member,] K13,
    place; the dump row's cells are tracked in :func:`_scratch`."""
    if not slots.is_cuda:
        vec_collect_plain(store, layout, j, contribs, slots, mode)
        return
    K = layout.components[j + 1].width
    c1 = layout.capacity + 1
    n = slots.shape[0]
    cnt, data, vbit = store[f"a{j}"], store[f"a{j + 1}"], store[f"a{j + 2}"]
    _expect(cnt, torch.int64, (c1,))
    _expect(data, data.dtype, (c1, K))
    _expect(vbit, torch.int8, (c1, K))
    _expect(slots, torch.int32, (n,))
    if n == 0:
        return
    head = contribs[j].to(torch.int64).contiguous()
    vals = contribs[j + 1].to(data.dtype).contiguous()
    vbits = contribs[j + 2].to(torch.int8).contiguous()
    esize, isfloat = _elem(data)
    dev = slots.device
    st = _stream(dev)
    code = COLLECT_MODES[mode]
    keys = torch.empty(4 * n, dtype=torch.int64, device=dev)
    k1, k2, eff, snap = keys[:n], keys[n:2 * n], keys[2 * n:3 * n], keys[3 * n:]
    scratch = _scratch(dev, st, K).data_ptr()
    cuda.check("vec_collect", cuda.lib("vec_collect", "ksql_vec_collect_keys")(
        code, head.data_ptr(), vals.data_ptr(), vbits.data_ptr(), esize, isfloat, slots.data_ptr(),
        cnt.data_ptr(), n, layout.capacity, k1.data_ptr(), k2.data_ptr(), eff.data_ptr(), snap.data_ptr(),
        scratch, K, st))
    if mode in ("set", "hist"):
        perm = seg_sort(k1, k2)
        cuda.check("vec_collect", cuda.lib("vec_collect", "ksql_vec_collect_member")(
            perm.data_ptr(), n, k1.data_ptr(), vals.data_ptr(), vbits.data_ptr(), esize, isfloat,
            cnt.data_ptr(), data.data_ptr(), vbit.data_ptr(), K, layout.capacity, eff.data_ptr(),
            scratch, st))
    perm = seg_sort(eff, eff)
    cuda.check("vec_collect", cuda.lib("vec_collect", "ksql_vec_collect_place")(
        code, perm.data_ptr(), n, eff.data_ptr(), snap.data_ptr(), cnt.data_ptr(), data.data_ptr(),
        vbit.data_ptr(), esize, K, layout.capacity, vals.data_ptr(), vbits.data_ptr(), scratch, st))
    vec_collect.launches += 1
    vec_collect.mode_launches[mode] += 1


#: K20's scratch by (device, stream, K): K dump-row cells, the highest row
#: aimed at each (-1 between calls), then the count of kept rows and the
#: place launch's done ticket (0); the place launch leaves them so
_SCRATCH: Dict[tuple, torch.Tensor] = {}


def _scratch(device: torch.device, stream: int, K: int) -> torch.Tensor:
    """K20's scratch for calls on ``stream`` at width ``K``, made once
    (calls on one stream run in order, so they can share it)."""
    key = (device.index, stream, K)
    cells = _SCRATCH.get(key)
    if cells is None:
        cells = torch.full((K + 2,), -1, dtype=torch.int32, device=device)
        cells[K:] = 0
        _SCRATCH[key] = cells
    return cells


vec_collect.launches = 0
vec_collect.mode_launches = {m: 0 for m in COLLECT_MODES}


def vec_hist(store: Dict[str, torch.Tensor], layout: StoreLayout, j: int,
             contribs: Sequence[torch.Tensor], slots: torch.Tensor) -> None:
    """K22 (replaces phase 2 of ``ops/hash_store.py:_vec_hist``), after
    K20's ``hist`` mode: each row whose signed head ``contribs[j]`` is not
    0 finds the first entry of its slot's occupied prefix equal to its
    (value code, bit) and adds its head to that entry's count; a row that
    finds none, or whose slot is the dump slot, adds it at
    ``hist_count[dump, pos]`` (``pos`` its match in the dump row, else 0),
    as the reference's ``argmax`` of an all-false row does.  Integer adds:
    exact in any order."""
    if not slots.is_cuda:
        vec_hist_plain(store, layout, j, contribs, slots)
        return
    K = layout.components[j + 1].width
    c1 = layout.capacity + 1
    n = slots.shape[0]
    cnt, data, vbit, num = (store[f"a{j + t}"] for t in range(4))
    _expect(cnt, torch.int64, (c1,))
    _expect(data, torch.int64, (c1, K))
    _expect(vbit, torch.int8, (c1, K))
    _expect(num, torch.int64, (c1, K))
    _expect(slots, torch.int32, (n,))
    head = contribs[j].to(torch.int64).contiguous()
    vals = contribs[j + 1].to(torch.int64).contiguous()
    vbits = contribs[j + 2].to(torch.int8).contiguous()
    cuda.check("vec_hist", cuda.lib("vec_hist")(
        cnt.data_ptr(), data.data_ptr(), vbit.data_ptr(), num.data_ptr(), K, layout.capacity,
        head.data_ptr(), vals.data_ptr(), vbits.data_ptr(), slots.data_ptr(), n,
        _stream(slots.device)))
    vec_hist.launches += 1


vec_hist.launches = 0


def vec_topk(store: Dict[str, torch.Tensor], layout: StoreLayout, j: int,
             contrib: torch.Tensor, slots: torch.Tensor) -> None:
    """K21 (replaces ``ops/hash_store.py:_vec_topk``): merge a batch into
    the top-K column at component ``j``, in place.  Rows whose value is not
    the sentinel (the dtype floor, ``comp.init``) and whose slot is real
    are ordered by (slot, value descending, row) (``distinct``: a value
    equal to the one before it in its slot leaves for the dump slot, then
    the order is taken again); the first row of each slot's run merges its
    run's first K values with the slot's stored K, sorted descending as
    XLA sorts (NaN first, equal values in reverse order of the merged
    list; ``distinct`` drops equal neighbours and sorts again), and writes
    the first K.  The dump row takes the merge of the last row that is not
    a run's first.  One cooperative launch, no sort; the scratch is made
    once per store size and batch size (:func:`_topk_scratch`)."""
    if not slots.is_cuda:
        vec_topk_plain(store, layout, j, contrib, slots)
        return
    comp = layout.components[j]
    K = comp.width
    c1 = layout.capacity + 1
    n = slots.shape[0]
    col = store[f"a{j}"]
    _expect(col, col.dtype, (c1, K))
    _expect(slots, torch.int32, (n,))
    if K > 256:
        raise ValueError("vec_topk merges at most 256 values a slot")
    if n == 0:
        return
    vals = contrib.to(col.dtype).contiguous()
    esize, isfloat = _elem(col)
    distinct = comp.mode == "distinct"
    dev = slots.device
    slot_buf, ctrl, rows32, rows64 = _topk_scratch(dev, c1, n, K)
    cuda.check("vec_topk", cuda.lib("vec_topk")(
        vals.data_ptr(), esize, isfloat, init_bits(comp), slots.data_ptr(), n, layout.capacity,
        col.data_ptr(), K, int(distinct), slot_buf.data_ptr(), ctrl.data_ptr(), rows32.data_ptr(),
        rows64.data_ptr(), _stream(dev)))
    vec_topk.launches += 1
    vec_topk.mode_launches["distinct" if distinct else "plain"] += 1


vec_topk.launches = 0
vec_topk.mode_launches = {"plain": 0, "distinct": 0}

#: K21's scratch: per (device, capacity + 1) the slots' ticket counts (0)
#: and bucket offsets (-1) and the control words (0), which the kernel
#: leaves so; per (device, rows, K) its row buffers
_TOPK_SLOTS: Dict[tuple, tuple] = {}
_TOPK_ROWS: Dict[tuple, tuple] = {}
#: ``ksql_vec_topk``'s control words (csrc/vec_topk.cu, kCtrlWords)
TOPK_CTRL_WORDS = 11


def _topk_scratch(dev: torch.device, c1: int, n: int, K: int):
    key = (str(dev), c1)
    if key not in _TOPK_SLOTS:
        slot_buf = torch.full((2 * c1,), -1, dtype=torch.int32, device=dev)
        slot_buf[:c1] = 0
        _TOPK_SLOTS[key] = (slot_buf, torch.zeros(TOPK_CTRL_WORDS, dtype=torch.int64, device=dev))
    rkey = (str(dev), n, K)
    if rkey not in _TOPK_ROWS:
        _TOPK_ROWS[rkey] = (torch.empty(3 * n, dtype=torch.int32, device=dev),
                            torch.empty((K + 7) * n, dtype=torch.int64, device=dev))
    return _TOPK_SLOTS[key] + _TOPK_ROWS[rkey]


def vec_remove(store: Dict[str, torch.Tensor], layout: StoreLayout, j: int,
               contribs: Sequence[torch.Tensor], slots: torch.Tensor) -> None:
    """K23 (replaces ``ops/hash_store.py:_vec_remove``, COLLECT_LIST's undo
    in a table aggregation): remove stored occurrences from the collect
    group at component ``j``, in place, before K20 folds the same rows.  A
    row removes when its head ``contribs[j] < 0`` and its slot is real; the
    r-th such row of a (slot, value, null bit) — in row order, values
    equal by IEEE ``==`` (±0.0 alike, a NaN equal to nothing) — claims the
    r-th equal entry among the slot's first ``min(count, K)``.  Each
    touched slot drops its claimed entries, shifts the rest left in order
    and zeroes the tail; its count (the logical one, which may exceed K)
    falls by the entries removed.  When some row of the batch is not the
    lowest undo row of its slot, the dump row is rewritten as well: its
    entries past ``min(count, K)`` become 0.  Every rewritten double goes
    through an add to +0.0, so a stored -0.0 comes back +0.0."""
    if not slots.is_cuda:
        vec_remove_plain(store, layout, j, contribs, slots)
        return
    K = layout.components[j + 1].width
    c1 = layout.capacity + 1
    n = slots.shape[0]
    cnt, data, vbit = store[f"a{j}"], store[f"a{j + 1}"], store[f"a{j + 2}"]
    _expect(cnt, torch.int64, (c1,))
    _expect(data, data.dtype, (c1, K))
    _expect(vbit, torch.int8, (c1, K))
    _expect(slots, torch.int32, (n,))
    head = contribs[j].to(torch.int64).contiguous()
    vals = contribs[j + 1].to(data.dtype).contiguous()
    vbits = contribs[j + 2].to(torch.int8).contiguous()
    esize, isfloat = _elem(data)
    dev = slots.device
    counts, ctrl = _remove_scratch(dev, c1)
    buf = torch.empty(3 * n + c1, dtype=torch.int32, device=dev)
    cuda.check("vec_remove", cuda.lib("vec_remove", "ksql_vec_remove")(
        head.data_ptr(), vals.data_ptr(), vbits.data_ptr(), esize, isfloat, slots.data_ptr(), n,
        layout.capacity, cnt.data_ptr(), data.data_ptr(), vbit.data_ptr(), K, counts.data_ptr(),
        ctrl.data_ptr(), buf.data_ptr(), _stream(dev)))
    vec_remove.launches += 1


vec_remove.launches = 0

#: K23's scratch per (device, capacity + 1): the slots' ticket counts and
#: the work list's two counters, zero between calls (the kernel leaves them
#: so)
_REMOVE_SCRATCH: Dict[tuple, tuple] = {}


def _remove_scratch(dev: torch.device, c1: int):
    key = (str(dev), c1)
    if key not in _REMOVE_SCRATCH:
        z = torch.zeros(c1 + 2, dtype=torch.int32, device=dev)
        _REMOVE_SCRATCH[key] = (z[:c1], z[c1:])
    return _REMOVE_SCRATCH[key]


KERNEL_WRAPPERS = (vec_collect, vec_topk, vec_hist, vec_remove)


# -------------------------------------------------------------- the driver
def fold_vectors(store: Dict[str, torch.Tensor], layout: StoreLayout, slots: torch.Tensor,
                 contribs: Sequence[torch.Tensor], vec_undo: bool = False) -> None:
    """The vector branches of the reference's ``scatter_combine``, walking
    the component list as it does: a ``vec_count`` heads a collect group
    (3 components) or, in ``hist`` mode, a histogram group (4); a ``topk``
    stands alone.  The scalar components are K3's; a layout without
    vector groups folds nothing here.  ``vec_undo`` (a table aggregation's
    undo side) runs K23's removal on each collect group before K20; a
    histogram's undo is its negative heads, which K20 skips and K22 adds."""
    comps: List = list(layout.components)
    j = 0
    while j < len(comps):
        comp = comps[j]
        if comp.combine == "vec_count" and comp.mode == "hist":
            vec_collect(store, layout, j, contribs, slots, "hist")
            vec_hist(store, layout, j, contribs, slots)
            j += 4
        elif comp.combine == "vec_count":
            if vec_undo:
                vec_remove(store, layout, j, contribs, slots)
            vec_collect(store, layout, j, contribs, slots, comps[j + 1].mode)
            j += 3
        elif comp.combine == "topk":
            vec_topk(store, layout, j, contribs[j], slots)
            j += 1
        else:
            j += 1
