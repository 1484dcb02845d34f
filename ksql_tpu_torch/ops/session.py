"""SESSION-window aggregation on the card: the sort, the stored-session
gather, the segmented interval merge and the store rewrite.

The port of ``ksql_tpu/runtime/lowering.py``'s ``post_session_exchange``
(B16) and the late drop of ``pre_session_exchange``.  A batch of ``n``
rows becomes ``m = n (S + 1)`` *items*: the rows as singleton sessions,
then, for each first active row of a key, the ``S`` stored sessions
``(khash, i)``, ``i = 0..S-1``, of its key (item ``n + i n + r`` is row
``r``'s session ``i``).  The items are sorted by (key hash, start); every
run of equal keys is cut into segments wherever a start lies more than the
inactivity gap past the running end; each segment becomes one session.
The store keeps a key's sessions in slots ``(khash, rank)``,
``rank = 0..S-1`` in start order, with ``sess_start``/``sess_end`` and the
aggregate components ``a<j>`` (component 0 the ts watermark) per slot.

Five hand-written CUDA kernels (``csrc/``) carry the work, beside K1's
session mode (``hash_store.session_prologue``) and K2 (``probe_insert``,
reused as it is):

* K13 ``seg_sort``: a stable sort of int64 key pairs, ties by index (the
  order of ``jnp.lexsort((k2, k1))``), as an int32 permutation: one
  block in one launch up to 8,192 items (the session rows, every vector
  order), block-sorted 2,048-item tiles and merge passes past it (the
  session items).
* K14 ``session_items``: :func:`session_prologue` (the running late-drop
  clock and the batch's stream time), :func:`session_first` (the first
  active row of each key, from K13's order of the rows) and
  :func:`session_items` (the stored-session gather into the item layout).
* K15 ``session_merge``: the permutation applied to every item column,
  the segmented interval merge, the per-segment folds, each segment's
  rank within its key and the slot-overflow count ``sess_ovf``; its
  ``argset`` mode also carries EARLIEST/LATEST_BY_OFFSET's payloads, the
  sum over the segment of the payloads of the items whose order equals
  the segment's (the reference's ``segment_sum`` of the winners).  It
  writes no store state, so the caller reads ``sess_ovf`` once, doubles
  ``S`` and starts again from the gather before anything is written (the
  reference re-runs a functional step instead).
* K16 ``session_write``: :func:`session_delete` marks the merged-away
  stored sessions as graves before K2 inserts the new set (so K2
  reclaims a matching grave); :func:`session_write` writes the merged
  sessions at K2's slots, the dump slot, ``dirty`` and the stream time,
  and the 2m emission lanes (a tombstone per touched stored session, then
  the merged aggregate per segment that holds a row).

A segment's values are kept at its first sorted position (``segfirst``):
K15 writes them there and every item reads them through ``segfirst``; the
other positions of those arrays are unspecified.  As in
``ops/hash_store.py``, each wrapper launches its kernel for CUDA tensors
and counts the launch in ``<kernel>.launches`` (K14 and K16 also in
``<kernel>.mode_launches[mode]``); for CPU tensors it runs the plain torch
twin beside it (``*_plain``), which is also the kernel's oracle on the
card.  Every int64 sum wraps, as XLA's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import (
    _COMBINE_CODES,
    _DTYPE_CODES,
    _DTYPES,
    AggComponent,
    _expect,
    _stream,
    _xla_signed_zero,
    init_bits,
    probe_find_plain,
    slot_base,
)

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
#: a dead item's key hash is SENTINEL + its item index: unique, so a dead
#: item never merges (a real key hash may lie above it: they interleave)
SENTINEL = 1 << 62

Items = Dict[str, object]


# ------------------------------------------------------------ K13: seg_sort
#: the most items K13 sorts in one block, with no scratch (csrc/seg_sort.cu
#: kBlockMax): keys and two index buffers in 196,608 bytes of shared memory
SEG_SORT_BLOCK_MAX = 8192


def seg_sort_plain(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Plain twin of K13 — see :func:`seg_sort`."""
    order = torch.argsort(k2, stable=True)
    order = order[torch.argsort(k1[order], stable=True)]
    return order.to(torch.int32)


def seg_sort(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """K13 (replaces the two ``jnp.lexsort`` calls of ``runtime/lowering.py:
    post_session_exchange``): the permutation that sorts items by signed
    int64 ``k1``, then ``k2``, then item index (``jnp.lexsort((k2, k1))``
    is stable), as int32.  Up to ``SEG_SORT_BLOCK_MAX`` items one block
    sorts them in one launch; past it blocks sort 2,048-item tiles and
    merge passes join them, in scratch of 40 bytes an item."""
    if not k1.is_cuda:
        return seg_sort_plain(k1, k2)
    n = k1.shape[0]
    _expect(k1, torch.int64, (n,))
    _expect(k2, torch.int64, (n,))
    if n > (1 << 31) - SEG_SORT_BLOCK_MAX:
        raise ValueError("seg_sort sorts fewer than 2^31 - 8,192 items")
    perm = torch.empty(n, dtype=torch.int32, device=k1.device)
    # two ping-pong buffers of (k1, k2, index): 20 bytes an item each
    work = torch.empty(5 * n, dtype=torch.int64, device=k1.device) if n > SEG_SORT_BLOCK_MAX else None
    fn = cuda.lib("seg_sort")
    cuda.check("seg_sort", fn(k1.data_ptr(), k2.data_ptr(), n, perm.data_ptr(),
                              None if work is None else work.data_ptr(), _stream(k1.device)))
    seg_sort.launches += 1
    return perm


seg_sort.launches = 0


# ------------------------------------------------------- K14: session_items
def session_prologue_plain(row_valid, ts, active, max_ts, grace, gap):
    """Plain twin of K14's prologue — see :func:`session_prologue`."""
    neg = torch.full_like(ts, INT64_MIN)
    cm = torch.maximum(torch.cummax(torch.where(row_valid, ts, neg), 0).values, max_ts)
    act = active & (ts + grace + gap >= cm)
    bst = torch.maximum(max_ts, cm.max())
    batch_max = torch.where(act, ts, neg).max()
    return act, torch.stack([bst, batch_max])


def session_prologue(row_valid: torch.Tensor, ts: torch.Tensor, active: torch.Tensor,
                     max_ts: torch.Tensor, grace: int, gap: int):
    """K14, prologue mode (replaces the late drop of ``runtime/lowering.py:
    pre_session_exchange`` and ``batch_stream_time``): the running stream
    time ``cm`` in arrival order, the max of ts over the ``row_valid`` rows
    so far seeded with the store's ``max_ts``; a row stays ``active`` while
    ``ts + grace + gap >= cm``.  Returns ``(active, scal)``, ``scal`` int64
    ``[batch stream time max(max_ts, cm), max ts over the active rows]``.
    One block; writes no state."""
    if not ts.is_cuda:
        return session_prologue_plain(row_valid, ts, active, max_ts, grace, gap)
    n = ts.shape[0]
    _expect(row_valid, torch.bool, (n,))
    _expect(ts, torch.int64, (n,))
    _expect(active, torch.bool, (n,))
    _expect(max_ts, torch.int64, ())
    act = torch.empty(n, dtype=torch.bool, device=ts.device)
    scal = torch.empty(2, dtype=torch.int64, device=ts.device)
    fn = cuda.lib("session_items", "ksql_session_prologue")
    cuda.check("session_items", fn(row_valid.data_ptr(), ts.data_ptr(), active.data_ptr(), n,
                                   max_ts.data_ptr(), int(grace), int(gap), act.data_ptr(),
                                   scal.data_ptr(), _stream(ts.device)))
    session_items.launches += 1
    session_items.mode_launches["prologue"] += 1
    return act, scal


def session_first_plain(order0, khash, active):
    """Plain twin of K14's first mode — see :func:`session_first`."""
    o = order0.long()
    khs = torch.where(active, khash, torch.zeros_like(khash))[o]
    firsts = torch.ones_like(active)
    firsts[1:] = khs[1:] != khs[:-1]
    firsts &= active[o]
    first_occ = torch.zeros_like(active)
    first_occ[o] = firsts
    return first_occ & active


def session_first(order0: torch.Tensor, khash: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """K14, first mode (replaces ``first_occ`` of ``runtime/lowering.py:
    post_session_exchange``): ``order0`` is K13's order of the rows by
    ``(where(active, khash, 0), 0)``; a sorted position whose key differs
    from the one before it (or the first position) marks its row, if
    active, as its key's first active row.  Returns ``first_occ``."""
    if not khash.is_cuda:
        return session_first_plain(order0, khash, active)
    n = khash.shape[0]
    _expect(order0, torch.int32, (n,))
    _expect(khash, torch.int64, (n,))
    _expect(active, torch.bool, (n,))
    first_occ = torch.empty(n, dtype=torch.bool, device=khash.device)
    fn = cuda.lib("session_items", "ksql_session_first")
    cuda.check("session_items", fn(order0.data_ptr(), khash.data_ptr(), active.data_ptr(), n,
                                   first_occ.data_ptr(), _stream(khash.device)))
    session_items.launches += 1
    session_items.mode_launches["first"] += 1
    return first_occ


def session_items_plain(store, capacity, slots_per_key, khash, active, first_occ, ts, reprs,
                        contribs, gap, grace, scal) -> Items:
    """Plain twin of K14's items mode — see :func:`session_items`."""
    n = khash.shape[0]
    dev = khash.device
    bst = scal[0]
    zero = torch.zeros_like(khash)
    kh, start, end, alive = [torch.where(active, khash, zero)], [ts], [ts], [active]
    slot = [torch.full((n,), capacity, dtype=torch.int32, device=dev)]
    rep, comps = [reprs], [list(contribs)]
    # only the first rows walk the store: the others read the dump slot
    walk = first_occ.nonzero().squeeze(1)
    kw = khash[walk]
    ones = torch.ones_like(walk, dtype=torch.bool)
    for i in range(slots_per_key):
        s = torch.full((n,), capacity, dtype=torch.int32, device=dev)
        s[walk] = probe_find_plain(store, capacity, kw, torch.full_like(kw, i), ones)
        sl = s.long()
        found = first_occ & (s != capacity)
        live = found & (store["sess_end"][sl] + gap + grace >= bst)
        kh.append(torch.where(live, khash, zero))
        start.append(store["sess_start"][sl])
        end.append(store["sess_end"][sl])
        alive.append(live)
        slot.append(s)
        rep.append(torch.stack([store[f"key{k}"][sl] for k in range(reprs.shape[0])]))
        comps.append([store[f"a{j}"][sl] for j in range(len(contribs))])
    alive_m = torch.cat(alive)
    m = alive_m.shape[0]
    sentinel = torch.arange(m, dtype=torch.int64, device=dev) + SENTINEL
    zeros = torch.zeros(m, dtype=torch.int64, device=dev)
    return {
        "kh": torch.where(alive_m, torch.cat(kh), sentinel),
        "start": torch.where(alive_m, torch.cat(start), zeros),
        "end": torch.where(alive_m, torch.cat(end), zeros),
        "alive": alive_m,
        "slot": torch.cat(slot),
        "reprs": torch.cat(rep, dim=1),
        "comps": [torch.cat([c[j] for c in comps]) for j in range(len(contribs))],
    }


def session_items(store: Dict[str, torch.Tensor], capacity: int, slots_per_key: int,
                  khash: torch.Tensor, active: torch.Tensor, first_occ: torch.Tensor,
                  ts: torch.Tensor, reprs: torch.Tensor, contribs: Sequence[torch.Tensor],
                  gap: int, grace: int, scal: torch.Tensor) -> Items:
    """K14, items mode (replaces the item arrays of ``runtime/lowering.py:
    post_session_exchange``, its ``probe_find`` loop and its gathers): the
    ``m = n (S + 1)`` items in the layout ``[rows | session i of row r at
    n + i n + r]``.  A row item is the row as a singleton session (alive
    when active).  A store item of a ``first_occ`` row walks the store for
    ``(khash, i)`` (``ops/hash_store.py:probe_find``'s walk: a truly empty
    slot ends it, graves are walked past, a key not found reads the dump
    slot ``capacity``); any other store item reads the dump slot.  It
    gathers ``sess_start``, ``sess_end``, ``key<k>`` and ``a<j>`` at that
    slot, and is alive when found and ``sess_end + gap + grace`` reaches
    the batch stream time ``scal[0]``.  A dead item takes the key hash
    ``SENTINEL + its index`` and start = end = 0; its key reprs and
    components are kept as gathered.

    Returns ``{kh, start, end, alive, slot (int32), reprs [k, m], comps}``
    (``comps`` one tensor per store component, in its dtype).  Writes no
    state."""
    if not khash.is_cuda:
        return session_items_plain(store, capacity, slots_per_key, khash, active, first_occ, ts,
                                   reprs, contribs, gap, grace, scal)
    k, n = reprs.shape
    m = n * (slots_per_key + 1)
    c1 = capacity + 1
    if m >= 1 << 31:
        raise ValueError("session_items: more than 2^31 items")
    for name, dt in (("occ", torch.bool), ("grave", torch.bool), ("khash", torch.int64),
                     ("wstart", torch.int64), ("sess_start", torch.int64),
                     ("sess_end", torch.int64)):
        _expect(store[name], dt, (c1,))
    _expect(khash, torch.int64, (n,))
    _expect(active, torch.bool, (n,))
    _expect(first_occ, torch.bool, (n,))
    _expect(ts, torch.int64, (n,))
    _expect(reprs, torch.int64, (k, n))
    _expect(scal, torch.int64, (2,))
    dev = khash.device
    out: Items = {
        "kh": torch.empty(m, dtype=torch.int64, device=dev),
        "start": torch.empty(m, dtype=torch.int64, device=dev),
        "end": torch.empty(m, dtype=torch.int64, device=dev),
        "alive": torch.empty(m, dtype=torch.bool, device=dev),
        "slot": torch.empty(m, dtype=torch.int32, device=dev),
        "reprs": torch.empty((k, m), dtype=torch.int64, device=dev),
        "comps": [],
    }
    keys = []
    for i in range(k):
        _expect(store[f"key{i}"], torch.int64, (c1,))
        keys += [store[f"key{i}"].data_ptr()]
    comps = []
    for j, c in enumerate(contribs):
        col = store[f"a{j}"]
        _expect(col, col.dtype, (c1,))
        _expect(c, col.dtype, (n,))
        o = torch.empty(m, dtype=col.dtype, device=dev)
        out["comps"].append(o)
        comps += [col.data_ptr(), c.data_ptr(), o.data_ptr(), col.element_size()]
    fn = cuda.lib("session_items", "ksql_session_items")
    cuda.check("session_items", fn(
        store["occ"].data_ptr(), store["grave"].data_ptr(), store["khash"].data_ptr(),
        store["wstart"].data_ptr(), store["sess_start"].data_ptr(), store["sess_end"].data_ptr(),
        cuda.host_i64(keys), k, cuda.host_i64(comps), len(contribs), capacity, slots_per_key,
        khash.data_ptr(), active.data_ptr(), first_occ.data_ptr(), ts.data_ptr(),
        reprs.data_ptr(), n, int(gap), int(grace), scal.data_ptr(),
        out["kh"].data_ptr(), out["start"].data_ptr(), out["end"].data_ptr(),
        out["alive"].data_ptr(), out["slot"].data_ptr(), out["reprs"].data_ptr(),
        _stream(dev),
    ))
    session_items.launches += 1
    session_items.mode_launches["items"] += 1
    return out


session_items.launches = 0
session_items.mode_launches = {"prologue": 0, "first": 0, "items": 0}


# ------------------------------------------------------ K15: session_merge
def _seg_fold(v, segfirst, comp: AggComponent, alive, pos):
    """One component's per-segment fold, indexed by segment first
    position: the dead items' values replaced by the component's init
    (``where(alive, v, init)``), then sum / min / max.  Float sums add in
    item order (one item a segment per round), the order of XLA's CPU
    ``segment_sum``; float min/max follow XLA's rules (NaN wins, -0.0 below
    +0.0)."""
    m = v.shape[0]
    init = torch.tensor(comp.init, dtype=v.dtype, device=v.device)
    v = torch.where(alive, v, init)
    if comp.combine == "add":
        out = torch.zeros(m, dtype=v.dtype, device=v.device)
        if not v.is_floating_point():
            return out.index_add_(0, segfirst, v)
        for t in range(int(pos.max()) + 1 if m else 0):
            sel = pos == t
            out.index_add_(0, segfirst[sel], v[sel])
        return out
    if comp.combine not in ("min", "max"):
        raise ValueError(comp.combine)
    identity = {torch.float64: float("inf"), torch.int32: (1 << 31) - 1}.get(v.dtype, INT64_MAX)
    if comp.combine == "max":
        identity = -identity if v.dtype == torch.float64 else -identity - 1
    out = torch.full((m,), identity, dtype=v.dtype, device=v.device)
    before = out.clone() if out.is_floating_point() else None
    out.scatter_reduce_(0, segfirst, v, "amin" if comp.combine == "min" else "amax")
    if before is not None:
        _xla_signed_zero(out, before, segfirst, v, comp.combine)
    return out


def _segend(kh, end):
    """The reference's segmented running max of ``end`` within equal
    ``kh`` (``associative_scan`` of its ``seg_combine``), Hillis-Steele."""
    e = end.clone()
    d = 1
    while d < e.shape[0]:
        same = kh[:-d] == kh[d:]
        e = torch.cat([e[:d], torch.where(same, torch.maximum(e[:-d], e[d:]), e[d:])])
        d *= 2
    return e


def _seg_folds(comps, sf, components, alive, pos):
    """Every component's per-segment fold; an 'argset' payload is the sum,
    in item order from +0, of the values of the alive items whose order
    (the nearest order component before it) equals the segment's and is
    not the init (``post_session_exchange``'s argset branch, :3671-3694 of
    the reference): -0.0 comes out +0.0, NaN stays NaN."""
    out = []
    last = 0
    everyone = torch.ones_like(alive)
    for j, (v, comp) in enumerate(zip(comps, components)):
        if comp.combine != "argset":
            out.append(_seg_fold(v, sf, comp, alive, pos))
            last = j
            continue
        init = torch.tensor(components[last].init, dtype=comps[last].dtype, device=v.device)
        order = torch.where(alive, comps[last], init)
        winner = alive & (order == out[last][sf]) & (order != init)
        payload = torch.where(winner, v, torch.zeros_like(v))
        out.append(_seg_fold(payload, sf, AggComponent("add", comp.dtype, 0), everyone, pos))
    return out


def session_merge_plain(items: Items, perm, n, slots_per_key, gap, components, capacity):
    """Plain twin of K15 — see :func:`session_merge`."""
    p = perm.long()
    m = p.shape[0]
    dev = p.device
    kh, start, end = items["kh"][p], items["start"][p], items["end"][p]
    alive, slot = items["alive"][p], items["slot"][p]
    reprs = items["reprs"][:, p]
    comps = [c[p] for c in items["comps"]]
    isrow = (p < n) & alive
    rowidx = p % n
    ar = torch.arange(m, dtype=torch.int64, device=dev)
    segend = _segend(kh, end)
    boundary = torch.ones(m, dtype=torch.bool, device=dev)
    boundary[1:] = (kh[1:] != kh[:-1]) | (start[1:] > segend[:-1] + gap)
    zero = torch.zeros_like(ar)
    segfirst = torch.cummax(torch.where(boundary, ar, zero), 0).values
    keyb = torch.ones(m, dtype=torch.bool, device=dev)
    keyb[1:] = kh[1:] != kh[:-1]
    keyfirst = torch.cummax(torch.where(keyb, ar, zero), 0).values
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    rank = seg - seg[keyfirst]
    pos = ar - segfirst

    def seg_max(x, fill):
        return torch.full((m,), fill, dtype=x.dtype, device=dev).scatter_reduce_(0, segfirst, x, "amax")

    def seg_min(x, fill):
        return torch.full((m,), fill, dtype=x.dtype, device=dev).scatter_reduce_(0, segfirst, x, "amin")

    neg = torch.full_like(ar, INT64_MIN)
    seg_alive = seg_max(alive.to(torch.int32), 0) > 0
    seg_reprs = torch.stack([seg_max(torch.where(alive, r, neg), INT64_MIN) for r in reprs]) \
        if reprs.shape[0] else reprs.new_zeros((0, m))
    sf = segfirst
    winner = boundary & seg_alive[sf]
    return {
        "kh": kh, "start": start, "end": end, "alive": alive, "isrow": isrow,
        "slot": slot, "reprs": reprs, "comps": comps,
        "segfirst": sf.to(torch.int32), "rank": rank,
        "seg_start": seg_min(start, INT64_MAX), "seg_end": seg_max(end, INT64_MIN),
        "seg_alive": seg_alive, "seg_has_row": seg_max((isrow & alive).to(torch.int32), 0) > 0,
        "seg_minrow": seg_min(torch.where(isrow & alive, rowidx, torch.full_like(ar, INT64_MAX)),
                              INT64_MAX),
        "seg_reprs": seg_reprs,
        "seg_comps": _seg_folds(comps, sf, components, alive, pos),
        "winner": winner,
        "ins_act": winner & (rank < slots_per_key),
        "base": slot_base(kh, rank, capacity),
        "ins_reprs": seg_reprs[:, sf],
        "sess_ovf": (winner & (rank >= slots_per_key)).sum(),
    }


#: sorted positions K15's merge launch takes at once (``kTile`` in
#: ``csrc/session_merge.cu``; a half or a quarter of it for a query whose
#: tile would not fit a block's shared memory): a block owns the runs that
#: open in its tile and follows its last run tile by tile
MERGE_TILE = 1024

#: K15's per-item outputs (sorted order), and its per-segment outputs (at
#: each segment's first position; read through ``segfirst``)
MERGE_ITEM_KEYS = ("kh", "start", "end", "alive", "isrow", "slot", "reprs", "comps", "segfirst",
                   "rank", "winner", "ins_act", "base", "ins_reprs")
MERGE_SEG_KEYS = ("seg_start", "seg_end", "seg_alive", "seg_has_row", "seg_minrow", "seg_reprs",
                  "seg_comps")


def session_merge(items: Items, perm: torch.Tensor, n: int, slots_per_key: int, gap: int,
                  components: Sequence[AggComponent], capacity: int) -> Dict[str, object]:
    """K15 (replaces the sort-apply, ``associative_scan``, segment folds and
    rank of ``runtime/lowering.py:post_session_exchange``, :3618-3715 of
    the reference): ``perm`` (K13's order of the items by ``(kh, start)``)
    applied to every item column; the running max of ``end`` within each
    run of equal ``kh``; a segment boundary at a key's first item and
    wherever ``start > running end of the item before + gap``; per segment
    its min start, max end, whether it is alive and holds a row, its lowest
    row index, its key reprs (max over alive items) and each component's
    fold over its items (dead items as the init; ``add`` in item order);
    per item its segment's first position ``segfirst`` and the segment's
    rank within its key; ``winner`` (a boundary item of an alive segment),
    ``ins_act = winner & rank < S``, K2's base slot for ``(kh, rank)`` and
    its key reprs; ``sess_ovf``, the winners with ``rank >= S``.  With an
    'argset' component (the ``argset`` mode) the segment's payload is the
    sum of its winners' values (:func:`_seg_folds`); its order component
    must be an int64 min or max.  Writes no state.  The sorted position 0 always opens a key and a segment (the
    reference's formula agrees unless a key hash is exactly -1)."""
    if not perm.is_cuda:
        return session_merge_plain(items, perm, n, slots_per_key, gap, components, capacity)
    m = perm.shape[0]
    reprs = items["reprs"]
    k = reprs.shape[0]
    _expect(perm, torch.int32, (m,))
    for name, dt in (("kh", torch.int64), ("start", torch.int64), ("end", torch.int64),
                     ("alive", torch.bool), ("slot", torch.int32)):
        _expect(items[name], dt, (m,))
    _expect(reprs, torch.int64, (k, m))
    dev = perm.device

    def e(dt, shape=(m,)):
        return torch.empty(shape, dtype=dt, device=dev)

    out = {
        "kh": e(torch.int64), "start": e(torch.int64), "end": e(torch.int64),
        "alive": e(torch.bool), "isrow": e(torch.bool), "slot": e(torch.int32),
        "reprs": e(torch.int64, (k, m)), "comps": [], "segfirst": e(torch.int32),
        "rank": e(torch.int64), "seg_start": e(torch.int64), "seg_end": e(torch.int64),
        "seg_alive": e(torch.bool), "seg_has_row": e(torch.bool), "seg_minrow": e(torch.int64),
        "seg_reprs": e(torch.int64, (k, m)), "seg_comps": [], "winner": e(torch.bool),
        "ins_act": e(torch.bool), "base": e(torch.int32), "ins_reprs": e(torch.int64, (k, m)),
        "sess_ovf": torch.empty((), dtype=torch.int64, device=dev),
    }
    desc: List[int] = []
    last = None
    for src, comp in zip(items["comps"], components):
        if comp.combine == "argset" and (last is None or last.combine not in ("min", "max")
                                         or last.dtype != "int64"):
            raise ValueError("session_merge: an argset payload needs an int64 min/max order")
        if comp.combine != "argset":
            last = comp
        dt = _DTYPES[comp.dtype]
        _expect(src, dt, (m,))
        srt, seg = e(dt), e(dt)
        out["comps"].append(srt)
        out["seg_comps"].append(seg)
        desc += [src.data_ptr(), srt.data_ptr(), seg.data_ptr(),
                 _COMBINE_CODES[comp.combine] * 3 + _DTYPE_CODES[comp.dtype], init_bits(comp)]
    fn = cuda.lib("session_merge")
    cuda.check("session_merge", fn(
        perm.data_ptr(), m, n, slots_per_key, int(gap), capacity,
        items["kh"].data_ptr(), items["start"].data_ptr(), items["end"].data_ptr(),
        items["alive"].data_ptr(), items["slot"].data_ptr(), reprs.data_ptr(), k,
        cuda.host_i64(desc), len(components),
        *(out[name].data_ptr() for name in (
            "kh", "start", "end", "alive", "isrow", "slot", "reprs", "segfirst", "rank",
            "seg_start", "seg_end", "seg_alive", "seg_has_row", "seg_minrow", "seg_reprs",
            "winner", "ins_act", "base", "ins_reprs", "sess_ovf")),
        _stream(dev),
    ))
    session_merge.launches += 1
    argset = any(comp.combine == "argset" for comp in components)
    session_merge.mode_launches["argset" if argset else "merge"] += 1
    return out


session_merge.launches = 0
#: ``merge``: add/min/max folds only; ``argset``: with EARLIEST/LATEST's
#: payloads
session_merge.mode_launches = {"merge": 0, "argset": 0}


# ------------------------------------------------------ K16: session_write
#: items a block of K16's write mode takes (csrc/session_write.cu kWriteThreads)
WRITE_THREADS = 256


def session_delete_plain(store, capacity, merged) -> None:
    """Plain twin of K16's delete mode — see :func:`session_delete`."""
    dm = ~merged["isrow"] & merged["alive"]
    tgt = merged["slot"][dm].long()
    store["occ"][tgt] = False
    store["grave"][tgt] = True
    store["occ"][capacity] = False
    store["grave"][capacity] = False


def session_delete(store: Dict[str, torch.Tensor], capacity: int, merged: Dict[str, object]) -> None:
    """K16, delete mode (replaces the deletes of ``runtime/lowering.py:
    post_session_exchange``, which run before its ``probe_insert``): every
    alive stored-session item (``~isrow & alive``) turns its slot into a
    grave, so that K2 reclaims it when the merged set puts a session of the
    same ``(khash, rank)`` back; the dump slot ends with occ and grave
    False."""
    slot = merged["slot"]
    if not slot.is_cuda:
        session_delete_plain(store, capacity, merged)
        return
    m = slot.shape[0]
    c1 = capacity + 1
    _expect(store["occ"], torch.bool, (c1,))
    _expect(store["grave"], torch.bool, (c1,))
    _expect(slot, torch.int32, (m,))
    _expect(merged["isrow"], torch.bool, (m,))
    _expect(merged["alive"], torch.bool, (m,))
    fn = cuda.lib("session_write", "ksql_session_delete")
    cuda.check("session_write", fn(
        store["occ"].data_ptr(), store["grave"].data_ptr(), capacity, slot.data_ptr(),
        merged["isrow"].data_ptr(), merged["alive"].data_ptr(), m, _stream(slot.device)))
    session_write.launches += 1
    session_write.mode_launches["delete"] += 1


def session_write_plain(store, capacity, merged, ins_slots, scal) -> Dict[str, object]:
    """Plain twin of K16's write mode — see :func:`session_write`."""
    m = ins_slots.shape[0]
    dev = ins_slots.device
    sf = merged["segfirst"].long()
    tgt = torch.where(merged["ins_act"], ins_slots, torch.full_like(ins_slots, capacity)).long()
    real = tgt != capacity
    dumped = (~real).nonzero()
    last = int(dumped[-1]) if dumped.numel() else -1
    cols = [("sess_start", merged["seg_start"]), ("sess_end", merged["seg_end"])]
    cols += [(f"a{j}", c) for j, c in enumerate(merged["seg_comps"])]
    for name, seg in cols:
        vals = seg[sf].to(store[name].dtype)
        store[name][tgt[real]] = vals[real]
        if last >= 0:
            store[name][capacity] = vals[last]
    store["dirty"][tgt] = True
    store["dirty"][capacity] = False
    torch.maximum(store["max_ts"], scal[1], out=store["max_ts"])
    dm = ~merged["isrow"] & merged["alive"]
    has_row = merged["seg_has_row"][sf]
    tomb, emit_seg = dm & has_row, merged["winner"] & has_row
    minrow = merged["seg_minrow"][sf]
    ord_row = torch.where(minrow == INT64_MAX, torch.zeros_like(minrow), minrow)
    start = merged["start"]
    return {
        "mask": torch.cat([tomb, emit_seg]),
        "keys": [torch.cat([r, s[sf]]) for r, s in zip(merged["reprs"], merged["seg_reprs"])],
        "comps": [torch.cat([c, s[sf]]) for c, s in zip(merged["comps"], merged["seg_comps"])],
        "ws": torch.cat([start, merged["seg_start"][sf]]),
        "we": torch.cat([merged["end"], merged["seg_end"][sf]]),
        "tombstone": torch.cat([torch.ones(m, dtype=torch.bool, device=dev),
                                torch.zeros(m, dtype=torch.bool, device=dev)]),
        "ord_a": torch.cat([ord_row, ord_row]),
        "ord_b": torch.cat([start, torch.full_like(start, INT64_MAX)]),
    }


def session_write(store: Dict[str, torch.Tensor], capacity: int, merged: Dict[str, object],
                  ins_slots: torch.Tensor, scal: torch.Tensor) -> Dict[str, object]:
    """K16, write mode (replaces the store writes and emission lanes of
    ``runtime/lowering.py:post_session_exchange`` after its
    ``probe_insert``): each inserting item (``ins_act``) writes its
    segment's start, end and components at its K2 slot ``ins_slots``; the
    other items all target the dump slot, and the highest such sorted item
    is the one that stays there (XLA applies duplicate ``.at[].set`` in
    order); ``dirty`` is set at the targets, then cleared at the dump slot;
    ``max_ts`` takes the batch's max over active rows ``scal[1]``.

    Returns the 2m emission lanes, part A (item ``p``: the stored session
    it was, a tombstone when it was deleted and its segment holds a row)
    then part B (item ``p``: its segment, emitted at the segment's winner
    when it holds a row): ``mask``, ``keys`` (the key reprs), ``comps``
    (raw components, ``comps[0]`` the ROWTIME), ``ws``/``we``,
    ``tombstone`` (part A), ``ord_a`` (the segment's lowest row, 0 if none)
    and ``ord_b`` (part A's start, then INT64_MAX).  One launch: the last
    block to finish writes the dump slot, ``dirty[C]`` and ``max_ts``."""
    if not ins_slots.is_cuda:
        return session_write_plain(store, capacity, merged, ins_slots, scal)
    m = ins_slots.shape[0]
    c1 = capacity + 1
    k = merged["reprs"].shape[0]
    for name, dt in (("dirty", torch.bool), ("sess_start", torch.int64),
                     ("sess_end", torch.int64)):
        _expect(store[name], dt, (c1,))
    _expect(store["max_ts"], torch.int64, ())
    _expect(ins_slots, torch.int32, (m,))
    _expect(scal, torch.int64, (2,))
    dev = ins_slots.device
    m2 = 2 * m
    # the 2m-row lanes: the int64 ones (ws, we, ord_a, ord_b, the keys) as
    # the rows of one allocation, mask and tombstone of another
    wide = torch.empty((4 + k, m2), dtype=torch.int64, device=dev).unbind(0)
    flags = torch.empty((2, m2), dtype=torch.bool, device=dev).unbind(0)
    ncomp = len(merged["comps"])
    lanes = {"ws": wide[0], "we": wide[1], "ord_a": wide[2], "ord_b": wide[3], "keys": list(wide[4:]),
             "comps": [torch.empty(m2, dtype=c.dtype, device=dev) for c in merged["comps"]],
             "mask": flags[0], "tombstone": flags[1]}
    _expect(merged["reprs"], torch.int64, (k, m))
    _expect(merged["seg_reprs"], torch.int64, (k, m))
    rp, sp = merged["reprs"].data_ptr(), merged["seg_reprs"].data_ptr()
    keys: List[int] = []
    for r, o in enumerate(lanes["keys"]):
        keys += [rp + 8 * m * r, sp + 8 * m * r, o.data_ptr()]
    comps: List[int] = []
    for j, (c, s, o) in enumerate(zip(merged["comps"], merged["seg_comps"], lanes["comps"])):
        col = store[f"a{j}"]
        _expect(col, c.dtype, (c1,))
        comps += [col.data_ptr(), c.data_ptr(), s.data_ptr(), o.data_ptr(), col.element_size()]
    blocks = -(-m // WRITE_THREADS)
    scratch = session_write.scratch.get(dev)
    if scratch is None or scratch.shape[0] < 1 + blocks:
        scratch = session_write.scratch[dev] = torch.zeros(1 + blocks, dtype=torch.int32, device=dev)
    fn = cuda.lib("session_write", "ksql_session_write")
    cuda.check("session_write", fn(
        store["sess_start"].data_ptr(), store["sess_end"].data_ptr(), store["dirty"].data_ptr(),
        store["max_ts"].data_ptr(), capacity, cuda.host_i64(keys), k, cuda.host_i64(comps),
        ncomp, m, ins_slots.data_ptr(),
        *(merged[name].data_ptr() for name in (
            "start", "end", "alive", "isrow", "segfirst", "winner", "ins_act", "seg_start",
            "seg_end", "seg_has_row", "seg_minrow")),
        scal.data_ptr(), scratch.data_ptr(), scratch.shape[0] - 1,
        *(lanes[name].data_ptr() for name in ("mask", "ws", "we", "tombstone", "ord_a", "ord_b")),
        _stream(dev),
    ))
    session_write.launches += 1
    session_write.mode_launches["write"] += 1
    return lanes


session_write.launches = 0
session_write.mode_launches = {"delete": 0, "write": 0}
#: per device, the write mode's int32 scratch: a done count, then one word
#: a block (its highest item aimed at the dump slot); zeroed once, left
#: clean by every call
session_write.scratch = {}

KERNEL_WRAPPERS = (seg_sort, session_items, session_merge, session_write)
