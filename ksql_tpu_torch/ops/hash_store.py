"""Device-resident keyed state store — the port of ``ksql_tpu/ops/hash_store.py``.

An open-addressing hash table laid out as structure-of-arrays on the card
(all columns length ``capacity + 1``; the last slot is the *dump slot* that
absorbs writes from inactive and overflowed rows):

* ``occ`` bool, ``grave`` bool — slot occupied / tombstoned
* ``khash`` int64, ``wstart`` int64 — probe identity
* ``key<i>`` int64, ``knull`` int32 — key reprs and null bits for emission
* ``dirty`` bool, ``max_ts`` int64 scalar, ``overflow`` int64 scalar
* ``a<j>`` — aggregate components (``ops/device_aggs.py``); a sliced
  hopping store widens each to ``[capacity + 1, ring]`` and adds
  ``slice_id`` and ``slast`` (``ops/slicing.py``)
* under EMIT FINAL: ``born`` int64 (first-touch order), ``emitted`` bool,
  and the scalars ``emit_clock`` and ``row_clock`` (``ops/suppress.py``);
  under HAVING retraction: ``hpass`` bool (the slot's last verdict)

The store is updated IN PLACE (the reference's functions return a new
store; PyTorch lets the port keep one set of device buffers).

Four hand-written CUDA kernels (``csrc/``) carry the per-batch work of an
aggregation: ``row_prologue`` (K1), ``probe_insert`` (K2),
``fold_and_mark`` (K3, whose ``argset`` mode writes the arg-min/max
payloads after its fold) and ``evict`` (K4); the sliced route's K5-K7 live in
``ops/slicing.py``, the vector aggregates' K20-K22 in ``ops/vector.py``.  A stream-table join keeps each table in a store of
the same layout (one key, no components, plus ``v_<col>``/``m_<col>``
value columns): K1's table mode (``table_prologue``) and K2 insert its
changelog, K9
``table_upsert`` writes the last row per key, and K8 ``probe_find`` looks
the stream rows up and gathers the table's columns; K8's find-only mode
(``probe_find_slots``) finds a table aggregation's old groups.  A
table-table join keeps both tables in one such store (``{side}_v_<col>``,
``{side}_m_<col>`` and ``{side}_live`` per side): K8's gather mode
(``probe_gather``) reads the other side at the slots K2 gave a batch of
changes, and K9's side mode (``upsert_side``) writes a side; a foreign-key
join's stores use the same two, and K8's live mode (``probe_find`` with a
``live`` column) finds a left change's right row.
Each wrapper below launches its kernel for CUDA tensors and counts the
launch in ``<wrapper>.launches`` (a wrapper with several modes also in
``<wrapper>.mode_launches[mode]``); for CPU tensors it runs the plain torch
twin beside it (``*_plain``), which is also the kernel's oracle on the
card.  There is no fallback: a CUDA tensor gets the kernel
or an exception.

``np_mix64`` and ``host_insert`` are numpy copies: the host rebuild on grow.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.window import (
    expand,
    hopping_expansion,
    hopping_starts,
    slice_starts,
    tumbling_starts,
)

MAX_PROBES = 32
INT32_MAX = np.iinfo(np.int32).max
INT64_MIN = np.iinfo(np.int64).min
INT64_MAX = np.iinfo(np.int64).max

_M1 = int(np.array(0xBF58476D1CE4E5B9, dtype=np.uint64).view(np.int64))
_M2 = int(np.array(0x94D049BB133111EB, dtype=np.uint64).view(np.int64))
_GOLD = int(np.array(0x9E3779B97F4A7C15, dtype=np.uint64).view(np.int64))

_DTYPES = {"int8": torch.int8, "int32": torch.int32, "int64": torch.int64,
           "float64": torch.float64}
#: dtype / combine codes shared with csrc/common.cuh (int8 is a vector
#: component's element type only: the scalar folds never see it)
_DTYPE_CODES = {"int32": 0, "int64": 1, "float64": 2, "int8": 3}
_COMBINE_CODES = {"add": 0, "min": 1, "max": 2, "argset": 3}
#: the combines K3 folds; the vector kinds go through ``ops/vector.py``
SCALAR_COMBINES = ("add", "min", "max")


@dataclasses.dataclass(frozen=True)
class AggComponent:
    """One scatter-combined state column of an aggregate.

    ``width`` > 1 is a ``[capacity + 1, width]`` column: the slice ring of
    a sliced hopping store, or per-slot VECTOR state (``ops/vector.py``):

    * ``vec_count`` — scalar int64 count heading a collect group; the two
      following components are ``vec_data`` (values) and ``vec_valid``
      (per-element null bits, int8), both width K.  ``mode`` on the
      vec_data component selects the fold: 'append' (COLLECT_LIST,
      EARLIEST_BY_OFFSET(n), capped at K), 'ring' (LATEST_BY_OFFSET(n)),
      'set' (COLLECT_SET); a histogram group (``mode='hist'`` on its
      vec_count) adds a fourth, ``hist_count`` (int64 per-element counts).
    * ``topk`` — a self-contained width-K descending top-K; ``mode=
      'distinct'`` dedups values (TOPKDISTINCT).

    ``argset`` is a scalar payload of an arg-min/max (EARLIEST/LATEST_BY_
    OFFSET): the row whose contribution to the nearest preceding order
    component equals the slot's order after the fold writes it
    (:func:`fold_argset`).
    """

    combine: str  # 'add' | 'min' | 'max' | 'argset' | 'vec_count' | 'vec_data' | 'vec_valid' | 'hist_count' | 'topk'
    dtype: str  # numpy dtype name
    init: float  # fill value for empty slots
    width: int = 1
    mode: str = ""


@dataclasses.dataclass(frozen=True)
class StoreLayout:
    capacity: int  # power of two
    num_keys: int
    components: Tuple[AggComponent, ...]
    windowed: bool = False

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError("store capacity must be a power of two")


def init_store(layout: StoreLayout, device) -> Dict[str, torch.Tensor]:
    c1 = layout.capacity + 1

    def z(dt):
        return torch.zeros(c1, dtype=dt, device=device)

    store = {
        "occ": z(torch.bool),
        # tombstoned slots: freed but still part of probe chains; the host
        # rebuild in _grow reclaims them
        "grave": z(torch.bool),
        "khash": z(torch.int64),
        "wstart": z(torch.int64),
        "knull": z(torch.int32),
        "dirty": z(torch.bool),
        "max_ts": torch.tensor(INT64_MIN, dtype=torch.int64, device=device),
        "overflow": torch.zeros((), dtype=torch.int64, device=device),
    }
    for i in range(layout.num_keys):
        store[f"key{i}"] = z(torch.int64)
    for j, comp in enumerate(layout.components):
        shape = (c1,) if comp.width == 1 else (c1, comp.width)
        store[f"a{j}"] = torch.full(
            shape, comp.init, dtype=_DTYPES[comp.dtype], device=device
        )
    return store


#: ``csrc/common.cuh``'s KSQL_MAX_COMPS: components a kernel descriptor holds
KSQL_MAX_COMPS = 32


def init_scratch(capacity: int, device) -> Dict[str, torch.Tensor]:
    """Per-store scratch the kernels keep clean between calls: the claim
    cells of probe_insert, the first-row cells of fold_and_mark, the
    dump-row cells (-1) of its argset mode, one an argset component, and
    that mode's done-block ticket (0).  probe_insert adds its grid scratch
    ``work`` (:func:`probe_work`)."""
    return {
        "claim": torch.full((capacity + 1,), INT32_MAX, dtype=torch.int32, device=device),
        "first": torch.full((capacity + 1,), INT32_MAX, dtype=torch.int32, device=device),
        "dump_row": torch.full((KSQL_MAX_COMPS,), -1, dtype=torch.int32, device=device),
        "ticket": torch.zeros(1, dtype=torch.int32, device=device),
    }


# ------------------------------------------------------------------ hashing
def _srl(h: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def mix64(h: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (logical shifts; int64 wraps)."""
    h = h ^ _srl(h, 30)
    h = h * _M1
    h = h ^ _srl(h, 27)
    h = h * _M2
    h = h ^ _srl(h, 31)
    return h


def combine_hash(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold per-key-column 64-bit reprs into one group hash.  Python's ``+``
    binds tighter than ``^``: each step is ``mix64(h ^ (p + GOLD))``."""
    h = torch.full_like(parts[0], _GOLD)
    for p in parts:
        h = mix64(h ^ (p + _GOLD))
    return h


def slot_base(khash: torch.Tensor, wstart: torch.Tensor, capacity: int) -> torch.Tensor:
    """First probe candidate of each row (the top of the reference's
    ``probe_insert``)."""
    return (mix64(khash ^ (wstart * _GOLD)) & (capacity - 1)).to(torch.int32)


# ----------------------------------------------------- K1: row_prologue
def row_prologue_plain(key_reprs, key_valid, ts, active, size_ms, grace_ms,
                       max_ts, capacity, advance_ms=0, slice_width=0,
                       slice_ring=0):
    """Plain twin of K1 — see :func:`row_prologue`."""
    k, n = key_reprs.shape
    knull = torch.zeros(n, dtype=torch.int32, device=ts.device)
    for i in range(k):
        knull = knull | ((~key_valid[i]).to(torch.int32) << i)
    parts = [key_reprs[i] for i in range(k)]
    khash = combine_hash(parts + [knull.to(torch.int64)])
    if advance_ms and slice_ring:  # sliced hopping
        wstart = slice_starts(ts, slice_width)
        newest = ts - torch.remainder(ts, advance_ms)
        open_any = newest + size_ms + grace_ms > max_ts
        batch_max = torch.maximum(max_ts, torch.where(active, ts, torch.full_like(ts, INT64_MIN)).max())
        horizon_ok = wstart + (slice_ring - 1) * slice_width > batch_max
        active = active & open_any & horizon_ok & (knull == 0)
        base = slot_base(khash, torch.zeros_like(wstart), capacity)
    elif advance_ms:  # k-fold hopping expansion
        hops = hopping_expansion(size_ms, advance_ms)
        wstart, in_win = hopping_starts(ts, size_ms, advance_ms)
        knull, khash, ts = expand(knull, hops), expand(khash, hops), expand(ts, hops)
        active = expand(active, hops) & in_win & (knull == 0)
        if max_ts is not None:
            active = active & (wstart + size_ms + grace_ms > max_ts)
        base = slot_base(khash, wstart, capacity)
    else:
        if size_ms:
            wstart = tumbling_starts(ts, size_ms)
        else:
            wstart = torch.zeros(n, dtype=torch.int64, device=ts.device)
        active = active & (knull == 0)
        if size_ms and max_ts is not None:
            active = active & (wstart + size_ms + grace_ms > max_ts)
        base = slot_base(khash, wstart, capacity)
    c0 = torch.where(active, ts, torch.full_like(ts, INT64_MIN))
    return wstart, knull, active, khash, base, c0


def row_prologue(key_reprs: torch.Tensor, key_valid: torch.Tensor,
                 ts: torch.Tensor, active: torch.Tensor, size_ms: int,
                 grace_ms: int, max_ts: torch.Tensor, capacity: int,
                 advance_ms: int = 0, slice_width: int = 0, slice_ring: int = 0):
    """K1 (replaces ``ops/hash_store.py:mix64/combine_hash``, the fixed
    per-row part of ``runtime/lowering.py:pre_exchange`` and
    ``ops/window.py:hopping_starts/expand``).

    ``key_reprs`` int64[k, n] and ``key_valid`` bool[k, n] are the group
    key columns' 64-bit reprs and valid bits; ``max_ts`` is the store's
    stream time at batch start (a device scalar), or None on the EMIT
    FINAL route, where the tumbling and expansion modes skip their grace
    cut (K17 ``ops/suppress.py:suppress_clock`` cuts against the running
    stream time instead).  Three modes (a fourth, for join tables, is
    :func:`table_prologue`):

    * ``advance_ms == 0``: unwindowed (``size_ms == 0``: no window start, no
      grace cut) or TUMBLING (window start, grace cut against ``max_ts``);
    * sliced HOPPING (``advance_ms`` and ``slice_ring``): ``wstart`` is the
      slice start; a row is admitted while the newest advance-aligned
      window covering it is open at batch start, and while its slice lies
      inside the ring of ``slice_ring`` slices below the batch's newest
      stream time (``max(max_ts, max ts over the active rows)``, taken
      before the null-key mask); the base slot hashes with window 0 (the
      sliced store keys by group key only);
    * k-fold HOPPING expansion (``advance_ms``, no ring): n rows become
      ``n·k`` lanes, lane ``h·n + i`` being row ``i``'s hop ``h``; each lane
      gets its window start and the tumbling-style grace cut.

    Returns ``(wstart, knull, active, khash, base, c0)`` per row (per lane
    when expanding): the window or slice start, the int32 null-key bitmask,
    the rows that reach the store, the group hash, the probe's base slot
    and the watermark contribution (``ts`` where active, INT64_MIN
    elsewhere)."""
    if not key_reprs.is_cuda:
        return row_prologue_plain(key_reprs, key_valid, ts, active, size_ms,
                                  grace_ms, max_ts, capacity, advance_ms,
                                  slice_width, slice_ring)
    k, n = key_reprs.shape
    _expect(key_reprs, torch.int64, (k, n))
    _expect(key_valid, torch.bool, (k, n))
    _expect(ts, torch.int64, (n,))
    _expect(active, torch.bool, (n,))
    if max_ts is not None or (advance_ms and slice_ring):
        _expect(max_ts, torch.int64, ())
    if advance_ms and slice_ring:
        mode, hops = 1, 1
    elif advance_ms:
        mode, hops = 2, hopping_expansion(size_ms, advance_ms)
    else:
        mode, hops = 0, 1
    dev = ts.device
    nn = n * hops
    wstart = torch.empty(nn, dtype=torch.int64, device=dev)
    knull = torch.empty(nn, dtype=torch.int32, device=dev)
    act = torch.empty(nn, dtype=torch.bool, device=dev)
    khash = torch.empty(nn, dtype=torch.int64, device=dev)
    base = torch.empty(nn, dtype=torch.int32, device=dev)
    c0 = torch.empty(nn, dtype=torch.int64, device=dev)
    batch_max = torch.empty(1, dtype=torch.int64, device=dev)
    fn = cuda.lib("row_prologue")
    cuda.check("row_prologue", fn(
        key_reprs.data_ptr(), key_valid.data_ptr(), k, n, ts.data_ptr(),
        active.data_ptr(), mode, int(size_ms), int(advance_ms), int(grace_ms),
        int(slice_width), int(slice_ring), hops,
        None if max_ts is None else max_ts.data_ptr(),
        capacity - 1, batch_max.data_ptr(), wstart.data_ptr(),
        knull.data_ptr(), act.data_ptr(), khash.data_ptr(), base.data_ptr(),
        c0.data_ptr(), _stream(dev),
    ))
    row_prologue.launches += 1
    row_prologue.mode_launches[ROW_PROLOGUE_MODES[mode]] += 1
    return wstart, knull, act, khash, base, c0


#: K1's modes by kernel code: ``tumbling`` also serves unwindowed plans,
#: ``table`` (:func:`table_prologue`) hashes a join table's changelog keys,
#: ``session`` (:func:`session_prologue`) a session aggregation's group keys
ROW_PROLOGUE_MODES = ("tumbling", "sliced", "expansion", "table", "session")
row_prologue.launches = 0
row_prologue.mode_launches = dict.fromkeys(ROW_PROLOGUE_MODES, 0)


def table_prologue_plain(key_reprs, key_valid, active, capacity):
    """Plain twin of K1's table mode — see :func:`table_prologue`."""
    k = key_reprs.shape[0]
    khash = combine_hash([key_reprs[i] for i in range(k)])
    base = slot_base(khash, torch.zeros_like(khash), capacity)
    return active & key_valid.all(0), khash, base


def table_prologue(key_reprs: torch.Tensor, key_valid: torch.Tensor,
                   active: torch.Tensor, capacity: int):
    """K1's table mode (replaces the key hash of ``runtime/lowering.py:
    _trace_table_step``): a join table's changelog key, hashed over the
    key reprs alone, without the null-key bitmask (``combine_hash([repr])``,
    what the stream side probes with), window 0, no grace cut.  It reads
    no timestamps and writes no window start, null bits or watermark
    contribution: K2 gets the reference's zeros for those.

    Returns ``(active, khash, base)`` per row: the rows with a valid key
    among ``active``, the key hash and the probe's base slot.  Counts on
    :func:`row_prologue`'s counters (it is K1's fourth mode)."""
    if not key_reprs.is_cuda:
        return table_prologue_plain(key_reprs, key_valid, active, capacity)
    k, n = key_reprs.shape
    _expect(key_reprs, torch.int64, (k, n))
    _expect(key_valid, torch.bool, (k, n))
    _expect(active, torch.bool, (n,))
    dev = active.device
    act = torch.empty(n, dtype=torch.bool, device=dev)
    khash = torch.empty(n, dtype=torch.int64, device=dev)
    base = torch.empty(n, dtype=torch.int32, device=dev)
    fn = cuda.lib("row_prologue")
    cuda.check("row_prologue", fn(
        key_reprs.data_ptr(), key_valid.data_ptr(), k, n, None,
        active.data_ptr(), 3, 0, 0, 0, 0, 0, 1, None, capacity - 1, None,
        None, None, act.data_ptr(), khash.data_ptr(), base.data_ptr(), None,
        _stream(dev),
    ))
    row_prologue.launches += 1
    row_prologue.mode_launches["table"] += 1
    return act, khash, base


def session_prologue_plain(key_reprs, key_valid, active):
    """Plain twin of K1's session mode — see :func:`session_prologue`."""
    k = key_reprs.shape[0]
    khash = combine_hash([key_reprs[i] for i in range(k)] + [torch.zeros_like(key_reprs[0])])
    return active & key_valid.all(0), khash


def session_prologue(key_reprs: torch.Tensor, key_valid: torch.Tensor, active: torch.Tensor):
    """K1's session mode (replaces the key hash and null-key drop of
    ``runtime/lowering.py:pre_session_exchange``): the group hash
    ``combine_hash(reprs + [0])``, whose last part is 0 whatever the key's
    validity, and the rows among ``active`` whose key columns are all
    valid (a null-key row never reaches a session).  No window, grace cut,
    base slot or watermark: the session step's own prologue
    (``ops/session.py``) does the late drop.

    Returns ``(active, khash)`` per row.  Counts on :func:`row_prologue`'s
    counters (it is K1's fifth mode)."""
    if not key_reprs.is_cuda:
        return session_prologue_plain(key_reprs, key_valid, active)
    k, n = key_reprs.shape
    _expect(key_reprs, torch.int64, (k, n))
    _expect(key_valid, torch.bool, (k, n))
    _expect(active, torch.bool, (n,))
    dev = active.device
    act = torch.empty(n, dtype=torch.bool, device=dev)
    khash = torch.empty(n, dtype=torch.int64, device=dev)
    fn = cuda.lib("row_prologue")
    cuda.check("row_prologue", fn(
        key_reprs.data_ptr(), key_valid.data_ptr(), k, n, None,
        active.data_ptr(), 4, 0, 0, 0, 0, 0, 1, None, 0, None,
        None, None, act.data_ptr(), khash.data_ptr(), None, None,
        _stream(dev),
    ))
    row_prologue.launches += 1
    row_prologue.mode_launches["session"] += 1
    return act, khash


# ----------------------------------------------------- K2: probe_insert
def probe_insert_plain(store, capacity, base, khash, wstart, key_reprs,
                       knull, active) -> torch.Tensor:
    """Plain twin of K2 — see :func:`probe_insert`."""
    n = khash.shape[0]
    dev = khash.device
    mask = capacity - 1
    dump = capacity
    occ, grave, kh, ws = store["occ"], store["grave"], store["khash"], store["wstart"]
    rowidx = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.full((n,), dump, dtype=torch.int32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    offset = torch.zeros(n, dtype=torch.int32, device=dev)
    won_round = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for r in range(MAX_PROBES):
        cand = (base + offset) & mask
        ci = cand.long()
        c_used = occ[ci] | grave[ci]
        # a matching grave is reclaimed (same key re-inserted after free)
        c_match = c_used & (kh[ci] == khash) & (ws[ci] == wstart)
        newly = ~done & active & c_match
        slots = torch.where(newly, cand, slots)
        done = done | newly
        # claim truly-empty candidates: lowest row index wins the slot
        want = ~done & active & ~c_used
        claim = torch.full((capacity + 1,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, torch.where(want, ci, dump), rowidx, "amin")
        winner = want & (claim[ci] == rowidx)
        w = winner.nonzero().squeeze(1)
        wc = ci[w]
        occ[wc] = True
        kh[wc] = khash[w]
        ws[wc] = wstart[w]
        won_round[w] = r
        slots = torch.where(winner, cand, slots)
        done = done | winner
        # used-by-other: advance; claim losers re-examine the same slot
        offset = offset + (~done & active & c_used & ~c_match).to(torch.int32)
        if not bool((active & ~done).any()):
            break  # the later rounds change nothing (no row wins in them)
    _dump_khash(kh, ws, khash, wstart, won_round, dump)
    store["overflow"] += (active & ~done).sum()
    d = done.nonzero().squeeze(1)
    ds = slots[d].long()
    occ[ds] = True
    grave[ds] = False
    for i in range(key_reprs.shape[0]):
        store[f"key{i}"][ds] = key_reprs[i][d]
    store["knull"][ds] = knull[d]
    undone = (~done).nonzero().squeeze(1)
    if undone.numel():
        last = undone[-1]
        grave[dump] = False
        for i in range(key_reprs.shape[0]):
            store[f"key{i}"][dump] = key_reprs[i][last]
        store["knull"][dump] = knull[last]
    occ[dump] = False
    return slots


def _dump_khash(kh, ws, khash, wstart, won_round, dump) -> None:
    """The reference scatters every round's non-winners into the dump slot
    and XLA applies duplicate updates in row order: the highest row that
    did not win the final round leaves its khash/wstart there (if every
    row won the final round, the round before it decides)."""
    for r in range(MAX_PROBES - 1, -1, -1):
        lost = (won_round != r).nonzero()
        if lost.numel():
            i = int(lost[-1])
            kh[dump] = khash[i]
            ws[dump] = wstart[i]
            return


def probe_insert(store: Dict[str, torch.Tensor], scratch: Dict[str, torch.Tensor],
                 capacity: int, base: torch.Tensor, khash: torch.Tensor,
                 wstart: torch.Tensor, key_reprs: torch.Tensor,
                 knull: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """K2 (replaces ``ops/hash_store.py:probe_insert``): resolve and create
    one slot per active row, in place; returns int32 ``slots`` (the dump
    slot ``capacity`` for inactive and overflowed rows).  The slot layout,
    ``overflow`` and the dump slot's contents are the reference's bit for
    bit.  One launch a call: one block for up to :func:`probe_sizes`'s
    rows, a cooperative grid past that (its scratch in
    ``scratch["work"]``)."""
    if not khash.is_cuda:
        return probe_insert_plain(store, capacity, base, khash, wstart,
                                  key_reprs, knull, active)
    k, n = key_reprs.shape
    cols, keys = _insert_columns(store, scratch, capacity, k)
    _expect(base, torch.int32, (n,))
    _expect(khash, torch.int64, (n,))
    _expect(wstart, torch.int64, (n,))
    _expect(key_reprs, torch.int64, (k, n))
    _expect(knull, torch.int32, (n,))
    _expect(active, torch.bool, (n,))
    dev = khash.device
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    work = probe_work(scratch, n, dev)
    occ, grave, kh, ws, knull_store, overflow, claim = cols
    cuda.check("probe_insert", cuda.lib("probe_insert", "ksql_probe_insert")(
        occ, grave, kh, ws, keys, k, knull_store, overflow, claim, capacity, base.data_ptr(),
        khash.data_ptr(), wstart.data_ptr(), key_reprs.data_ptr(), knull.data_ptr(),
        active.data_ptr(), n, slots.data_ptr(), None if work is None else work.data_ptr(),
        0 if work is None else work.numel(), _stream(dev),
    ))
    probe_insert.launches += 1
    return slots


#: K2's store columns, checked once per set of buffers: (capacity, key
#: count, the column pointers) -> the key column pointers as a host array
_INSERT_COLUMNS: Dict[tuple, object] = {}


def _insert_columns(store, scratch, capacity: int, k: int):
    """The pointers of K2's store columns and claim cells, and its key
    columns' pointer array; the columns are checked when a set of buffers
    is first seen (a grow replaces them)."""
    cols = (store["occ"].data_ptr(), store["grave"].data_ptr(), store["khash"].data_ptr(),
            store["wstart"].data_ptr(), store["knull"].data_ptr(), store["overflow"].data_ptr(),
            scratch["claim"].data_ptr())
    key = (capacity, cols, tuple(store[f"key{i}"].data_ptr() for i in range(k)))
    keys = _INSERT_COLUMNS.get(key)
    if keys is None:
        c1 = capacity + 1
        for name, dt in (("occ", torch.bool), ("grave", torch.bool), ("khash", torch.int64),
                         ("wstart", torch.int64), ("knull", torch.int32)):
            _expect(store[name], dt, (c1,))
        for i in range(k):
            _expect(store[f"key{i}"], torch.int64, (c1,))
        _expect(store["overflow"], torch.int64, ())
        _expect(scratch["claim"], torch.int32, (c1,))
        keys = cuda.host_i64(key[2])
        if len(_INSERT_COLUMNS) >= 64:
            _INSERT_COLUMNS.pop(next(iter(_INSERT_COLUMNS)))
        _INSERT_COLUMNS[key] = keys
    return cols, keys


probe_insert.launches = 0

_PROBE_SIZES: List[int] = []


def probe_sizes() -> Tuple[int, int]:
    """``(rows, words)``: the most rows K2 resolves in one block, and the
    int32 words of its cooperative grid's scratch besides one a row (the
    per-round pending counts, two cells, the rows handed to one block for
    the last rounds), as ``csrc/probe_insert.cu`` sets them."""
    if not _PROBE_SIZES:
        out = (ctypes.c_int64 * 2)()
        cuda.check("probe_insert", cuda.lib("probe_insert", "ksql_probe_insert_sizes")(out))
        _PROBE_SIZES.extend(out)
    return _PROBE_SIZES[0], _PROBE_SIZES[1]


def probe_work(scratch: Dict[str, torch.Tensor], n: int, device) -> Optional[torch.Tensor]:
    """K2's grid scratch for an ``n``-row batch, None for one block's:
    ``scratch["work"]``, grown (never shrunk) to the largest batch the
    store has seen; it needs no cleaning between calls."""
    solo, fixed = probe_sizes()
    if n <= solo:
        return None
    need = fixed + n
    work = scratch.get("work")
    if work is None or work.numel() < need:
        work = torch.empty(need, dtype=torch.int32, device=device)
        scratch["work"] = work
    return work


# ---------------------------------------------------- K3: fold_and_mark
def fold_and_mark_plain(store, layout: StoreLayout, slots, contribs,
                        active) -> torch.Tensor:
    """Plain twin of K3 — see :func:`fold_and_mark`."""
    capacity = layout.capacity
    s = slots.long()
    for j, comp in enumerate(layout.components):
        if comp.combine not in SCALAR_COMBINES:
            continue  # a vector group (ops/vector.py)
        col = store[f"a{j}"]
        c = contribs[j].to(col.dtype)
        if comp.combine == "add":
            col.index_add_(0, s, c)
        else:
            before = col.clone() if col.is_floating_point() else None
            col.scatter_reduce_(0, s, c, "amin" if comp.combine == "min" else "amax")
            if before is not None:
                _xla_signed_zero(col, before, s, c, comp.combine)
    store["dirty"][s] = True
    store["dirty"][capacity] = False
    n = s.shape[0]
    rowidx = torch.arange(n, dtype=torch.int32, device=s.device)
    first = torch.full((capacity + 1,), n, dtype=torch.int32, device=s.device)
    first.scatter_reduce_(0, torch.where(active, s, capacity), rowidx, "amin")
    return active & (s != capacity) & (first[s] == rowidx)


def xla_minmax(a: torch.Tensor, b: torch.Tensor, combine: str) -> torch.Tensor:
    """XLA's elementwise min or max (``combine``): NaN wins, and -0.0 is
    below +0.0 (torch.minimum/maximum return either zero on a tie)."""
    want_neg = combine == "min"
    r = torch.minimum(a, b) if want_neg else torch.maximum(a, b)
    if r.is_floating_point():
        zero = (a == 0) & (b == 0)
        sa, sb = torch.signbit(a), torch.signbit(b)
        neg = (sa | sb) if want_neg else (sa & sb)
        r = torch.where(zero & neg, -0.0, torch.where(zero & ~neg, 0.0, r))
    return r


def _xla_signed_zero(col, before, s, c, combine) -> None:
    """Bring a float column folded by torch's scatter_reduce (which keeps
    whichever zero it saw first) to XLA's zero: a slot folded to zero is
    min/maxed (:func:`xla_minmax`) with the wanted zero (-0.0 for min,
    +0.0 for max) where any of its operands — the rows scattered to it or
    its value before — was that zero.  NaN and nonzero slots keep their
    bits."""
    want_neg = combine == "min"
    zero_src = (c == 0) & (torch.signbit(c) == want_neg)
    hit = torch.zeros_like(col, dtype=torch.bool)
    hit[s[zero_src]] = True
    hit |= (before == 0) & (torch.signbit(before) == want_neg)
    fix = hit & (col == 0)
    col[fix] = xla_minmax(col[fix], torch.full_like(col[fix], -0.0 if want_neg else 0.0), combine)


def fold_and_mark(store: Dict[str, torch.Tensor], scratch: Dict[str, torch.Tensor],
                  layout: StoreLayout, slots: torch.Tensor,
                  contribs: Sequence[torch.Tensor], active: torch.Tensor) -> torch.Tensor:
    """K3 (replaces ``ops/hash_store.py:scatter_combine``'s add/min/max
    branches with its ``dirty`` marking, and ``winners_per_slot``): fold
    each row's contributions into its slot in place, mark touched slots
    dirty, and return the bool mask of one representative (lowest) row per
    touched slot.  Inactive rows must carry identity contributions.  The
    vector groups' components are left to ``ops/vector.py``."""
    if not slots.is_cuda:
        return fold_and_mark_plain(store, layout, slots, contribs, active)
    n = slots.shape[0]
    capacity = layout.capacity
    c1 = capacity + 1
    _expect(slots, torch.int32, (n,))
    _expect(active, torch.bool, (n,))
    _expect(store["dirty"], torch.bool, (c1,))
    _expect(scratch["first"], torch.int32, (c1,))
    desc: List[int] = []
    keep = []  # the cast contributions must outlive the launch below
    scalar = [(j, comp) for j, comp in enumerate(layout.components)
              if comp.combine in SCALAR_COMBINES]
    for j, comp in scalar:
        col = store[f"a{j}"]
        c = contribs[j].to(col.dtype).contiguous()
        _expect(col, _DTYPES[comp.dtype], (c1,))
        _expect(c, _DTYPES[comp.dtype], (n,))
        keep.append(c)
        desc += [col.data_ptr(), c.data_ptr(),
                 _COMBINE_CODES[comp.combine] * 3 + _DTYPE_CODES[comp.dtype]]
    winners = torch.empty(n, dtype=torch.bool, device=slots.device)
    fn = cuda.lib("fold_and_mark", "ksql_fold_and_mark")
    cuda.check("fold_and_mark", fn(
        cuda.host_i64(desc), len(scalar), slots.data_ptr(),
        active.data_ptr(), n, capacity, store["dirty"].data_ptr(),
        scratch["first"].data_ptr(), winners.data_ptr(), _stream(slots.device),
    ))
    fold_and_mark.launches += 1
    fold_and_mark.mode_launches["fold"] += 1
    return winners


fold_and_mark.launches = 0
#: ``fold``: the add/min/max folds and the winners; ``argset``: the
#: arg-min/max payloads (:func:`fold_argset`)
fold_and_mark.mode_launches = {"fold": 0, "argset": 0}


def argset_pairs(layout: StoreLayout) -> List[Tuple[int, int]]:
    """``(j, o)`` for each 'argset' component ``j``, ``o`` the nearest
    order (add/min/max) component before it (``scatter_combine``'s
    ``last_order``)."""
    pairs, last = [], 0
    for j, comp in enumerate(layout.components):
        if comp.combine in SCALAR_COMBINES:
            last = j
        elif comp.combine == "argset":
            pairs.append((j, last))
    return pairs


def fold_argset_plain(store, layout: StoreLayout, slots, contribs) -> None:
    """Plain twin of K3's argset mode — see :func:`fold_argset`."""
    capacity = layout.capacity
    s = slots.long()
    for j, o in argset_pairs(layout):
        col = store[f"a{j}"]
        c = contribs[j].to(col.dtype)
        win = (s != capacity) & (contribs[o] == store[f"a{o}"][s])
        w = win.nonzero().squeeze(1)
        col[s[w]] = c[w]  # winners of one slot write the same payload
        lost = (~win).nonzero().squeeze(1)
        if lost.numel():
            col[capacity] = c[lost[-1]]  # the highest row aimed at the dump


class ArgsetPlan:
    """K3 argset's host side for one store and layout: its (payload, order)
    component pairs, the store columns checked once, and per pair the
    contributions' dtypes and the words of ``csrc/fold_and_mark.cu``'s
    descriptor that do not change from call to call.  The plan holds the
    store's columns weakly: a cached plan keeps no store alive, and one
    whose columns are gone (a grow) no longer matches."""

    def __init__(self, store: Dict[str, torch.Tensor], layout: StoreLayout):
        c1 = layout.capacity + 1
        self.layout = layout  # held, so the cache's id(layout) stays its own
        self.pairs = argset_pairs(layout)
        self.names = [f"a{x}" for j, o in self.pairs for x in (j, o)]
        self.refs = [weakref.ref(store[k]) for k in self.names]
        self.dtypes = []
        self.words = []
        for j, o in self.pairs:
            comp, order = layout.components[j], layout.components[o]
            col, ocol = store[f"a{j}"], store[f"a{o}"]
            _expect(col, _DTYPES[comp.dtype], (c1,))
            _expect(ocol, _DTYPES[order.dtype], (c1,))
            self.dtypes.append((_DTYPES[comp.dtype], _DTYPES[order.dtype]))
            self.words.append((col.data_ptr(), ocol.data_ptr(), _DTYPE_CODES[comp.dtype],
                               _DTYPE_CODES[order.dtype]))
        self.desc = (ctypes.c_int64 * (6 * max(len(self.pairs), 1)))()

    def matches(self, store: Dict[str, torch.Tensor], layout: StoreLayout) -> bool:
        return layout is self.layout and all(store[k] is r() for k, r in zip(self.names, self.refs))


_ARGSET_PLANS: Dict[tuple, ArgsetPlan] = {}
_ARGSET_PLAN_CACHE_SIZE = 64


def argset_plan(store: Dict[str, torch.Tensor], layout: StoreLayout) -> ArgsetPlan:
    """K3 argset's host side for a store and layout, built and checked
    once per set of store columns and cached."""
    key = (id(store), id(layout))
    plan = _ARGSET_PLANS.get(key)
    if plan is not None and plan.matches(store, layout):
        return plan
    plan = ArgsetPlan(store, layout)
    if key not in _ARGSET_PLANS and len(_ARGSET_PLANS) >= _ARGSET_PLAN_CACHE_SIZE:
        _ARGSET_PLANS.pop(next(iter(_ARGSET_PLANS)))
    _ARGSET_PLANS[key] = plan
    return plan


def _contribution(c: torch.Tensor, dtype, n: int) -> torch.Tensor:
    """``c`` as the kernel takes it: contiguous ``dtype[n]`` on the card."""
    if c.dtype != dtype or not c.is_contiguous():
        c = c.to(dtype).contiguous()
    if c.shape != (n,) or not c.is_cuda:
        raise ValueError(f"kernel argument: expected contiguous {dtype}[{n}] on the card, "
                         f"got {c.dtype}{list(c.shape)}")
    return c


def fold_argset(store: Dict[str, torch.Tensor], scratch: Dict[str, torch.Tensor],
                layout: StoreLayout, slots: torch.Tensor,
                contribs: Sequence[torch.Tensor]) -> None:
    """K3's argset mode (replaces ``ops/hash_store.py:scatter_combine``'s
    'argset' branch, :552-558): after :func:`fold_and_mark` has settled
    each order component, for each 'argset' component ``j`` with ``o``
    the nearest order component before it, a row whose slot is not the
    dump and whose ``contribs[o]`` equals ``a{o}`` at its slot writes
    ``contribs[j]`` there; every other row is aimed at the dump slot, which
    keeps the payload of the highest such row (XLA's duplicate-index
    ``.at[].set`` order).  Unlike the fold it covers inactive rows too:
    they aim at the dump (their slot is the dump).  A slot that never had
    a candidate keeps the init order, so every row there with an init
    contribution writes the same zero payload.  The sequence numbers are
    unique, so a real slot has no other ties.  In place; returns nothing.
    One launch; the store's side of the launch is checked once
    (:func:`argset_plan`), and a call allocates nothing."""
    if not slots.is_cuda:
        if argset_pairs(layout):
            fold_argset_plain(store, layout, slots, contribs)
        return
    plan = argset_plan(store, layout)
    if not plan.pairs:
        return
    n = slots.shape[0]
    _expect(slots, torch.int32, (n,))
    dump_row, ticket = scratch["dump_row"], scratch["ticket"]
    _expect(dump_row, torch.int32, (KSQL_MAX_COMPS,))
    _expect(ticket, torch.int32, (1,))
    desc = plan.desc
    keep = []  # the cast contributions must outlive the launch below
    for k, ((j, o), (dt, odt), (col, ocol, code, ocode)) in enumerate(zip(plan.pairs, plan.dtypes, plan.words)):
        c, oc = _contribution(contribs[j], dt, n), _contribution(contribs[o], odt, n)
        keep += [c, oc]
        desc[6 * k:6 * k + 6] = [col, c.data_ptr(), ocol, oc.data_ptr(), code, ocode]
    cuda.check("fold_and_mark", cuda.lib("fold_and_mark", "ksql_fold_argset")(
        desc, len(plan.pairs), slots.data_ptr(), n, layout.capacity, dump_row.data_ptr(),
        ticket.data_ptr(), _stream(slots.device)))
    fold_and_mark.launches += 1
    fold_and_mark.mode_launches["argset"] += 1


# ------------------------------------------------------------ K4: evict
#: ``slast`` of a sliced slot that holds no slice
SLAST_NONE = -(2 ** 62)


def evict_plain(store, layout: StoreLayout, retention_ms: int, sliced: bool = False,
                suppress: bool = False) -> None:
    """Plain twin of K4 — see :func:`evict`."""
    if sliced:
        expired = store["occ"] & (store["slast"] + retention_ms < store["max_ts"])
        store["slast"].masked_fill_(expired, SLAST_NONE)
        store["slice_id"].masked_fill_(expired[:, None], -1)
    else:
        expired = store["occ"] & (store["wstart"] + retention_ms < store["max_ts"])
    if suppress:
        expired &= ~store["dirty"]
    store["occ"] &= ~expired
    store["grave"] |= expired
    store["dirty"] &= ~expired
    if "hpass" in store:
        store["hpass"] &= ~expired
    if "born" in store:
        store["born"].masked_fill_(expired, INT64_MAX)
        store["emitted"] &= ~expired
    for j, comp in enumerate(layout.components):
        col = store[f"a{j}"]
        col.masked_fill_(expired[:, None] if col.dim() == 2 else expired, comp.init)


def evict(store: Dict[str, torch.Tensor], layout: StoreLayout, retention_ms: int,
          sliced: bool = False, suppress: bool = False) -> None:
    """K4 (replaces ``runtime/lowering.py:_trace_evict``): free the slots
    that left retention, in place, resetting their components to init.  A
    windowed slot expires when its window start plus retention is below the
    stream time; a sliced slot (one per group key, ``sliced=True``) when
    its newest slice start ``slast`` is, and then also drops its ring
    (``slice_id`` -1, ``slast`` reset).  A width-K component (a slice ring
    or vector state) resets every cell of the slot's row.  Under EMIT FINAL
    (``suppress=True``) a slot still ``dirty`` (its final result not
    emitted yet) stays until a flush, and an expired slot's ``born`` and
    ``emitted`` reset; a store with HAVING verdicts (``hpass``) clears an
    expired slot's verdict, in every mode."""
    occ = store["occ"]
    if not occ.is_cuda:
        evict_plain(store, layout, retention_ms, sliced, suppress)
        return
    c1 = layout.capacity + 1
    ring = layout.components[0].width if sliced else 0
    for name, dt in (("occ", torch.bool), ("grave", torch.bool),
                     ("dirty", torch.bool), ("wstart", torch.int64)):
        _expect(store[name], dt, (c1,))
    _expect(store["max_ts"], torch.int64, ())
    if sliced:
        _expect(store["slast"], torch.int64, (c1,))
        _expect(store["slice_id"], torch.int64, (c1, ring))
    hpass, born, emitted = store.get("hpass"), store.get("born"), store.get("emitted")
    if hpass is not None:
        _expect(hpass, torch.bool, (c1,))
    if suppress and (born is None or emitted is None):
        raise ValueError("evict: the suppress mode needs born and emitted")
    if born is not None:
        _expect(born, torch.int64, (c1,))
        _expect(emitted, torch.bool, (c1,))
    desc: List[int] = []
    for j, comp in enumerate(layout.components):
        col = store[f"a{j}"]
        _expect(col, _DTYPES[comp.dtype], (c1,) if comp.width == 1 else (c1, comp.width))
        desc += [col.data_ptr(), _DTYPE_CODES[comp.dtype], init_bits(comp), comp.width]
    fn = cuda.lib("evict")
    cuda.check("evict", fn(
        cuda.host_i64(desc), len(layout.components), occ.data_ptr(),
        store["grave"].data_ptr(), store["dirty"].data_ptr(),
        store["wstart"].data_ptr(),
        store["slast"].data_ptr() if sliced else None,
        store["slice_id"].data_ptr() if sliced else None, ring,
        store["max_ts"].data_ptr(), int(retention_ms), layout.capacity, int(suppress),
        None if hpass is None else hpass.data_ptr(),
        None if born is None else born.data_ptr(),
        None if emitted is None else emitted.data_ptr(),
        _stream(occ.device),
    ))
    evict.launches += 1
    evict.mode_launches["suppress" if suppress else "sliced" if sliced else "tumbling"] += 1


evict.launches = 0
#: ``tumbling``: one slot per (key, window), as the tumbling and expansion
#: stores keep; ``sliced``: one slot per key with its slice ring;
#: ``suppress``: an EMIT FINAL store, whose unemitted windows stay
evict.mode_launches = {"tumbling": 0, "sliced": 0, "suppress": 0}


# ------------------------------------------------- K8: probe_find (join)
def probe_find_plain(store, capacity, khash, wstart, active) -> torch.Tensor:
    """Find-only probe (a copy of the reference's ``probe_find``): one slot
    per active row, or the dump slot ``capacity`` when the key is absent,
    the row is inactive, or 32 rounds did not resolve it.  Only LIVE slots
    match; a truly empty slot ends the walk, graves are walked past."""
    n = khash.shape[0]
    mask = capacity - 1
    dump = capacity
    base = slot_base(khash, wstart, capacity)
    slots = torch.full((n,), dump, dtype=torch.int32, device=khash.device)
    done = torch.zeros(n, dtype=torch.bool, device=khash.device)
    offset = torch.zeros(n, dtype=torch.int32, device=khash.device)
    for _ in range(MAX_PROBES):
        ci = ((base + offset) & mask).long()
        c_occ = store["occ"][ci]
        c_used = c_occ | store["grave"][ci]
        c_match = c_occ & (store["khash"][ci] == khash) & (store["wstart"][ci] == wstart)
        newly = ~done & active & c_match
        slots = torch.where(newly, ci.to(torch.int32), slots)
        done = done | newly | ~c_used
        offset = offset + (~done & active).to(torch.int32)
        if bool((done | ~active).all()):
            break
    return torch.where(active, slots, torch.full_like(slots, dump))


def probe_find_gather_plain(store, capacity, krepr, kvalid, active, cols, live=None):
    """Plain twin of K8 — see :func:`probe_find`."""
    look = active & kvalid
    khash = combine_hash([krepr])
    slots = probe_find_plain(store, capacity, khash, torch.zeros_like(khash), look)
    found = look & (slots != capacity)
    s = slots.long()
    if live is not None:
        found = found & live[s]
    out = {}
    for name in cols:
        out[f"v_{name}"] = store[f"v_{name}"][s]
        out[f"m_{name}"] = store[f"m_{name}"][s] & found
    return out, store["key0"][s], found


def probe_find_live_pair_plain(store, capacity, sets, cols, live):
    """Plain twin of K8's pair call — see :func:`probe_find_live_pair`."""
    return tuple(probe_find_gather_plain(store, capacity, krepr, kvalid, active, cols, live)
                 for krepr, kvalid, active in sets)


def probe_find(store: Dict[str, torch.Tensor], capacity: int, krepr: torch.Tensor,
               kvalid: torch.Tensor, active: torch.Tensor, cols: Sequence[str],
               live: Optional[torch.Tensor] = None):
    """K8 (replaces ``ops/hash_store.py:probe_find`` and the gather of
    ``runtime/lowering.py:_apply_join``): look each stream row's join key
    up in a table store and gather the table's columns.  With a ``live``
    column (bool, ``capacity + 1``: the live mode, which replaces the
    ``probe_find`` and gathers of ``runtime/lowering.py:_trace_fk_left``'s
    ``right_of``) a row is found only where its slot is live: a deleted
    key keeps its slot, whose values are still gathered.  A foreign-key
    join's left change looks up its new and its old foreign key in one
    launch through :func:`probe_find_live_pair`.

    ``krepr`` int64[n] is the key's 64-bit repr, ``kvalid`` its valid bit;
    a row is looked up when it is ``active`` with a valid key.  Returns
    ``(lanes, key0, found)``: per table column ``v_<col>`` (the store's
    value at the row's slot) and ``m_<col>`` (its valid bit AND found),
    the slot's ``key0`` repr and ``found``.  A row not found reads the
    dump slot, as the reference does.  Every lane is a fresh tensor: the
    lanes of one call are views of one fresh allocation."""
    if not krepr.is_cuda:
        return probe_find_gather_plain(store, capacity, krepr, kvalid, active, cols, live)
    (out,) = _launch_find(find_plan(store, capacity, cols, live), ((krepr, kvalid, active),))
    probe_find.mode_launches["join" if live is None else "live"] += 1
    return out


def probe_find_live_pair(store: Dict[str, torch.Tensor], capacity: int,
                         sets: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                         cols: Sequence[str], live: torch.Tensor):
    """K8's live mode for two key sets in one launch (replaces both
    ``right_of`` calls of ``runtime/lowering.py:_trace_fk_left``, the new
    foreign key's and the old one's: nothing writes the store between
    them).  ``sets`` holds two ``(krepr, kvalid, active)`` triples, each as
    :func:`probe_find` takes them; returns two ``(lanes, key0, found)``
    triples, each what :func:`probe_find` with ``live`` returns for its
    set."""
    if not sets[0][0].is_cuda:
        return probe_find_live_pair_plain(store, capacity, sets, cols, live)
    out = _launch_find(find_plan(store, capacity, cols, live), sets)
    probe_find.mode_launches["live"] += 1
    return out


class FindPlan:
    """K8's host side for one store's buffers (join and live mode): the
    store's arrays, checked once, and per batch length and row-set count
    the device descriptor of ``csrc/probe_find.cu`` (the columns' store
    arrays and element bytes, each output lane's byte offset in the call's
    one allocation), packed once (a store's calls come from its query's
    one thread).  ``lanes`` is the :class:`Lanes` layout of a set's output
    lanes.  The plan holds the store's tensors weakly: a cached plan keeps
    no store alive, and one whose tensors are gone no longer matches."""

    def __init__(self, names, tensors, live, capacity, cols, lanes):
        self.names = names
        self.refs = [weakref.ref(t) for t in tensors]
        self.live = None if live is None else weakref.ref(live)
        self.ptrs = [t.data_ptr() for t in tensors[:5]] + [None if live is None else live.data_ptr()]
        self.capacity = capacity
        self.cols = cols
        self.lanes = lanes
        self.device = tensors[0].device
        by_name = dict(zip(names, tensors))
        self.store_words = [len(cols)]
        for name in cols:
            v, m = by_name[f"v_{name}"], by_name[f"m_{name}"]
            self.store_words += [v.data_ptr(), v.element_size(), m.data_ptr()]
        self._descs: Dict[Tuple[int, int], torch.Tensor] = {}

    def matches(self, store: Dict[str, torch.Tensor], live) -> bool:
        return (all(store[k] is r() for k, r in zip(self.names, self.refs))
                and (live is None if self.live is None else self.live() is live))

    def desc(self, n: int, copies: int) -> torch.Tensor:
        d = self._descs.get((n, copies))
        if d is None:
            words = list(self.store_words)
            for rel in self.lanes.offsets(n, copies):
                words += [rel["key0"], rel["found"]]
                for name in self.cols:
                    words += [rel[f"v_{name}"], rel[f"m_{name}"]]
            d = torch.tensor(words, dtype=torch.int64).to(self.device)
            if len(self._descs) >= 8:
                self._descs.clear()
            self._descs[(n, copies)] = d
        return d


class Lanes:
    """Output lanes of a kernel call as views of ONE fresh allocation: per
    dtype, widest first, a ``(copies * len(names), rows)`` block (each
    block starts aligned, since every block before it has elements at
    least as wide).  ``groups`` is ``[(dtype, names)]``; the offsets of a
    ``(rows, copies)`` shape are computed once."""

    def __init__(self, groups):
        self.groups = sorted(groups, key=lambda g: -g[0].itemsize)
        self._shapes: Dict[Tuple[int, int], tuple] = {}

    def _shape(self, rows: int, copies: int):
        """``(allocation elements, per set each lane's byte offset, per
        dtype (dtype, element offset, block rows, per set its names))``."""
        shape = self._shapes.get((rows, copies))
        if shape is None:
            rel, blocks, off = [{} for _ in range(copies)], [], 0
            for dt, names in self.groups:
                k = len(names)
                blocks.append((dt, off // dt.itemsize, copies * k,
                               [(c * k, (c + 1) * k, names) for c in range(copies)]))
                for c in range(copies):
                    for j, name in enumerate(names):
                        rel[c][name] = off + (c * k + j) * rows * dt.itemsize
                off += copies * k * rows * dt.itemsize
            shape = (-(-off // self.groups[0][0].itemsize), rel, blocks)
            self._shapes[(rows, copies)] = shape
        return shape

    def offsets(self, rows: int, copies: int = 1) -> List[Dict[str, int]]:
        """Per set, each lane's byte offset in the allocation."""
        return self._shape(rows, copies)[1]

    def alloc(self, rows: int, device, copies: int = 1) -> torch.Tensor:
        """The allocation for ``copies`` sets of ``rows``-row lanes."""
        return torch.empty(self._shape(rows, copies)[0], dtype=self.groups[0][0], device=device)

    def views(self, buf, rows: int, m: int, copies: int = 1) -> List[Dict[str, torch.Tensor]]:
        """Per set, the lanes of ``alloc(rows, ...)``'s ``buf`` as tensors
        of their first ``m`` rows."""
        out: List[Dict[str, torch.Tensor]] = [{} for _ in range(copies)]
        for dt, at, k, sets in self._shape(rows, copies)[2]:
            block = (buf if dt == buf.dtype else buf.view(dt)).as_strided((k, m), (rows, 1), at).unbind(0)
            for lanes, (lo, hi, names) in zip(out, sets):
                lanes.update(zip(names, block[lo:hi]))
        return out


_FIND_PLANS: Dict[tuple, FindPlan] = {}
_FIND_PLAN_CACHE_SIZE = 64


def find_plan(store: Dict[str, torch.Tensor], capacity: int, cols: Sequence[str],
              live: Optional[torch.Tensor]) -> FindPlan:
    """K8's host side for a store and the columns it gathers, built and
    checked once per set of buffers and cached: a grow that replaces the
    store's tensors gets a new one."""
    key = (id(store), capacity, tuple(cols), id(live))
    plan = _FIND_PLANS.get(key)
    if plan is not None and plan.matches(store, live):
        return plan
    c1 = capacity + 1
    names = ["occ", "grave", "khash", "wstart", "key0"]
    for name, dt in zip(names, (torch.bool, torch.bool, torch.int64, torch.int64, torch.int64)):
        _expect(store[name], dt, (c1,))
    if live is not None:
        _expect(live, torch.bool, (c1,))
    groups: Dict[torch.dtype, List[str]] = {torch.int64: ["key0"], torch.bool: ["found"]}
    for name in cols:
        v, m = store[f"v_{name}"], store[f"m_{name}"]
        _expect(v, v.dtype, (c1,))
        _expect(m, torch.bool, (c1,))
        groups.setdefault(v.dtype, []).append(f"v_{name}")
        groups[torch.bool].append(f"m_{name}")
        names += [f"v_{name}", f"m_{name}"]
    plan = FindPlan(names, [store[k] for k in names], live, capacity, tuple(cols),
                    Lanes(list(groups.items())))
    if key not in _FIND_PLANS and len(_FIND_PLANS) >= _FIND_PLAN_CACHE_SIZE:
        _FIND_PLANS.pop(next(iter(_FIND_PLANS)))
    _FIND_PLANS[key] = plan
    return plan


def _launch_find(plan: FindPlan, sets) -> List[Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]]:
    """One K8 launch (join or live mode) over one or two row sets of the
    same length, whose lanes come from one allocation."""
    dev = sets[0][0].device
    n = sets[0][0].shape[0]
    for krepr, kvalid, active in sets:
        _expect(krepr, torch.int64, (n,))
        _expect(kvalid, torch.bool, (n,))
        _expect(active, torch.bool, (n,))
    keys = [t.data_ptr() for s in sets for t in s]
    copies = len(sets)
    desc = plan.desc(n, copies)
    buf = plan.lanes.alloc(n, dev, copies)
    if copies == 1:
        keys += [None, None, None]
    cuda.check("probe_find", cuda.lib("probe_find", "ksql_probe_find")(
        *plan.ptrs, plan.capacity, desc.data_ptr(), desc.shape[0], buf.data_ptr(), *keys, n, copies,
        _stream(dev)))
    probe_find.launches += 1
    results = []
    for lanes in plan.lanes.views(buf, n, n, copies):
        key, found = lanes.pop("key0"), lanes.pop("found")
        results.append((lanes, key, found))
    return results


def probe_gather_plain(store, capacity, slots, live, cols, prefix=""):
    """Plain twin of K8's gather mode — see :func:`probe_gather`."""
    s = slots.long()
    o_live = live[s] & (slots != capacity)
    out = {}
    for name in cols:
        out[f"v_{name}"] = store[f"{prefix}v_{name}"][s]
        out[f"m_{name}"] = store[f"{prefix}m_{name}"][s] & o_live
    return out, o_live


def probe_gather(store: Dict[str, torch.Tensor], capacity: int, slots: torch.Tensor,
                 live: torch.Tensor, cols: Sequence[str], prefix: str = ""):
    """K8's gather mode (replaces the gathers of ``runtime/lowering.py:
    _tt_joined_env``: ``tt[{other}_v_*][slots]``, ``{other}_live[slots] &
    found``): the other side's columns ``{prefix}v_<col>`` /
    ``{prefix}m_<col>`` of a table-table join store at the ``slots`` K2
    gave a batch of changes (no walk; the dump slot ``capacity`` for a row
    K2 did not place).  Returns ``(lanes, o_live)``: per column ``v_<col>``
    and ``m_<col>`` AND ``o_live``, where ``o_live`` is the slot's
    ``live`` bit for a placed row.  Every lane is a fresh tensor."""
    if not slots.is_cuda:
        return probe_gather_plain(store, capacity, slots, live, cols, prefix)
    n = slots.shape[0]
    c1 = capacity + 1
    _expect(slots, torch.int32, (n,))
    _expect(live, torch.bool, (c1,))
    dev = slots.device
    out: Dict[str, torch.Tensor] = {}
    desc: List[int] = []
    for name in cols:
        v, m = store[f"{prefix}v_{name}"], store[f"{prefix}m_{name}"]
        _expect(v, v.dtype, (c1,))
        _expect(m, torch.bool, (c1,))
        vo = torch.empty(n, dtype=v.dtype, device=dev)
        mo = torch.empty(n, dtype=torch.bool, device=dev)
        out[f"v_{name}"], out[f"m_{name}"] = vo, mo
        desc += [v.data_ptr(), vo.data_ptr(), v.element_size(), m.data_ptr(), mo.data_ptr()]
    o_live = torch.empty(n, dtype=torch.bool, device=dev)
    cuda.check("probe_find", cuda.lib("probe_find", "ksql_probe_gather")(
        live.data_ptr(), capacity, cuda.host_i64(desc), len(cols), slots.data_ptr(), n,
        o_live.data_ptr(), _stream(dev),
    ))
    probe_find.launches += 1
    probe_find.mode_launches["gather"] += 1
    return out, o_live


def probe_find_slots(store: Dict[str, torch.Tensor], capacity: int, khash: torch.Tensor,
                     base: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """K8's find-only mode (replaces ``ops/hash_store.py:probe_find`` with
    window 0, the undo side of ``runtime/lowering.py:_ta_side``): per row
    the live slot of its group hash ``khash`` (walked from ``base``, K1's
    unwindowed probe start), or the dump slot ``capacity`` when the row is
    not ``active``, its key is absent, or 32 rounds did not resolve it.
    Only LIVE slots match; a truly empty slot ends the walk, graves are
    walked past.  Returns int32 slots; gathers nothing."""
    if not khash.is_cuda:
        return probe_find_plain(store, capacity, khash, torch.zeros_like(khash), active)
    n = khash.shape[0]
    c1 = capacity + 1
    for name, dt in (("occ", torch.bool), ("grave", torch.bool),
                     ("khash", torch.int64), ("wstart", torch.int64)):
        _expect(store[name], dt, (c1,))
    _expect(khash, torch.int64, (n,))
    _expect(base, torch.int32, (n,))
    _expect(active, torch.bool, (n,))
    slots = torch.empty(n, dtype=torch.int32, device=khash.device)
    cuda.check("probe_find", cuda.lib("probe_find", "ksql_probe_find_slots")(
        store["occ"].data_ptr(), store["grave"].data_ptr(), store["khash"].data_ptr(),
        store["wstart"].data_ptr(), capacity, khash.data_ptr(), base.data_ptr(),
        active.data_ptr(), n, slots.data_ptr(), _stream(khash.device),
    ))
    probe_find.launches += 1
    probe_find.mode_launches["find"] += 1
    return slots


probe_find.launches = 0
#: ``join``: a stream-table join's lookup and gather (:func:`probe_find`);
#: ``find``: the find-only walk of a table aggregation's undo side
#: (:func:`probe_find_slots`); ``gather``: a table-table join's other side
#: at the changes' slots (:func:`probe_gather`); ``live``: a foreign-key
#: join's right-row lookup, found only where live (:func:`probe_find` with
#: ``live``)
probe_find.mode_launches = {"join": 0, "find": 0, "gather": 0, "live": 0}


# ----------------------------------------------- K9: table_upsert (join)
def init_table_scratch(capacity: int, device) -> Dict[str, torch.Tensor]:
    """Scratch of one join table store: K2's claim cells and K9's
    last-writer cells (-1 when clean), both kept clean by the kernels."""
    return {
        "claim": torch.full((capacity + 1,), INT32_MAX, dtype=torch.int32, device=device),
        "last": torch.full((capacity + 1,), -1, dtype=torch.int32, device=device),
    }


def table_upsert_plain(store, capacity, slots, active, delete, values) -> None:
    """Plain twin of K9 — see :func:`table_upsert`."""
    n = slots.shape[0]
    dump = capacity
    s = slots.long()
    rowidx = torch.arange(n, dtype=torch.int32, device=slots.device)
    last = torch.full((capacity + 1,), -1, dtype=torch.int32, device=slots.device)
    last.scatter_reduce_(0, torch.where(active, s, dump), rowidx, "amax")
    winner = active & (s != dump) & (last[s] == rowidx)
    up = winner & ~delete
    rest = (~up).nonzero()
    for name, (data, valid) in values.items():
        v, m = store[f"v_{name}"], store[f"m_{name}"]
        data = data.to(v.dtype)
        v[s[up]] = data[up]
        m[s[up]] = valid[up]
        if rest.numel():  # the highest non-upserting row's values
            v[dump] = data[int(rest[-1])]
            m[dump] = valid[int(rest[-1])]
    dl = s[winner & delete]
    store["occ"][dl] = False
    store["grave"][dl] = True
    store["occ"][dump] = False
    store["grave"][dump] = False


def table_upsert(store: Dict[str, torch.Tensor], scratch: Dict[str, torch.Tensor],
                 capacity: int, slots: torch.Tensor, active: torch.Tensor,
                 delete: torch.Tensor, values: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """K9 (replaces the body of ``runtime/lowering.py:_trace_table_step``
    after its ``probe_insert``): fold a changelog batch, whose rows K2 has
    given ``slots``, into a join table store in place.  Per slot the LAST
    active row wins; an upserting winner writes ``values`` (per column
    ``(data, valid)``, data cast to the store's dtype), a deleting winner
    turns the slot into a grave.  Every other row writes the dump row, the
    highest such row last, as the reference's scatter leaves it; the dump
    row ends with occ and grave False."""
    if not slots.is_cuda:
        table_upsert_plain(store, capacity, slots, active, delete, values)
        return
    plan = upsert_plan((store["occ"], store["grave"]), scratch["last"], capacity,
                       [(store[f"v_{name}"], store[f"m_{name}"], False) for name in values])
    _launch_upsert(plan, "join", slots, active, delete, None, list(values.values()))


class UpsertPlan:
    """K9's host descriptor for one store's buffers: ``block`` holds six
    int64 a column (value dst, value src, element bytes, valid dst, valid
    src, whether the valid bits take ``act``); the store half is packed and
    checked once, the batch half (value and valid src) is filled per call
    (:func:`_launch_upsert`; a store's calls come from its query's one
    thread).  ``dtypes`` are the store's value dtypes."""

    def __init__(self, flags, last, capacity, dtypes, block):
        self.flags = flags  # held, so the cache's data pointers stay theirs
        self.last = last
        self.capacity = capacity
        self.dtypes = dtypes
        self.block = block


_UPSERT_PLANS: Dict[tuple, UpsertPlan] = {}
_UPSERT_PLAN_CACHE_SIZE = 64


def upsert_plan(flags: Sequence[torch.Tensor], last: torch.Tensor, capacity: int,
                cols: Sequence[Tuple[torch.Tensor, torch.Tensor, bool]]) -> UpsertPlan:
    """K9's descriptor for a store: ``flags`` its (occ, grave) (table
    mode) or (live,) (side mode), ``last`` its scratch, ``cols`` per column
    (values, valid bits, whether the valid bits take ``act``).  Built and
    checked once per set of buffers and cached: a grow that replaces the
    store's tensors gets a new one."""
    key = (capacity, last.data_ptr(), tuple(f.data_ptr() for f in flags),
           tuple((v.data_ptr(), v.dtype, m.data_ptr(), bool(u)) for v, m, u in cols))
    plan = _UPSERT_PLANS.get(key)
    if plan is not None:
        return plan
    c1 = capacity + 1
    for f in flags:
        _expect(f, torch.bool, (c1,))
    _expect(last, torch.int32, (c1,))
    desc: List[int] = []
    for v, m, use_act in cols:
        _expect(v, v.dtype, (c1,))
        _expect(m, torch.bool, (c1,))
        desc += [v.data_ptr(), 0, v.element_size(), m.data_ptr(), 0, int(use_act)]
    plan = UpsertPlan(tuple(flags), last, capacity, tuple(v.dtype for v, _, _ in cols),
                      cuda.host_i64(desc))
    if len(_UPSERT_PLANS) >= _UPSERT_PLAN_CACHE_SIZE:
        _UPSERT_PLANS.pop(next(iter(_UPSERT_PLANS)))
    _UPSERT_PLANS[key] = plan
    return plan


def _batch_col(t: torch.Tensor, dtype, n: int, cast: bool = True) -> torch.Tensor:
    """A batch column as K9 reads it: cast only when its dtype differs
    (``cast``; else a dtype that differs is refused), copied only when it
    is not contiguous."""
    if t.dtype != dtype:
        if not cast:
            raise ValueError(f"kernel argument: expected {dtype}, got {t.dtype}")
        t = t.to(dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    if t.shape != (n,) or not t.is_cuda:
        raise ValueError(f"kernel argument: expected a CUDA column of {n} rows, got "
                         f"{list(t.shape)} on {t.device}")
    return t


def _launch_upsert(plan: UpsertPlan, mode: str, slots, active, delete, act,
                   batch: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """One K9 launch: the batch's rows and columns into ``plan``'s store."""
    n = slots.shape[0]
    for t, dt in ((slots, torch.int32), (active, torch.bool), (delete, torch.bool)):
        _expect(t, dt, (n,))
    if act is not None:
        _expect(act, torch.bool, (n,))
    block = plan.block
    keep = []  # the cast and contiguous columns must outlive the launch below
    for j, ((data, valid), dt) in enumerate(zip(batch, plan.dtypes)):
        data, valid = _batch_col(data, dt, n), _batch_col(valid, torch.bool, n, cast=False)
        keep += [data, valid]
        block[6 * j + 1] = data.data_ptr()
        block[6 * j + 4] = valid.data_ptr()
    stream = _stream(slots.device)
    if mode == "join":
        occ, grave = plan.flags
        code = cuda.lib("table_upsert", "ksql_table_upsert")(
            occ.data_ptr(), grave.data_ptr(), plan.capacity, block, len(batch),
            slots.data_ptr(), active.data_ptr(), delete.data_ptr(), n, plan.last.data_ptr(),
            stream)
    else:
        (live,) = plan.flags
        code = cuda.lib("table_upsert", "ksql_table_upsert_side")(
            live.data_ptr(), plan.capacity, block, len(batch), slots.data_ptr(),
            active.data_ptr(), delete.data_ptr(), act.data_ptr(), n, plan.last.data_ptr(),
            stream)
    cuda.check("table_upsert", code)
    table_upsert.launches += 1
    table_upsert.mode_launches[mode] += 1


#: a column :func:`upsert_side` writes: (store values, store valid bits,
#: the batch's values, their valid bits, whether the valid bits take the
#: side's filter verdict ``act``)
SideColumn = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, bool]


def upsert_side_plain(live, capacity, slots, touched, delete, act, cols) -> None:
    """Plain twin of K9's side mode — see :func:`upsert_side`."""
    n = slots.shape[0]
    dump = capacity
    s = slots.long()
    rowidx = torch.arange(n, dtype=torch.int32, device=slots.device)
    last = torch.full((capacity + 1,), -1, dtype=torch.int32, device=slots.device)
    last.scatter_reduce_(0, torch.where(touched, s, dump), rowidx, "amax")
    winner = touched & (s != dump) & (last[s] == rowidx)
    up = winner & ~delete
    rest = (~up).nonzero()
    for v, m, data, valid, use_act in cols:
        data = data.to(v.dtype)
        valid = valid & act if use_act else valid
        v[s[up]] = data[up]
        m[s[up]] = valid[up]
        if rest.numel():  # the highest non-upserting row's values
            v[dump] = data[int(rest[-1])]
            m[dump] = valid[int(rest[-1])]
    live[s[up]] = True
    live[s[winner & delete]] = False
    live[dump] = False


def upsert_side(live: torch.Tensor, scratch: Dict[str, torch.Tensor], capacity: int,
                slots: torch.Tensor, touched: torch.Tensor, delete: torch.Tensor,
                act: torch.Tensor, cols: Sequence[SideColumn]) -> None:
    """K9's side mode (replaces ``runtime/lowering.py:_upsert_side``, with
    the fkrepr/fkvalid writes of ``_trace_fk_left`` riding along): fold one
    side's batch of a table-table or foreign-key join's changes, whose rows
    K2 has given ``slots``, into that side's columns of the join store in
    place.  Per slot the LAST row among the ``touched`` rows (a valid key)
    with a real slot wins; an upserting winner (``~delete``) writes every
    column of ``cols`` and ``live[slot] = True``, a deleting winner
    ``live[slot] = False`` (the slot keeps its key, occ and grave are not
    touched).  A column flagged with ``act`` writes ``valid & act`` as its
    valid bits.  Every other row writes the dump row, the highest such row
    last, as the reference's scatter leaves it; ``live[capacity]`` ends
    False."""
    if not slots.is_cuda:
        upsert_side_plain(live, capacity, slots, touched, delete, act, cols)
        return
    plan = upsert_plan((live,), scratch["last"], capacity, [(v, m, u) for v, m, _, _, u in cols])
    _launch_upsert(plan, "side", slots, touched, delete, act, [(d, m) for _, _, d, m, _ in cols])


table_upsert.launches = 0
#: ``join``: a stream-table join's table changelog (:func:`table_upsert`);
#: ``side``: one side of a table-table or foreign-key join (:func:`upsert_side`)
table_upsert.mode_launches = {"join": 0, "side": 0}


def init_bits(comp: AggComponent) -> int:
    """The bit pattern of a component's init value, as the kernels take it
    (int8 and int32 sign-extended, int64 and float64 as their 64 bits)."""
    init = np.array([comp.init], dtype=comp.dtype)
    if comp.dtype in ("int8", "int32"):
        return int(init[0])
    return int(init.view(np.int64)[0])


KERNEL_WRAPPERS = (row_prologue, probe_insert, fold_and_mark, evict, probe_find, table_upsert)


def _stream(device: torch.device) -> int:
    """The current CUDA stream of a CUDA tensor's ``device``, as the
    kernels' entry points take it: read as a raw pointer, without building
    the Stream object that ``torch.cuda.current_stream`` makes a call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _expect(t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"kernel argument: expected contiguous {dtype}{list(shape)}, "
            f"got {t.dtype}{list(t.shape)}"
        )
    if not t.is_cuda:
        raise ValueError("kernel argument on the CPU beside CUDA tensors")


# --------------------------------------------------------- host rebuild
def np_mix64(h: np.ndarray) -> np.ndarray:
    """Host (numpy) replica of mix64 — bit-identical; used when rebuilding
    a store into a larger capacity."""
    u = np.asarray(h).astype(np.int64).view(np.uint64).copy()
    u ^= u >> np.uint64(30)
    u *= np.uint64(0xBF58476D1CE4E5B9)
    u ^= u >> np.uint64(27)
    u *= np.uint64(0x94D049BB133111EB)
    u ^= u >> np.uint64(31)
    return u.view(np.int64)


def host_insert(
    occ: np.ndarray,
    kh: np.ndarray,
    ws: np.ndarray,
    capacity: int,
    khash: np.ndarray,
    wstart: np.ndarray,
) -> np.ndarray:
    """Vectorized numpy insert of unique (khash, wstart) keys into a store
    (occ/kh/ws mutated in place); returns per-key slots.  The host half of
    store growth — the RocksDB-compaction analog."""
    n = len(khash)
    mask = capacity - 1
    wmul = (
        np.asarray(wstart).astype(np.int64).view(np.uint64)
        * np.uint64(0x9E3779B97F4A7C15)
    ).view(np.int64)
    base = (np_mix64(np.asarray(khash) ^ wmul) & mask).astype(np.int64)
    slots = np.full(n, -1, np.int64)
    offset = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    for _ in range(4 * MAX_PROBES):
        if done.all():
            break
        cand = (base + offset) & mask
        c_occ = occ[cand]
        match = c_occ & (kh[cand] == khash) & (ws[cand] == wstart)
        newly = ~done & match
        slots[newly] = cand[newly]
        done |= newly
        want = ~done & ~c_occ
        claim = np.full(capacity, n, np.int64)
        np.minimum.at(claim, cand[want], np.nonzero(want)[0])
        winner = want & (claim[cand] == np.arange(n))
        occ[cand[winner]] = True
        kh[cand[winner]] = khash[winner]
        ws[cand[winner]] = wstart[winner]
        slots[winner] = cand[winner]
        done |= winner
        offset += (~done & c_occ & ~match).astype(np.int64)
    if not done.all():
        raise RuntimeError("host_insert: probe limit exceeded (table too full)")
    return slots
