"""EMIT FINAL and HAVING retraction on the card.

The port of the suppress lanes of ``ksql_tpu/runtime/lowering.py``'s
``pre_exchange`` and the suppress branch of its ``post_exchange`` (B17),
and of the HAVING verdict of its ``_emit_agg`` (B6).  An EMIT FINAL store
keeps, beside the aggregate store's columns, ``born`` (each slot's first
touch in lane order, ``row_clock`` + lane, across batches), ``emitted``
(its final result went out), and two scalars: ``emit_clock`` (the stream
time over every raw source row, filtered rows included) and ``row_clock``
(lanes seen so far).  A window closes at ``wstart + size + grace`` and
leaves the store's retention at ``wstart + retention``; it emits once, in
the batch whose stream times first reach its close, if one of them is at
or before its horizon, and is evicted unemitted otherwise.  A store with
HAVING retraction keeps ``hpass``, each slot's last verdict: a slot that
passed before and fails now emits a tombstone.

Three hand-written CUDA kernels (``csrc/``):

* K17 ``suppress_clock``: the running stream time over the aggregation
  lanes and the grace cut it drives (in place of K1's), and the running
  emission clock over the raw rows.
* K18 ``suppress_close``: the ``born`` scatter-min, then per slot the close
  decision (emit, evict or wait) and its state updates, the emission mask
  and the two clocks, in one launch.
* K19 ``having_verdict``: per emission lane, the retraction tombstone, the
  new mask and the slot's verdict.

K4's suppress mode (``ops/hash_store.py:evict``) is this path's retention
pass.  As in ``ops/hash_store.py``, each wrapper launches its kernel for
CUDA tensors and counts the launch in ``<kernel>.launches`` (K17 also in
``mode_launches``, by lane layout); for CPU tensors it runs the plain
torch twin beside it (``*_plain``), which is also the kernel's oracle on
the card.  Every int64 sum wraps, as XLA's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import (
    _DTYPE_CODES,
    _DTYPES,
    INT64_MAX,
    INT64_MIN,
    StoreLayout,
    _expect,
    _stream,
    init_bits,
)


# ------------------------------------------------------ K17: suppress_clock
#: the smallest tile K17 takes (csrc/suppress_clock.cu: kThreads x 2 items)
CLOCK_MIN_TILE = 512


def suppress_clock_plain(ts, wstart, active, row_valid, max_ts, emit_clock, size_ms, grace_ms):
    """Plain twin of K17 — see :func:`suppress_clock`."""
    n = ts.shape[0]
    lane_ts = ts.repeat(active.shape[0] // n)
    neg = torch.full_like(lane_ts, INT64_MIN)
    cm = torch.maximum(torch.cummax(torch.where(active, lane_ts, neg), 0).values, max_ts)
    act = active & (wstart + size_ms + grace_ms > cm)
    c0 = torch.where(act, lane_ts, neg)
    raw = torch.where(row_valid, ts, torch.full_like(ts, INT64_MIN))
    cm_emit = torch.maximum(torch.cummax(raw, 0).values, emit_clock)
    return act, c0, cm_emit


def suppress_clock(ts: torch.Tensor, wstart: torch.Tensor, active: torch.Tensor,
                   row_valid: torch.Tensor, max_ts: torch.Tensor, emit_clock: torch.Tensor,
                   size_ms: int, grace_ms: int):
    """K17 (replaces the suppress lanes of ``runtime/lowering.py:
    pre_exchange``): ``ts`` and ``row_valid`` are the batch's ``n`` raw
    rows, ``wstart`` and ``active`` its ``n·k`` aggregation lanes from K1
    (lane ``h·n + i`` is row ``i``'s hop ``h``; K1 ran without its grace
    cut).  The running stream time over the lanes in lane order, ``cm =
    max(cummax(where(active, ts, MIN)), max_ts)``, cuts the late lanes
    (``active &= wstart + size + grace > cm``); on the expansion route the
    hops ``h >= 1`` therefore see the whole batch's maximum, as the
    reference's scan over the tiled lanes does.  Returns ``(active, c0,
    cm_emit)``: the lanes that reach the store, their watermark
    contribution (``ts`` where active, INT64_MIN elsewhere) and the
    emission clock per raw row, ``max(cummax(where(row_valid, ts, MIN)),
    emit_clock)``, which is non-decreasing.  One launch (a single-pass
    scan with decoupled look-back over many blocks); writes no state but
    its per-device scratch (``suppress_clock.scratch``)."""
    if not ts.is_cuda:
        return suppress_clock_plain(ts, wstart, active, row_valid, max_ts, emit_clock,
                                    size_ms, grace_ms)
    n = ts.shape[0]
    lanes = active.shape[0]
    _expect(ts, torch.int64, (n,))
    _expect(row_valid, torch.bool, (n,))
    _expect(wstart, torch.int64, (lanes,))
    _expect(active, torch.bool, (lanes,))
    _expect(max_ts, torch.int64, ())
    _expect(emit_clock, torch.int64, ())
    dev = ts.device
    act = torch.empty(lanes, dtype=torch.bool, device=dev)
    c0 = torch.empty(lanes, dtype=torch.int64, device=dev)
    cm_emit = torch.empty(n, dtype=torch.int64, device=dev)
    # tiles of the smallest size the kernel takes: an upper bound on its grid
    need = (lanes // n) * -(-n // CLOCK_MIN_TILE)
    scratch = suppress_clock.scratch.get(dev)
    if scratch is None or scratch["tiles"] < need:
        scratch = suppress_clock.scratch[dev] = {
            "buf": torch.zeros(1 + 4 * need, dtype=torch.int64, device=dev), "tiles": need, "epoch": 0}
    scratch["epoch"] += 1
    fn = cuda.lib("suppress_clock")
    cuda.check("suppress_clock", fn(
        ts.data_ptr(), wstart.data_ptr(), active.data_ptr(), row_valid.data_ptr(), n, lanes,
        max_ts.data_ptr(), emit_clock.data_ptr(), int(size_ms), int(grace_ms),
        act.data_ptr(), c0.data_ptr(), cm_emit.data_ptr(), scratch["buf"].data_ptr(),
        scratch["tiles"], scratch["epoch"], _stream(dev),
    ))
    suppress_clock.launches += 1
    suppress_clock.mode_launches["expansion" if lanes > n else "tumbling"] += 1
    return act, c0, cm_emit


suppress_clock.launches = 0
#: ``tumbling``: one lane per row; ``expansion``: the k-fold hopping lanes
suppress_clock.mode_launches = {"tumbling": 0, "expansion": 0}
#: per device, the look-back scratch: ``buf`` (a ticket word, then a flag
#: and a value a tile for the lane and the row sequences; zeroed once),
#: its ``tiles`` and the calls made on it (``epoch``: each call's flags
#: carry it, so no call resets the scratch)
suppress_clock.scratch = {}


# ------------------------------------------------------ K18: suppress_close
def suppress_close_plain(store, layout: StoreLayout, slots, active, cm_emit, size_ms,
                         grace_ms, retention_ms) -> torch.Tensor:
    """Plain twin of K18 — see :func:`suppress_close`."""
    cap = layout.capacity
    lanes = active.shape[0]
    order = store["row_clock"] + torch.arange(lanes, dtype=torch.int64, device=active.device)
    slot_or_dump = torch.where(active, slots.long(), cap)
    store["born"].scatter_reduce_(0, slot_or_dump,
                                  torch.where(active, order, torch.full_like(order, INT64_MAX)),
                                  "amin")
    cm = torch.sort(cm_emit).values
    m = cm.shape[0]
    ws = store["wstart"]
    close = ws + size_ms + grace_ms
    horizon = ws + retention_ms
    pos = torch.searchsorted(cm, close)
    t_first = cm[pos.clamp(max=m - 1)]
    reachable = (pos < m) & (t_first <= horizon)
    final_t = cm[m - 1]
    torch.maximum(store["emit_clock"], final_t, out=store["emit_clock"])
    store["row_clock"].add_(lanes)
    cand = store["occ"] & store["dirty"] & ~store["emitted"]
    emit_now = cand & reachable
    evict_now = cand & (close <= final_t) & ~reachable
    store["dirty"] &= ~(emit_now | evict_now)
    store["emitted"] |= emit_now
    store["occ"] &= ~evict_now
    store["grave"] |= evict_now
    store["born"].masked_fill_(evict_now, INT64_MAX)
    for j, comp in enumerate(layout.components):
        store[f"a{j}"].masked_fill_(evict_now, comp.init)
    return emit_now


def suppress_close(store: Dict[str, torch.Tensor], layout: StoreLayout, slots: torch.Tensor,
                   active: torch.Tensor, cm_emit: torch.Tensor, size_ms: int, grace_ms: int,
                   retention_ms: int) -> torch.Tensor:
    """K18 (replaces the suppress branch of ``runtime/lowering.py:
    post_exchange``), in place, after K3 has folded the batch and marked
    its slots ``dirty``.  First ``born[slot] = min(born[slot], row_clock +
    lane)`` for every active lane (``slots`` are K2's; an overflowed active
    lane aims at the dump slot).  Then per slot: ``close = wstart + size +
    grace``, ``horizon = wstart + retention``; a candidate (``occ & dirty &
    ~emitted``) emits when the first emission-clock time ``T >= close``
    exists and is ``<= horizon``, and is evicted unemitted when ``close <=
    cm_emit[-1]`` and it does not emit (occ off, grave on, born INT64_MAX,
    components to init); both clear ``dirty``, an emit sets ``emitted``.
    ``emit_clock`` advances to ``cm_emit[-1]`` and ``row_clock`` by the lane
    count.  ``cm_emit`` is K17's, already non-decreasing (the twin sorts it
    as the reference does; the kernel does not need to).  Returns the
    ``[capacity + 1]`` mask of the slots that emit.  One cooperative launch:
    the born scatter (one atomic a warp's group of lanes on a slot; a
    group of several reads born first and skips the atomic where born
    already holds a smaller order), a grid barrier, then the
    close pass (16 slots a lane as 16-byte vectors, each warp's candidates
    shared out among its lanes, the search through a sample of ``cm_emit``
    in shared memory)."""
    occ = store["occ"]
    if not occ.is_cuda:
        return suppress_close_plain(store, layout, slots, active, cm_emit, size_ms, grace_ms,
                                    retention_ms)
    c1 = layout.capacity + 1
    lanes = active.shape[0]
    n = cm_emit.shape[0]
    for name, dt in (("occ", torch.bool), ("grave", torch.bool), ("dirty", torch.bool),
                     ("emitted", torch.bool), ("born", torch.int64), ("wstart", torch.int64)):
        _expect(store[name], dt, (c1,))
    _expect(store["emit_clock"], torch.int64, ())
    _expect(store["row_clock"], torch.int64, ())
    _expect(slots, torch.int32, (lanes,))
    _expect(active, torch.bool, (lanes,))
    _expect(cm_emit, torch.int64, (n,))
    desc = []
    for j, comp in enumerate(layout.components):
        col = store[f"a{j}"]
        _expect(col, _DTYPES[comp.dtype], (c1,))
        desc += [col.data_ptr(), _DTYPE_CODES[comp.dtype], init_bits(comp)]
    dev = occ.device
    emit_now = torch.empty(c1, dtype=torch.bool, device=dev)
    sample = suppress_close.scratch.get(dev)
    if sample is None:
        sample = suppress_close.scratch[dev] = torch.empty(CLOSE_SAMPLE_WORDS, dtype=torch.int64, device=dev)
    fn = cuda.lib("suppress_close")
    cuda.check("suppress_close", fn(
        cuda.host_i64(desc), len(layout.components), slots.data_ptr(), active.data_ptr(), lanes,
        occ.data_ptr(), store["grave"].data_ptr(), store["dirty"].data_ptr(),
        store["emitted"].data_ptr(), store["born"].data_ptr(), store["wstart"].data_ptr(),
        cm_emit.data_ptr(), n, int(size_ms), int(grace_ms), int(retention_ms),
        store["emit_clock"].data_ptr(), store["row_clock"].data_ptr(), emit_now.data_ptr(),
        layout.capacity, sample.data_ptr(), CLOSE_SAMPLE_WORDS, _stream(dev),
    ))
    suppress_close.launches += 1
    return emit_now


suppress_close.launches = 0
#: the words of K18's sample scratch (csrc/suppress_close.cu's kSample, or
#: more; the kernel refuses less)
CLOSE_SAMPLE_WORDS = 8192
#: per device, the sample of cm_emit the born phase writes and the close
#: phase reads (no state between calls)
suppress_close.scratch = {}


# ------------------------------------------------------ K19: having_verdict
def having_verdict_plain(hpass, slots, mask, data, valid, tombstone=None):
    """Plain twin of K19 — see :func:`having_verdict`."""
    cap = hpass.shape[0] - 1
    s = slots.long()
    passed = valid & data.to(torch.bool)
    t = mask & hpass[s] & ~passed
    touched = torch.where(mask, s, cap)
    real = touched != cap
    hpass[touched[real]] = passed[real]
    at_dump = (~real).nonzero()
    if at_dump.numel():
        hpass[cap] = passed[at_dump[-1, 0]]
    tomb = t if tombstone is None else tombstone | t
    return mask & (passed | t), tomb


def having_verdict(hpass: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor,
                   data: torch.Tensor, valid: torch.Tensor,
                   tombstone: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19 (replaces the hpass branch of ``runtime/lowering.py:_emit_agg``),
    one HAVING filter over an EMIT CHANGES aggregation's emission lanes:
    ``slots`` are the lanes' store slots, ``mask`` the lanes that emit so
    far (one winner per slot), ``data``/``valid`` the predicate.  A lane
    passes when ``valid & data``; a masked lane whose slot passed before
    (``hpass``) and fails now is a retraction tombstone.  ``hpass`` is set,
    in place, to the verdict at ``where(mask, slot, C)``: the dump slot C
    keeps the verdict of the highest lane aimed at it, as XLA's
    duplicate-index set leaves it.  Returns ``(mask & (pass | tombstone),
    tombstone)``, the tombstones OR'd into ``tombstone`` when given."""
    lanes = mask.shape[0]
    data = data.to(torch.bool).expand(lanes).contiguous()
    valid = valid.expand(lanes).contiguous()
    if not hpass.is_cuda:
        return having_verdict_plain(hpass, slots, mask, data, valid, tombstone)
    c1 = hpass.shape[0]
    _expect(hpass, torch.bool, (c1,))
    _expect(slots, torch.int32, (lanes,))
    _expect(mask, torch.bool, (lanes,))
    _expect(data, torch.bool, (lanes,))
    _expect(valid, torch.bool, (lanes,))
    if tombstone is not None:
        _expect(tombstone, torch.bool, (lanes,))
    dev = hpass.device
    mask_out = torch.empty(lanes, dtype=torch.bool, device=dev)
    tomb_out = torch.empty(lanes, dtype=torch.bool, device=dev)
    last = having_verdict.scratch.get(dev)
    if last is None:
        last = having_verdict.scratch[dev] = torch.full((1,), -1, dtype=torch.int32, device=dev)
    fn = cuda.lib("having_verdict")
    code = fn(
        hpass.data_ptr(), slots.data_ptr(), mask.data_ptr(), data.data_ptr(), valid.data_ptr(),
        None if tombstone is None else tombstone.data_ptr(), lanes, c1 - 1,
        mask_out.data_ptr(), tomb_out.data_ptr(), last.data_ptr(), _stream(dev),
    )
    if code != 0:  # the dump launch may not have reset the scratch
        del having_verdict.scratch[dev]
    cuda.check("having_verdict", code)
    having_verdict.launches += 1
    return mask_out, tomb_out


having_verdict.launches = 0
#: per device, the int32 index of the highest lane aimed at the dump slot;
#: -1 between calls (the kernel's second launch resets it)
having_verdict.scratch = {}

KERNEL_WRAPPERS = (suppress_clock, suppress_close, having_verdict)
