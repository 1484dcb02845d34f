"""Sliced hopping aggregation on the card: the slice-ring fold, the
per-window combine and the emission lanes.

The port of ``ksql_tpu/runtime/lowering.py``'s ``_sliced_scatter``,
``_combine_windows`` and ``_sliced_member_emits`` (the reference keeps them
as ``CompiledDeviceQuery`` methods; ``TorchCompiledQuery``'s methods of
the same names call the wrappers here).  A sliced store keys one slot per
group key; each slot holds a ring of ``ring`` slice partials per aggregate
component (``a<j>`` is ``[capacity + 1, ring]``), ``slice_id[slot, pos]``
the absolute slice index a ring cell holds (-1 = empty) and
``slast[slot]`` the newest slice start folded into the slot.

Three hand-written CUDA kernels (``csrc/``) carry the work: K5
``sliced_fold``, K6 ``combine_windows`` (which also serves the plain
emission gather of every other aggregate route, S = 1, no ring) and K7
``member_lanes``.  As in ``ops/hash_store.py``, each wrapper launches its
kernel for CUDA tensors and counts the launch in ``<wrapper>.launches``
(K6 also in ``combine_windows.mode_launches``, ``gather``, ``sliced`` or
``wide``);
for CPU tensors it runs the plain torch twin beside it (``*_plain``),
which is also the kernel's oracle on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops.hash_store import StoreLayout, _expect, _stream

INT32_MAX = hs.INT32_MAX
INT64_MAX = (1 << 63) - 1


def init_slice_scratch(capacity: int, ring: int, spw: int, device) -> Dict[str, torch.Tensor]:
    """Scratch the sliced kernels keep clean between calls: K5's per-ring
    position claim for the dump row (-1 = none) and K7's per-(slot, window
    mod ``ring + spw``) lane claims (INT32_MAX = none)."""
    return {
        "ring_last": torch.full((ring,), -1, dtype=torch.int32, device=device),
        "lanes": torch.full(((capacity + 1) * (ring + spw),), INT32_MAX,
                            dtype=torch.int32, device=device),
    }


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


# ------------------------------------------------------- K5: sliced_fold
def sliced_fold_plain(store, layout: StoreLayout, slots, wstart, contribs,
                      active, width: int) -> None:
    """Plain twin of K5 — see :func:`sliced_fold`."""
    ring = layout.components[0].width
    dump = layout.capacity
    n = slots.shape[0]
    sidx = _floor_div(wstart, width)
    pos = torch.remainder(sidx, ring)
    eff = torch.where(active, slots.long(), dump)
    live = active & (slots != dump)
    sid = store["slice_id"]
    stale = live & (sid[eff, pos] != sidx)
    tgt_stale = torch.where(stale, eff, dump)
    flat = eff * ring + pos
    for j, comp in enumerate(layout.components):
        col = store[f"a{j}"]
        # every writer of one cell writes the same init: order-free
        col[tgt_stale, pos] = torch.tensor(comp.init, dtype=col.dtype)
        c = contribs[j].to(col.dtype)
        view = col.view(-1)
        if comp.combine == "add":
            view.index_add_(0, flat, c)
        else:
            before = view.clone() if view.is_floating_point() else None
            view.scatter_reduce_(0, flat, c, "amin" if comp.combine == "min" else "amax")
            if before is not None:
                hs._xla_signed_zero(view, before, flat, c, comp.combine)
    # the reference's slice_id scatter is unmasked: non-live rows write the
    # dump row, and XLA applies duplicates in row order (the highest wins)
    rowidx = torch.arange(n, device=slots.device)
    last = torch.full((ring,), -1, dtype=torch.int64, device=slots.device)
    last.scatter_reduce_(0, pos[~live], rowidx[~live], "amax")
    hit = (last >= 0).nonzero().squeeze(1)
    sid[dump, hit] = sidx[last[hit]]
    sid[eff[live], pos[live]] = sidx[live]
    store["slast"].scatter_reduce_(
        0, eff, torch.where(live, wstart, torch.full_like(wstart, hs.SLAST_NONE)), "amax"
    )
    store["dirty"][eff] = True
    store["dirty"][dump] = False


def sliced_fold(store: Dict[str, torch.Tensor], scratch: Dict[str, torch.Tensor],
                layout: StoreLayout, slots: torch.Tensor, wstart: torch.Tensor,
                contribs: Sequence[torch.Tensor], active: torch.Tensor,
                width: int) -> None:
    """K5 (replaces ``runtime/lowering.py:_sliced_scatter``): fold each row
    into its key slot's ring cell ``[slot, sidx % ring]`` (``sidx = wstart
    // width``, the absolute slice index), in place.  A targeted cell whose
    ``slice_id`` differs is a recycled cell of an earlier ring wrap and
    resets to the component inits first.  Then ``slice_id`` takes the
    slice index, ``slast`` the newest slice start and ``dirty`` is set.
    The dump row ends as the reference's leaves it: init at every ring
    position a non-stale row targets, and in ``slice_id`` the slice index
    of the highest non-live row per position.  Inactive rows must carry
    identity contributions."""
    if not slots.is_cuda:
        sliced_fold_plain(store, layout, slots, wstart, contribs, active, width)
        return
    n = slots.shape[0]
    capacity = layout.capacity
    ring = layout.components[0].width
    c1 = capacity + 1
    _expect(slots, torch.int32, (n,))
    _expect(wstart, torch.int64, (n,))
    _expect(active, torch.bool, (n,))
    _expect(store["slice_id"], torch.int64, (c1, ring))
    _expect(store["slast"], torch.int64, (c1,))
    _expect(store["dirty"], torch.bool, (c1,))
    _expect(scratch["ring_last"], torch.int32, (ring,))
    desc: List[int] = []
    keep = []  # the cast contributions must outlive the launches below
    for j, comp in enumerate(layout.components):
        col = store[f"a{j}"]
        c = contribs[j].to(col.dtype).contiguous()
        _expect(col, hs._DTYPES[comp.dtype], (c1, ring))
        _expect(c, hs._DTYPES[comp.dtype], (n,))
        keep.append(c)
        desc += [col.data_ptr(), c.data_ptr(),
                 hs._COMBINE_CODES[comp.combine] * 3 + hs._DTYPE_CODES[comp.dtype],
                 hs.init_bits(comp)]
    fn = cuda.lib("sliced_fold")
    cuda.check("sliced_fold", fn(
        cuda.host_i64(desc), len(layout.components), slots.data_ptr(),
        wstart.data_ptr(), active.data_ptr(), n, capacity, ring, int(width),
        store["slice_id"].data_ptr(), store["slast"].data_ptr(),
        store["dirty"].data_ptr(), scratch["ring_last"].data_ptr(),
        _stream(slots.device),
    ))
    sliced_fold.launches += 1


sliced_fold.launches = 0


# --------------------------------------------------- K6: combine_windows
def combine_windows_plain(store, layout: StoreLayout, num_keys: int, slot_lane,
                          w_lane=None, spw: int = 1, width: int = 0, mask=None):
    """Plain twin of K6 — see :func:`combine_windows`.  The wide columns'
    rows of lanes outside ``mask`` are zeros."""
    idx = slot_lane.long()
    out: Dict[str, torch.Tensor] = {}
    if w_lane is None:
        for j, comp in enumerate(layout.components):
            col = store[f"a{j}"]
            if comp.width == 1 or mask is None:
                out[f"a{j}"] = col[idx]
            else:
                wide = torch.zeros((idx.shape[0], comp.width), dtype=col.dtype, device=col.device)
                wide[mask] = col[idx[mask]]
                out[f"a{j}"] = wide
        out["wstart"] = store["wstart"][idx]
    else:
        ring = layout.components[0].width
        ids = w_lane[:, None] + torch.arange(spw, dtype=torch.int64, device=idx.device)
        pos = torch.remainder(ids, ring)
        rows = idx[:, None]
        idok = store["slice_id"][rows, pos] == ids
        for j, comp in enumerate(layout.components):
            cells = store[f"a{j}"][rows, pos]
            init = torch.tensor(comp.init, dtype=cells.dtype)
            cells = torch.where(idok, cells, init)
            # the reduction's identity, then the covering slices in order
            if comp.combine == "add":
                acc = torch.zeros_like(cells[:, 0])
            else:
                acc = torch.full_like(cells[:, 0], comp.init)
            for t in range(spw):
                if comp.combine == "add":
                    acc = acc + cells[:, t]
                else:
                    acc = hs.xla_minmax(acc, cells[:, t], comp.combine)
            out[f"a{j}"] = acc
        out["wstart"] = w_lane * width
    out["knull"] = store["knull"][idx]
    for i in range(num_keys):
        out[f"key{i}"] = store[f"key{i}"][idx]
    return out


#: K6's outputs start at multiples of this many bytes of one buffer
OUT_ALIGN = 16
_ESIZE = {torch.bool: 1, torch.int8: 1, torch.int32: 4, torch.int64: 8, torch.float64: 8}
#: K6's column kinds (``csrc/combine_windows.cu``); a reduce is
#: ``_K_REDUCE + combine * 3 + dtype``
_K_GATHER4, _K_GATHER8, _K_WSTART, _K_REDUCE = 0, 1, 2, 3
#: descriptors kept (a store that grows leaves its old ones behind)
_PLAN_CACHE_SIZE = 64


class GatherPlan:
    """K6's host descriptor for one store and layout: ``specs`` the outputs
    in order (name, dtype, width; width 0 for one value a lane), ``block``
    the ``ctypes`` descriptor block ``csrc/combine_windows.cu`` reads
    (which holds each output's bytes a lane, so the kernel's entry places
    the outputs as :meth:`offsets` does) and ``mode`` the launch's mode."""

    def __init__(self, layout, specs, lane_bytes, block, mode):
        self.layout = layout  # held, so the cache's id(layout) stays unique
        self.specs = specs
        self.lane_bytes = lane_bytes
        self.block = block
        self.mode = mode

    def offsets(self, nn: int) -> Tuple[List[int], int]:
        """``(byte offsets, total bytes)`` of the outputs for ``nn`` lanes:
        each starts at the first multiple of :data:`OUT_ALIGN` past the
        one before it."""
        offs, at = [], 0
        for b in self.lane_bytes:
            offs.append(at)
            at += -(-nn * b // OUT_ALIGN) * OUT_ALIGN
        return offs, at


_PLANS: Dict[tuple, GatherPlan] = {}


def _check_col(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"K6 store column {name}: expected contiguous {dtype}{list(shape)} on "
                         f"{device}, got {t.dtype}{list(t.shape)} on {t.device}")


def gather_plan(store: Dict[str, torch.Tensor], layout: StoreLayout, num_keys: int, ring: int,
                device) -> GatherPlan:
    """K6's descriptor for ``store`` (sliced when ``ring`` > 0), built and
    checked once per (layout, store buffers) and cached: a grow that
    replaces the store's tensors gets a new one."""
    names = [f"a{j}" for j in range(len(layout.components))]
    names += [f"key{i}" for i in range(num_keys)] + ["knull", "wstart"]
    if ring:
        names.append("slice_id")
    key = (id(layout), num_keys, ring, device, tuple(store[n].data_ptr() for n in names))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    dev = torch.device(device)
    c1 = layout.capacity + 1
    specs, cols, wide = [], [], []
    slice_id = 0
    if ring:
        _check_col(store["slice_id"], "slice_id", torch.int64, (c1, ring), dev)
        slice_id = store["slice_id"].data_ptr()
    for j, comp in enumerate(layout.components):
        col = store[f"a{j}"]
        dt = hs._DTYPES[comp.dtype]
        if not ring and comp.width > 1:
            _check_col(col, f"a{j}", dt, (c1, comp.width), dev)
            wide += [col.data_ptr(), len(specs), comp.width * _ESIZE[dt]]
            specs.append((f"a{j}", dt, comp.width))
            continue
        _check_col(col, f"a{j}", dt, (c1, ring) if ring else (c1,), dev)
        if ring:
            # a vector group's scalar head (vec_count) is gathered as it is
            kind = _K_REDUCE + hs._COMBINE_CODES.get(comp.combine, 0) * 3 + hs._DTYPE_CODES[comp.dtype]
        elif _ESIZE[dt] in (4, 8):
            kind = _K_GATHER4 if _ESIZE[dt] == 4 else _K_GATHER8
        else:
            raise ValueError(f"K6 gathers 4- and 8-byte columns, not {dt} (a{j})")
        cols += [col.data_ptr(), len(specs), kind, hs.init_bits(comp)]
        specs.append((f"a{j}", dt, 0))
    for name, dt in [(f"key{i}", torch.int64) for i in range(num_keys)] + [
            ("knull", torch.int32), ("wstart", torch.int64)]:
        col = store[name]
        _check_col(col, name, dt, (c1,), dev)
        kind = _K_WSTART if ring and name == "wstart" else _K_GATHER4 if dt == torch.int32 else _K_GATHER8
        cols += [col.data_ptr(), len(specs), kind, 0]
        specs.append((name, dt, 0))
    lane_bytes = [max(w, 1) * _ESIZE[dt] for _, dt, w in specs]
    block = cuda.host_i64([len(cols) // 4, len(wide) // 3, slice_id, len(specs)] + lane_bytes
                          + cols + wide)
    plan = GatherPlan(layout, tuple(specs), tuple(lane_bytes), block,
                      "sliced" if ring else "wide" if wide else "gather")
    if len(_PLANS) >= _PLAN_CACHE_SIZE:
        _PLANS.pop(next(iter(_PLANS)))
    _PLANS[key] = plan
    return plan


def pack_outputs(plan: GatherPlan, nn: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One fresh byte buffer for K6's outputs of ``nn`` lanes and the typed
    view of each (``[nn]``, or ``[nn, width]`` for a wide column) at its
    offset; no view aliases another or the store."""
    offs, total = plan.offsets(nn)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    typed: Dict[torch.dtype, torch.Tensor] = {}
    out: Dict[str, torch.Tensor] = {}
    for (name, dt, w), off in zip(plan.specs, offs):
        v = typed.get(dt)
        if v is None:
            v = typed[dt] = buf.view(dt)
        start = off // _ESIZE[dt]
        out[name] = v.as_strided((nn, w), (w, 1), start) if w else v.as_strided((nn,), (1,), start)
    return buf, out


def combine_windows(store: Dict[str, torch.Tensor], layout: StoreLayout,
                    num_keys: int, slot_lane: torch.Tensor,
                    w_lane: Optional[torch.Tensor] = None, spw: int = 1,
                    width: int = 0, mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """K6 (replaces ``runtime/lowering.py:_combine_windows`` and the gather
    of ``_finalized_env``): per emission lane, the store's state at
    ``slot_lane`` in fresh tensors — ``a<j>``, ``key<i>``, ``knull`` and
    ``wstart``.

    With ``w_lane`` (sliced store), lane ``l`` is the window of ``spw``
    slices starting at slice ``w_lane[l]``: each component is the monoid
    reduce (add/min/max, in ascending slice order, XLA's NaN and
    signed-zero order for min/max) of the ring cells ``(slot, (w + t) %
    ring)``; a cell whose ``slice_id`` is not ``w + t`` reads as the init.
    ``wstart`` is ``w_lane * width``.  Without ``w_lane`` it is the plain
    gather (S = 1, no ring) of the tumbling, unwindowed and expansion
    routes; there a vector aggregate's width-K column (``ops/vector.py``)
    is gathered whole per lane (K6's wide mode, counted as ``wide``), for
    the lanes of ``mask`` only when one is given (K3's winners: the rows
    of the other lanes are left unspecified).  The outputs are views of one
    fresh buffer (:func:`pack_outputs`); the store's columns are checked
    when their descriptor is built (:func:`gather_plan`)."""
    if not slot_lane.is_cuda:
        return combine_windows_plain(store, layout, num_keys, slot_lane, w_lane, spw, width, mask)
    nn = slot_lane.shape[0]
    ring = layout.components[0].width if w_lane is not None else 0
    _expect(slot_lane, torch.int32, (nn,))
    if w_lane is not None:
        _expect(w_lane, torch.int64, (nn,))
    if mask is not None:
        _expect(mask, torch.bool, (nn,))
    dev = slot_lane.device
    plan = gather_plan(store, layout, num_keys, ring, dev)
    buf, out = pack_outputs(plan, nn, dev)
    cuda.check("combine_windows", cuda.lib("combine_windows")(
        plan.block, buf.data_ptr(), slot_lane.data_ptr(),
        w_lane.data_ptr() if ring else None, None if mask is None else mask.data_ptr(),
        nn, ring, int(spw), int(width), _stream(dev),
    ))
    combine_windows.launches += 1
    combine_windows.mode_launches[plan.mode] += 1
    return out


combine_windows.launches = 0
#: ``wide``: a plain gather whose layout holds width-K vector columns
combine_windows.mode_launches = {"gather": 0, "sliced": 0, "wide": 0}


# ------------------------------------------------------ K7: member_lanes
def member_lanes_plain(slots, active, wstart, max_ts, capacity: int, width: int,
                       spw: int, advance_ms: int, size_ms: int, grace_ms: int,
                       hops: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K7 — see :func:`member_lanes`."""
    n = slots.shape[0]
    dump = capacity
    adv = advance_ms // width
    act = active & (slots != dump)
    sidx = _floor_div(wstart, width)
    newest = sidx - torch.remainder(sidx, adv)
    hop = torch.arange(hops, dtype=torch.int64, device=slots.device).repeat_interleave(n)
    w_lane = newest.repeat(hops) - hop * adv
    slot_lane = slots.repeat(hops)
    covers = (w_lane + spw > sidx.repeat(hops)) & (w_lane >= 0)
    open_w = w_lane * width + size_ms + grace_ms > max_ts
    mask = act.repeat(hops) & covers & open_w
    # lexsort first occurrence: lanes grouped by (slot, window), lane order
    eff_slot = torch.where(mask, slot_lane.long(), dump)
    eff_w = torch.where(mask, w_lane, torch.full_like(w_lane, INT64_MAX))
    o1 = torch.argsort(eff_w, stable=True)
    order = o1[torch.argsort(eff_slot[o1], stable=True)]
    so_s, so_w = eff_slot[order], eff_w[order]
    first = torch.ones_like(mask)
    first[1:] = (so_s[1:] != so_s[:-1]) | (so_w[1:] != so_w[:-1])
    winner = torch.zeros_like(mask)
    winner[order] = first & (so_s != dump)
    return w_lane, slot_lane, winner & mask


def member_lanes(slots: torch.Tensor, active: torch.Tensor, wstart: torch.Tensor,
                 max_ts: torch.Tensor, capacity: int, width: int, spw: int,
                 advance_ms: int, size_ms: int, grace_ms: int, hops: int,
                 scratch: Dict[str, torch.Tensor]):
    """K7 (replaces the lane expansion and dedupe of
    ``runtime/lowering.py:_sliced_member_emits``): expand the n rows to
    ``n·hops`` window lanes, lane ``h·n + i`` being window ``newest_i −
    h·A`` (``newest`` the newest advance-aligned window over row ``i``'s
    slice, ``A`` the advance in slices).  A lane emits when its row reached
    a store slot, its window covers the row's slice, starts at or after 0
    and is still open at the stream time ``max_ts`` of batch start; of the
    emitting lanes of one (slot, window) only the lowest lane index wins,
    as the reference's lexsort first occurrence gives.  Returns
    ``(w_lane, slot_lane, winner)``: every lane's window start in slice
    units and slot, and the winner mask."""
    if not slots.is_cuda:
        return member_lanes_plain(slots, active, wstart, max_ts, capacity, width,
                                  spw, advance_ms, size_ms, grace_ms, hops)
    n = slots.shape[0]
    claims = scratch["lanes"]
    span = claims.shape[0] // (capacity + 1)
    _expect(slots, torch.int32, (n,))
    _expect(active, torch.bool, (n,))
    _expect(wstart, torch.int64, (n,))
    _expect(max_ts, torch.int64, ())
    _expect(claims, torch.int32, ((capacity + 1) * span,))
    dev = slots.device
    nn = n * hops
    w_lane = torch.empty(nn, dtype=torch.int64, device=dev)
    slot_lane = torch.empty(nn, dtype=torch.int32, device=dev)
    winner = torch.empty(nn, dtype=torch.bool, device=dev)
    fn = cuda.lib("member_lanes")
    cuda.check("member_lanes", fn(
        slots.data_ptr(), active.data_ptr(), wstart.data_ptr(), n, hops,
        int(spw), advance_ms // width, int(width), int(size_ms), int(grace_ms),
        max_ts.data_ptr(), capacity, claims.data_ptr(), span,
        w_lane.data_ptr(), slot_lane.data_ptr(), winner.data_ptr(), _stream(dev),
    ))
    member_lanes.launches += 1
    return w_lane, slot_lane, winner


member_lanes.launches = 0

KERNEL_WRAPPERS = (sliced_fold, combine_windows, member_lanes)
