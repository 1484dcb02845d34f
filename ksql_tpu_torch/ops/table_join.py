"""The foreign-key join's fan-out of a right-table change — K24 ``fk_fanout``.

A foreign-key table-table join keeps its left table (keyed by its own
primary key) in a store ``fkl`` whose every slot also holds the row's
foreign key as a 64-bit repr (``fkrepr``, ``fkvalid``) beside its liveness
(``live``).  A change of a right row must re-join every live left row whose
foreign key is that row's key: the reference scans all ``capacity + 1``
slots (``runtime/lowering.py:_trace_fk_right``) and runs the post-join
chain over as many lanes.  :func:`fk_fanout` scans them once, compacts the
matching slots in slot order and gathers their columns, so that the chain
runs over the matches alone (only matched lanes can emit; the sink's order
is the host sort of the reference's ``process_fk``).

The wrapper launches the CUDA kernel (``csrc/fk_fanout.cu``, one
single-pass launch a call: the scan, the order-keeping compaction and the
gathers, with one host synchronization for the match count) for CUDA
tensors and counts it in ``fk_fanout.launches``; for CPU tensors it runs
the plain torch twin, :func:`fk_fanout_plain`.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Sequence, Tuple

import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import Lanes, _expect, _stream

#: the kernel's tile (csrc/fk_fanout.cu kTile): one status word a tile
_TILE = 4096


def fk_fanout_plain(store, capacity, krepr, touched, cols):
    """Plain twin of K24 — see :func:`fk_fanout`."""
    match = store["live"] & store["fkvalid"] & (store["fkrepr"] == krepr[0]) & touched[0]
    idx = match.nonzero().squeeze(1)
    lanes = {}
    for name in cols:
        lanes[f"v_{name}"] = store[f"v_{name}"][idx]
        lanes[f"m_{name}"] = store[f"m_{name}"][idx]
    return idx.to(torch.int32), lanes, store["key0"][idx]


def fk_fanout(store: Dict[str, torch.Tensor], capacity: int, krepr: torch.Tensor,
              touched: torch.Tensor, cols: Sequence[str]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """K24 (replaces the ``match`` scan and the ``lenv``/``lkey`` lanes of
    ``runtime/lowering.py:_trace_fk_right``): the left slots of ``store``
    (``fkl``) that a right change re-joins, ``live & fkvalid & fkrepr ==
    krepr[0] & touched[0]`` over all ``capacity + 1`` slots (row 0 of the
    per-record batch is the change; the dump slot is never live).

    Returns ``(slots, lanes, key0)``, each as long as the matches, in slot
    order: the int32 slots, per left column ``v_<col>`` and ``m_<col>``
    (the store's values and valid bits there) and the slots' ``key0``
    reprs.  One single-pass launch writes them into lanes of ``capacity +
    1`` rows of one fresh allocation, and the call synchronizes once to
    read the match count."""
    if not krepr.is_cuda:
        return fk_fanout_plain(store, capacity, krepr, touched, cols)
    plan = fanout_plan(store, capacity, cols)
    _expect(krepr, torch.int64, (krepr.shape[0],))
    _expect(touched, torch.bool, (touched.shape[0],))
    buf = plan.lanes.alloc(plan.c1, krepr.device)
    cuda.check("fk_fanout", cuda.lib("fk_fanout", "ksql_fk_fanout")(
        *plan.ptrs, plan.c1, krepr.data_ptr(), touched.data_ptr(), plan.desc_ptr, plan.words,
        buf.data_ptr(), *plan.scratch_ptrs, plan.host_ptr, _stream(krepr.device)))
    fk_fanout.launches += 1
    (lanes,) = plan.lanes.views(buf, plan.c1, int(plan.host[0]))
    slots, key = lanes.pop("slots"), lanes.pop("key0")
    return slots, lanes, key


fk_fanout.launches = 0


class FanoutPlan:
    """K24's host side for one store's buffers: the store's arrays,
    checked once; ``desc`` the device descriptor of ``csrc/fk_fanout.cu``
    (the left columns' store arrays and element bytes, each output lane's
    byte offset in the call's one allocation); ``scratch`` the kernel's
    status words, ticket and done count (int64 each; the kernel leaves
    them clean) and the device int64 it writes the match count into;
    ``host`` the pinned int64 the count is copied to; ``lanes`` the
    :class:`Lanes` layout of the outputs.  The plan holds the store's
    tensors weakly: a cached plan keeps no store alive, and one whose
    tensors are gone no longer matches."""

    def __init__(self, names, tensors, c1, cols, lanes, host):
        self.names = names
        self.refs = [weakref.ref(t) for t in tensors]
        self.ptrs = [t.data_ptr() for t in tensors[:4]]
        self.c1 = c1
        self.lanes = lanes
        by_name = dict(zip(names, tensors))
        rel = lanes.offsets(c1)[0]
        words = [len(cols)]
        for name in cols:
            v, m = by_name[f"v_{name}"], by_name[f"m_{name}"]
            words += [v.data_ptr(), v.element_size(), m.data_ptr()]
        words += [rel["slots"], rel["key0"]]
        for name in cols:
            words += [rel[f"v_{name}"], rel[f"m_{name}"]]
        dev = tensors[0].device
        self.desc = torch.tensor(words, dtype=torch.int64).to(dev)
        self.desc_ptr, self.words = self.desc.data_ptr(), len(words)
        ntiles = -(-c1 // _TILE)
        self.scratch = torch.zeros(ntiles + 3, dtype=torch.int64, device=dev)
        p = self.scratch.data_ptr()
        # status words, ticket, done count, total
        self.scratch_ptrs = (p, p + 8 * ntiles, p + 8 * ntiles + 8, p + 8 * ntiles + 16)
        self.host = host
        self.host_ptr = host.data_ptr()

    def matches(self, store: Dict[str, torch.Tensor]) -> bool:
        return all(store[k] is r() for k, r in zip(self.names, self.refs))


_FANOUT_PLANS: Dict[tuple, FanoutPlan] = {}
_FANOUT_PLAN_CACHE_SIZE = 64


def fanout_plan(store: Dict[str, torch.Tensor], capacity: int, cols: Sequence[str]) -> FanoutPlan:
    """K24's host side for a store and the columns it gathers, built and
    checked once per set of buffers and cached: a grow that replaces the
    store's tensors gets a new one."""
    key = (id(store), capacity, tuple(cols))
    plan = _FANOUT_PLANS.get(key)
    if plan is not None and plan.matches(store):
        return plan
    c1 = capacity + 1
    names = ["live", "fkvalid", "fkrepr", "key0"]
    for name, dt in zip(names, (torch.bool, torch.bool, torch.int64, torch.int64)):
        _expect(store[name], dt, (c1,))
    groups: Dict[torch.dtype, List[str]] = {torch.int64: ["key0"], torch.int32: ["slots"]}
    for name in cols:
        v, m = store[f"v_{name}"], store[f"m_{name}"]
        _expect(v, v.dtype, (c1,))
        _expect(m, torch.bool, (c1,))
        groups.setdefault(v.dtype, []).append(f"v_{name}")
        groups.setdefault(torch.bool, []).append(f"m_{name}")
        names += [f"v_{name}", f"m_{name}"]
    plan = FanoutPlan(names, [store[k] for k in names], c1, cols, Lanes(list(groups.items())),
                      torch.zeros(1, dtype=torch.int64, pin_memory=True))
    if key not in _FANOUT_PLANS and len(_FANOUT_PLANS) >= _FANOUT_PLAN_CACHE_SIZE:
        _FANOUT_PLANS.pop(next(iter(_FANOUT_PLANS)))
    _FANOUT_PLANS[key] = plan
    return plan


KERNEL_WRAPPERS = (fk_fanout,)
