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

The wrapper launches the CUDA kernel (``csrc/fk_fanout.cu``) for CUDA
tensors and counts it in ``fk_fanout.launches``; for CPU tensors it runs
the plain torch twin, :func:`fk_fanout_plain`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import _expect, _stream

#: the kernel's block size (csrc/fk_fanout.cu kThreads): one block count
#: per 256 slots
_THREADS = 256


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
    reprs.  Reads the match count back to the host between its two
    passes."""
    if not krepr.is_cuda:
        return fk_fanout_plain(store, capacity, krepr, touched, cols)
    c1 = capacity + 1
    for name, dt in (("live", torch.bool), ("fkvalid", torch.bool), ("fkrepr", torch.int64),
                     ("key0", torch.int64)):
        _expect(store[name], dt, (c1,))
    _expect(krepr, torch.int64, (krepr.shape[0],))
    _expect(touched, torch.bool, (touched.shape[0],))
    dev = krepr.device
    nb = -(-c1 // _THREADS)
    offsets = torch.empty(nb, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    live, fkvalid, fkrepr = store["live"], store["fkvalid"], store["fkrepr"]
    cuda.check("fk_fanout", cuda.lib("fk_fanout", "ksql_fk_fanout_count")(
        live.data_ptr(), fkvalid.data_ptr(), fkrepr.data_ptr(), c1, krepr.data_ptr(),
        touched.data_ptr(), offsets.data_ptr(), total.data_ptr(), _stream(dev),
    ))
    m = int(total)
    slots = torch.empty(m, dtype=torch.int32, device=dev)
    key = torch.empty(m, dtype=torch.int64, device=dev)
    lanes: Dict[str, torch.Tensor] = {}
    desc: List[int] = []
    for name in cols:
        v, mk = store[f"v_{name}"], store[f"m_{name}"]
        _expect(v, v.dtype, (c1,))
        _expect(mk, torch.bool, (c1,))
        vo = torch.empty(m, dtype=v.dtype, device=dev)
        mo = torch.empty(m, dtype=torch.bool, device=dev)
        lanes[f"v_{name}"], lanes[f"m_{name}"] = vo, mo
        desc += [v.data_ptr(), vo.data_ptr(), v.element_size(), mk.data_ptr(), mo.data_ptr()]
    if m:
        cuda.check("fk_fanout", cuda.lib("fk_fanout", "ksql_fk_fanout_write")(
            live.data_ptr(), fkvalid.data_ptr(), fkrepr.data_ptr(), store["key0"].data_ptr(), c1,
            krepr.data_ptr(), touched.data_ptr(), offsets.data_ptr(), cuda.host_i64(desc),
            len(cols), slots.data_ptr(), key.data_ptr(), _stream(dev),
        ))
    fk_fanout.launches += 1
    return slots, lanes, key


fk_fanout.launches = 0

KERNEL_WRAPPERS = (fk_fanout,)
