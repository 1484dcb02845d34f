"""K6's host side (``ops/slicing.py``): the output packing and the cached
column descriptors, on CPU tensors.

``combine_windows`` puts every output of a call in one fresh byte buffer,
each a typed view at a 16-byte-aligned offset, and reads the store's
columns through a descriptor block built once per (layout, store
buffers).  The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``); these tests hold what surrounds it
against the plain twin's outputs: offsets, disjointness, dtypes and
shapes, no aliasing of the store, and a new descriptor once a grow
replaces the store.
"""

import json
import os

import numpy as np
import pytest
import torch

from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import slicing
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

CPU = torch.device("cpu")
PLANS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ksql_tpu_torch", "plans")
I64 = np.iinfo(np.int64)


def _case(kind, cap=64, seed=0):
    """(layout, store, num_keys, ring, twin kwargs) of a plain store with 1
    or 16 keys, a store of width-K vector columns, or a sliced store."""
    rng = np.random.default_rng(seed)
    ring, num_keys = 0, 1
    if kind.startswith("plain"):
        num_keys = int(kind[5:])
        comps = (hs.AggComponent("add", "int64", 0), hs.AggComponent("max", "int32", -5),
                 hs.AggComponent("min", "float64", float("inf")), hs.AggComponent("vec_count", "int64", 0))
    elif kind == "wide":
        comps = (hs.AggComponent("vec_count", "int64", 0),
                 hs.AggComponent("vec_data", "int64", 0, width=7, mode="append"),
                 hs.AggComponent("vec_valid", "int8", 0, width=7),
                 hs.AggComponent("topk", "int32", 0, width=3),
                 hs.AggComponent("vec_valid", "int8", 0, width=13))
    else:
        ring = 6
        comps = (hs.AggComponent("max", "int64", I64.min, width=ring),
                 hs.AggComponent("add", "float64", 0.0, width=ring),
                 hs.AggComponent("min", "int32", 2 ** 31 - 1, width=ring))
    layout = hs.StoreLayout(cap, num_keys, comps, windowed=bool(ring))
    st = hs.init_store(layout, CPU)
    if ring:
        st["slice_id"] = torch.from_numpy(rng.integers(0, 20, (cap + 1, ring)))
    for t in st.values():
        if t.dim() >= 1 and t.dtype != torch.bool:
            t.copy_(torch.from_numpy(rng.integers(-100, 100, tuple(t.shape))).to(t.dtype))
    nn = 37
    slots = torch.from_numpy(rng.integers(0, cap + 1, nn).astype(np.int32))
    kw = {}
    if ring:
        kw = dict(w_lane=torch.from_numpy(rng.integers(0, 20, nn)), spw=3, width=900)
    elif kind == "wide":
        kw = dict(mask=torch.from_numpy(rng.random(nn) < 0.5))
    return layout, st, num_keys, ring, slots, kw


KINDS = ["plain1", "plain16", "wide", "sliced"]


def _byte_range(t):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_are_aligned_disjoint_views_of_one_fresh_buffer(kind):
    layout, st, num_keys, ring, slots, kw = _case(kind)
    nn = slots.shape[0]
    plan = slicing.gather_plan(st, layout, num_keys, ring, CPU)
    buf, out = slicing.pack_outputs(plan, nn, CPU)
    offs, total = plan.offsets(nn)
    assert all(o % slicing.OUT_ALIGN == 0 for o in offs) and total % slicing.OUT_ALIGN == 0
    assert buf.numel() == total and buf.dtype == torch.uint8
    lo, hi = _byte_range(buf)
    ranges = []
    for (name, _dt, _w), off in zip(plan.specs, offs):
        t = out[name]
        assert t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr(), name
        a, b = _byte_range(t)
        assert a == lo + off and lo <= a <= b <= hi, name
        ranges.append((a, b, name))
    ranges.sort()
    for (a0, b0, n0), (a1, b1, n1) in zip(ranges, ranges[1:]):
        assert b0 <= a1, (n0, n1)
    stores = [_byte_range(t) for t in st.values() if t.dim() >= 1]
    for a, b, name in ranges:
        assert all(b <= s0 or a >= s1 for s0, s1 in stores), name
    want = slicing.combine_windows_plain(st, layout, num_keys, slots, **kw)
    assert set(out) == set(want)
    for name in want:
        assert out[name].dtype == want[name].dtype and out[name].shape == want[name].shape, name
        assert out[name].is_contiguous(), name


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_are_placed_by_the_blocks_lane_bytes_at_every_lane_count(kind):
    """The kernel's entry places the outputs from the block's bytes a lane
    and ``nn`` (each at the first multiple of 16 bytes past the one before,
    ``csrc/combine_windows.cu``); the views are placed the same way at
    every lane count, and the plan keeps nothing per lane count."""
    layout, st, num_keys, ring, _slots, _kw = _case(kind)
    plan = slicing.gather_plan(st, layout, num_keys, ring, CPU)
    before = dict(vars(plan))
    block = list(plan.block)
    lane_bytes = block[4: 4 + block[3]]
    for nn in list(range(0, 70)) + [255, 256, 257, 1000, 4096, 65_537]:
        want, at = [], 0
        for b in lane_bytes:
            want.append(at)
            at += (nn * b + 15) // 16 * 16
        offs, total = plan.offsets(nn)
        assert (offs, total) == (want, at), nn
        buf, out = slicing.pack_outputs(plan, nn, CPU)
        assert buf.numel() == total, nn
        base = buf.data_ptr()
        for (name, _dt, w), off in zip(plan.specs, offs):
            assert out[name].data_ptr() - base == off and out[name].shape[0] == nn, (nn, name)
            assert out[name].numel() * out[name].element_size() <= total - off, (nn, name)
    assert vars(plan) == before


@pytest.mark.parametrize("kind", KINDS)
def test_descriptor_block_holds_the_columns_the_kernel_reads(kind):
    layout, st, num_keys, ring, _slots, _kw = _case(kind)
    plan = slicing.gather_plan(st, layout, num_keys, ring, CPU)
    block = list(plan.block)
    ncols, nwide, slice_id, nout = block[:4]
    assert slice_id == (st["slice_id"].data_ptr() if ring else 0)
    assert nout == len(plan.specs) == ncols + nwide
    lane_bytes = block[4: 4 + nout]
    at = 4 + nout
    cols = [block[at + 4 * j: at + 4 + 4 * j] for j in range(ncols)]
    wide = [block[at + 4 * ncols + 3 * j: at + 3 + 4 * ncols + 3 * j] for j in range(nwide)]
    assert len(block) == at + 4 * ncols + 3 * nwide
    names = [name for name, _dt, _w in plan.specs]
    for name, b in zip(names, lane_bytes):
        assert b == st[name][0].numel() * st[name].element_size() // (ring if ring and name[0] == "a" else 1)
    for src, idx, kind_code, init in cols:
        name = names[idx]
        assert src == st[name].data_ptr(), name
        if name == "wstart" and ring:
            assert kind_code == slicing._K_WSTART
        elif name.startswith("a") and ring:
            comp = layout.components[int(name[1:])]
            assert kind_code == (slicing._K_REDUCE + hs._COMBINE_CODES[comp.combine] * 3
                                 + hs._DTYPE_CODES[comp.dtype])
            assert init == hs.init_bits(comp)
        else:
            size = st[name].element_size()
            assert kind_code == (slicing._K_GATHER4 if size == 4 else slicing._K_GATHER8), name
    for src, idx, row_bytes in wide:
        name = names[idx]
        assert src == st[name].data_ptr() and row_bytes == st[name][0].numel() * st[name].element_size()
    assert sorted([c[1] for c in cols] + [w[1] for w in wide]) == list(range(len(names)))
    assert plan.mode == ("sliced" if ring else "wide" if nwide else "gather")


def test_descriptor_is_cached_per_store_and_rebuilt_after_a_grow():
    with open(os.path.join(PLANS, "pv_counts_tumbling.json")) as f:
        q = TorchCompiledQuery(plan_from_json(json.load(f)), capacity=8, store_capacity=16, device="cpu")
    k = len(q.key_types)
    first = slicing.gather_plan(q.state, q.store_layout, k, 0, CPU)
    assert slicing.gather_plan(q.state, q.store_layout, k, 0, CPU) is first
    old = {name: t.data_ptr() for name, t in q.state.items() if isinstance(t, torch.Tensor)}
    q._grow()
    grown = slicing.gather_plan(q.state, q.store_layout, k, 0, CPU)
    assert grown is not first and grown.layout is q.store_layout
    block = list(grown.block)
    srcs = {block[4 + block[3] + 4 * j] for j in range(block[0])}
    for name, _dt, _w in grown.specs:
        assert q.state[name].data_ptr() in srcs and q.state[name].data_ptr() != old[name], name
    assert slicing.gather_plan(q.state, q.store_layout, k, 0, CPU) is grown


def test_a_store_column_of_the_wrong_type_is_refused_when_the_descriptor_is_built():
    layout, st, num_keys, ring, _slots, _kw = _case("plain1", seed=3)
    st["knull"] = st["knull"].to(torch.int64)
    with pytest.raises(ValueError, match="knull"):
        slicing.gather_plan(st, layout, num_keys, ring, CPU)
