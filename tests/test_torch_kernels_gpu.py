"""The port's CUDA kernels against their plain torch twins, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
compiled with nvcc at first use); without one each test skips from its
fixture.  Run them on the card with

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

Ints, bools, hashes and slots must be equal; float64 sums agree to rtol
1e-12 (atomic fold order is not fixed).  The sliced stores come from
``chip_smoke.make_sliced_case``, the stream-stream join steps from
``chip_smoke.make_ss_case``, the session steps from
``chip_smoke.make_session_case`` (checked by phase 2w's own chain), the
EMIT FINAL and HAVING steps from ``chip_smoke.make_suppress_case``, the
table aggregation's undo side from ``chip_smoke.make_find_case`` and
``make_orders_case``, the table-table and foreign-key joins' from
``make_tt_case``, ``make_fkr_case`` and ``make_fanout_case``, the push
taps' from ``make_tap_case`` over ``tap_group``s of the committed tap
template and of ``corpus_plans``: the generators of the chip check's own
kernel phases.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from ksql_tpu_torch.execution import expressions as pex
from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import session as sess
from ksql_tpu_torch.ops import slicing
from ksql_tpu_torch.ops import ss_join as ssj
from ksql_tpu_torch.ops import suppress as sup
from torch_kernel_cases import (ARGSET_CASES, ARGSET_COMPONENTS, CLOCK_CASES, CLOSE_CASES, COLLECT_CASES,
                                EVICT_CASES, FOLD_CASES, FOLD_COMPONENTS, REMOVE_CASES, SLICED_SKEWS, TAP_EDGES,
                                TOPK_KINDS, WRITE_CASES, argset_case, clock_case, close_case, collect_case,
                                evict_case, fold_case, remove_case, sliced_skew, tap_edge_case, tap_edge_plans,
                                topk_case, write_case, write_torch)

pytestmark = pytest.mark.gpu
I64 = np.iinfo(np.int64)
HOUR = 3_600_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b, rtol=0.0):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        assert torch.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True).all()
    else:
        assert torch.equal(a, b)


def _prologue_inputs(dev, n, k, seed):
    rng = np.random.default_rng(seed)
    reprs = torch.from_numpy(rng.integers(I64.min, I64.max, (k, n), dtype=np.int64)).to(dev)
    valid = torch.from_numpy(rng.random((k, n)) > 0.05).to(dev)
    max_ts = 472_222 * HOUR
    ts = max_ts - rng.integers(-HOUR, 40 * HOUR, n)
    # windows that end exactly at max_ts - grace (dropped) and one ms later
    ts[:6] = max_ts - 25 * HOUR + np.array([0, HOUR - 1, HOUR, HOUR + 1, -1, -HOUR])
    ts[6:10] = -np.array([1, HOUR, HOUR + 1, 7])  # negative: floor, not truncate
    ts = torch.from_numpy(ts).to(dev)
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    max_ts = torch.tensor(max_ts, device=dev)
    return reprs, valid, ts, active, max_ts


@pytest.mark.parametrize("k,size", [(1, HOUR), (3, HOUR), (2, 0)])
def test_row_prologue_kernel_matches_twin(dev, k, size):
    reprs, valid, ts, active, max_ts = _prologue_inputs(dev, 5000, k, k)
    args = (reprs, valid, ts, active, size, 24 * HOUR, max_ts, 1 << 12)
    before = hs.row_prologue.launches
    mode_before = dict(hs.row_prologue.mode_launches)
    got = hs.row_prologue(*args)
    assert hs.row_prologue.launches == before + 1
    assert hs.row_prologue.mode_launches == {**mode_before, "tumbling": mode_before["tumbling"] + 1}
    for g, w in zip(got, hs.row_prologue_plain(*args)):
        _same(g, w)


def _store(dev, capacity, fill, graves, seed):
    rng = np.random.default_rng(seed)
    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", I64.min),
        hs.AggComponent("add", "int64", 0),
        hs.AggComponent("add", "float64", 0.0),
        hs.AggComponent("min", "float64", float("inf")),
    ), windowed=True)
    st = {k: v.numpy().copy() for k, v in hs.init_store(layout, "cpu").items()}
    kh = rng.integers(I64.min, I64.max, fill, dtype=np.int64)
    slots = hs.host_insert(st["occ"], st["khash"], st["wstart"], capacity, kh, np.zeros(fill, np.int64))
    st["key0"][slots] = kh
    st["occ"][slots[:graves]] = False
    st["grave"][slots[:graves]] = True
    return layout, {k: torch.from_numpy(v).to(dev) for k, v in st.items()}


# n = 1 and 1,024: a foreign-key join's per-record step and a batch beside it
@pytest.mark.parametrize("capacity,fill,graves,n", [(1 << 12, 1500, 200, 2048), (1 << 7, 60, 20, 512),
                                                    (1 << 12, 1500, 200, 1024), (1 << 10, 400, 50, 1)])
def test_probe_insert_and_fold_kernels_match_twins(dev, capacity, fill, graves, n):
    layout, st = _store(dev, capacity, fill, graves, seed=capacity)
    rng = np.random.default_rng(1)
    live = np.nonzero((st["occ"] | st["grave"]).cpu().numpy()[:-1])[0]
    khash = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    pick = live[rng.integers(0, live.size, n // 2)]
    khash[: n // 2] = st["khash"].cpu().numpy()[pick]
    khash = torch.from_numpy(khash[rng.integers(0, n, n)]).to(dev)  # duplicates
    wstart = torch.zeros(n, dtype=torch.int64, device=dev)
    reprs = khash.reshape(1, n).clone()
    knull = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    base = hs.slot_base(khash, wstart, capacity)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    scratch = hs.init_scratch(capacity, dev)
    slots = hs.probe_insert(sk, scratch, capacity, base, khash, wstart, reprs, knull, active)
    want = hs.probe_insert_plain(sp, capacity, base, khash, wstart, reprs, knull, active)
    _same(slots, want)
    for k in st:
        _same(sk[k], sp[k])
    assert (scratch["claim"] == hs.INT32_MAX).all()
    x = torch.from_numpy(rng.standard_normal(n)).to(dev)
    contribs = [
        torch.where(active, torch.arange(n, device=dev), torch.full((n,), I64.min, device=dev)),
        active.long(), torch.where(active, x, torch.zeros_like(x)),
        torch.where(active, x, torch.full_like(x, float("inf"))),
    ]
    sc = {k: v.clone() for k, v in sk.items()}
    win_k = hs.fold_and_mark(sk, scratch, layout, slots, contribs, active)
    win_p = hs.fold_and_mark_plain(sp, layout, slots, contribs, active)
    _same(win_k, win_p)
    for k in st:
        _same(sk[k], sp[k], rtol=1e-12)
    assert (scratch["first"] == hs.INT32_MAX).all()
    # K3's one cooperative launch, from 20 calls on a copy
    names = _records_per_call(lambda: hs.fold_and_mark(sc, scratch, layout, slots, contribs, active))
    assert len(names) == 1 and "fold_mark_kernel" in names[0], names


def test_evict_kernel_matches_twin(dev):
    layout, st = _store(dev, 1 << 12, 2000, 100, seed=5)
    occ = st["occ"].cpu().numpy()
    st["wstart"] = torch.from_numpy(np.where(occ, np.arange(occ.size) % 50 * HOUR, 0)).to(dev)
    st["max_ts"].fill_(40 * HOUR)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    mode_before = dict(hs.evict.mode_launches)
    hs.evict(sk, layout, 25 * HOUR)
    assert hs.evict.mode_launches == {**mode_before, "tumbling": mode_before["tumbling"] + 1}
    hs.evict_plain(sp, layout, 25 * HOUR)
    for k in st:
        _same(sk[k], sp[k])
    assert (st["occ"] & ~sk["occ"]).any()


def test_cuda_tensor_never_takes_the_twin(dev):
    # a CUDA tensor of the wrong dtype is refused, not routed to the twin
    reprs, valid, ts, active, max_ts = _prologue_inputs(dev, 64, 1, 0)
    with pytest.raises(ValueError):
        hs.row_prologue(reprs.to(torch.int32), valid, ts, active, HOUR, 0, max_ts, 64)


@pytest.mark.parametrize("mode", ["sliced", "expansion"])
@pytest.mark.parametrize("k", [1, 2])
def test_row_prologue_hopping_modes_match_twin(dev, mode, k):
    reprs, valid, ts, active, max_ts = _prologue_inputs(dev, 5000, k, 10 + k)
    hop = dict(advance_ms=15 * 60_000)
    if mode == "sliced":
        # a ring of 26 h: the horizon cut drops the oldest rows
        hop.update(slice_width=15 * 60_000, slice_ring=106)
    args = (reprs, valid, ts, active, HOUR, 24 * HOUR, max_ts, 1 << 12)
    before = hs.row_prologue.launches
    mode_before = dict(hs.row_prologue.mode_launches)
    got = hs.row_prologue(*args, **hop)
    assert hs.row_prologue.launches == before + 1
    assert hs.row_prologue.mode_launches == {**mode_before, mode: mode_before[mode] + 1}
    want = hs.row_prologue_plain(*args, **hop)
    for g, w in zip(got, want):
        _same(g, w)
    assert 0 < int(got[2].sum()) < got[2].numel()


def _sliced(dev, seed, capacity=1 << 10, ring=30, n=3000, **kw):
    layout, store, rows = chip_smoke.make_sliced_case(
        hs, np.random.default_rng(seed), capacity, ring, n, **kw)
    st = {k: torch.from_numpy(v).to(dev) for k, v in store.items()}
    r = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in rows.items() if k != "contribs"}
    r["contribs"] = [torch.from_numpy(c).to(dev) for c in rows["contribs"]]
    return layout, st, r


FLOAT_COMPONENTS = chip_smoke.HOP_COMPONENTS + (
    ("add", "float64", 0.0), ("min", "float64", float("inf")), ("max", "float64", float("-inf")),
)
SW = chip_smoke.SLICE_MS


@pytest.mark.parametrize("components", [chip_smoke.HOP_COMPONENTS, FLOAT_COMPONENTS])
def test_sliced_fold_kernel_matches_twin(dev, components):
    layout, st, r = _sliced(dev, 1, components=components, specials=len(components) > 8)
    ring = layout.components[0].width
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    scratch = slicing.init_slice_scratch(layout.capacity, ring, 4, dev)
    args = (layout, r["slots"], r["wstart"], r["contribs"], r["active"], SW)
    before = slicing.sliced_fold.launches
    slicing.sliced_fold(sk, scratch, *args)
    assert slicing.sliced_fold.launches == before + 1
    slicing.sliced_fold_plain(sp, *args)
    for k in st:
        _same(sk[k], sp[k], rtol=1e-12)
    assert (scratch["ring_last"] == -1).all()
    assert not torch.equal(sk["slice_id"], st["slice_id"])
    names = _records_per_call(lambda: slicing.sliced_fold(sp, scratch, *args))
    assert len(names) == 1 and "sliced_fold_kernel" in names[0], names


@pytest.mark.parametrize("kind", SLICED_SKEWS)
def test_sliced_fold_kernel_at_its_skews(dev, kind):
    # tolerance: float64 adds rtol 1e-12, every other cell by its bits;
    # ring_last clean after the call
    layout, store, rows = chip_smoke.make_sliced_case(hs, np.random.default_rng(7), 1 << 10, 30, 3000,
                                                      components=FLOAT_COMPONENTS, specials=True)
    ring = layout.components[0].width
    store, rows = sliced_skew(kind, store, rows, 1 << 10, ring, SW, seed=7)
    st = {k: torch.from_numpy(v).to(dev) for k, v in store.items()}
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    t = {k: torch.from_numpy(rows[k]).to(dev) for k in ("slots", "wstart", "active")}
    args = (layout, t["slots"], t["wstart"], [torch.from_numpy(c).to(dev) for c in rows["contribs"]],
            t["active"], SW)
    scratch = slicing.init_slice_scratch(layout.capacity, ring, 4, dev)
    slicing.sliced_fold(sk, scratch, *args)
    slicing.sliced_fold_plain(sp, *args)
    for k in st:
        _same(sk[k], sp[k], rtol=1e-12)
    assert (scratch["ring_last"] == -1).all()


@pytest.mark.parametrize("one_slot", [False, True])
def test_member_lanes_and_combine_kernels_match_twins(dev, one_slot):
    layout, st, r = _sliced(dev, 2, ring=12, components=FLOAT_COMPONENTS, specials=True,
                            one_slot=one_slot)
    ring = layout.components[0].width
    scratch = slicing.init_slice_scratch(layout.capacity, ring, 4, dev)
    # a grace of 2 h closes the oldest windows at batch start
    lane_args = (r["slots"], r["active"], r["wstart"], r["max_ts"], layout.capacity,
                 SW, 4, SW, HOUR, 2 * HOUR, 4)
    got = slicing.member_lanes(*lane_args, scratch)
    want = slicing.member_lanes_plain(*lane_args)
    for g, w in zip(got, want):
        _same(g, w)
    assert (scratch["lanes"] == hs.INT32_MAX).all()
    w_lane, slot_lane, winner = want
    assert 0 < int(winner.sum()) < int((r["active"] & (r["slots"] != layout.capacity)).sum()) * 4
    mode_before = dict(slicing.combine_windows.mode_launches)
    got = slicing.combine_windows(st, layout, 1, slot_lane, w_lane, 4, SW)
    assert slicing.combine_windows.mode_launches == {**mode_before, "sliced": mode_before["sliced"] + 1}
    want = slicing.combine_windows_plain(st, layout, 1, slot_lane, w_lane, 4, SW)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], rtol=1e-12)


def test_combine_kernel_plain_gather_matches_twin(dev):
    layout, st = _store(dev, 1 << 12, 2000, 100, seed=7)
    slots = torch.from_numpy(np.random.default_rng(3).integers(0, (1 << 12) + 1, 9000)
                             .astype(np.int32)).to(dev)
    mode_before = dict(slicing.combine_windows.mode_launches)
    got = slicing.combine_windows(st, layout, 1, slots)
    assert slicing.combine_windows.mode_launches == {**mode_before, "gather": mode_before["gather"] + 1}
    want = slicing.combine_windows_plain(st, layout, 1, slots)
    for k in want:
        _same(got[k], want[k])


def test_evict_kernel_sliced_matches_twin(dev):
    layout, st, _r = _sliced(dev, 4)
    live = st["slast"][st["occ"]]
    st["max_ts"].fill_(int(live.median()) + 20 * SW)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    mode_before = dict(hs.evict.mode_launches)
    hs.evict(sk, layout, 20 * SW, sliced=True)
    assert hs.evict.mode_launches == {**mode_before, "sliced": mode_before["sliced"] + 1}
    hs.evict_plain(sp, layout, 20 * SW, sliced=True)
    for k in st:
        _same(sk[k], sp[k])
    assert (st["occ"] & ~sk["occ"]).any() and sk["occ"].any()


JOIN_COLS = (("A", "int64"), ("B", "int32"), ("C", "float64"), ("D", "bool"))


def _join_store(dev, capacity, n_users, seed):
    st = chip_smoke.make_join_case(torch, hs, np.random.default_rng(seed), capacity, n_users,
                                   cols=JOIN_COLS, grave_frac=0.1)
    return {k: torch.from_numpy(v).to(dev) for k, v in st.items()}


@pytest.mark.parametrize("capacity,n_users", [(1 << 12, 1500), (1 << 6, 40)])
def test_probe_find_kernel_matches_twin(dev, capacity, n_users):
    # the small table is 60% full with graves: long walks, some past 32 rounds
    st = _join_store(dev, capacity, n_users, capacity)
    rng = np.random.default_rng(2)
    n = 3000
    krepr = torch.from_numpy(rng.integers(0, 2 * n_users, n)).to(dev)
    kvalid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    cols = [c for c, _ in JOIN_COLS]
    before = hs.probe_find.launches
    lanes, key, found = hs.probe_find(st, capacity, krepr, kvalid, active, cols)
    assert hs.probe_find.launches == before + 1
    want_lanes, want_key, want_found = hs.probe_find_gather_plain(st, capacity, krepr, kvalid, active, cols)
    assert set(lanes) == set(want_lanes)
    for k in want_lanes:
        _same(lanes[k], want_lanes[k])
    _same(key, want_key)
    _same(found, want_found)
    assert 0 < int(found.sum()) < int((kvalid & active).sum())


def test_table_mode_and_upsert_kernels_match_twins(dev):
    capacity, n_users, n = 1 << 12, 1500, 2048
    st = _join_store(dev, capacity, n_users, 3)
    rng = np.random.default_rng(4)
    keys, kv, dels, act_np = chip_smoke.table_batch(rng, n, n_users, pad=40)
    reprs = torch.from_numpy(keys.reshape(1, n)).to(dev)
    kvalid = torch.from_numpy(kv.reshape(1, n)).to(dev)
    active = torch.from_numpy(act_np).to(dev)
    args = (reprs, kvalid, active, capacity)
    mode_before = dict(hs.row_prologue.mode_launches)
    got = hs.table_prologue(*args)
    assert hs.row_prologue.mode_launches == {**mode_before, "table": mode_before["table"] + 1}
    for g, w in zip(got, hs.table_prologue_plain(*args)):
        _same(g, w)
    act, khash, base = got
    scratch = hs.init_table_scratch(capacity, dev)
    zeros64 = torch.zeros(n, dtype=torch.int64, device=dev)
    zeros32 = torch.zeros(n, dtype=torch.int32, device=dev)
    slots = hs.probe_insert(st, scratch, capacity, base, khash, zeros64, reprs, zeros32, act)
    values = {c: (torch.from_numpy(chip_smoke._col_values(rng, d, n)).to(dev),
                  torch.from_numpy(rng.random(n) > 0.1).to(dev)) for c, d in JOIN_COLS}
    delete = torch.from_numpy(dels).to(dev)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    before = hs.table_upsert.launches
    hs.table_upsert(sk, scratch, capacity, slots, act, delete, values)
    assert hs.table_upsert.launches == before + 1
    hs.table_upsert_plain(sp, capacity, slots, act, delete, values)
    for k in st:
        _same(sk[k], sp[k])
    assert (scratch["last"] == -1).all() and (scratch["claim"] == hs.INT32_MAX).all()
    assert (sk["grave"] & ~st["grave"]).any() and not torch.equal(sk["v_A"], st["v_A"])


def _ss_case(dev, seed, ring=1 << 10, n=512):
    # 2,000 keys: about 240 matches a batch against the 1,024-entry ring
    case = chip_smoke.make_ss_case(np.random.default_rng(seed), ring, n, keys=2000)
    return chip_smoke.ss_case_tensors(torch, case, dev)


def _same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        _same(got, want)


@pytest.mark.parametrize("oc_rows", [8, 0])
def test_ss_match_kernel_matches_twin(dev, oc_rows):
    # tolerance: exact (every lane, the matched bits and the counts bit for
    # bit); oc_rows 0 gives 16 lanes, fewer than the matches: the cut
    case = _ss_case(dev, 5)
    n = case["rows"]["ts"].shape[0]
    oc = oc_rows * n or 16
    kc, pc = chip_smoke._clone_case(case), chip_smoke._clone_case(case)
    k_calls = chip_smoke._ss_calls(torch, kc, oc)
    p_calls = chip_smoke._ss_calls(torch, pc, oc, plain=True)
    modes = dict(ssj.ss_match.mode_launches)
    got = k_calls[0]()
    assert ssj.ss_match.mode_launches == {**modes, "count": modes["count"] + 1}
    want = p_calls[0]()
    _same_tree(got, want)
    assert 16 < int(want[3]) < 8 * n
    lanes = k_calls[1](got)
    assert ssj.ss_match.mode_launches["write"] == modes["write"] + 1
    _same_tree(lanes, p_calls[1](want))
    _same(kc["ring_r"]["matched"], pc["ring_r"]["matched"])


@pytest.mark.parametrize("deferred", [True, False])
def test_ss_insert_kernels_match_twins(dev, deferred):
    # tolerance: exact (pads, admissions, targets, the scalars, the whole
    # ring with its dump entry, the cursor and the clocks)
    case = _ss_case(dev, 6)
    kc, pc = chip_smoke._clone_case(case), chip_smoke._clone_case(case)
    r = case["rows"]
    count = ssj.ss_match_count_plain("l", r["krepr"], r["kvalid"], r["active"], r["ts"], case["ring_r"],
                                     10_000, 10_000)
    args = dict(pad_side=True, deferred=deferred, swin=10_000, grace=1_000 if deferred else 86_400_000,
                retention=21_000 if deferred else 86_420_000)
    modes = dict(ssj.ss_insert.mode_launches)
    pros = [fn(r["row_valid"], r["ts"], r["active"], count[1], c["ring_l"], c["max_ts"], c["smax_l"],
               c["cursor_l"], **args)
            for fn, c in ((ssj.ss_insert_prologue, kc), (ssj.ss_insert_prologue_plain, pc))]
    assert ssj.ss_insert.mode_launches == {**modes, "prologue": modes["prologue"] + 1}
    _same_tree(pros[0], pros[1])
    assert int(pros[1]["scal"][4]) >= 0  # some row is not admitted: the dump entry takes it
    for fn, c, pro in ((ssj.ss_insert, kc, pros[0]), (ssj.ss_insert_plain, pc, pros[1])):
        fn(c["ring_l"], c["cols_l"], pro, r["ts"], r["krepr"], r["kvalid"], count[1], c["row_cols"],
           c["max_ts"], c["smax_l"], c["cursor_l"])
    assert ssj.ss_insert.mode_launches["write"] == modes["write"] + 1
    for k in ("ring_l", "cols_l", "cursor_l", "max_ts", "smax_l"):
        _same_tree(kc[k], pc[k])


@pytest.mark.parametrize("deferred", [True, False])
def test_ss_expire_kernel_matches_twin(dev, deferred):
    # tolerance: exact (every lane and both rings' live and matched bits);
    # keys decode as int64, int32, float64 bits and bool
    case = _ss_case(dev, 7)
    outs, rings = [], []
    for fn in (ssj.ss_expire, ssj.ss_expire_plain):
        c = chip_smoke._clone_case(case)
        c["max_ts"].add_(20_000)  # past the close of the ring's newer entries
        before = ssj.ss_expire.launches
        outs.append(fn({"l": c["ring_l"], "r": c["ring_r"]}, {"l": c["cols_l"], "r": c["cols_r"]},
                       c["max_ts"], {"l": c["smax_l"], "r": c["smax_r"]},
                       [torch.int64, torch.int32, torch.float64, torch.bool], deferred=deferred,
                       pad_sides={"l", "r"}, after=10_000, before=10_000, grace=1_000,
                       retention=21_000))
        assert ssj.ss_expire.launches == before + (fn is ssj.ss_expire)
        rings.append((c["ring_l"], c["ring_r"]))
    _same_tree(outs[0], outs[1])
    _same_tree(rings[0], rings[1])
    assert bool(outs[1]["mask"].any()) == deferred


# ------------------------------------------------- session (K1, K13-K16)
def test_session_mode_kernel_matches_twin(dev):
    # tolerance: exact (the hash bits and the active mask)
    reprs, valid, _ts, active, _max_ts = _prologue_inputs(dev, 5000, 2, 9)
    modes = dict(hs.row_prologue.mode_launches)
    got = hs.session_prologue(reprs, valid, active)
    assert hs.row_prologue.mode_launches == {**modes, "session": modes["session"] + 1}
    _same_tree(got, hs.session_prologue_plain(reprs, valid, active))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2047, 2048, 2049, 4096, 8192, 8193, 70_000, 139_264,
                               270_336])
def test_seg_sort_kernel_matches_twin(dev, n):
    # tolerance: exact (the permutation; equal key pairs keep index order)
    rng = np.random.default_rng(n)
    k1 = torch.from_numpy(rng.choice(np.array([I64.min, -1, 0, 1, 1 << 62, I64.max]), n)).to(dev)
    k2 = torch.from_numpy(rng.integers(-3, 3, n)).to(dev)
    before = sess.seg_sort.launches
    got = sess.seg_sort(k1, k2)
    assert sess.seg_sort.launches == before + 1
    _same(got, sess.seg_sort_plain(k1, k2))


@pytest.mark.parametrize("n,slots", [(2048, 8), (1024, 2)])
def test_session_kernels_match_twins(dev, n, slots):
    # tolerance: exact (every item column, every segment value read through
    # segfirst, every emission lane, the whole store and its dump slot);
    # chip_smoke's phase 2w chain at a smaller store, on its own case
    with open("ksql_tpu_torch/plans/pv_sessions.json") as f:
        plan = json.load(f)
    case = chip_smoke.make_session_case(torch, plan, 3, dev, n=n, store=1 << 14, slots=slots, warm=4)
    before = {w.__name__: w.launches for w in sess.KERNEL_WRAPPERS}
    chip_smoke.phase_session_kernels(torch, plan, 3, case=case, timed=False)
    assert all(w.launches > before[w.__name__] for w in sess.KERNEL_WRAPPERS)


@pytest.mark.parametrize("ncomp,k", [(2, 1), (4, 2), (6, 3), (12, 8), (32, 16)])
def test_session_merge_kernel_matches_twin_at_each_width(dev, ncomp, k):
    # tolerance: exact (every sorted item column, and every segment value
    # read through segfirst; float64 sums add in item order on both sides).
    # K15's tile is the widest of 1,024, 512 and 256 sorted positions whose
    # shared memory fits a block: 1,024 up to 6 components, 512 at 12
    # components and 8 keys, 256 at 32 and 16; on long runs of few keys.
    rng = np.random.default_rng(100 * ncomp + k)
    n, slots, gap, cap = 512, 3, 1_000, 1 << 12
    m = n * (slots + 1)
    pool = np.array([-5, 3, 1 << 62, (1 << 62) + 7, I64.max - 1], dtype=np.int64)
    kh = pool[rng.integers(0, pool.size, m)]
    start = rng.integers(0, 2_000_000, m)
    specs = [("add", "int64", 0), ("min", "int32", 2**31 - 1), ("max", "float64", -np.inf),
             ("add", "float64", 0.0), ("min", "float64", np.inf), ("max", "int32", -(2**31))] * 6
    specs = specs[:ncomp]
    comps, cols = [], []
    for combine, dtype, init in specs:
        comps.append(hs.AggComponent(combine, dtype, init))
        if dtype == "float64":
            v = rng.normal(size=m) * 1e3
            v[rng.random(m) < 0.05] = np.nan
            v[rng.random(m) < 0.05] = -0.0
            v[rng.random(m) < 0.05] = 0.0
        else:
            v = rng.integers(-1000, 1000, m).astype(dtype)
        cols.append(torch.from_numpy(v).to(dev))
    items = {
        "kh": torch.from_numpy(kh).to(dev), "start": torch.from_numpy(start).to(dev),
        "end": torch.from_numpy(start + rng.integers(0, 2 * gap, m)).to(dev),
        "alive": torch.from_numpy(rng.random(m) < 0.8).to(dev),
        "slot": torch.from_numpy(rng.integers(0, cap + 1, m).astype(np.int32)).to(dev),
        "reprs": torch.from_numpy(rng.integers(-50, 50, (k, m))).to(dev), "comps": cols,
    }
    perm = sess.seg_sort_plain(items["kh"], items["start"])
    before = sess.session_merge.launches
    got = sess.session_merge(items, perm, n, slots, gap, comps, cap)
    assert sess.session_merge.launches == before + 1
    want = sess.session_merge_plain(items, perm, n, slots, gap, comps, cap)
    for key in sess.MERGE_ITEM_KEYS + ("sess_ovf",):
        _same_tree(got[key], want[key])
    sf = want["segfirst"].long()
    for key in sess.MERGE_SEG_KEYS:
        pick = (lambda xs: [x[sf] for x in xs]) if key == "seg_comps" else (lambda x: x[..., sf])
        _same_tree(pick(got[key]), pick(want[key]))
    assert int(want["sess_ovf"]) > 0


def _suppress_case(dev, n, cap, seed, advance=chip_smoke.FINAL_ADVANCE_MS):
    return chip_smoke.make_suppress_case(torch, np.random.default_rng(seed), dev, n, cap, advance)


# K17 scans tiles of 4,096 items: one row, partial tiles, a tile and one
# more, the flagship's shapes, phase 12h's (k = 4) and phase 12g's (2^20 rows)
@pytest.mark.parametrize("n,cap,advance", [
    (1, 1 << 10, chip_smoke.FINAL_ADVANCE_MS), (5000, 1 << 14, chip_smoke.FINAL_ADVANCE_MS),
    (4097, 1 << 14, chip_smoke.HOP_ADVANCE_MS), (1 << 16, 1 << 20, chip_smoke.FINAL_ADVANCE_MS),
    (1 << 14, 1 << 20, chip_smoke.HOP_ADVANCE_MS), (1 << 20, 1 << 20, chip_smoke.HOP_ADVANCE_MS)])
def test_suppress_clock_kernel_matches_twin(dev, n, cap, advance):
    c = _suppress_case(dev, n, cap, 3, advance)
    st = c["store"]
    for mode, ws, act in (("tumbling", c["tws"], c["act_rows"]), ("expansion", c["hws"], c["hact"])):
        args = (c["ts"], ws, act, c["row_valid"], st["max_ts"], st["emit_clock"], HOUR,
                chip_smoke.FINAL_GRACE_MS)
        before = dict(sup.suppress_clock.mode_launches)
        got = sup.suppress_clock(*args)
        assert sup.suppress_clock.mode_launches[mode] == before[mode] + 1
        _same_tree(list(got), list(sup.suppress_clock_plain(*args)))
        assert torch.equal(torch.sort(got[2]).values, got[2])


@pytest.mark.parametrize("n,cap", [(5000, 1 << 14), (1 << 16, 1 << 20), (1 << 20, 1 << 20)])
def test_suppress_close_kernel_matches_twin(dev, n, cap):
    c = _suppress_case(dev, n, cap, 4)
    st = c["store"]
    cm = sup.suppress_clock_plain(c["ts"], c["tws"], c["act_rows"], c["row_valid"], st["max_ts"],
                                  st["emit_clock"], HOUR, chip_smoke.FINAL_GRACE_MS)[2]
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    args = (c["layout"], c["slots"], c["act_rows"], cm, HOUR, chip_smoke.FINAL_GRACE_MS,
            chip_smoke.FINAL_RETENTION_MS)
    before = sup.suppress_close.launches
    got = sup.suppress_close(sk, *args)
    assert sup.suppress_close.launches == before + 1
    _same(got, sup.suppress_close_plain(sp, *args))
    _same_tree(sk, sp)
    assert bool(got.any()) and bool((st["occ"] & ~sk["occ"]).any())


@pytest.mark.parametrize("tomb", [False, True])
def test_having_verdict_kernel_matches_twin(dev, tomb):
    c = _suppress_case(dev, 1 << 16, 1 << 20, 5)
    t = torch.from_numpy(np.random.default_rng(7).random(1 << 16) < 0.1).to(dev) if tomb else None
    hk, hp = c["hpass"].clone(), c["hpass"].clone()
    args = (c["hslots"], c["hmask"], c["hdata"], c["hvalid"], t)
    before = sup.having_verdict.launches
    got = sup.having_verdict(hk, *args)
    assert sup.having_verdict.launches == before + 1
    _same_tree(list(got), list(sup.having_verdict_plain(hp, *args)))
    _same(hk, hp)


@pytest.mark.parametrize("suppress", [True, False])
def test_evict_kernel_suppress_and_hpass_match_twin(dev, suppress):
    c = _suppress_case(dev, 1 << 16, 1 << 20, 6)
    e0 = {k: v.clone() for k, v in c["store"].items()}
    e0["max_ts"].fill_(int(c["ts"].max()) + 4 * HOUR)
    if not suppress:  # a HAVING store: hpass, no born or emitted
        del e0["born"], e0["emitted"]
        e0["hpass"] = c["hpass"].clone()
    ek = {k: v.clone() for k, v in e0.items()}
    ep = {k: v.clone() for k, v in e0.items()}
    mode = "suppress" if suppress else "tumbling"
    before = hs.evict.mode_launches[mode]
    hs.evict(ek, c["layout"], chip_smoke.FINAL_RETENTION_MS, suppress=suppress)
    assert hs.evict.mode_launches[mode] == before + 1
    hs.evict_plain(ep, c["layout"], chip_smoke.FINAL_RETENTION_MS, suppress=suppress)
    _same_tree(ek, ep)
    assert bool((e0["occ"] & ~ek["occ"]).any())


@pytest.mark.parametrize("advance", [0, 20 * 60_000])
def test_row_prologue_without_grace_cut_matches_twin(dev, advance):
    reprs, valid, ts, active, _max_ts = _prologue_inputs(dev, 5000, 2, 9)
    args = (reprs, valid, ts, active, HOUR, 0, None, 1 << 12)
    _same_tree(list(hs.row_prologue(*args, advance_ms=advance)),
               list(hs.row_prologue_plain(*args, advance_ms=advance)))


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


#: K20's CUDA functions a call launches, by mode, in order (K13's sorts between them)
_COLLECT_FUNCS = {
    "append": ["collect_keys_kernel", "collect_place_kernel"],
    "ring": ["collect_keys_kernel", "collect_place_kernel"],
    "set": ["collect_keys_kernel", "collect_member_kernel", "collect_place_kernel"],
    "hist": ["collect_keys_kernel", "collect_member_kernel", "collect_place_kernel"],
}


def _collect_launches(fn):
    """K20's CUDA functions one call of ``fn`` launches, in order, from a
    20-call trace (``_records_per_call``)."""
    names = _records_per_call(fn)
    return [f for x in names for f in ("collect_keys_kernel", "collect_member_kernel", "collect_place_kernel")
            if f in x]


@pytest.mark.parametrize("seed", [0, 1])
def test_vector_kernels_match_twins(dev, seed):
    # K20 (append, set, ring), K21 (plain, distinct) and K6's wide gather on
    # phase 2v's pv_vectors case, K20 hist and K22 on its histogram case;
    # exact, the dump row included
    from ksql_tpu_torch.ops import vector as vec

    rng = np.random.default_rng(seed)
    c = chip_smoke.make_vector_case(torch, rng, dev, n=2048, capacity=1 << 13)
    layout, store, slots, contribs = c["layout"], c["store"], c["slots"], c["contribs"]
    j = 1
    while j < len(layout.components):
        comp = layout.components[j]
        size = 3 if comp.combine == "vec_count" else 1
        keys = [f"a{j + t}" for t in range(size)]
        got = {k: store[k].clone() for k in keys}
        want = {k: store[k].clone() for k in keys}
        if size == 3:
            mode = layout.components[j + 1].mode
            before = vec.vec_collect.mode_launches[mode]
            vec.vec_collect(got, layout, j, contribs, slots, mode)
            assert vec.vec_collect.mode_launches[mode] == before + 1
            vec.vec_collect_plain(want, layout, j, contribs, slots, mode)
            sc = {k: store[k].clone() for k in keys}
            assert _collect_launches(lambda: vec.vec_collect(sc, layout, j, contribs, slots, mode)) == \
                _COLLECT_FUNCS[mode]
        elif comp.combine == "topk":
            vec.vec_topk(got, layout, j, contribs[j], slots)
            vec.vec_topk_plain(want, layout, j, contribs[j], slots)
        for k in keys:
            _same(_bits(got[k]), _bits(want[k]))
        j += size
    mask = torch.from_numpy(rng.random(slots.shape[0]) < 0.3).to(dev)
    got = slicing.combine_windows(store, layout, 1, slots, mask=mask)
    want = slicing.combine_windows_plain(store, layout, 1, slots, mask=mask)
    for k in want:
        g, w = got[k], want[k]
        if g.dim() == 2:
            g, w = g[mask], w[mask]
        _same(_bits(g), _bits(w))
    h = chip_smoke.make_hist_case(torch, rng, dev, n=2048, capacity=1 << 12)
    keys = [f"a{h['j'] + t}" for t in range(4)]
    got = {k: h["store"][k].clone() for k in keys}
    want = {k: h["store"][k].clone() for k in keys}
    vec.fold_vectors(got, h["layout"], h["slots"], h["contribs"])
    vec.vec_collect_plain(want, h["layout"], h["j"], h["contribs"], h["slots"], "hist")
    vec.vec_hist_plain(want, h["layout"], h["j"], h["contribs"], h["slots"])
    for k in keys:
        _same(got[k], want[k])


def test_vector_topk_over_doubles_matches_twin(dev):
    chip_smoke._check_topk_doubles(torch, np.random.default_rng(4), dev, capacity=1 << 9, n=4096)


def test_probe_find_find_mode_matches_twin(dev):
    # K8's find mode on phase 2t's store shape at 2^14 slots: graves, misses
    rng = np.random.default_rng(5)
    cap = 1 << 14
    store, kh, base, active, _st = chip_smoke.make_find_case(torch, hs, rng, dev, n=20_000,
                                                             capacity=cap)
    before = hs.probe_find.mode_launches["find"]
    got = hs.probe_find_slots(store, cap, kh, base, active)
    assert hs.probe_find.mode_launches["find"] == before + 1
    _same(got, hs.probe_find_plain(store, cap, kh, torch.zeros_like(kh), active))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_agg_undo_kernels_match_twins(dev, seed):
    # the undo side's vector folds on phase 2t's customer_orders case: K23
    # then K20 append on COLLECT_LIST(ID), K20 hist and K22 with negative
    # heads on HISTOGRAM(STATUS); exact, the dump row included
    from ksql_tpu_torch.ops import vector as vec

    rng = np.random.default_rng(seed)
    c = chip_smoke.make_orders_case(torch, rng, dev, n=2048, capacity=1 << 12)
    layout, store, slots, contribs = c["layout"], c["store"], c["slots"], c["contribs"]
    keys = [f"a{j}" for j in range(3, 10)]
    got = {k: store[k].clone() for k in keys}
    want = {k: store[k].clone() for k in keys}
    before = vec.vec_remove.launches
    vec.fold_vectors(got, layout, slots, contribs, vec_undo=True)
    assert vec.vec_remove.launches == before + 1
    vec.vec_remove_plain(want, layout, 3, contribs, slots)
    vec.vec_collect_plain(want, layout, 3, contribs, slots, "append")
    vec.vec_collect_plain(want, layout, 6, contribs, slots, "hist")
    vec.vec_hist_plain(want, layout, 6, contribs, slots)
    for k in keys:
        _same(got[k], want[k])
    assert bool((want["a3"] < store["a3"]).any())  # entries were removed
    # one launch a call, no K13 sort: a 20-call trace on a copy
    sc = {k: store[k].clone() for k in keys}
    names = _records_per_call(lambda: vec.vec_remove(sc, layout, 3, contribs, slots))
    assert len(names) == 1 and "remove_kernel" in names[0], names


@pytest.mark.parametrize("case", REMOVE_CASES)
def test_vec_remove_at_its_skews(dev, case):
    # tolerance: exact (bits; count, data and null bits, the dump row
    # included); one remove_kernel record a call, the ticket scratch clean
    from ksql_tpu_torch.ops import vector as vec

    comps, state, contribs, slots = remove_case(case)
    capacity = state["a1"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c, d, i, width=w, mode=m)
                                               for c, d, i, w, m in comps))
    st = {k: torch.from_numpy(v.copy()).to(dev) for k, v in state.items()}
    got, want, sc = ({k: v.clone() for k, v in st.items()} for _ in range(3))
    cs = [None if c is None else torch.from_numpy(c).to(dev) for c in contribs]
    s = torch.from_numpy(slots).to(dev)
    vec.vec_remove(got, layout, 1, cs, s)
    vec.vec_remove_plain(want, layout, 1, cs, s)
    for k in st:
        _same(_bits(got[k]), _bits(want[k]))
    counts, ctrl = vec._remove_scratch(s.device, capacity + 1)
    assert not counts.any() and not ctrl.any()
    names = _records_per_call(lambda: vec.vec_remove(sc, layout, 1, cs, s))
    assert len(names) == 1 and "remove_kernel" in names[0], names


def test_vec_remove_over_doubles_matches_twin(dev):
    chip_smoke.check_remove_doubles(torch, np.random.default_rng(6), dev, capacity=1 << 8, n=2048)


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_gather_and_upsert_side_match_twins(dev, seed):
    # K8's gather mode and K9's side mode on phase 2x's user_accounts case
    # at 2^14 slots: the dump slot (padding rows), a hot key, deletes; the
    # dump row and the last-writer cells after the call
    rng = np.random.default_rng(seed + 20)
    cap = 1 << 14
    c = chip_smoke.make_tt_case(torch, rng, dev, n=4096, capacity=cap, users=6000, accounts=5400)
    st, slots = c["store"], c["slots"]
    rcols = [col.name for col in c["query"].tt_cols["r"]]
    before = dict(hs.probe_find.mode_launches)
    lanes, o_live = hs.probe_gather(st, cap, slots, st["r_live"], rcols, "r_")
    assert hs.probe_find.mode_launches["gather"] == before["gather"] + 1
    want, want_live = hs.probe_gather_plain(st, cap, slots, st["r_live"], rcols, "r_")
    _same(o_live, want_live)
    for k in want:
        _same(lanes[k], want[k])
    assert bool((slots == cap).any()) and bool(o_live.any())
    keys = ["l_live"] + [k for k in st if k.startswith("l_v_") or k.startswith("l_m_")]
    saved = {k: st[k].clone() for k in keys}
    args = (cap, slots, c["touched"], c["delete"], c["act"], chip_smoke.tt_side_cols(c))
    before = hs.table_upsert.mode_launches["side"]
    hs.upsert_side(st["l_live"], c["scratch"], *args)
    assert hs.table_upsert.mode_launches["side"] == before + 1
    got = {k: st[k].clone() for k in keys}
    for k in keys:
        st[k].copy_(saved[k])
    hs.upsert_side_plain(st["l_live"], *args)
    for k in keys:
        _same(got[k], st[k])
    assert bool((c["scratch"]["last"] == -1).all())
    assert not bool(got["l_live"][cap])


def test_probe_find_live_mode_matches_twin(dev):
    # K8's join mode with a liveness column: deleted keys found, not live
    rng = np.random.default_rng(22)
    cap = 1 << 14
    c = chip_smoke.make_fkr_case(torch, rng, dev, n=20_000, capacity=cap, users=6000)
    st, fk, valid = c["store"], c["fk"], c["valid"]
    cols = [col.name for col in c["query"].fk_cols["r"]]
    before = hs.probe_find.mode_launches["live"]
    got = hs.probe_find(st, cap, fk, valid, valid, cols, live=st["live"])
    assert hs.probe_find.mode_launches["live"] == before + 1
    want = hs.probe_find_gather_plain(st, cap, fk, valid, valid, cols, live=st["live"])
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)
    for k in want[0]:
        _same(got[0][k], want[0][k])
    plain_found = hs.probe_find_gather_plain(st, cap, fk, valid, valid, cols)[2]
    assert bool((plain_found & ~want[2]).any())  # some found keys are not live


@pytest.mark.parametrize("case", ["hot", "none", "untouched", "small"])
def test_fk_fanout_matches_twin_in_slot_order(dev, case):
    # K24 on phase 2x's orders store (zipf customers, deletes, null
    # customers, a dump row holding the hottest customer, never live)
    from ksql_tpu_torch.ops import table_join as tj

    rng = np.random.default_rng(23)
    cap, orders = (1 << 10, 500) if case == "small" else (1 << 16, 30_000)
    c = chip_smoke.make_fanout_case(torch, rng, dev, capacity=cap, orders=orders)
    st = c["store"]
    cols = [col.name for col in c["query"].fk_cols["l"]]
    cust = chip_smoke.ORDER_CUSTOMERS + 3 if case == "none" else c["hot"]
    krepr = torch.tensor([cust, 0], dtype=torch.int64, device=dev)
    touched = torch.tensor([case != "untouched", True], device=dev)
    before = tj.fk_fanout.launches
    got = tj.fk_fanout(st, cap, krepr, touched, cols)
    assert tj.fk_fanout.launches == before + 1
    want = tj.fk_fanout_plain(st, cap, krepr, touched, cols)
    _same(got[0], want[0])
    _same(got[2], want[2])
    for k in want[1]:
        _same(got[1][k], want[1][k])
    assert (want[0].numel() > 0) == (case in ("hot", "small"))
    assert bool((want[0][1:] > want[0][:-1]).all()) and cap not in want[0].tolist()


#: K24's tile edges: (capacity, the slots that match; None: the hottest
#: customer's orders of phase 2x's store), the store C + 1 slots long, never
#: a multiple of the kernel's 1,024-slot tile
FANOUT_EDGES = {
    "zero": (1 << 12, ()),
    "one_last": (1 << 12, ((1 << 12) - 1,)),
    "tile_boundary": (1 << 12, (0, 1023, 1024, 2047, 2048, 3071, 3072, 4095)),
    "all": (1 << 12, "all"),
    "phase_2t": (1 << 18, None),
}


@pytest.mark.parametrize("case", list(FANOUT_EDGES))
def test_fk_fanout_is_one_launch_at_tile_edges(dev, case):
    # K24's single pass: one kernel record a call, exact against the twin,
    # its scratch clean after every call (called twice)
    from ksql_tpu_torch.ops import table_join as tj
    from ksql_tpu_torch.state import state_from_numpy

    cap, where = FANOUT_EDGES[case]
    c = chip_smoke.make_fanout_case(torch, np.random.default_rng(cap), dev, capacity=cap,
                                    orders=cap // 2)
    cust = c["hot"]
    if where is not None:
        st = c["st"]
        cust = chip_smoke.ORDER_CUSTOMERS + 7  # no stored order has it
        idx = np.arange(cap) if where == "all" else np.array(where, np.int64)
        st["fkrepr"][idx], st["fkvalid"][idx], st["live"][idx] = cust, True, True
        c["store"] = state_from_numpy(st, dev)
    st = c["store"]
    cols = [col.name for col in c["query"].fk_cols["l"]]
    krepr = torch.tensor([cust, 0], dtype=torch.int64, device=dev)
    touched = torch.tensor([True, True], device=dev)
    want = tj.fk_fanout_plain(st, cap, krepr, touched, cols)
    plan = tj.fanout_plan(st, cap, cols)
    for _ in range(2):
        before = tj.fk_fanout.launches
        got = tj.fk_fanout(st, cap, krepr, touched, cols)
        assert tj.fk_fanout.launches == before + 1
        _same(got[0], want[0])
        _same(got[2], want[2])
        for k in want[1]:
            _same(got[1][k], want[1][k])
        assert not bool(plan.scratch[:-1].any())  # the total aside
    m = want[0].numel()
    if where is None:
        assert m > 100
    else:
        assert m == (cap if where == "all" else len(where))
    kernels = _records_per_call(lambda: tj.fk_fanout(st, cap, krepr, touched, cols))
    assert len(kernels) == 1 and "fanout" in kernels[0]


@pytest.mark.parametrize("n", [1, 4096, 65_536])
def test_probe_find_live_pair_is_one_launch_and_matches_twin(dev, n):
    # K8's pair call: a left change's new and old foreign keys in one
    # launch, each set exact against the twin's single call
    rng = np.random.default_rng(n)
    cap = 1 << 18 if n == 65_536 else 1 << 14
    c = chip_smoke.make_fkr_case(torch, rng, dev, n=n, capacity=cap, users=min(6000, cap // 4))
    st = c["store"]
    cols = [col.name for col in c["query"].fk_cols["r"]]
    old = torch.roll(c["fk"], 1).contiguous()
    old_valid = torch.roll(c["valid"], 1).contiguous()
    sets = [(c["fk"], c["valid"], c["valid"]), (old, old_valid, old_valid)]
    before = dict(hs.probe_find.mode_launches)
    got = hs.probe_find_live_pair(st, cap, sets, cols, st["live"])
    assert hs.probe_find.mode_launches["live"] == before["live"] + 1
    want = hs.probe_find_live_pair_plain(st, cap, sets, cols, st["live"])
    for g, w in zip(got, want):
        _same(g[1], w[1])
        _same(g[2], w[2])
        for k in w[0]:
            _same(g[0][k], w[0][k])
    kernels = _records_per_call(lambda: hs.probe_find_live_pair(st, cap, sets, cols, st["live"]))
    assert len(kernels) == 1 and "probe_find" in kernels[0]


@pytest.mark.parametrize("lanes,rows", [(256, 4096), (3, 1000), (40, 257)])
def test_tap_residual_matches_twin(dev, lanes, rows):
    from ksql_tpu_torch.ops import tap_residual as tr

    group = chip_smoke.tap_group(torch, chip_smoke.mod_plans(lanes), lanes)
    args = chip_smoke.make_tap_case(torch, np.random.default_rng(lanes), dev, group, rows)
    prog = group.program()
    before = tr.lane_masks.launches
    got = tr.lane_masks(prog, *args)
    assert tr.lane_masks.launches == before + 1
    want = tr.lane_masks_plain(prog.spec, prog.col_types, *args)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert int(want[1].sum()) > 0


@pytest.mark.parametrize("name", sorted(chip_smoke._corpus_predicates(pex)))
def test_tap_residual_corpus_families_match_twin(dev, name):
    from ksql_tpu_torch.ops import tap_residual as tr

    group = chip_smoke.tap_group(torch, chip_smoke.corpus_plans(64)[name], 64)
    args = chip_smoke.make_tap_case(torch, np.random.default_rng(7), dev, group, 2000)
    prog = group.program()
    got = tr.lane_masks(prog, *args)
    want = tr.lane_masks_plain(prog.spec, prog.col_types, *args)
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("n,capacity", [(4096, 1 << 12), (512, 1 << 7)])
def test_fold_argset_kernel_matches_twin(dev, n, capacity):
    # tolerance: exact (every component's bits, the dump slot included)
    store, scratch, layout, slots, contribs = chip_smoke.make_argset_case(
        torch, hs, np.random.default_rng(n), dev, n=n, capacity=capacity)
    want = {k: v.clone() for k, v in store.items()}
    hs.fold_argset_plain(want, layout, slots, contribs)
    before = hs.fold_and_mark.mode_launches["argset"]
    hs.fold_argset(store, scratch, layout, slots, contribs)
    assert hs.fold_and_mark.mode_launches["argset"] == before + 1
    for k in store:
        a, b = store[k], want[k]
        _same(a.view(torch.int64) if a.dtype == torch.float64 else a,
              b.view(torch.int64) if b.dtype == torch.float64 else b)
    assert int((scratch["dump_row"] != -1).sum()) == 0 and int(scratch["ticket"][0]) == 0
    names = _records_per_call(lambda: hs.fold_argset(store, scratch, layout, slots, contribs))
    assert len(names) == 1 and "argset_kernel" in names[0], names


@pytest.mark.parametrize("ties", [False, True])
def test_session_merge_argset_kernel_matches_twin(dev, ties):
    # tolerance: exact (every sorted item column, and every segment value
    # read through segfirst; the payload sums start from +0 on both sides).
    # ``ties``: orders modulo 50, so tied winners' payloads are summed
    items, perm, comps = chip_smoke.make_merge_case(torch, sess, hs, np.random.default_rng(5), dev,
                                                    n=1024, slots=4, keys=300, ties=ties)
    chip_smoke.check_merge_argset(torch, sess, items, perm, comps, 1024, 4, 1 << 12, "K15 argset")


def _keys_at(rng, capacity, base, count):
    out = []
    while len(out) < count:
        kh = rng.integers(I64.min, I64.max, 1 << 14, dtype=np.int64)
        out.extend(kh[(hs.np_mix64(kh) & (capacity - 1)) == base].tolist())
    return np.array(out[:count], np.int64)


def _insert_case(dev, n, capacity, seed, cluster=False):
    """A store 30% full (5% graves) and ``n`` rows, half of them stored
    keys, with duplicates; ``cluster`` adds a run of 40 other keys from
    slot 100, four rows probing from its start and the last one too (they
    overflow after all 32 rounds) and the one before it from slot 109 (it
    wins slot 140 in round 31); no other row probes near the run."""
    layout, st = _store(dev, capacity, int(0.3 * capacity), int(0.015 * capacity), seed)
    rng = np.random.default_rng(seed)
    if cluster:
        cells = torch.arange(100, 141, device=dev)
        st["occ"][cells] = True
        st["grave"][cells] = False
        st["khash"][cells] = torch.from_numpy(rng.integers(I64.min, I64.max, 41, dtype=np.int64)).to(dev)
        st["occ"][140] = False
    live = np.nonzero((st["occ"] | st["grave"]).cpu().numpy()[:-1])[0]
    khash = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    pick = live[rng.integers(0, live.size, n // 2)]
    khash[: n // 2] = st["khash"].cpu().numpy()[pick]
    khash = khash[rng.integers(0, n, n)]
    if cluster:
        base = hs.np_mix64(khash) & (capacity - 1)
        near = (base >= 60) & (base <= 141)
        khash[near] = _keys_at(rng, capacity, 3000, int(near.sum()))
        khash[-6:] = np.concatenate([_keys_at(rng, capacity, 100, 4), _keys_at(rng, capacity, 109, 1),
                                     _keys_at(rng, capacity, 100, 1)])
    khash = torch.from_numpy(khash).to(dev)
    wstart = torch.zeros(n, dtype=torch.int64, device=dev)
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    active[-6:] = True
    args = (hs.slot_base(khash, wstart, capacity), khash, wstart, khash.reshape(1, n).clone(),
            (khash & 1).to(torch.int32), active)
    return st, args


# one block (n <= 4,096), the cooperative grid past it; 2^20 rows run more
# blocks than the card holds at once (grid stride); the cluster case needs
# all 32 rounds and overflows
@pytest.mark.parametrize("n,capacity,cluster", [(1, 1 << 10, False), (4096, 1 << 14, False),
                                                (4097, 1 << 14, False), (4096, 1 << 14, True),
                                                (4097, 1 << 14, True), (1 << 16, 1 << 18, False),
                                                (1 << 20, 1 << 22, False)])
def test_probe_insert_is_one_launch_and_matches_twin(dev, n, capacity, cluster):
    st, args = _insert_case(dev, n, capacity, seed=n, cluster=cluster)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    sc = {k: v.clone() for k, v in st.items()}
    scratch = hs.init_scratch(capacity, dev)
    got = hs.probe_insert(sk, scratch, capacity, *args)
    # the launches from 20 calls on another copy (each call launches the same)
    names = _records_per_call(lambda: hs.probe_insert(sc, scratch, capacity, *args))
    solo = hs.probe_sizes()[0]
    assert solo == 4096  # the shapes above straddle the one-block threshold
    assert len(names) == 1 and ("block_kernel" if n <= solo else "grid_kernel") in names[0]
    want = hs.probe_insert_plain(sp, capacity, *args)
    _same(got, want)
    for k in st:
        _same(sk[k], sp[k])
    assert (scratch["claim"] == hs.INT32_MAX).all()
    if cluster:
        assert int(sp["overflow"]) >= 5 and int(want[-2]) == 140


def test_probe_insert_refuses_a_grid_scratch_too_short(dev):
    """Past the one-block rows the entry refuses a scratch shorter than
    the grid needs (``ksql_probe_insert_sizes``) and launches nothing."""
    solo, fixed = hs.probe_sizes()
    n, capacity = solo + 1, 1 << 14
    st, args = _insert_case(dev, n, capacity, seed=5, cluster=False)
    scratch = hs.init_scratch(capacity, dev)
    cols, keys = hs._insert_columns(st, scratch, capacity, 1)
    occ, grave, kh, ws, knull_store, overflow, claim = cols
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    work = torch.empty(fixed + n - 1, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in args]
    entry = cuda.lib("probe_insert", "ksql_probe_insert")
    for buf, words in ((None, 0), (work, work.numel())):
        code = entry(occ, grave, kh, ws, keys, 1, knull_store, overflow, claim, capacity, *ptrs, n,
                     slots.data_ptr(), None if buf is None else buf.data_ptr(), words,
                     torch.cuda.current_stream(dev).cuda_stream)
        with pytest.raises(RuntimeError, match="probe_insert"):
            cuda.check("probe_insert", code)
    assert (scratch["claim"] == hs.INT32_MAX).all()


def _wide_store(dev, rng, cap):
    comps = (hs.AggComponent("vec_count", "int64", 0),
             hs.AggComponent("vec_data", "int64", 0, width=7, mode="append"),
             hs.AggComponent("vec_valid", "int8", 0, width=7),
             hs.AggComponent("vec_count", "int64", 0),
             hs.AggComponent("vec_data", "float64", 0.0, width=1000, mode="append"),
             hs.AggComponent("vec_valid", "int8", 0, width=1000),
             hs.AggComponent("topk", "int32", 0, width=3),
             hs.AggComponent("vec_valid", "int8", 0, width=13))
    layout = hs.StoreLayout(cap, 1, comps)
    st = hs.init_store(layout, dev)
    for t in st.values():
        if t.dim() >= 1 and t.dtype != torch.bool:
            t.copy_(torch.from_numpy(rng.integers(-100, 100, tuple(t.shape))).to(t.dtype))
    return layout, st


# rows of 56, 7, 8,000, 1,000, 12 and 13 bytes (source and destination
# alignments differ lane by lane); masks all false, all true, random, none
@pytest.mark.parametrize("nn,mask", [(1, "all"), (1, "none"), (4096, "none"), (4096, "all"),
                                     (4096, "rand"), (777, None)])
def test_combine_wide_matches_twin(dev, nn, mask):
    rng = np.random.default_rng(nn)
    cap = 1 << 12
    layout, st = _wide_store(dev, rng, cap)
    slots = torch.from_numpy(rng.integers(0, cap + 1, nn).astype(np.int32)).to(dev)
    m = None if mask is None else torch.from_numpy(
        {"all": np.ones(nn, bool), "none": np.zeros(nn, bool), "rand": rng.random(nn) < 0.2}[mask]).to(dev)
    before = slicing.combine_windows.mode_launches["wide"]
    got = slicing.combine_windows(st, layout, 1, slots, mask=m)
    assert slicing.combine_windows.mode_launches["wide"] == before + 1
    want = slicing.combine_windows_plain(st, layout, 1, slots, mask=m)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if g.dim() == 2 and m is not None:
            g, w = g[m], w[m]
        _same(_bits(g), _bits(w))


@pytest.mark.parametrize("num_keys", [1, 16])
def test_combine_plain_gather_types_match_twin(dev, num_keys):
    rng = np.random.default_rng(num_keys)
    cap = 1 << 12
    comps = (hs.AggComponent("add", "int64", 0), hs.AggComponent("max", "int32", -5),
             hs.AggComponent("min", "float64", float("inf")), hs.AggComponent("add", "int32", 0))
    layout = hs.StoreLayout(cap, num_keys, comps)
    st = hs.init_store(layout, dev)
    for t in st.values():
        if t.dim() >= 1 and t.dtype != torch.bool:
            t.copy_(torch.from_numpy(rng.integers(-1000, 1000, tuple(t.shape))).to(t.dtype))
    st["a2"][::3] = float("nan")
    st["a2"][1::7] = -0.0
    for nn in (1, 65_536):
        slots = torch.from_numpy(rng.integers(0, cap + 1, nn).astype(np.int32)).to(dev)
        got = slicing.combine_windows(st, layout, num_keys, slots)
        want = slicing.combine_windows_plain(st, layout, num_keys, slots)
        assert set(got) == set(want)
        for k in want:
            _same(_bits(got[k]), _bits(want[k]))
            assert got[k].data_ptr() not in {t.data_ptr() for t in st.values()}


def _upsert_case(dev, n, shape, seed):
    """A join store of 2^16 slots with every flag and column kind, and a
    batch of ``n`` changes at K9's launch shapes: random slots (a tenth of
    them the dump slot), every row on one slot, a deleting winner beside
    upserting losers, or every row upserting a slot of its own."""
    rng = np.random.default_rng(seed)
    cap = 1 << 16
    st = {"occ": rng.random(cap + 1) < 0.5, "grave": rng.random(cap + 1) < 0.1,
          "live": rng.random(cap + 1) < 0.5}
    for name, dt in JOIN_COLS:
        st[f"v_{name}"] = chip_smoke._col_values(rng, dt, cap + 1)
        st[f"m_{name}"] = rng.random(cap + 1) < 0.5
    slots = rng.integers(0, cap + 1, n).astype(np.int32)
    slots[rng.random(n) < 0.1] = cap
    active, delete = rng.random(n) < 0.9, rng.random(n) < 0.3
    if shape in ("one_slot", "delete_winner"):
        slots[:], active[:] = 9, True
    if shape == "delete_winner":
        delete[:] = False
        delete[-1] = True
    if shape == "all_upsert":
        slots = rng.permutation(cap)[:n].astype(np.int32)
        active[:], delete[:] = True, False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    batch = {name: (t(chip_smoke._col_values(rng, dt, n)), t(rng.random(n) < 0.8))
             for name, dt in JOIN_COLS}
    return cap, {k: t(v) for k, v in st.items()}, t(slots), t(active), t(delete), t(rng.random(n) < 0.7), batch


# one block (n <= 4,096), the cooperative grid past it and phase 2x's
# 65,536 changes; every shape in both modes, each one launch
@pytest.mark.parametrize("n", [1, 4096, 4097, 1 << 16])
@pytest.mark.parametrize("shape", ["random", "one_slot", "delete_winner", "all_upsert"])
def test_table_upsert_is_one_launch_and_matches_twin(dev, n, shape):
    # tolerance: exact (the whole store, its dump row, and the clean scratch)
    cap, st, slots, active, delete, act, batch = _upsert_case(dev, n, shape, seed=n)
    scratch = hs.init_table_scratch(cap, dev)
    kernel = "upsert_block_kernel" if n <= 4096 else "upsert_grid_kernel"
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    sc = {k: v.clone() for k, v in st.items()}
    hs.table_upsert(sk, scratch, cap, slots, active, delete, batch)
    names = _records_per_call(lambda: hs.table_upsert(sc, scratch, cap, slots, active, delete, batch))
    assert len(names) == 1 and kernel in names[0]
    hs.table_upsert_plain(sp, cap, slots, active, delete, batch)
    for k in st:
        _same(sk[k], sp[k])
    assert bool((scratch["last"] == -1).all())
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}

    def cols(s):
        return [(s[f"v_{c}"], s[f"m_{c}"], *batch[c], c != "D") for c, _ in JOIN_COLS]

    sc = {k: v.clone() for k, v in st.items()}
    hs.upsert_side(sk["live"], scratch, cap, slots, active, delete, act, cols(sk))
    names = _records_per_call(lambda: hs.upsert_side(sc["live"], scratch, cap, slots, active, delete, act,
                                                     cols(sc)))
    assert len(names) == 1 and kernel in names[0]
    hs.upsert_side_plain(sp["live"], cap, slots, active, delete, act, cols(sp))
    for k in st:
        _same(sk[k], sp[k])
    assert bool((scratch["last"] == -1).all())
    if shape == "delete_winner":
        assert not bool(sk["live"][9])


def _long_run_case(dev, rng, kh, start, gap, specs, k=1, alive=0.8):
    m = kh.size
    comps, cols = [], []
    for combine, dtype, init in specs:
        comps.append(hs.AggComponent(combine, dtype, init))
        if dtype == "float64":
            v = rng.normal(size=m) * 1e3
            v[rng.random(m) < 0.05] = np.nan
            v[rng.random(m) < 0.05] = -0.0
        else:
            v = rng.integers(-1000, 1000, m).astype(dtype)
        cols.append(torch.from_numpy(v).to(dev))
    items = {"kh": torch.from_numpy(kh).to(dev), "start": torch.from_numpy(start).to(dev),
             "end": torch.from_numpy(start + rng.integers(0, max(gap, 1), m)).to(dev),
             "alive": torch.from_numpy(rng.random(m) < alive).to(dev),
             "slot": torch.from_numpy(rng.integers(0, 4097, m).astype(np.int32)).to(dev),
             "reprs": torch.from_numpy(rng.integers(-50, 50, (k, m))).to(dev), "comps": cols}
    return items, comps


def _bits(x):
    """float64 tensors as their int64 bits (signed zeros and NaN payloads
    compared too), in nested lists."""
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    return x.view(torch.int64) if x.dtype == torch.float64 else x


_RUN_SPECS = [("add", "int64", 0), ("min", "int32", 2**31 - 1), ("max", "float64", -np.inf),
              ("add", "float64", 0.0)]
_ARGSET_SPECS = [("min", "int64", I64.max), ("argset", "float64", 0.0), ("argset", "int64", 0),
                 ("max", "int64", I64.min), ("argset", "int32", 0), ("argset", "float64", 0.0),
                 ("add", "int64", 0)]


# K15 takes a run 1,024 sorted positions at a time (512 or 256 for a query
# too wide for that tile): runs one short of, at and past a tile; a session
# spanning tiles; sessions opening at the tile edges; a float64 sum of
# 1e16, 1.0, -1e16 in item order; argset ties carried across an edge;
# winners past S in a long run
@pytest.mark.parametrize("case", ["run63", "run64", "run65", "run255", "run256", "run257",
                                  "run511", "run512", "run513", "run1023", "run1024", "run1025",
                                  "spans_tiles",
                                  "opens_at_tile_edges",
                                  "float_sum_in_item_order", "argset_ties", "winners_past_s"])
def test_session_merge_long_runs_are_two_launches_and_match_twin(dev, case):
    # tolerance: exact (every sorted item column, every segment value read
    # through segfirst, sess_ovf)
    rng = np.random.default_rng(len(case))
    gap, specs, S = 1000, _RUN_SPECS, 3
    if case.startswith("run"):
        n = int(case[3:])
        kh = np.concatenate([np.full(n, -5), np.full(3, 9), np.full(n + 1, 11)]).astype(np.int64)
        step = rng.integers(0, 600, kh.size)
    else:
        kh = np.concatenate([np.full(2 * 1024 + 5, 5), np.full(4, 6)]).astype(np.int64)
        step = rng.integers(0, 100, kh.size)
    if case == "spans_tiles":
        step[:] = 10
    if case == "opens_at_tile_edges":
        step[:] = 10
        step[[256, 512, 768, 1024, 2048]] = 5000
    if case == "winners_past_s":
        step[:] = 5000
    if case == "argset_ties":
        specs = _ARGSET_SPECS
        step[::97] = 5000
    start = np.cumsum(step).astype(np.int64)
    items, comps = _long_run_case(dev, rng, kh, start, gap, specs)
    if case == "float_sum_in_item_order":
        items["comps"][3] = torch.from_numpy(np.tile([1e16, 1.0, -1e16], kh.size)[:kh.size].copy()).to(dev)
        items["alive"][:] = True
    if case == "argset_ties":
        orders = torch.from_numpy(rng.integers(0, 7, kh.size)).to(dev)
        items["comps"][0], items["comps"][3] = orders, orders.clone()
    m = kh.size
    perm = torch.arange(m, dtype=torch.int32, device=dev)  # already in (kh, start) order
    got = sess.session_merge(items, perm, m // 2, S, gap, comps, 1 << 12)
    names = _records_per_call(lambda: sess.session_merge(items, perm, m // 2, S, gap, comps, 1 << 12))
    assert len(names) == 2 and "permute_kernel" in names[0] and "merge_kernel" in names[1]
    want = sess.session_merge_plain(items, perm, m // 2, S, gap, comps, 1 << 12)
    for key in sess.MERGE_ITEM_KEYS + ("sess_ovf",):
        _same_tree(_bits(got[key]), _bits(want[key]))
    sf = want["segfirst"].long()
    for key in sess.MERGE_SEG_KEYS:
        pick = (lambda xs: [x[sf] for x in xs]) if key == "seg_comps" else (lambda x: x[..., sf])
        _same_tree(_bits(pick(got[key])), _bits(pick(want[key])))
    if case == "opens_at_tile_edges":
        assert [int(want["rank"][p]) for p in (255, 256, 512, 768, 1024, 2048)] == [0, 1, 2, 3, 4, 5]
    if case == "winners_past_s":
        assert int(want["sess_ovf"]) > 1024


# ---- launch counts: every one-launch check reads a trace of 20 calls (a
# one-call trace can lose its records on the H100)
def _records_per_call(fn, reps=20, attempts=8, warm=3):
    """Names of the CUDA kernels one call of ``fn()`` launches, from a
    trace of ``reps`` calls fenced as chip_smoke's kernel_device_ms fences
    its traces (a ~50 ms spin before them, two ~2 ms spins and an event
    synchronized after): a single short call's trace can lose its one
    record (seen for K13's one-block launch), a long trace keeps them.
    The H100's profiler also drops single records of short kernels, most
    often the first after the long spin (traces of K3's, K15's and K20's
    checks came back with 18 or 19 of 20 calls' records, three traces
    running), so ``warm`` calls run after it and a ~1 ms marker spin before
    the counted calls, only the records between the marker and the
    closing fences count, and a short trace is taken again, at most
    ``attempts`` times in all, unless the marker and both closing fences
    are in it and its counted records are a whole number of calls'; ``fn``
    must give the same launches run again."""
    from torch.profiler import ProfilerActivity, profile

    cuda_events = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(chip_smoke._LEAD_CYCLES)
            for _ in range(warm):
                fn()
            torch.cuda._sleep(chip_smoke._FENCE_CYCLES // 2)
            for _ in range(reps):
                fn()
            for _ in range(chip_smoke._FENCES):
                torch.cuda._sleep(chip_smoke._FENCE_CYCLES)
            fence = torch.cuda.Event()
            fence.record()
            fence.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == cuda_events
                         and "emcpy" not in e.name and "emset" not in e.name),
                        key=lambda e: e.time_range.start)
        spins = [e for e in events if "spin_kernel" in e.name]
        # the marker: the spin before the last two (the closing fences), not
        # the lead spin (~50 ms; it may be dropped): the marker is ~1 ms
        marker = spins[-3] if len(spins) >= 3 and spins[-3].time_range.elapsed_us() < 10_000 else None
        body = [e for e in events if "spin_kernel" not in e.name
                and (marker is None or e.time_range.start > marker.time_range.start)]
        last = max((e.time_range.start for e in body), default=-1)
        closing = sum(e.time_range.start > last for e in spins)
        if body and marker is not None and closing == chip_smoke._FENCES and len(body) % reps == 0:
            return [e.name for e in body[:len(body) // reps]]
    seen = {}
    for e in body:
        seen[e.name[:60]] = seen.get(e.name[:60], 0) + 1
    raise AssertionError(f"{attempts} traces of {reps} calls came back short (the last: {len(body)} "
                         f"records, {closing} closing fences, spins of "
                         f"{[round(e.time_range.elapsed_us()) for e in spins]} us, {seen})")


#: K10's ring-tile edges (512-entry tiles; rings of B + 1 entries): the
#: ring, and which entries match row 0 (None: make_ss_case's own traffic)
SS_EDGES = {
    "zero": (1 << 12, ()),
    "one_at_tile_end": (1 << 12, (1023,)),
    "all": (1 << 12, "all"),
    "ring_4097": (1 << 12, None),
    "ring_65537": (1 << 16, None),
}


@pytest.mark.parametrize("case", list(SS_EDGES))
def test_ss_match_count_is_one_launch_at_tile_edges(dev, case):
    # tolerance: exact (the count's four outputs, every lane, the matched
    # bits); count mode is one kernel record a call and leaves its ticket 0
    B, where = SS_EDGES[case]
    c = chip_smoke.make_ss_case(np.random.default_rng(B), B, 512, keys=2000)
    if where is not None:
        ring, rows = c["ring_r"], c["rows"]
        ring["krepr"][:] = 10**12  # no row's key
        idx = np.arange(B) if where == "all" else np.array(where, np.int64)
        rows["active"][0] = rows["kvalid"][0] = True
        rows["krepr"][0] = 10**12 + 1  # row 0's key alone
        ring["krepr"][idx], ring["ts"][idx] = rows["krepr"][0], rows["ts"][0]
        ring["live"][idx] = ring["kval"][idx] = True
    case_t = chip_smoke.ss_case_tensors(torch, c, dev)
    n = case_t["rows"]["ts"].shape[0]
    oc = 8 * n
    kc, pc = chip_smoke._clone_case(case_t), chip_smoke._clone_case(case_t)
    k_calls = chip_smoke._ss_calls(torch, kc, oc)
    p_calls = chip_smoke._ss_calls(torch, pc, oc, plain=True)
    plan = ssj.ring_plan(kc["ring_r"])
    want = p_calls[0]()
    for _ in range(2):
        got = k_calls[0]()
        _same_tree(tuple(got), tuple(want))
        assert int(plan.ticket[0]) == 0 and not bool(plan.totals.any())
    if where is not None:
        assert int(want[3]) == (B if where == "all" else len(where))
    lanes = k_calls[1](got)
    _same_tree(lanes, p_calls[1](want))
    _same(kc["ring_r"]["matched"], pc["ring_r"]["matched"])
    kernels = _records_per_call(k_calls[0])
    assert len(kernels) == 1 and "tile_count_kernel" in kernels[0], kernels


@pytest.mark.parametrize("shape", ["equal", "k1_as_k2", "sentinels", "rows_8192"])
def test_seg_sort_is_one_launch_up_to_a_block(dev, shape):
    # tolerance: exact.  Up to 8,192 items K13 is one kernel record a
    # call; ties keep index order; int64 extremes and the session items'
    # 2^62 + index sentinels
    rng = np.random.default_rng(3)
    n = 8192 if shape in ("sentinels", "rows_8192") else 4096
    if shape == "equal":
        k1, k2 = np.full(n, 7, np.int64), np.full(n, -7, np.int64)
    elif shape == "k1_as_k2":
        k1 = k2 = rng.integers(0, 300, n)
    elif shape == "sentinels":
        k1 = (1 << 62) + np.arange(n, dtype=np.int64)
        live = rng.random(n) < 0.3
        k1[live] = rng.choice(np.array([I64.min, I64.max, (1 << 62) + 5, 42]), int(live.sum()))
        k2 = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    else:
        k1 = rng.integers(I64.min, I64.max, 1369, dtype=np.int64)[rng.zipf(1.3, n) % 1369]
        k1[rng.random(n) < 0.05] = 0
        k2 = np.zeros(n, np.int64)
    t1 = torch.from_numpy(k1).to(dev)
    t2 = t1 if k2 is k1 else torch.from_numpy(k2).to(dev)
    before = sess.seg_sort.launches
    got = sess.seg_sort(t1, t2)
    assert sess.seg_sort.launches == before + 1
    _same(got, sess.seg_sort_plain(t1, t2))
    kernels = _records_per_call(lambda: sess.seg_sort(t1, t2))
    assert len(kernels) == 1 and "block_sort_kernel" in kernels[0], kernels


# ---- K17 and K16's write mode at their tiles' edges (tests/torch_kernel_cases.py)
@pytest.mark.parametrize("case", list(CLOCK_CASES))
def test_suppress_clock_is_one_launch_at_tile_edges(dev, case):
    # tolerance: exact (the lanes' cut and contribution, the emission
    # clock); one clock_kernel record a call; called twice, so the second
    # call meets the first's look-back scratch
    n, k, kind = CLOCK_CASES[case]
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in clock_case(n, k, kind, seed=n + k)]
    want = sup.suppress_clock_plain(*args)
    mode = "expansion" if k > 1 else "tumbling"
    for _ in range(2):
        before = dict(sup.suppress_clock.mode_launches)
        got = sup.suppress_clock(*args)
        assert sup.suppress_clock.mode_launches[mode] == before[mode] + 1
        _same_tree(list(got), list(want))
    kernels = _records_per_call(lambda: sup.suppress_clock(*args))
    assert len(kernels) == 1 and "clock_kernel" in kernels[0], kernels


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_session_write_is_one_launch_at_block_edges(dev, case):
    # tolerance: exact (every lane, the whole store with its dump slot);
    # one write_kernel record a call, its done count back to 0 after it
    m, kind, sizes, k = WRITE_CASES[case]
    store, merged, ins, scal = write_case(m, kind, sizes, k, seed=m)
    cap = store["dirty"].shape[0] - 1
    sp, pm, pins, pscal = write_torch(store, merged, ins, scal)
    want = sess.session_write_plain(sp, cap, pm, pins, pscal)

    def on_card():
        s, mm, i, sc = write_torch(store, merged, ins, scal)
        cu = {key: ([x.to(dev) for x in v] if isinstance(v, list) else v.to(dev)) for key, v in mm.items()}
        return {key: v.to(dev) for key, v in s.items()}, cu, i.to(dev), sc.to(dev)

    for _ in range(2):
        sk, cm, cins, cscal = on_card()
        before = dict(sess.session_write.mode_launches)
        got = sess.session_write(sk, cap, cm, cins, cscal)
        assert sess.session_write.mode_launches["write"] == before["write"] + 1
        _same_tree({key: _bits(v) for key, v in got.items()}, {key: _bits(v) for key, v in want.items()})
        for key in sp:
            _same(_bits(sk[key]), _bits(sp[key]))
        assert int(sess.session_write.scratch[cins.device][0]) == 0
    kernels = _records_per_call(lambda: sess.session_write(sk, cap, cm, cins, cscal))
    assert len(kernels) == 1 and "write_kernel" in kernels[0], kernels


# ---- K3 and K20 at the skews their designs lean on (tests/torch_kernel_cases.py)
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_and_mark_is_one_launch_at_its_skews(dev, case):
    # tolerance: float64 sums rtol 1e-12 (a warp's rows are summed first,
    # then the warps in atomic order), every other column by its bits;
    # one fold_mark_kernel record a call, the first cells clean after it
    n, kind = FOLD_CASES[case]
    state, slots, active, contribs = fold_case(n, kind)
    capacity = state["dirty"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(*c) for c in FOLD_COMPONENTS))
    st = {k: torch.from_numpy(v.copy()).to(dev) for k, v in state.items()}
    sk, sp, sc = ({k: v.clone() for k, v in st.items()} for _ in range(3))
    s, a = torch.from_numpy(slots).to(dev), torch.from_numpy(active).to(dev)
    cs = [torch.from_numpy(c).to(dev) for c in contribs]
    scratch = hs.init_scratch(capacity, dev)
    _same(hs.fold_and_mark(sk, scratch, layout, s, cs, a), hs.fold_and_mark_plain(sp, layout, s, cs, a))
    for j, (combine, dtype, _init) in enumerate(FOLD_COMPONENTS):
        if combine == "add" and dtype == "float64":
            _same(sk[f"a{j}"], sp[f"a{j}"], rtol=1e-12)
        else:
            _same(_bits(sk[f"a{j}"]), _bits(sp[f"a{j}"]))
    _same(sk["dirty"], sp["dirty"])
    assert (scratch["first"] == hs.INT32_MAX).all()
    names = _records_per_call(lambda: hs.fold_and_mark(sc, scratch, layout, s, cs, a))
    assert len(names) == 1 and "fold_mark_kernel" in names[0], names


@pytest.mark.parametrize("case", list(ARGSET_CASES))
def test_fold_argset_is_one_launch_at_its_edges(dev, case):
    # tolerance: exact (bits, the dump slot included); one argset_kernel
    # record a call, the dump cells and the done count clean after it
    n, kind = ARGSET_CASES[case]
    state, slots, active, contribs = argset_case(n, kind)
    capacity = state["a0"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(*x) for x in ARGSET_COMPONENTS))
    st = {k: torch.from_numpy(v.copy()).to(dev) for k, v in state.items()}
    st["dirty"] = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    s, a = torch.from_numpy(slots).to(dev), torch.from_numpy(active).to(dev)
    cs = [torch.from_numpy(c).to(dev) for c in contribs]
    hs.fold_and_mark_plain(st, layout, s, cs, a)  # the orders settled
    got, want, sc = ({k: v.clone() for k, v in st.items()} for _ in range(3))
    scratch = hs.init_scratch(capacity, dev)
    for _ in range(2):  # the cells the first call used come back clean
        hs.fold_argset(got, scratch, layout, s, cs)
        hs.fold_argset_plain(want, layout, s, cs)
        for k in st:
            _same(_bits(got[k]), _bits(want[k]))
        assert int((scratch["dump_row"] != -1).sum()) == 0 and int(scratch["ticket"][0]) == 0
    names = _records_per_call(lambda: hs.fold_argset(sc, scratch, layout, s, cs))
    assert len(names) == 1 and "argset_kernel" in names[0], names


@pytest.mark.parametrize("case", list(COLLECT_CASES))
def test_vec_collect_set_and_hist_at_their_skews(dev, case):
    # tolerance: exact (the group's columns, the dump row included); the
    # keys, member and place launches a call, the scratch clean after it
    from ksql_tpu_torch.ops import vector as vec

    kind, mode, dtype = COLLECT_CASES[case]
    comps, state, contribs, slots = collect_case(kind, mode, dtype)
    capacity = state["a1"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c, d, i, width=w, mode=m)
                                               for c, d, i, w, m in comps))
    st = {k: torch.from_numpy(v.copy()).to(dev) for k, v in state.items()}
    got, want, sc = ({k: v.clone() for k, v in st.items()} for _ in range(3))
    s = torch.from_numpy(slots).to(dev)
    cs = [None if c is None else torch.from_numpy(c).to(dev) for c in contribs]
    for _ in range(2):
        vec.vec_collect(got, layout, 1, cs, s, mode)
        vec.vec_collect_plain(want, layout, 1, cs, s, mode)
        for k in st:
            _same(_bits(got[k]), _bits(want[k]))
        assert all(bool((t[:-2] == -1).all()) and not bool(t[-2:].any()) for t in vec._SCRATCH.values())
    assert _collect_launches(lambda: vec.vec_collect(sc, layout, 1, cs, s, mode)) == _COLLECT_FUNCS[mode]


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "int32", "int64", "float64"])
@pytest.mark.parametrize("kind", TOPK_KINDS)
def test_vec_topk_is_one_launch_at_its_skews(dev, kind, dtype, distinct):
    # tolerance: exact (bits, the dump row included); one topk_kernel
    # record a call (no K13 sort), the scratch clean after each call
    from ksql_tpu_torch.ops import vector as vec

    comps, state, vals, slots = topk_case(kind, dtype, distinct)
    capacity = state["a1"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c, d, i, width=w, mode=m)
                                               for c, d, i, w, m in comps))
    col = torch.from_numpy(state["a1"]).to(dev)
    v, s = torch.from_numpy(vals).to(dev), torch.from_numpy(slots).to(dev)
    got, want, sc = ({"a1": col.clone()} for _ in range(3))
    mode = "distinct" if distinct else "plain"
    for _ in range(2):
        before = vec.vec_topk.mode_launches[mode]
        vec.vec_topk(got, layout, 1, v, s)
        assert vec.vec_topk.mode_launches[mode] == before + 1
        vec.vec_topk_plain(want, layout, 1, v, s)
        _same(_bits(got["a1"]), _bits(want["a1"]))
        slot_buf, ctrl = vec._TOPK_SLOTS[(str(s.device), capacity + 1)]
        assert not slot_buf[:capacity + 1].any() and bool((slot_buf[capacity + 1:] == -1).all())
        assert not ctrl.any()
    names = _records_per_call(lambda: vec.vec_topk(sc, layout, 1, v, s))
    assert len(names) == 1 and "topk_kernel" in names[0], names


@pytest.mark.parametrize("case", list(EVICT_CASES))
def test_evict_is_one_launch_at_its_edges(dev, case):
    # tolerance: exact (bits, every column); one evict_kernel record a call
    comps, state, retention, sliced, suppress = evict_case(case)
    capacity = state["occ"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c, d, i, width=w) for c, d, i, w in comps),
                            windowed=True)
    st = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in state.items()}
    got, want, sc = ({k: v.clone() for k, v in st.items()} for _ in range(3))
    mode = "suppress" if suppress else "sliced" if sliced else "tumbling"
    before = hs.evict.mode_launches[mode]
    hs.evict(got, layout, retention, sliced=sliced, suppress=suppress)
    assert hs.evict.mode_launches[mode] == before + 1
    hs.evict_plain(want, layout, retention, sliced=sliced, suppress=suppress)
    for k in st:
        _same(_bits(got[k]), _bits(want[k]))
    names = _records_per_call(lambda: hs.evict(sc, layout, retention, sliced=sliced, suppress=suppress))
    kernel = "evict_rows_kernel" if sliced or max(c[3] for c in comps) > 1 else "evict_kernel"
    assert len(names) == 1 and kernel in names[0], names


# ---- K18 and K25 at their cases and edges (tests/torch_kernel_cases.py)
@pytest.mark.parametrize("case", list(CLOSE_CASES))
def test_suppress_close_is_one_launch_at_its_cases(dev, case):
    # tolerance: exact (every slot's flags, born and component bits, the
    # clocks, the emission mask); one close_slots_kernel record a call
    comps, st, slots, active, cm, size, grace, retention = close_case(case)
    capacity = st["occ"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c, d, i) for c, d, i in comps),
                            windowed=True)
    store = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in st.items()}
    got_st, want_st, sc = ({k: v.clone() for k, v in store.items()} for _ in range(3))
    args = (layout, torch.from_numpy(slots).to(dev), torch.from_numpy(active).to(dev),
            torch.from_numpy(cm).to(dev), size, grace, retention)
    before = sup.suppress_close.launches
    got = sup.suppress_close(got_st, *args)
    assert sup.suppress_close.launches == before + 1
    _same(got, sup.suppress_close_plain(want_st, *args))
    for k in store:
        _same(_bits(got_st[k]), _bits(want_st[k]))
    names = _records_per_call(lambda: sup.suppress_close(sc, *args))
    assert len(names) == 1 and "close_slots_kernel" in names[0], names


@pytest.mark.parametrize("edge", list(TAP_EDGES))
def test_tap_residual_is_one_launch_at_its_edges(dev, edge):
    # tolerance: exact (masks and counts); one tap_tile_kernel record a
    # call, the counts' scratch back to 0 after each call
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import tap_residual as tr

    plans = tap_edge_plans(edge)
    group = chip_smoke.tap_group(torch, plans, len(plans))
    columns, row_valid, limits, inactive = tap_edge_case(edge, stable_hash64, seed=len(edge))
    for k in inactive:
        group.remove(f"t{k}")
    names = group.rep.col_names
    P_i, P_f, active = group.device_params(dev)
    args = ([torch.from_numpy(columns[c][0]).to(dev) for c in names],
            [torch.from_numpy(columns[c][1]).to(dev) for c in names], P_i, P_f, active,
            torch.from_numpy(row_valid).to(dev), torch.from_numpy(limits).to(dev))
    prog = group.program()
    want = tr.lane_masks_plain(prog.spec, prog.col_types, *args)
    for _ in range(2):
        before = tr.lane_masks.launches
        got = tr.lane_masks(prog, *args)
        assert tr.lane_masks.launches == before + 1
        _same(got[0], want[0])
        _same(got[1], want[1])
        assert not any(sc.any() for sc in tr.lane_masks.scratch.values())
    kernels = _records_per_call(lambda: tr.lane_masks(prog, *args))
    assert len(kernels) == 1 and "tap_tile_kernel" in kernels[0], kernels
