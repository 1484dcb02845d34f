"""The vector folds of ``ksql_tpu_torch/ops/vector.py`` against the reference.

The reference's ``_vec_collect`` (each mode), ``_vec_hist``, ``_vec_topk``
(both modes), ``_slot_ranks`` and ``_batch_membership``
(``ksql_tpu/ops/hash_store.py``), run on the JAX CPU backend, and the
port's twins (what the wrappers run for CPU tensors) get the same store
state and contributions, made with numpy from a seed; the whole state must
come out bit-equal, the dump row included.  The cases pin the traps the
kernels must keep: XLA's last-row-wins duplicate scatter into the dump row,
the count's meaning per mode, histogram rows that find no entry, float
equality and XLA's sort order for -0.0/+0.0 and NaN, nulls, and the
decompositions' contributions and finalizers (``ops/device_aggs.py``)
against the reference's.  K6's wide gather and K4's reset of width-K
columns are held to their definitions.  Tolerance: none (ints, bools and
copied doubles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.common import types as RT
from ksql_tpu.compiler.jax_expr import DCol as RDCol
from ksql_tpu.ops import device_aggs as rda
from ksql_tpu.ops import hash_store as rhs
from ksql_tpu_torch.common import types as PT
from ksql_tpu_torch.compiler.torch_expr import DCol as PDCol
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.ops import device_aggs as pda
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import slicing
from ksql_tpu_torch.ops import vector
from tests.torch_kernel_cases import COLLECT_CASES, TOPK_KINDS, collect_case, topk_case

jax.config.update("jax_enable_x64", True)

#: doubles that exercise the traps: both zeros, NaN, the top-K floor
FVALS = np.array([-0.0, 0.0, np.nan, 1.5, -2.0, 7.25, -np.inf], dtype=np.float64)


def _vals(rng, dtype, n):
    if dtype == "float64":
        return FVALS[rng.integers(0, len(FVALS), n)].copy()
    return rng.integers(-3, 4, n).astype(dtype)


def _layouts(capacity, comps):
    """The same component list as a reference and a port layout."""
    ref = rhs.StoreLayout(capacity, 1, tuple(rhs.AggComponent(**c) for c in comps))
    port = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(**c) for c in comps))
    return ref, port


def _run_both(ref_fn, port_fn, state, contribs, slots):
    """``ref_fn(store, jnp contribs, jnp slots)`` mutates a dict of jnp
    arrays, ``port_fn`` a dict of torch tensors; both start from ``state``
    (numpy) and must end bit-equal."""
    ref = {k: jnp.asarray(v) for k, v in state.items()}
    ref_fn(ref, [None if c is None else jnp.asarray(c) for c in contribs], jnp.asarray(slots))
    port = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    port_fn(port, [None if c is None else torch.from_numpy(c.copy()) for c in contribs],
            torch.from_numpy(slots.copy()))
    for k in state:
        want, got = np.asarray(ref[k]), port[k].numpy()
        assert got.dtype == want.dtype, k
        if want.dtype == np.float64:
            want, got = want.view(np.int64), got.view(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=k)
    return port


def _collect_case(seed, mode, dtype, capacity=16, K=4, n=48, dump_cnt=0):
    """A collect (or histogram) group at component 1, its slots' counts
    below, at and past K, its rows aimed at real slots, the dump slot
    (overflow) and repeated values, nulls as (0, bit 0)."""
    rng = np.random.default_rng(seed)
    hist = mode == "hist"
    ddt = "int64" if hist else dtype
    comps = [dict(combine="max", dtype="int64", init=0),
             dict(combine="vec_count", dtype="int64", init=0, mode="hist" if hist else ""),
             dict(combine="vec_data", dtype=ddt, init=0, width=K, mode=mode),
             dict(combine="vec_valid", dtype="int8", init=0, width=K)]
    if hist:
        comps.append(dict(combine="hist_count", dtype="int64", init=0, width=K))
    c1 = capacity + 1
    state = {
        "a1": rng.integers(0, (K if hist else K + 3) + 1, c1).astype(np.int64),
        "a2": _vals(rng, ddt, c1 * K).reshape(c1, K),
        "a3": rng.integers(0, 2, (c1, K)).astype(np.int8),
    }
    state["a1"][capacity] = dump_cnt
    if hist:
        state["a4"] = rng.integers(0, 5, (c1, K)).astype(np.int64)
    slots = rng.choice(np.r_[np.arange(capacity), [capacity] * 3], n).astype(np.int32)
    head = rng.integers(-1 if hist else 0, 2, n).astype(np.int64)
    vbits = rng.integers(0, 2, n).astype(np.int8)
    vals = np.where(vbits != 0, _vals(rng, ddt, n), 0).astype(ddt)
    contribs = [None, head, vals, vbits] + ([head] if hist else [])
    return _layouts(capacity, comps), state, contribs, slots


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode,dtype", [
    ("append", "int64"), ("append", "float64"), ("append", "int32"), ("append", "int8"),
    ("set", "int64"), ("set", "float64"), ("set", "int8"),
    ("ring", "int64"), ("ring", "float64"),
])
def test_vec_collect_matches_reference(mode, dtype, seed):
    (rl, pl), state, contribs, slots = _collect_case(seed, mode, dtype, dump_cnt=seed)
    _run_both(lambda s, c, sl: rhs._vec_collect(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
              lambda s, c, sl: vector.vec_collect(s, pl, 1, c, sl, mode),
              state, contribs, slots)


@pytest.mark.parametrize("seed", range(4))
def test_vec_hist_matches_reference(seed):
    (rl, pl), state, contribs, slots = _collect_case(seed, "hist", "int64", dump_cnt=seed % 2)
    _run_both(lambda s, c, sl: rhs._vec_hist(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
              lambda s, c, sl: vector.fold_vectors(s, pl, sl, c),
              state, contribs, slots)


@pytest.mark.parametrize("case", list(COLLECT_CASES))
def test_set_and_hist_match_reference_at_the_kernels_skews(case):
    """K20's set and hist modes (``_vec_collect``, ``_vec_hist`` with
    ``_batch_membership``) where the kernel reads each slot's stored prefix
    once into a table (``COLLECT_CASES``): stored prefixes full at K,
    every row on one slot with repeated values, NULL bits and NaNs, one
    slot's run longer than a block; then the membership masks themselves
    against ``_batch_membership``.  Tolerance: none."""
    kind, mode, dtype = COLLECT_CASES[case]
    comps, state, contribs, slots = collect_case(kind, mode, dtype)
    capacity = state["a1"].shape[0] - 1
    rl, pl = _layouts(capacity, [dict(combine=c, dtype=d, init=i, width=w, mode=m)
                                 for c, d, i, w, m in comps])
    if mode == "hist":
        _run_both(lambda s, c, sl: rhs._vec_hist(s, rl, 1, c, sl, jnp.int32(capacity)),
                  lambda s, c, sl: vector.fold_vectors(s, pl, sl, c), state, contribs, slots)
    else:
        _run_both(lambda s, c, sl: rhs._vec_collect(s, rl, 1, c, sl, jnp.int32(capacity)),
                  lambda s, c, sl: vector.vec_collect(s, pl, 1, c, sl, mode), state, contribs, slots)
    K = comps[2][3]
    eff0 = np.where((contribs[1] > 0) & (slots != capacity), slots, capacity).astype(np.int32)
    want = rhs._batch_membership(*map(jnp.asarray, (state["a1"], state["a2"], state["a3"])), K,
                                 *map(jnp.asarray, (eff0, contribs[2], contribs[3])))
    got = vector.batch_membership_plain(*map(torch.from_numpy, (state["a1"], state["a2"], state["a3"])), K,
                                        *map(torch.from_numpy, (eff0, contribs[2], contribs[3])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[0]).any() and not np.asarray(want[0]).all()  # members and not


@pytest.mark.parametrize("seed", [*range(3), *TOPK_KINDS])
@pytest.mark.parametrize("dtype", ["int64", "float64", "int32", "int8"])
@pytest.mark.parametrize("distinct", [False, True])
def test_vec_topk_matches_reference(dtype, distinct, seed):
    # a seed: small random batches; a kind of TOPK_KINDS: the kernel's
    # skews (no row at the dump slot or the sentinel, every row there,
    # every row alone, a hot slot past K, runs of equal values (+-0.0 and
    # NaN for doubles), K = 1 and K = 256), one seed-made input each
    if isinstance(seed, str):
        comps, state, vals, slots = topk_case(seed, dtype, distinct, capacity=64, n=192)
        capacity = state["a1"].shape[0] - 1
        rl, pl = _layouts(capacity, [dict(combine=c, dtype=d, init=i, width=w, mode=m) for c, d, i, w, m in comps])
        _run_both(lambda s, c, sl: rhs._vec_topk(s, rl.components[1], 1, c[1], sl, jnp.int32(capacity)),
                  lambda s, c, sl: vector.vec_topk(s, pl, 1, c[1], sl),
                  state, [None, vals], slots)
        return
    rng = np.random.default_rng(seed)
    capacity, K, n = 16, 1 + seed, 48
    sent = float("-inf") if dtype == "float64" else int(np.iinfo(dtype).min)
    comps = [dict(combine="add", dtype="int32", init=0),
             dict(combine="topk", dtype=dtype, init=sent, width=K,
                  mode="distinct" if distinct else "")]
    rl, pl = _layouts(capacity, comps)
    state = {"a1": _vals(rng, dtype, (capacity + 1) * K).reshape(capacity + 1, K)}
    slots = rng.choice(np.r_[np.arange(capacity), [capacity] * 3], n).astype(np.int32)
    vals = np.where(rng.random(n) < 0.8, _vals(rng, dtype, n), sent).astype(dtype)
    _run_both(lambda s, c, sl: rhs._vec_topk(s, rl.components[1], 1, c[1], sl, jnp.int32(capacity)),
              lambda s, c, sl: vector.vec_topk(s, pl, 1, c[1], sl),
              state, [None, vals], slots)


@pytest.mark.parametrize("seed", range(3))
def test_slot_ranks_and_batch_membership_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, K, c1 = 64, 5, 9
    eff = rng.integers(0, c1, n).astype(np.int32)
    got = vector.slot_ranks_plain(torch.from_numpy(eff)).numpy()
    np.testing.assert_array_equal(got, np.asarray(rhs._slot_ranks(jnp.asarray(eff))))
    for dtype in ("int64", "float64"):
        cnt = rng.integers(0, K + 2, c1).astype(np.int64)
        data = _vals(rng, dtype, c1 * K).reshape(c1, K)
        vbit = rng.integers(0, 2, (c1, K)).astype(np.int8)
        vals = _vals(rng, dtype, n)
        vbits = rng.integers(0, 2, n).astype(np.int8)
        want = rhs._batch_membership(*map(jnp.asarray, (cnt, data, vbit)), K,
                                     *map(jnp.asarray, (eff, vals, vbits)))
        got = vector.batch_membership_plain(*map(torch.from_numpy, (cnt, data, vbit)), K,
                                            *map(torch.from_numpy, (eff, vals, vbits)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dump_row_keeps_the_last_row_aimed_at_each_cell():
    # every row of one slot beyond the cap, and overflowed rows, aim at the
    # dump row: the highest such row index decides each of its cells
    (rl, pl), state, _c, _s = _collect_case(0, "append", "int64", capacity=4, K=2)
    state["a1"][:] = 0
    n = 9
    slots = np.array([0, 0, 0, 4, 0, 4, 1, 0, 4], np.int32)
    head = np.ones(n, np.int64)
    vals = np.arange(10, 10 + n, dtype=np.int64)
    vbits = np.ones(n, np.int8)
    port = _run_both(lambda s, c, sl: rhs._vec_collect(s, rl, 1, c, sl, jnp.int32(4)),
                     lambda s, c, sl: vector.vec_collect(s, pl, 1, c, sl, "append"),
                     state, [None, head, vals, vbits], slots)
    # slot 0 takes rows 0, 1; rows 2, 4, 7 (past K) and the dump rows 3, 5,
    # 8 aim at dump cells min(pos, K-1) and at the dump's own ranks
    assert port["a2"][0].tolist() == [10, 11]
    assert port["a1"][0].item() == 5  # the logical count keeps going past K
    assert port["a2"][4].tolist() == [13, 18]


def test_count_is_the_logical_total_except_in_hist_mode():
    (rl, pl), state, _c, _s = _collect_case(1, "hist", "int64", capacity=4, K=2)
    state["a1"][:] = 0
    state["a4"][:] = 0
    slots = np.zeros(5, np.int32)
    head = np.ones(5, np.int64)
    vals = np.array([1, 2, 3, 1, 4], np.int64)
    vbits = np.ones(5, np.int8)
    port = _run_both(lambda s, c, sl: rhs._vec_hist(s, rl, 1, c, sl, jnp.int32(4)),
                     lambda s, c, sl: vector.fold_vectors(s, pl, sl, c),
                     state, [None, head, vals, vbits, head], slots)
    assert port["a1"][0].item() == 2  # hist: only the 2 written entries
    # values 3 and 4 found no entry (cap reached): their heads land at
    # hist_count[dump, 0]
    assert port["a4"][0].tolist() == [2, 1]
    assert port["a4"][4, 0].item() == 2
    (rl, pl), state, _c, _s = _collect_case(1, "set", "int64", capacity=4, K=2)
    state["a1"][:] = 0
    port = _run_both(lambda s, c, sl: rhs._vec_collect(s, rl, 1, c, sl, jnp.int32(4)),
                     lambda s, c, sl: vector.vec_collect(s, pl, 1, c, sl, "set"),
                     state, [None, head, vals, vbits], slots)
    assert port["a1"][0].item() == 4  # set: 4 distinct values, past K = 2


def test_float_set_and_topk_follow_ieee_equality_and_xla_order():
    (rl, pl), state, _c, _s = _collect_case(2, "set", "float64", capacity=4, K=6)
    state["a1"][:] = 0
    vals = np.array([0.0, -0.0, np.nan, np.nan, -0.0, 1.0], np.float64)
    n = vals.size
    slots = np.zeros(n, np.int32)
    port = _run_both(lambda s, c, sl: rhs._vec_collect(s, rl, 1, c, sl, jnp.int32(4)),
                     lambda s, c, sl: vector.vec_collect(s, pl, 1, c, sl, "set"),
                     state, [None, np.ones(n, np.int64), vals, np.ones(n, np.int8)], slots)
    got = port["a2"][0, :port["a1"][0]].numpy()
    # +0.0 first (-0.0 equals it), each NaN its own element
    assert port["a1"][0].item() == 4 and np.signbit(got[0]) == 0 and np.isnan(got[1:3]).all()
    for distinct in (False, True):
        comps = [dict(combine="add", dtype="int32", init=0),
                 dict(combine="topk", dtype="float64", init=float("-inf"), width=3,
                      mode="distinct" if distinct else "")]
        rl2, pl2 = _layouts(4, comps)
        st2 = {"a1": np.full((5, 3), -np.inf)}
        _run_both(lambda s, c, sl: rhs._vec_topk(s, rl2.components[1], 1, c[1], sl, jnp.int32(4)),
                  lambda s, c, sl: vector.vec_topk(s, pl2, 1, c[1], sl),
                  st2, [None, np.array([-0.0, 0.0, np.nan, 2.0, np.nan, -0.0])], slots)


ARG_TYPES = {
    "BIGINT": (RT.BIGINT, PT.BIGINT, np.int64),
    "DOUBLE": (RT.DOUBLE, PT.DOUBLE, np.float64),
    "INTEGER": (RT.INTEGER, PT.INTEGER, np.int32),
    "BOOLEAN": (RT.BOOLEAN, PT.BOOLEAN, np.bool_),
    "STRING": (RT.STRING, PT.STRING, np.int64),
}
#: (function, argument type, literals, device kind)
FAMILIES = [
    ("COLLECT_LIST", "BIGINT", (), "collect"), ("COLLECT_LIST", "STRING", (), "collect"),
    ("COLLECT_SET", "DOUBLE", (), "collect"), ("COLLECT_LIST", "BOOLEAN", (), "collect"),
    ("EARLIEST_BY_OFFSET", "INTEGER", (3,), "collect"),
    ("LATEST_BY_OFFSET", "DOUBLE", (2, False), "collect"),
    ("LATEST_BY_OFFSET", "BIGINT", (4, True), "collect"),
    ("TOPK", "DOUBLE", (3,), "topk"), ("TOPKDISTINCT", "BIGINT", (2,), "topk"),
    ("TOPKDISTINCT", "INTEGER", (3,), "topk"), ("TOPK", "BOOLEAN", (2,), "topk"),
    ("HISTOGRAM", "STRING", (), "histogram"), ("ATTR", "DOUBLE", (), "attr"),
    ("ATTR", "STRING", (), "attr"), ("COLLECT_ALL", "BIGINT", (), "collect_all_valid"),
]


def _comp_state(rng, comp, n):
    shape = (n,) if comp.width == 1 else (n, comp.width)
    if comp.dtype == "float64":
        return FVALS[rng.integers(0, len(FVALS), shape)]
    hi = 3 if comp.combine in ("vec_count", "add") and comp.width == 1 else 4
    return rng.integers(-1 if comp.combine == "hist_count" else 0, hi + comp.width, shape).astype(comp.dtype)


@pytest.mark.parametrize("fname,tname,lits,kind", FAMILIES)
def test_decomposition_matches_reference(fname, tname, lits, kind):
    rt, pt, npdt = ARG_TYPES[tname]
    if kind in ("collect", "topk", "collect_all_valid"):
        r_res, p_res = RT.SqlType.array(rt), PT.SqlType.array(pt)
    elif kind == "histogram":
        r_res, p_res = RT.SqlType.map(RT.STRING, RT.BIGINT), PT.SqlType.map(PT.STRING, PT.BIGINT)
    else:
        r_res, p_res = rt, pt
    ref = rda.compile_device_agg(kind, [rt], r_res, fname=fname, literals=lits)
    port = pda.compile_device_agg(kind, [pt], p_res, fname=fname, literals=lits)
    assert [dict(vars(c)) for c in port.components] == [dict(vars(c)) for c in ref.components]
    rng = np.random.default_rng(len(fname) + len(tname))
    n = 40
    data = rng.integers(-2, 3, n).astype(npdt) if npdt != np.float64 else FVALS[rng.integers(0, 7, n)]
    valid = rng.random(n) < 0.7
    act = rng.random(n) < 0.9
    want = ref.contribs([RDCol(jnp.asarray(data), jnp.asarray(valid), rt)], jnp.asarray(act))
    got = port.contribs([PDCol(torch.from_numpy(data), torch.from_numpy(valid), pt)],
                        torch.from_numpy(act))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    comps = [_comp_state(rng, c, 12) for c in ref.components]
    want = ref.finalize([jnp.asarray(c) for c in comps])
    got = port.finalize([torch.from_numpy(c) for c in comps])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fname,targ,lits,words", [
    ("TOPK", RT.STRING, (3,), "string ordering on device"),
    ("TOPK", RT.SqlType.array(RT.BIGINT), (3,), "TOPK over nested types on device"),
    ("TOPK", RT.BIGINT, (300,), "TOPK k 300 on device"),
    ("LATEST_BY_OFFSET", RT.BIGINT, (3, None), "LATEST_BY_OFFSET dynamic ignoreNulls on device"),
    ("EARLIEST_BY_OFFSET", RT.BIGINT, (5000,), "EARLIEST_BY_OFFSET cap 5000 on device"),
])
def test_refusals_keep_the_references_words(fname, targ, lits, words):
    kind = "topk" if fname == "TOPK" else "collect"
    with pytest.raises(Exception) as ref_err:
        rda.compile_device_agg(kind, [targ], RT.SqlType.array(targ), fname=fname, literals=lits)
    ptarg = PT.SqlType.from_json(targ.to_json())
    with pytest.raises(DeviceUnsupported) as port_err:
        pda.compile_device_agg(kind, [ptarg], PT.SqlType.array(ptarg), fname=fname, literals=lits)
    assert str(port_err.value) == str(ref_err.value) == words


def _bits(t):
    return t.view(torch.int64) if t.is_floating_point() else t


@pytest.mark.parametrize("K", [3, 1000])
def test_wide_gather_and_evict_reset_width_k_rows(K):
    rng = np.random.default_rng(5)
    comps = (hs.AggComponent("max", "int64", 0), hs.AggComponent("vec_count", "int64", 0),
             hs.AggComponent("vec_data", "float64", 0, width=K, mode="append"),
             hs.AggComponent("vec_valid", "int8", 0, width=K),
             hs.AggComponent("topk", "int32", int(np.iinfo(np.int32).min), width=2))
    layout = hs.StoreLayout(8, 1, comps, windowed=True)
    store = hs.init_store(layout, "cpu")
    for j, c in enumerate(comps):
        store[f"a{j}"].copy_(torch.from_numpy(_comp_state(rng, c, 9)))
    slots = torch.tensor([3, 0, 8, 3, 5], dtype=torch.int32)
    mask = torch.tensor([True, False, True, False, True])
    view = slicing.combine_windows(store, layout, 1, slots, mask=mask)
    for j, c in enumerate(comps):
        want = store[f"a{j}"][slots.long()]
        if c.width > 1:
            want = torch.where(mask.reshape(-1, *[1] * (want.dim() - 1)), want, torch.zeros_like(want))
        assert torch.equal(_bits(view[f"a{j}"]), _bits(want))
    store["occ"][:] = True
    store["wstart"].copy_(torch.arange(9) * 10)
    store["max_ts"].fill_(45)
    before = {k: v.clone() for k, v in store.items()}
    hs.evict(store, layout, 10)
    expired = torch.arange(9) * 10 + 10 < 45
    for j, c in enumerate(comps):
        col = store[f"a{j}"]
        if col.dim() == 2:
            assert bool((col[expired] == torch.tensor(c.init, dtype=col.dtype)).all())
        assert torch.equal(_bits(col[~expired]), _bits(before[f"a{j}"][~expired]))  # kept rows bit for bit
    assert bool((store["grave"] == expired).all())
