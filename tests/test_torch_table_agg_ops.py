"""The table aggregation's device functions against the reference's.

Each plain twin (the CPU path, and the oracle of its CUDA kernel on the
card) meets the reference function on the same numpy-seeded inputs, bit
for bit: K23's twin ``vector.vec_remove_plain`` against
``ops/hash_store.py:_vec_remove`` and, with K20 after it, against
``scatter_combine(vec_undo=True)`` — int64, int32, float64 (±0.0, NaN) and
dictionary-code values, duplicate undo rows of one (slot, value), values
the slot does not hold, lists at and past the 1,000 cap, a populated dump
row, misses to the dump slot; K8's find-only mode against ``probe_find``
with window 0 (graves, misses, 32-round exhaustion); K20's hist mode and
K22 with an undo side's negative heads against ``_vec_hist``; and the
STDDEV, CORRELATION and undo decompositions against
``ops/device_aggs.py``.  Tolerance: none (float sums are folded in row
order on both sides here; only the card's atomics reorder them).
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
from ksql_tpu_torch.common.batch import stable_hash64
from ksql_tpu_torch.compiler.torch_expr import DCol as PDCol
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.ops import device_aggs as pda
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import vector
from test_torch_vector_ops import FVALS, _layouts, _run_both
from torch_kernel_cases import REMOVE_CASES, remove_case

jax.config.update("jax_enable_x64", True)

#: dictionary codes of a few strings (a COLLECT_LIST of STRING stores them)
CODES = np.array([stable_hash64(f"s{i}") for i in range(5)], np.int64)


def _pool(rng, dtype, n):
    if dtype == "float64":
        return FVALS[rng.integers(0, len(FVALS), n)].copy()
    if dtype == "code":
        return CODES[rng.integers(0, len(CODES), n)].copy()
    return rng.integers(-3, 4, n).astype(dtype)


def _remove_case(seed, dtype, capacity=16, K=6, n=64, dump_cnt=3, counts=None):
    """A COLLECT_LIST group at component 1 (counts below, at and past K;
    the dump row populated) and an undo batch: heads mostly -1 (some 0 or
    +1), values mostly taken from the slot's own stored entries (so the
    r-th duplicate has an r-th occurrence to claim, or not), some absent,
    some rows aimed at the dump slot (a missed group)."""
    rng = np.random.default_rng(seed)
    ddt = "int64" if dtype == "code" else dtype
    comps = [dict(combine="max", dtype="int64", init=0),
             dict(combine="vec_count", dtype="int64", init=0),
             dict(combine="vec_data", dtype=ddt, init=0, width=K, mode="append"),
             dict(combine="vec_valid", dtype="int8", init=0, width=K)]
    c1 = capacity + 1
    if counts is None:
        counts = [0, 1, 2, K - 1, K, K + 2, 3 * K]
    cnt = np.asarray(counts, np.int64)[rng.integers(0, len(counts), c1)]
    cnt[capacity] = dump_cnt
    data = _pool(rng, dtype, c1 * K).reshape(c1, K)
    vbit = (rng.random((c1, K)) < 0.85).astype(np.int8)
    data = np.where(vbit != 0, data, 0).astype(ddt)
    state = {"a0": np.zeros(c1, np.int64), "a1": cnt, "a2": data, "a3": vbit,
             "dirty": np.zeros(c1, bool)}
    slots = rng.choice(np.r_[np.arange(capacity), [capacity] * 4], n).astype(np.int32)
    pick = rng.integers(0, K, n)
    take = rng.random(n) < 0.75
    s_real = np.minimum(slots, capacity)
    vals = np.where(take, data[s_real, pick], _pool(rng, dtype, n)).astype(ddt)
    vbits = np.where(take, vbit[s_real, pick], (rng.random(n) < 0.9).astype(np.int8)).astype(np.int8)
    vals = np.where(vbits != 0, vals, 0).astype(ddt)
    head = np.where(rng.random(n) < 0.85, -1, rng.integers(0, 2, n)).astype(np.int64)
    ts = rng.integers(0, 1000, n).astype(np.int64)
    return _layouts(capacity, comps), state, [ts, head, vals, vbits], slots


DTYPES = ["int64", "int32", "float64", "code"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("dtype", DTYPES)
def test_vec_remove_matches_reference(dtype, seed):
    (rl, pl), state, contribs, slots = _remove_case(seed, dtype, dump_cnt=seed * 3)
    _run_both(lambda s, c, sl: rhs._vec_remove(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
              lambda s, c, sl: vector.vec_remove(s, pl, 1, c, sl),
              state, contribs, slots)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("dtype", DTYPES)
def test_undo_fold_matches_scatter_combine_vec_undo(dtype, seed):
    # the undo side's whole fold: K3's scalar max, then K23 and K20
    (rl, pl), state, contribs, slots = _remove_case(seed + 10, dtype)

    def port(s, c, sl):
        hs.fold_and_mark(s, {}, pl, sl, c, torch.ones(sl.shape[0], dtype=torch.bool))
        vector.fold_vectors(s, pl, sl, c, vec_undo=True)

    _run_both(lambda s, c, sl: s.update(rhs.scatter_combine(s, rl, sl, c, vec_undo=True)),
              port, state, contribs, slots)


def test_vec_remove_lists_at_and_past_the_cap():
    # COLLECT_LIST's real cap: counts 999, 1,000, 1,001 and 2,500 (the
    # logical count past K), many duplicate values, a populated dump row
    (rl, pl), state, contribs, slots = _remove_case(
        5, "int64", capacity=8, K=1000, n=256, dump_cnt=1200, counts=[999, 1000, 1001, 2500])
    port = _run_both(lambda s, c, sl: rhs._vec_remove(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
                     lambda s, c, sl: vector.vec_remove(s, pl, 1, c, sl),
                     state, contribs, slots)
    assert (port["a1"][:-1].numpy() < state["a1"][:-1]).any()  # entries were removed


def test_vec_remove_traps():
    # hand-built: the r-th duplicate claims the r-th occurrence; +-0.0 match
    # each other and come back +0.0; a NaN is never removed; the dump row's
    # cells past its count become 0 once any row is not a winner
    comps = [dict(combine="max", dtype="int64", init=0),
             dict(combine="vec_count", dtype="int64", init=0),
             dict(combine="vec_data", dtype="float64", init=0, width=5, mode="append"),
             dict(combine="vec_valid", dtype="int8", init=0, width=5)]
    rl, pl = _layouts(2, comps)
    nan = float("nan")
    state = {"a0": np.zeros(3, np.int64), "a1": np.array([5, 4, 2], np.int64),
             "a2": np.array([[1.0, -0.0, 1.0, nan, 1.0], [0.0, 2.0, -0.0, 7.0, 9.0],
                             [-0.0, 3.0, 4.0, -0.0, 5.0]]),
             "a3": np.ones((3, 5), np.int8), "dirty": np.zeros(3, bool)}
    slots = np.array([0, 0, 0, 1, 1, 2], np.int32)
    head = np.array([-1, -1, -1, -1, 0, -1], np.int64)
    vals = np.array([1.0, 1.0, nan, 0.0, 3.0, 4.0])
    contribs = [np.zeros(6, np.int64), head, vals, np.ones(6, np.int8)]
    port = _run_both(lambda s, c, sl: rhs._vec_remove(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
                     lambda s, c, sl: vector.vec_remove(s, pl, 1, c, sl),
                     state, contribs, slots)
    data = port["a2"].numpy()
    # slot 0 lost its first two 1.0s and kept the NaN and its -0.0 as +0.0
    np.testing.assert_array_equal(data[0, :3].view(np.int64),
                                  np.array([0.0, nan, 1.0]).view(np.int64))
    assert port["a1"].tolist() == [3, 3, 2]  # slot 1's +0.0 took its first zero
    assert not np.signbit(data[2]).any()  # the dump row: -0.0 -> +0.0, tail 0


def _find_case(seed, capacity=64, n=200):
    """A 70%-full store with graves and one run of 40 taken slots; rows of
    stored keys (some placed past 32 probes from their base), absent keys
    and inactive rows."""
    rng = np.random.default_rng(seed)
    mask = capacity - 1
    occ = rng.random(capacity + 1) < 0.6
    grave = ~occ & (rng.random(capacity + 1) < 0.4)
    occ[10:50] = True
    grave[10:50] = False
    occ[capacity] = grave[capacity] = False
    kh = rng.integers(-2 ** 62, 2 ** 62, capacity + 1)
    ws = np.zeros(capacity + 1, np.int64)
    ws[rng.random(capacity + 1) < 0.05] = 7  # another window: never a match
    base = lambda k: int(hs.slot_base(torch.tensor([k]), torch.zeros(1, dtype=torch.int64),
                                      capacity)[0])
    # a stored key 35 slots past its base, inside the run: 32 rounds miss it
    far = next(int(k) for k in rng.integers(-2 ** 62, 2 ** 62, 10_000) if base(int(k)) == 12)
    kh[(12 + 35) & mask] = far
    ws[(12 + 35) & mask] = 0
    stored = kh[:capacity][occ[:capacity] & (ws[:capacity] == 0)]
    khash = np.where(rng.random(n) < 0.6, rng.choice(stored, n), rng.integers(-2 ** 62, 2 ** 62, n))
    khash[:3] = far
    active = rng.random(n) < 0.9
    store = {"occ": occ, "grave": grave, "khash": kh, "wstart": ws}
    return store, khash.astype(np.int64), active


@pytest.mark.parametrize("seed", range(4))
def test_find_only_probe_matches_reference(seed):
    capacity = 64
    store, khash, active = _find_case(seed, capacity)
    want = np.asarray(rhs.probe_find({k: jnp.asarray(v) for k, v in store.items()}, capacity,
                                     jnp.asarray(khash), jnp.zeros(len(khash), jnp.int64),
                                     jnp.asarray(active)))
    pstore = {k: torch.from_numpy(v) for k, v in store.items()}
    kh_t = torch.from_numpy(khash)
    base = hs.slot_base(kh_t, torch.zeros_like(kh_t), capacity)
    got = hs.probe_find_slots(pstore, capacity, kh_t, base, torch.from_numpy(active)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:3] == capacity).all()  # exhausted after 32 rounds, though stored
    assert (got < capacity).sum() > 0 and (got[active] == capacity).sum() > 3


@pytest.mark.parametrize("seed", range(3))
def test_hist_with_negative_heads_matches_reference(seed):
    # the undo side: HISTOGRAM's undo contributions (heads -1 or 0) through
    # K20's hist mode (which appends nothing) and K22 (which decrements)
    rng = np.random.default_rng(seed)
    capacity, K, n = 16, 5, 48
    comps = [dict(combine="max", dtype="int64", init=0),
             dict(combine="vec_count", dtype="int64", init=0, mode="hist"),
             dict(combine="vec_data", dtype="int64", init=0, width=K, mode="hist"),
             dict(combine="vec_valid", dtype="int8", init=0, width=K),
             dict(combine="hist_count", dtype="int64", init=0, width=K)]
    rl, pl = _layouts(capacity, comps)
    c1 = capacity + 1
    cnt = rng.integers(0, K + 1, c1).astype(np.int64)
    data = CODES[rng.integers(0, len(CODES), (c1, K))]
    state = {"a1": cnt, "a2": data, "a3": np.ones((c1, K), np.int8),
             "a4": rng.integers(0, 4, (c1, K)).astype(np.int64)}
    slots = rng.choice(np.r_[np.arange(capacity), [capacity] * 3], n).astype(np.int32)
    vals = CODES[rng.integers(0, len(CODES), n)]
    valid = rng.random(n) < 0.9
    act = rng.random(n) < 0.85
    spec = pda.compile_device_agg("histogram", [PT.STRING], PT.SqlType.map(PT.STRING, PT.BIGINT))
    undo = [c.numpy() for c in spec.undo_contribs(
        [PDCol(torch.from_numpy(vals), torch.from_numpy(valid), PT.STRING)], torch.from_numpy(act))]
    assert (undo[0] <= 0).all() and (undo[0] < 0).any()
    contribs = [None] + undo
    _run_both(lambda s, c, sl: rhs._vec_hist(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
              lambda s, c, sl: vector.fold_vectors(s, pl, sl, c, vec_undo=True),
              state, contribs, slots)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int64) if x.dtype == np.float64 else x


FAMILIES = [("STDDEV_SAMPLE", "stddev", 1), ("STDDEV_POP", "stddev", 1),
            ("CORRELATION", "correlation", 2)]


@pytest.mark.parametrize("fname,kind,nargs", FAMILIES)
@pytest.mark.parametrize("tname", ["INTEGER", "BIGINT", "DOUBLE"])
def test_stddev_and_correlation_match_reference(fname, kind, nargs, tname):
    rt, pt = getattr(RT, tname), getattr(PT, tname)
    assert pda.resolve_udaf(fname, [pt] * nargs) == (kind, PT.DOUBLE, 0)
    ref = rda.compile_device_agg(kind, [rt] * nargs, RT.DOUBLE, fname=fname)
    port = pda.compile_device_agg(kind, [pt] * nargs, PT.DOUBLE, fname=fname)
    assert [dict(vars(c)) for c in port.components] == [dict(vars(c)) for c in ref.components]
    assert port.undo_contribs is None  # undone by negation
    rng = np.random.default_rng(len(fname) + len(tname))
    n = 64
    npdt = {"INTEGER": np.int32, "BIGINT": np.int64, "DOUBLE": np.float64}[tname]
    cols = []
    for _ in range(nargs):
        data = (rng.uniform(-50, 50, n) if npdt == np.float64
                else rng.integers(-50, 50, n)).astype(npdt)
        cols.append((data, rng.random(n) < 0.8))
    act = rng.random(n) < 0.9
    want = ref.contribs([RDCol(jnp.asarray(d), jnp.asarray(v), rt) for d, v in cols],
                        jnp.asarray(act))
    got = port.contribs([PDCol(torch.from_numpy(d), torch.from_numpy(v), pt) for d, v in cols],
                        torch.from_numpy(act))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    # finalize over slot state after undos: counts 0, 1, 2 and more, sums
    # that cancel to tiny residues, variances a rounding below 0
    m = 200
    comps = []
    for c in ref.components:
        if c.dtype == "int64":
            comps.append(rng.integers(0, 6, m).astype(np.int64))
        else:
            comps.append(rng.uniform(-1e3, 1e3, m) * (rng.random(m) < 0.8) + rng.uniform(-1e-12, 1e-12, m))
    want = ref.finalize([jnp.asarray(c) for c in comps])
    got = port.finalize([torch.from_numpy(c) for c in comps])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_stddev_samp_has_no_device_kind():
    # STDDEV_SAMP returns the sample variance in the reference: no device kind
    with pytest.raises(DeviceUnsupported):
        pda.resolve_udaf("STDDEV_SAMP", [PT.BIGINT])


@pytest.mark.parametrize("fname,kind,tname", [
    ("COLLECT_LIST", "collect", "BIGINT"), ("COLLECT_LIST", "collect", "DOUBLE"),
    ("COLLECT_LIST", "collect", "STRING"), ("HISTOGRAM", "histogram", "STRING"),
    ("ATTR", "attr", "BIGINT"),
])
def test_undo_contributions_match_reference(fname, kind, tname):
    rt, pt = getattr(RT, tname), getattr(PT, tname)
    if kind == "collect":
        r_res, p_res = RT.SqlType.array(rt), PT.SqlType.array(pt)
    elif kind == "histogram":
        r_res, p_res = RT.SqlType.map(RT.STRING, RT.BIGINT), PT.SqlType.map(PT.STRING, PT.BIGINT)
    else:
        r_res, p_res = rt, pt
    ref = rda.compile_device_agg(kind, [rt], r_res, fname=fname)
    port = pda.compile_device_agg(kind, [pt], p_res, fname=fname)
    rng = np.random.default_rng(len(fname))
    n = 40
    if tname == "DOUBLE":
        data = FVALS[rng.integers(0, len(FVALS), n)]
    elif tname == "STRING":
        data = CODES[rng.integers(0, len(CODES), n)]
    else:
        data = rng.integers(-3, 4, n).astype(np.int64)
    valid = rng.random(n) < 0.7
    act = rng.random(n) < 0.9
    want = ref.undo_contribs([RDCol(jnp.asarray(data), jnp.asarray(valid), rt)], jnp.asarray(act))
    got = port.undo_contribs([PDCol(torch.from_numpy(data), torch.from_numpy(valid), pt)],
                             torch.from_numpy(act))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("fname", ["COLLECT_SET", "EARLIEST_BY_OFFSET"])
def test_collect_families_without_undo(fname):
    # only COLLECT_LIST of the collect kind has an undo (the reference's)
    lits = (2,) if fname == "EARLIEST_BY_OFFSET" else ()
    port = pda.compile_device_agg("collect", [PT.BIGINT], PT.SqlType.array(PT.BIGINT),
                                  fname=fname, literals=lits)
    ref = rda.compile_device_agg("collect", [RT.BIGINT], RT.SqlType.array(RT.BIGINT),
                                 fname=fname, literals=lits)
    assert port.undo_contribs is None and ref.undo_contribs is None


def test_vec_remove_leaves_the_dump_row_when_every_row_wins():
    # every row is its slot's lowest undo row: nothing writes the dump row,
    # whose -0.0 and cells past its count stay as they are
    (rl, pl), state, contribs, slots = _remove_case(3, "float64", capacity=8, n=8, dump_cnt=1)
    slots[:] = np.arange(8, dtype=np.int32)
    contribs[1][:] = -1
    state["a2"][8] = -0.0
    port = _run_both(lambda s, c, sl: rhs._vec_remove(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
                     lambda s, c, sl: vector.vec_remove(s, pl, 1, c, sl),
                     state, contribs, slots)
    assert np.signbit(port["a2"][8].numpy()).all()


def test_a_list_past_its_cap_shows_a_null_after_an_undo():
    # the reference's logical count runs past K: once an entry of a full
    # list is removed, the list still presents min(count, K) entries, the
    # last a zeroed (null) cell, and later appends (count >= K) never fill
    # it; the port keeps this bit for bit
    comps = [dict(combine="max", dtype="int64", init=0),
             dict(combine="vec_count", dtype="int64", init=0),
             dict(combine="vec_data", dtype="int64", init=0, width=4, mode="append"),
             dict(combine="vec_valid", dtype="int8", init=0, width=4)]
    rl, pl = _layouts(1, comps)
    state = {"a0": np.zeros(2, np.int64), "a1": np.array([6, 0], np.int64),
             "a2": np.array([[11, 12, 13, 14], [0, 0, 0, 0]], np.int64),
             "a3": np.array([[1, 1, 1, 1], [0, 0, 0, 0]], np.int8), "dirty": np.zeros(2, bool)}
    contribs = [np.zeros(1, np.int64), np.array([-1], np.int64), np.array([12], np.int64),
                np.ones(1, np.int8)]
    port = _run_both(lambda s, c, sl: rhs._vec_remove(s, rl, 1, c, sl, jnp.int32(rl.capacity)),
                     lambda s, c, sl: vector.vec_remove(s, pl, 1, c, sl),
                     state, contribs, np.zeros(1, np.int32))
    # COLLECT_LIST's finalize at this width
    finalize = pda._collect_finalize(4, False)
    data, present, valid = finalize([port["a1"][:1], port["a2"][:1], port["a3"][:1]])
    assert present[0].tolist() == [True] * 4 and valid[0].tolist() == [True, True, True, False]
    assert data[0, :3].tolist() == [11, 13, 14] and port["a1"][0] == 5


@pytest.mark.parametrize("case", REMOVE_CASES)
def test_vec_remove_matches_reference_at_the_kernels_skews(case):
    """K23's twin against ``_vec_remove`` where the kernel's design leans
    (``REMOVE_CASES``): one slot taking most undo rows, a full list whose
    value is stored 70 times with 40 undo rows (claims past the 32nd
    occurrence and the 1,024th entry) beside one with 5, NaN and both zeros
    undone in one slot's run, every row winning its slot (the dump row
    untouched), undo values no slot holds.  Tolerance: none."""
    comps, state, contribs, slots = remove_case(case)
    capacity = state["a1"].shape[0] - 1
    rl, pl = _layouts(capacity, [dict(combine=c, dtype=d, init=i, width=w, mode=m)
                                 for c, d, i, w, m in comps])
    state = dict(state, a0=np.zeros(capacity + 1, np.int64))
    port = _run_both(lambda s, c, sl: rhs._vec_remove(s, rl, 1, c, sl, jnp.int32(capacity)),
                     lambda s, c, sl: vector.vec_remove(s, pl, 1, c, sl), state, contribs, slots)
    removed = state["a1"] - port["a1"].numpy()
    if case == "repeats":
        assert removed[3] >= 40 and removed[4] >= 5
    elif case == "all_win":
        np.testing.assert_array_equal(port["a2"][capacity].numpy(), state["a2"][capacity])
    elif case == "no_match":
        assert not removed.any()
    else:
        assert removed.sum() > 0
