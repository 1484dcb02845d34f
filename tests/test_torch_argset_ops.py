"""K3's and K15's argset modes (EARLIEST/LATEST_BY_OFFSET's payloads): the
port's plain twins against the reference.

``hash_store.fold_and_mark`` + ``fold_argset`` (on CPU tensors, their
twins) are held against ``ksql_tpu.ops.hash_store.scatter_combine`` on the
same store and contributions, every slot and the dump slot included: rows
aimed at the dump (inactive, overflowed, or beaten to their slot's order)
leave the payload of the highest such row there; a slot that never had a
candidate keeps its init order and takes the zero payloads of every row
with the init contribution; NULL values ignored (EARLIEST) or kept
(LATEST(x, false)); -0.0, +0.0, NaN and infinity payloads.  Tolerance:
none, every component is compared by its bits.

``ops/session._seg_folds`` is held against the reference's argset branch of
the segment merge (``runtime/lowering.py:3671-3694``), written out in jax
over the same sorted items: ``segment_sum`` of the values of the alive
items whose order equals the segment's and is not the init, so a -0.0
payload comes out +0.0 and NaN stays NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.ops import hash_store as ref
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import session as sess
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.torch_kernel_cases import ARGSET_CASES, ARGSET_COMPONENTS, argset_case

jax.config.update("jax_enable_x64", True)

I64 = np.iinfo(np.int64)
#: the offsets' components (ops/device_aggs.py): the ts watermark, EARLIEST
#: over a DOUBLE (min order, value, valid bit), LATEST over a BIGINT (max
#: order, value, valid bit), a SUM between them and an INTEGER LATEST
COMPONENTS = (("max", "int64", I64.min), ("min", "int64", I64.max), ("argset", "float64", 0),
              ("argset", "int32", 0), ("add", "int64", 0), ("max", "int64", I64.min),
              ("argset", "int64", 0), ("argset", "int32", 0), ("max", "int64", I64.min),
              ("argset", "int32", 0), ("argset", "int32", 0))
ORDERS = {1: "min", 5: "max", 8: "max"}  # order component -> combine
PAYLOADS = {2: 1, 3: 1, 6: 5, 7: 5, 9: 8, 10: 8}  # argset component -> its order


def _doubles(rng, n):
    v = rng.normal(0, 100, n)
    sp = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf])
    pick = rng.random(n) < 0.15
    v[pick] = sp[rng.integers(0, sp.size, int(pick.sum()))]
    return v


def _case(seed, capacity, n, inactive=0.05, overflow=0.02, never=0.15, nulls=0.2, hot=None):
    """A store (numpy) after earlier batches and a batch's slots and
    contributions, as the lowering hands them to the fold: slots of
    inactive rows are the dump, their contributions the identity."""
    rng = np.random.default_rng(seed)
    comps = tuple(ref.AggComponent(*c) for c in COMPONENTS)
    layout = ref.StoreLayout(capacity, 1, comps)
    st = {k: np.array(v) for k, v in jax.device_get(ref.init_store(layout)).items()}
    held = np.nonzero(rng.random(capacity) < 0.7)[0]
    st["occ"][held] = True
    seen = held[rng.random(held.size) >= never]
    seq0 = 1 << 30
    old = rng.choice(seq0, 3 * seen.size, replace=False).astype(np.int64)
    for j, k in ((1, 0), (5, 1), (8, 2)):
        st[f"a{j}"][seen] = old[k * seen.size:(k + 1) * seen.size]
    st["a2"][seen] = _doubles(rng, seen.size)
    for j in (3, 7, 9, 10):
        st[f"a{j}"][seen] = rng.random(seen.size) < 0.8
    st["a6"][seen] = rng.integers(I64.min, I64.max, seen.size, dtype=np.int64)
    # a dump slot that earlier batches wrote
    for j in range(len(COMPONENTS)):
        st[f"a{j}"][capacity] = st[f"a{j}"][held[0]] if held.size else 0
    pool = held if hot is None else held[:hot]
    slots = pool[rng.integers(0, max(pool.size, 1), n) % max(pool.size, 1)].astype(np.int32) \
        if pool.size else np.full(n, capacity, np.int32)
    active = rng.random(n) >= inactive
    slots[~active] = capacity
    slots[rng.random(n) < overflow] = capacity  # active, overflowed
    seq = seq0 + np.arange(n, dtype=np.int64)
    valid = rng.random(n) >= nulls
    e_cand = active & valid  # EARLIEST ignores NULLs
    l_cand = active.copy()  # LATEST(x, false) keeps them
    i_cand = active & valid & (rng.random(n) < 0.5)
    c = [np.where(active, rng.integers(0, 10**12, n), I64.min).astype(np.int64),
         np.where(e_cand, seq, I64.max), np.where(e_cand, _doubles(rng, n), 0.0),
         (e_cand & valid).astype(np.int32), np.where(active, rng.integers(-9, 9, n), 0).astype(np.int64),
         np.where(l_cand, seq, I64.min), np.where(l_cand, rng.integers(-10**9, 10**9, n), 0).astype(np.int64),
         (l_cand & valid).astype(np.int32), np.where(i_cand, seq, I64.min),
         np.where(i_cand, rng.integers(-5, 5, n), 0).astype(np.int32), i_cand.astype(np.int32)]
    return layout, st, slots, active, c


CASES = {
    "mixed": dict(seed=1, capacity=1 << 10, n=2048),
    "hot_slots": dict(seed=2, capacity=1 << 8, n=1024, hot=4),
    "sparse": dict(seed=3, capacity=1 << 12, n=64),
    "many_never": dict(seed=4, capacity=1 << 6, n=512, never=0.9),
    "all_null": dict(seed=5, capacity=1 << 7, n=256, nulls=1.0),
    "mostly_inactive": dict(seed=6, capacity=1 << 7, n=256, inactive=0.9),
    "overflowed": dict(seed=7, capacity=1 << 6, n=300, overflow=0.5),
    "last_row_wins_its_slot": dict(seed=8, capacity=1 << 5, n=33, inactive=0.0, overflow=0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fold_and_argset_twins_match_scatter_combine(case):
    layout, st, slots, active, c = _case(**CASES[case])
    want_store = ref.scatter_combine({k: jnp.asarray(v) for k, v in st.items()}, layout,
                                     jnp.asarray(slots), [jnp.asarray(x) for x in c])
    want_win = np.asarray(ref.winners_per_slot(jnp.asarray(slots), jnp.asarray(active), layout.capacity))
    port = state_from_numpy(st, "cpu")
    port_layout = hs.StoreLayout(layout.capacity, 1, tuple(hs.AggComponent(*x) for x in COMPONENTS))
    scratch = hs.init_scratch(layout.capacity, "cpu")
    cs = [torch.from_numpy(x) for x in c]
    win = hs.fold_and_mark(port, scratch, port_layout, torch.from_numpy(slots), cs, torch.from_numpy(active))
    hs.fold_argset(port, scratch, port_layout, torch.from_numpy(slots), cs)
    np.testing.assert_array_equal(win.numpy(), want_win)
    got = state_to_numpy(port)
    want = {k: np.asarray(v) for k, v in jax.device_get(want_store).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        g, w = got[k], want[k]
        if g.dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", list(ARGSET_CASES))
def test_argset_twin_matches_scatter_combine_at_the_kernels_edges(case):
    """K3 argset's twin against ``scatter_combine`` where the kernel's
    block reduction and last-block ticket decide the dump slot
    (``ARGSET_CASES``): every row of the last 256-row block wins, so the
    dump takes the highest row of an earlier block; no row wins, so it
    takes the last row; zipf slots.  Tolerance: none (bits)."""
    n, kind = ARGSET_CASES[case]
    state, slots, active, c = argset_case(n, kind)
    capacity = state["a0"].shape[0] - 1
    layout = ref.StoreLayout(capacity, 1, tuple(ref.AggComponent(*x) for x in ARGSET_COMPONENTS))
    st = {k: np.array(v) for k, v in jax.device_get(ref.init_store(layout)).items()}
    st.update({k: v.copy() for k, v in state.items()})
    want_store = ref.scatter_combine({k: jnp.asarray(v) for k, v in st.items()}, layout,
                                     jnp.asarray(slots), [jnp.asarray(x) for x in c])
    port = state_from_numpy(st, "cpu")
    port_layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(*x) for x in ARGSET_COMPONENTS))
    scratch = hs.init_scratch(capacity, "cpu")
    cs = [torch.from_numpy(x) for x in c]
    hs.fold_and_mark(port, scratch, port_layout, torch.from_numpy(slots), cs, torch.from_numpy(active))
    hs.fold_argset(port, scratch, port_layout, torch.from_numpy(slots), cs)
    got = state_to_numpy(port)
    want = {k: np.asarray(v) for k, v in jax.device_get(want_store).items()}
    for k in want:
        g, w = got[k], want[k]
        if g.dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=k)
    # the case does what it says: LATEST's payload at the dump is that row's
    dump_row = {"top_block_wins": None, "none_wins": n - 1}.get(kind)
    if kind == "top_block_wins":
        top = slots[n - 256:]
        assert (want["a4"][top] == c[4][n - 256:]).all()  # each wins its slot
        lost = np.nonzero(~((slots != capacity) & (c[4] == want["a4"][slots])))[0]
        dump_row = int(lost[-1])
        assert dump_row < n - 256
    if dump_row is not None:
        assert want["a5"][capacity] == c[5][dump_row]


def test_argset_pairs_follow_the_nearest_order():
    layout = hs.StoreLayout(16, 1, tuple(hs.AggComponent(*x) for x in COMPONENTS))
    assert hs.argset_pairs(layout) == sorted(PAYLOADS.items())


def test_dump_keeps_the_highest_rows_payload():
    """Rows 0..4 at one slot, rows 5 and 6 at the dump: the slot keeps the
    winner's payload, the dump the payload of row 6, the highest row aimed
    at it (not a winner's, not row 0's)."""
    comps = (hs.AggComponent("max", "int64", I64.min), hs.AggComponent("min", "int64", I64.max),
             hs.AggComponent("argset", "int64", 0))
    layout = hs.StoreLayout(4, 1, comps)
    st = hs.init_store(layout, "cpu")
    slots = torch.tensor([1, 1, 1, 1, 1, 4, 4], dtype=torch.int32)
    order = torch.tensor([9, 7, 8, 12, 10, I64.max, 3], dtype=torch.int64)
    pay = torch.tensor([90, 70, 80, 120, 100, 55, 33], dtype=torch.int64)
    active = torch.tensor([True] * 5 + [False, True])
    c = [torch.zeros(7, dtype=torch.int64), order, pay]
    hs.fold_and_mark(st, {}, layout, slots, c, active)
    hs.fold_argset(st, hs.init_scratch(4, "cpu"), layout, slots, c)
    assert int(st["a1"][1]) == 7 and int(st["a2"][1]) == 70
    assert int(st["a2"][4]) == 33


def _ref_argset_segments(order, pay, alive, seg, m, init):
    """The reference's argset branch (``lowering.py:3671-3694``) over items
    already in segment order: the segment order over alive items (dead as
    the init), then the segment sum of the winners' payloads."""
    order_vals = jnp.where(alive, order, jnp.asarray(init, order.dtype))
    seg_order = (jax.ops.segment_min if init == I64.max else jax.ops.segment_max)(
        order_vals, seg, num_segments=m)
    winner = alive & (order_vals == seg_order[seg]) & (order_vals != jnp.asarray(init, order.dtype))
    return jax.ops.segment_sum(jnp.where(winner, pay, jnp.zeros_like(pay)), seg, num_segments=m)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_segment_argset_twin_matches_reference(seed, ties):
    """K15's twin: for each argset component, the payload at each segment's
    first position equals the reference's segment sum of its winners.
    ``ties`` repeats order values inside a segment (the sum adds the tied
    winners in item order, as segment_sum does)."""
    rng = np.random.default_rng(seed)
    m = 600
    kh = np.sort(rng.integers(0, 40, m)).astype(np.int64)
    start = np.zeros(m, np.int64)
    for k in np.unique(kh):
        idx = np.nonzero(kh == k)[0]
        start[idx] = np.cumsum(rng.integers(0, 50, idx.size))
    _check_segment_argset(rng, kh, start, ties)


def test_segment_argset_twin_matches_reference_across_tiles():
    """K15 takes a run a tile of sorted positions at a time (1,024, or 512
    or 256 for a wide query): one key's run of 771 items whose sessions
    span the edges at 256 and 512, one opening exactly at 512, with tied
    orders throughout (the payload sum carried across a tile edge adds the
    tied winners in item order)."""
    rng = np.random.default_rng(7)
    m = 771
    kh = np.zeros(m, np.int64)
    kh[-3:] = 1
    step = rng.integers(0, 20, m)
    step[[0, 200, 512, 700]] = 100  # past the gap of 25
    first = _check_segment_argset(rng, kh, np.cumsum(step).astype(np.int64), ties=True)
    assert np.nonzero(first)[0].tolist() == [0, 200, 512, 700, 768]


def _check_segment_argset(rng, kh, start, ties):
    m = kh.size
    alive = rng.random(m) >= 0.2
    seqs = rng.permutation(10 * m)[:m].astype(np.int64)
    if ties:
        seqs = seqs % 50
    nocand = rng.random(m) < 0.2
    comps = [hs.AggComponent(*x) for x in COMPONENTS[:4]] + [hs.AggComponent(*x) for x in COMPONENTS[5:8]]
    cols = [start.copy(), np.where(nocand, I64.max, seqs), _doubles(rng, m),
            (rng.random(m) < 0.8).astype(np.int32), np.where(nocand, I64.min, seqs[::-1].copy()),
            rng.integers(-10**9, 10**9, m), (rng.random(m) < 0.8).astype(np.int32)]
    items = {"kh": torch.from_numpy(kh), "start": torch.from_numpy(start),
             "end": torch.from_numpy(start + rng.integers(0, 30, m)), "alive": torch.from_numpy(alive),
             "slot": torch.zeros(m, dtype=torch.int32), "reprs": torch.from_numpy(kh[None, :].copy()),
             "comps": [torch.from_numpy(c) for c in cols]}
    perm = torch.arange(m, dtype=torch.int32)  # already in (kh, start) order
    got = sess.session_merge(items, perm, m, 1, 25, comps, 1 << 10)
    sf = got["segfirst"].long()
    first = (sf == torch.arange(m)).numpy()
    seg = jnp.asarray(np.cumsum(first) - 1)
    for j, o, init in ((2, 1, I64.max), (3, 1, I64.max), (5, 4, I64.min), (6, 4, I64.min)):
        want = np.asarray(_ref_argset_segments(jnp.asarray(cols[o]), jnp.asarray(cols[j]),
                                               jnp.asarray(alive), seg, m, init))[: int(first.sum())]
        g = got["seg_comps"][j].numpy()[first]
        if g.dtype == np.float64:
            np.testing.assert_array_equal(g.view(np.int64), want.view(np.int64))
            assert not (np.signbit(g) & (g == 0)).any()  # a -0.0 payload sums to +0.0
        else:
            np.testing.assert_array_equal(g, want)
    assert sess.session_merge.mode_launches["argset"] == 0  # CPU tensors: the twin, uncounted
    return first
