"""The session step's twins (``ops/session.py``, K1's session mode) against
the JAX code, on targeted cases.

Each case crafts a store and a payload by hand and runs the reference's
``post_session_exchange(state, payload)`` beside the port's
``post_session_exchange(payload)`` on the same numpy arrays; the new state
(every slot, the dump slot included) and every emit lane must be equal bit
for bit.  The cases: key hashes among and on the dead items' sentinels
(2^62 + item index), repeated and inactive rows of a key (``first_occ``),
a dump slot full of data (masked lanes carry it), expired stored sessions
under a GRACE PERIOD (they stay occupied), float segment min/max/sum with
-0.0 and NaN, and the ``sess_ovf`` restart.  Then the twins alone against
``jnp.lexsort``, the reference's late-drop clock and its hash.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.ops.hash_store import combine_hash as ref_combine_hash
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import session as sess
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.test_torch_join import _same_bits
from tests.test_torch_session import (BENCH, DDL, DOUBLES, D_DDL, GRACE, PV_DDL, SQL,
                                      build_pair)
from tests.torch_kernel_cases import WRITE_CASES, write_case, write_torch

jax.config.update("jax_enable_x64", True)
I64 = np.iinfo(np.int64)


def _store(ref_q, sessions, dump=None):
    """The query's empty store with ``sessions`` inserted: (khash, rank,
    start, end, key repr, component values) each; ``dump`` fills the dump
    slot's sess_start, sess_end, key0 and a<j> with junk."""
    st = {k: np.array(v) for k, v in jax.device_get(ref_q.init_state()).items()}
    cap = ref_q.store_capacity
    if sessions:
        kh = np.array([s[0] for s in sessions], np.int64)
        rank = np.array([s[1] for s in sessions], np.int64)
        slots = hs.host_insert(st["occ"], st["khash"], st["wstart"], cap, kh, rank)
        for slot, (_kh, _r, start, end, key, comps) in zip(slots, sessions):
            st["sess_start"][slot], st["sess_end"][slot], st["key0"][slot] = start, end, key
            for j, v in enumerate(comps):
                st[f"a{j}"][slot] = v
    if dump is not None:
        st["sess_start"][cap], st["sess_end"][cap], st["key0"][cap] = dump, dump + 7, dump + 11
        for j in range(len(ref_q.store_layout.components)):
            st[f"a{j}"][cap] = np.asarray(dump % 1000 + j).astype(st[f"a{j}"].dtype)
    st["max_ts"] = np.asarray(max(s[3] for s in sessions) if sessions else I64.min, np.int64)
    return st


def run_post(ddl, sql, state, khash, ts, active, reprs, contribs, slots, store=32):
    """Both queries' post_session_exchange on the same arrays, compared bit
    for bit; returns the reference's emits and the port's query (None when
    the reference ran out of session slots: the port would restart)."""
    ref_q, q = build_pair(ddl, sql, capacity=len(ts), store=store, slots=slots)
    khash, ts = np.asarray(khash, np.int64), np.asarray(ts, np.int64)
    active, reprs = np.asarray(active, bool), np.asarray(reprs, np.int64)
    row_valid = np.ones(len(ts), bool)
    cm = np.maximum(np.maximum.accumulate(np.where(row_valid, ts, I64.min)), state["max_ts"])
    payload = {"khash": jnp.asarray(khash), "ts": jnp.asarray(ts), "active": jnp.asarray(active),
               "cm": jnp.asarray(cm), "repr0": jnp.asarray(reprs)}
    for j, c in enumerate(contribs):
        payload[f"c{j}"] = jnp.asarray(c)
    want_state, want = ref_q.post_session_exchange({k: jnp.asarray(v) for k, v in state.items()},
                                                   payload)
    if int(want["sess_ovf"]) > 0:
        return want, None
    q.state = state_from_numpy(state, "cpu")
    t = torch.from_numpy
    bst = max(int(state["max_ts"]), int(cm.max()))
    batch_max = int(np.where(active, ts, I64.min).max())
    got = q.post_session_exchange({
        "khash": t(khash), "ts": t(ts), "active": t(active),
        "scal": torch.tensor([bst, batch_max]), "reprs": t(reprs).reshape(1, -1),
        "contribs": [t(np.asarray(c)) for c in contribs],
    })
    got_state = state_to_numpy(q.state)
    assert set(got_state) == set(want_state)
    for k, v in jax.device_get(want_state).items():
        _same_bits(got_state[k], np.asarray(v), f"state {k}")
    assert set(got) == set(want)
    for k in want:
        _same_bits(got[k].numpy(), np.asarray(want[k]), f"lane {k}")
    return want, q


def _count_contribs(ts, active, v=None):
    """COUNT/SUM/MIN of test_device_session's query: ts watermark, count,
    sum(V), min(V) value and its present bit."""
    ts, active = np.asarray(ts, np.int64), np.asarray(active, bool)
    v = np.arange(len(ts), dtype=np.int64) + 3 if v is None else np.asarray(v, np.int64)
    return [np.where(active, ts, I64.min), active.astype(np.int64), np.where(active, v, 0),
            np.where(active, v, I64.max), active.astype(np.int32)]


def _stored(kh, rank, start, end, key, cnt=2):
    return (kh, rank, start, end, key, [end, cnt, 10 * cnt, -cnt, 1])


@pytest.mark.parametrize("case", ["clean", "on_sentinel", "above_all"])
def test_dead_item_sentinels_interleave_with_real_hashes(case):
    n = 8
    m = n * 3
    base = sess.SENTINEL
    # key hashes inside the sentinel range 2^62 + [0, m): row 0's own index
    # (row 0 is alive, so no dead item holds it), a dead store item's
    # index (that dead item then shares the key's run), and above all
    hot = {"clean": base + 0, "on_sentinel": base + n + 3, "above_all": base + 10 * m}[case]
    khash = [hot, hot, -5, I64.max, hot, 7, -5, base + 2]
    ts = [50_000, 52_000, 1000, 2000, 80_000, 3000, 30_000, 4000]
    active = [True, True, True, True, True, True, True, False]
    ref_q, _ = build_pair(DDL, SQL, capacity=n, store=32, slots=2)
    st = _store(ref_q, [_stored(hot, 0, 40_000, 45_000, 11),
                        _stored(-5, 0, 12_000, 20_000, 12),
                        _stored(I64.max, 1, 100, 150, 13)], dump=991)
    # on a sentinel, that dead item opens the key's run as a segment of its
    # own and pushes the key's sessions to ranks 1 and 2: 4 slots
    want, q = run_post(DDL, SQL, st, khash, ts, active, [11, 11, 12, 13, 11, 14, 12, 15],
                       _count_contribs(ts, active), slots=4)
    assert q is not None and int(np.asarray(want["emit_mask"]).sum()) > 5


def test_first_occurrence_and_dump_slot_data():
    # key 7 in rows 0, 2, 5 (row 2 inactive): only row 0 gathers the stored
    # sessions; every other store item reads the dump slot, whose junk
    # rides in the masked lanes
    khash = [7, 8, 7, 9, 8, 7]
    ts = [10_000, 11_000, 12_000, 13_000, 14_000, 90_000]
    active = [True, True, False, True, True, True]
    ref_q, _ = build_pair(DDL, SQL, capacity=6, store=32, slots=4)
    st = _store(ref_q, [_stored(7, 0, 1000, 5000, 70), _stored(7, 1, 30_000, 31_000, 70),
                        _stored(7, 2, 60_000, 70_000, 70), _stored(9, 0, 0, 100, 90)],
                dump=123_456)
    st["grave"][3] = True  # a grave in a probe chain is walked past
    want, q = run_post(DDL, SQL, st, khash, ts, active, [70, 80, 70, 90, 80, 70],
                       _count_contribs(ts, active), slots=4)
    assert q is not None
    # the masked tombstone lanes of non-first rows carry the dump slot's key
    # (dead items zero their start and end, not their key or components)
    assert 123_456 + 11 in np.asarray(want["v_ID"])


def test_expired_sessions_stay_until_overwritten():
    # key 5's rank-1 session ended gap + grace (15 s) before the batch's
    # stream time (50 s): it no longer merges, is not deleted and leaves no
    # tombstone; its rank-0 session merges with two rows, is deleted
    # (tombstone) and comes back at rank 0 in the grave K2 reclaims
    ref_q, _ = build_pair(DDL, GRACE, capacity=4, store=32, slots=2)
    st = _store(ref_q, [_stored(5, 0, 40_000, 41_000, 50), _stored(5, 1, 1000, 2000, 50)])
    ts = [41_500, 3000, 50_000, 45_000]
    active = [True, False, True, True]
    want, q = run_post(DDL, GRACE, st, [5, 5, 6, 5], ts, active, [50, 50, 60, 50],
                       _count_contribs(ts, active), slots=2)
    tomb = np.asarray(want["tombstone"]) & np.asarray(want["emit_mask"])
    assert np.asarray(want["ws"])[tomb].tolist() == [40_000]
    assert int(q.state["occ"].sum()) == 3 and int(q.state["grave"].sum()) == 0


def test_float_segment_folds_follow_xla():
    ref_q, _ = build_pair(D_DDL, DOUBLES, capacity=8, store=32, slots=2)
    nan = float("nan")
    d = np.array([-0.0, 0.0, nan, -0.0, 1.5, 0.0, -2.0, nan])
    ts = [1000, 1500, 2000, 9000, 60_000, 61_000, 62_000, 63_000]
    active = np.ones(8, bool)
    present = np.array([True, True, True, True, True, True, False, True])
    ok = active & present
    contribs = [np.asarray(ts, np.int64),
                np.where(ok, d, 0.0),  # SUM(D)
                np.where(ok, d, np.inf), ok.astype(np.int32),  # MIN(D)
                np.where(ok, d, -np.inf), ok.astype(np.int32),  # MAX(D)
                ok.astype(np.int64)]  # COUNT(D)
    # a stored session of key 1 with -0.0 / +0.0 folds, and one with NaN
    st = _store(ref_q, [(1, 0, 500, 800, 1, [800, -0.0, -0.0, 1, 0.0, 1, 2]),
                        (2, 0, 58_000, 59_000, 2, [59_000, nan, 0.0, 1, nan, 1, 1])])
    want, q = run_post(D_DDL, DOUBLES, st, [1, 1, 1, 1, 2, 2, 2, 2], ts, active,
                       [1, 1, 1, 1, 2, 2, 2, 2], contribs, slots=2)
    assert q is not None


def test_restart_on_session_overflow_equals_reference_at_doubled_slots():
    ts = [1000, 100_000, 200_000, 300_000, 400_000]
    active = [True] * 5
    ref_q, _ = build_pair(DDL, SQL, capacity=5, store=32, slots=2)
    st = _store(ref_q, [_stored(3, 0, 50_000, 50_000, 30), _stored(3, 1, 150_000, 150_000, 30)])
    args = (st, [3] * 5, ts, active, [30] * 5, _count_contribs(ts, active))
    want_ovf, none = run_post(DDL, SQL, *args, slots=2)
    assert none is None and int(want_ovf["sess_ovf"]) == 5  # 7 sessions, 2 slots
    want, _q = run_post(DDL, SQL, *args, slots=8)  # the reference re-run at 8 slots
    # the port starts at 2 slots and doubles twice before it writes
    ref_q, q = build_pair(DDL, SQL, capacity=5, store=32, slots=2)
    q.state = state_from_numpy(st, "cpu")
    t = torch.from_numpy
    got = q.post_session_exchange({
        "khash": torch.full((5,), 3), "ts": t(np.asarray(ts)), "active": torch.ones(5, dtype=torch.bool),
        "scal": torch.tensor([400_000, 400_000]), "reprs": torch.full((1, 5), 30),
        "contribs": [t(c) for c in _count_contribs(ts, active)]})
    assert (q.session_slots, q.session_grows) == (8, 2)
    for k in want:
        _same_bits(got[k].numpy(), np.asarray(want[k]), f"lane {k}")


def test_bench_plan_post_exchange_equals_reference():
    rng = np.random.default_rng(4)
    n = 16
    ref_q, _ = build_pair(PV_DDL, BENCH, capacity=n, store=64, slots=4)
    urls = rng.integers(I64.min, I64.max, 5)
    khash = ref_combine_hash([jnp.asarray(urls), jnp.zeros(5, jnp.int64)])
    khash = np.asarray(khash)
    pick = rng.integers(0, 5, n)
    ts = 1_000_000 + np.sort(rng.integers(0, 200_000, n))
    active = rng.random(n) > 0.1
    st = _store(ref_q, [(int(khash[i]), r, 900_000 + 40_000 * r, 910_000 + 40_000 * r, int(urls[i]),
                         [910_000 + 40_000 * r, 3]) for i in range(5) for r in range(2)])
    contribs = [np.where(active, ts, I64.min), active.astype(np.int64)]
    _want, q = run_post(PV_DDL, BENCH, st, khash[pick], ts, active, urls[pick], contribs, slots=4,
                        store=64)
    assert q is not None


#: runs of one key across K15's tiles of sorted positions (1,024, or 512
#: or 256 for a query too wide for that tile): (rows,
#: positions that open a session, the query); the key's hash is the
#: lowest, so its run starts at position 0 and run positions are tile
#: positions
_BREAKS = np.arange(0, 1025, 37)
LONG_RUNS = {
    **{f"run{n}": (n, _BREAKS[_BREAKS < n], "src") for n in (63, 64, 65, 255, 256, 257, 513, 1025)},
    "spans_tiles": (600, np.array([0]), "src"),
    "opens_at_tile_edges": (600, np.array([0, 256, 512]), "src"),
    "float_sum_in_item_order": (600, np.array([0]), "doubles"),
}


@pytest.mark.parametrize("case", list(LONG_RUNS))
def test_long_runs_across_tiles_equal_reference(case):
    """K15's schedule cuts a run into tiles of sorted positions: runs one
    position short of, at and past a tile, a session that spans tiles,
    sessions that open exactly at a tile edge, and a float64 SUM of 1e16,
    1.0, -1e16 repeated, whose item-order bits differ from a tree sum.
    The twin against the reference's post_session_exchange."""
    n, breaks, query = LONG_RUNS[case]
    step = np.full(n, 50, np.int64)
    step[breaks] = 20_000  # past the 10 s gap
    ts = (1_000_000 + np.cumsum(step)).tolist()
    khash = [-5] * (n - 2) + [7, I64.max]
    active = [True] * n
    ddl, sql = (DDL, SQL) if query == "src" else (D_DDL, DOUBLES)
    slots = 1 << max(1, (len(breaks) - 1).bit_length())
    ref_q, _ = build_pair(ddl, sql, capacity=n, store=64, slots=slots)
    st = _store(ref_q, [])
    if query == "src":
        contribs = _count_contribs(ts, active)
    else:
        d = np.tile([1e16, 1.0, -1e16], n)[:n]
        contribs = [np.asarray(ts, np.int64), d, d, np.ones(n, np.int32), d, np.ones(n, np.int32),
                    np.ones(n, np.int64)]
    want, q = run_post(ddl, sql, st, khash, ts, active, [3] * n, contribs, slots=slots, store=64)
    assert q is not None
    if query == "doubles":
        serial = 0.0
        for v in contribs[1][: n - 2]:
            serial += v
        sums = np.asarray(want["v_SD"])[np.asarray(want["emit_mask"])]
        assert serial in sums.tolist() and serial != float(np.sum(contribs[1][: n - 2]))


def test_winners_past_the_slots_in_a_long_run_equal_reference():
    """60 sessions of one key in a run of 120 rows at 2 slots a key: the
    reference's sess_ovf at 2 slots is the port's first count, and the port
    doubles its slots until they fit and then equals the reference there."""
    n = 120
    step = np.full(n, 50, np.int64)
    step[::2] = 20_000
    ts = (1_000_000 + np.cumsum(step)).tolist()
    active = [True] * n
    ref_q, _ = build_pair(DDL, SQL, capacity=n, store=128, slots=2)
    st = _store(ref_q, [])
    args = (st, [-5] * n, ts, active, [3] * n, _count_contribs(ts, active))
    want_ovf, none = run_post(DDL, SQL, *args, slots=2, store=128)
    assert none is None and int(want_ovf["sess_ovf"]) == 58
    ref_q, q = build_pair(DDL, SQL, capacity=n, store=128, slots=2)
    q.state = state_from_numpy(st, "cpu")
    seen = []
    read = q._read_sess_ovf
    q._read_sess_ovf = lambda merged: seen.append(read(merged)) or seen[-1]
    t = torch.from_numpy
    got = q.post_session_exchange({
        "khash": torch.full((n,), -5), "ts": t(np.asarray(ts)), "active": torch.ones(n, dtype=torch.bool),
        "scal": torch.tensor([max(ts), max(ts)]), "reprs": torch.full((1, n), 3),
        "contribs": [t(c) for c in _count_contribs(ts, active)]})
    assert seen[0] == 58 and seen[-1] == 0 and q.session_slots == 64
    want, _q = run_post(DDL, SQL, *args, slots=64, store=128)
    for k in want:
        _same_bits(got[k].numpy(), np.asarray(want[k]), f"lane {k}")


# ------------------------------------------------------------ twins alone
def _sort_keys(shape):
    """K13's inputs by case: ``mixed<n>`` int64 extremes and small ties,
    ``equal`` every key pair the same, ``k1_as_k2`` one tensor passed
    twice (``vector.py``'s ``seg_sort(eff, eff)``), ``sentinels`` the
    session items' key hashes among the dead items' 2^62 + index."""
    rng = np.random.default_rng(0)
    if shape.startswith("mixed"):
        n = int(shape[5:])
        return rng.choice(np.array([I64.min, -1, 0, 1, 1 << 62, I64.max]), n), rng.integers(-3, 3, n)
    if shape == "equal":
        return np.full(4096, 7, np.int64), np.full(4096, -7, np.int64)
    if shape == "k1_as_k2":
        k = rng.integers(0, 300, 4096)
        return k, k
    n = 8193
    k1 = (1 << 62) + np.arange(n, dtype=np.int64)
    live = rng.random(n) < 0.3
    k1[live] = rng.choice(np.array([I64.min, I64.max, (1 << 62) + 5, 1 << 62, 42]), int(live.sum()))
    return k1, rng.integers(I64.min, I64.max, n, dtype=np.int64)


@pytest.mark.parametrize("shape", ["mixed1", "mixed255", "mixed256", "mixed257", "mixed500", "mixed4096",
                                   "mixed8192", "mixed8193", "equal", "k1_as_k2", "sentinels"])
def test_seg_sort_twin_equals_lexsort(shape):
    # tolerance: exact (the permutation; equal key pairs keep index order)
    k1, k2 = _sort_keys(shape)
    same = k2 is k1
    t1 = torch.from_numpy(k1)
    got = sess.seg_sort_plain(t1, t1 if same else torch.from_numpy(k2)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.lexsort((jnp.asarray(k2), jnp.asarray(k1)))))
    assert got.dtype == np.int32


def test_session_prologue_twin_equals_reference_clock():
    rng = np.random.default_rng(1)
    n = 64
    ts = 1_000_000 + np.cumsum(rng.integers(0, 2000, n)) - np.where(rng.random(n) < 0.2, 40_000, 0)
    row_valid = rng.random(n) > 0.1
    active = row_valid & (rng.random(n) > 0.1)
    max_ts = 1_010_000
    grace, gap = 5000, 10_000
    cm = np.maximum(np.maximum.accumulate(np.where(row_valid, ts, I64.min)), max_ts)
    want = active & (ts + grace + gap >= cm)
    t = torch.from_numpy
    act, scal = sess.session_prologue(t(row_valid), t(ts), t(active), torch.tensor(max_ts), grace, gap)
    np.testing.assert_array_equal(act.numpy(), want)
    assert scal.tolist() == [max(max_ts, int(cm.max())), int(np.where(want, ts, I64.min).max())]
    assert 0 < int(want.sum()) < int(active.sum())


def test_session_mode_hash_equals_reference():
    rng = np.random.default_rng(2)
    reprs = rng.integers(I64.min, I64.max, (2, 50))
    valid = rng.random((2, 50)) > 0.2
    active = rng.random(50) > 0.1
    act, khash = hs.session_prologue(torch.from_numpy(reprs), torch.from_numpy(valid),
                                     torch.from_numpy(active))
    want = ref_combine_hash([jnp.asarray(reprs[0]), jnp.asarray(reprs[1]), jnp.zeros(50, jnp.int64)])
    np.testing.assert_array_equal(khash.numpy(), np.asarray(want))
    np.testing.assert_array_equal(act.numpy(), active & valid.all(0))


# ------------------------------------------------- K16's write mode alone
@jax.jit
def _reference_write(store, merged, ins, scal):
    """The store writes and emission lanes of the reference's
    ``post_session_exchange`` (``ksql_tpu/runtime/lowering.py:3715-3799``)
    written out in jax, on K16's inputs: ``seg`` is ``segfirst``,
    ``del_mask`` the alive stored-session items, ``batch_max`` ``scal[1]``."""
    state = dict(store)
    cap = store["dirty"].shape[0] - 1
    seg = merged["segfirst"]
    tgt_ins = jnp.where(merged["ins_act"], ins, jnp.int32(cap))
    state["sess_start"] = state["sess_start"].at[tgt_ins].set(merged["seg_start"][seg])
    state["sess_end"] = state["sess_end"].at[tgt_ins].set(merged["seg_end"][seg])
    for j, sc in enumerate(merged["seg_comps"]):
        col = state[f"a{j}"]
        state[f"a{j}"] = col.at[tgt_ins].set(sc[seg].astype(col.dtype))
    state["dirty"] = state["dirty"].at[tgt_ins].set(True).at[cap].set(False)
    state["max_ts"] = jnp.maximum(state["max_ts"], scal[1])
    del_mask = ~merged["isrow"] & merged["alive"]
    tomb = del_mask & merged["seg_has_row"][seg]
    emit_seg = merged["winner"] & merged["seg_has_row"][seg]
    m = seg.shape[0]
    big = jnp.int64(I64.max)
    ord_row = jnp.where(merged["seg_minrow"][seg] == big, 0, merged["seg_minrow"][seg])
    lanes = {
        "mask": jnp.concatenate([tomb, emit_seg]),
        "keys": [jnp.concatenate([r, s[seg]]) for r, s in zip(merged["reprs"], merged["seg_reprs"])],
        "comps": [jnp.concatenate([c, s[seg]]) for c, s in zip(merged["comps"], merged["seg_comps"])],
        "ws": jnp.concatenate([merged["start"], merged["seg_start"][seg]]),
        "we": jnp.concatenate([merged["end"], merged["seg_end"][seg]]),
        "tombstone": jnp.concatenate([jnp.ones(m, bool), jnp.zeros(m, bool)]),
        "ord_a": jnp.concatenate([ord_row, ord_row]),
        "ord_b": jnp.concatenate([merged["start"], jnp.full(m, big, jnp.int64)]),
    }
    return state, lanes


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_session_write_twin_equals_reference(case):
    # tolerance: exact (every lane, the whole store with its dump slot,
    # float64 compared as bits)
    m, kind, sizes, k = WRITE_CASES[case]
    store, merged, ins, scal = write_case(m, kind, sizes, k, seed=m)
    cap = store["dirty"].shape[0] - 1
    jm = {key: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
          for key, v in merged.items()}
    want_state, want_lanes = _reference_write({key: jnp.asarray(v) for key, v in store.items()}, jm,
                                              jnp.asarray(ins), jnp.asarray(scal))
    st, pm, pins, pscal = write_torch(store, merged, ins, scal)
    lanes = sess.session_write(st, cap, pm, pins, pscal)  # CPU tensors: the twin
    for key, w in want_state.items():
        _same_bits(st[key].numpy(), np.asarray(w), f"store {key}")
    for key, w in want_lanes.items():
        if isinstance(w, list):
            assert len(lanes[key]) == len(w)
            for j, (g, x) in enumerate(zip(lanes[key], w)):
                _same_bits(g.numpy(), np.asarray(x), f"lane {key}[{j}]")
        else:
            _same_bits(lanes[key].numpy(), np.asarray(w), f"lane {key}")
    aimed = ~merged["ins_act"] | (ins == cap)
    if kind == "none":
        assert not aimed.any()
    if kind in ("all", "last"):
        assert aimed[-1] and aimed.sum() == (m if kind == "all" else 1)
