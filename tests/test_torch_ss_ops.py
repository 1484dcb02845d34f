"""The stream-stream join kernels' plain twins against the JAX expressions.

Each case builds one state (both rings, as numpy), loads it into the
reference ``CompiledDeviceQuery`` and into ``TorchCompiledQuery`` on the
CPU, runs one step of each (``_trace_ss_step`` against the port's
``_ss_prepare`` + ``_ss_write``, which call K10's and K11's twins;
``_trace_ss_expire`` against ``_ss_expire``, K12's twin) and requires
every emit lane and the whole state after it, dump entries included, to
be equal.  The cases aim at the traps: inclusive window edges on both
sides, null keys in rows and ring entries, truncation at the match-lane
capacity (the twin alone: the port grows first), a cursor that wraps the
ring, the overwrite loss, late rows cut by admission (and the dump entry
they write), pads of windows closed on arrival, and the expiry in eager
and deferred mode with each key type's decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.test_torch_join import _pschema
from tests.test_torch_ss_join import BENCH_DDL, BENCH_SS, build_pair

jax.config.update("jax_enable_x64", True)

T0 = 1_700_000_000_000
# WITHIN (2 SECONDS, 5 SECONDS): before 2 s, after 5 s, so each side's
# window edges differ
ASYM = ("CREATE STREAM J AS SELECT L.ID, L.V AS LV, R.V AS RV FROM LEFTS L "
        "LEFT JOIN RIGHTS R WITHIN (2 SECONDS, 5 SECONDS) GRACE PERIOD 1 SECOND "
        "ON L.ID = R.ID EMIT CHANGES;")
OUTER_EAGER = ("CREATE STREAM J AS SELECT ROWKEY AS ID, L.V AS LV, R.V AS RV FROM LEFTS L "
               "FULL OUTER JOIN RIGHTS R WITHIN 10 SECONDS ON L.ID = R.ID EMIT CHANGES;")
OUTER_GRACE = ("CREATE STREAM J AS SELECT ROWKEY AS ID, L.V AS LV, R.V AS RV FROM LEFTS L "
               "FULL OUTER JOIN RIGHTS R WITHIN 10 SECONDS GRACE PERIOD 3 SECONDS "
               "ON L.ID = R.ID EMIT CHANGES;")


def key_ddl(key_type):
    return tuple(d.replace("ID BIGINT KEY", f"ID {key_type} KEY") for d in BENCH_DDL)


def base_state(port_q):
    return state_to_numpy(port_q.init_state("cpu"))


def fill_ring(st, side, ts, keys, kval=None, live=None, matched=None, seq0=0, at=0, values=None):
    """Entries ``at``.. of one ring: ``ts``, key reprs ``keys``, and
    optional kval/live/matched (default True, True, False); seq from
    ``seq0``; ``ss{side}_v_*`` from ``values`` (default: the key)."""
    k = len(ts)
    sl = slice(at, at + k)
    st[f"ss{side}_ts"][sl] = ts
    st[f"ss{side}_krepr"][sl] = keys
    st[f"ss{side}_kval"][sl] = True if kval is None else kval
    st[f"ss{side}_live"][sl] = True if live is None else live
    st[f"ss{side}_matched"][sl] = False if matched is None else matched
    st[f"ss{side}_seq"][sl] = seq0 + np.arange(k)
    for name in st:
        if name.startswith(f"ss{side}_v_"):
            st[name][sl] = np.asarray(keys if values is None else values).astype(st[name].dtype)
            st[name.replace("_v_", "_m_")][sl] = True


def step_both(ref_q, port_q, st, side, rows, ts, oc=None):
    """One ``side`` batch through both on state ``st``: emit lanes and the
    new state must be equal.  Returns (reference emits, port state)."""
    if oc is not None:
        ref_q.ss_out_cap = port_q.ss_out_cap = oc
    src = ref_q.source if side == "l" else ref_q.right_source
    rlay = ref_q.layout if side == "l" else ref_q.right_layout
    play = port_q.layout if side == "l" else port_q.right_layout
    arrays = rlay.encode(RHostBatch.from_rows(src.schema, rows, timestamps=ts))
    ref_state, ref_emits = ref_q._trace_ss_step(side, {k: jnp.asarray(v) for k, v in st.items()},
                                                arrays)
    port_q.state = state_from_numpy(st, "cpu")
    parr = port_q.upload(play.encode(PHostBatch.from_rows(_pschema(src.schema), rows, timestamps=ts)))
    emits = port_q._ss_write(side, parr, port_q._ss_prepare(side, parr))
    assert_same(ref_emits, emits, "emits")
    assert_same(ref_state, port_q.state, "state")
    return {k: np.asarray(v) for k, v in ref_emits.items()}, state_to_numpy(port_q.state)


def expire_both(ref_q, port_q, st):
    ref_state, ref_emits = ref_q._trace_ss_expire({k: jnp.asarray(v) for k, v in st.items()})
    port_q.state = state_from_numpy(st, "cpu")
    emits = port_q._ss_expire()
    assert_same(ref_emits, emits, "emits")
    assert_same(ref_state, port_q.state, "state")
    return {k: np.asarray(v) for k, v in ref_emits.items()}


def assert_same(want, got, what):
    want = {k: np.asarray(v) for k, v in want.items()}
    got = state_to_numpy(got)
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("side", ["l", "r"])
def test_window_edges_are_inclusive_on_each_side(side):
    ref_q, port_q = build_pair(BENCH_DDL, ASYM, capacity=4, buffer=16, out_cap=64)
    st = base_state(port_q)
    other = "r" if side == "l" else "l"
    t = T0 + 50_000
    # left row at t takes right ts in [t-2000, t+5000]; right row at t takes
    # left ts in [t-5000, t+2000]
    lo, hi = (-2000, 5000) if side == "l" else (-5000, 2000)
    offsets = [lo - 1, lo, 0, hi, hi + 1, lo, hi]
    fill_ring(st, other, [t + o for o in offsets], [7, 7, 7, 7, 7, 8, 8])
    st["max_ts"] = np.asarray(t, np.int64)
    emits, _ = step_both(ref_q, port_q, st, side, [{"ID": 7, "V": 1}, {"ID": 8, "V": 2}], [t, t])
    matched_j = sorted(emits["ord_b"][: 64][emits["emit_mask"][:64]].tolist())
    assert matched_j == [1, 2, 3, 5, 6], "the five entries on or inside the edges"


def test_null_keys_never_match_and_outer_rows_pad_with_their_key():
    ref_q, port_q = build_pair(BENCH_DDL, OUTER_EAGER, capacity=4, buffer=16, out_cap=64)
    st = base_state(port_q)
    # right entries: key 0 valid, key 0 null (krepr 0 like a null), key 3
    fill_ring(st, "r", [T0, T0, T0], [0, 0, 3], kval=[True, False, True])
    rows = [{"ID": None, "V": 1}, {"ID": 0, "V": 2}, {"ID": 3, "V": 3}, {"ID": 5, "V": 4}]
    emits, after = step_both(ref_q, port_q, st, "l", rows, [T0 + 1] * 4)
    oc = 64
    assert emits["emit_mask"][:oc].sum() == 2  # key 0 (valid entry) and key 3
    # the null-key row and key 5 pad eagerly (OUTER, no GRACE)
    assert emits["emit_mask"][oc:].tolist() == [True, False, False, True]
    assert after["ssr_matched"][:3].tolist() == [True, False, True]


def test_matches_past_the_lane_capacity_are_cut_like_nonzero():
    ref_q, port_q = build_pair(BENCH_DDL, BENCH_SS, capacity=4, buffer=16, out_cap=4)
    st = base_state(port_q)
    fill_ring(st, "r", [T0 + i for i in range(6)], [1] * 3 + [2] * 3)
    rows = [{"ID": 1, "V": 1}, {"ID": 2, "V": 2}, {"ID": 1, "V": 3}, {"ID": 9, "V": 4}]
    emits, after = step_both(ref_q, port_q, st, "l", rows, [T0 + 10] * 4, oc=4)
    assert int(emits["ss_matchovf"]) == 5  # 9 matches, 4 lanes
    assert emits["emit_mask"][:4].all()
    # every match marks its entry, the cut ones included
    assert after["ssr_matched"][:6].all()


#: K10's ring-tile edges (the kernel tests 512-entry tiles): per case the
#: ring capacity B (B + 1 entries, never a multiple of the tile), the
#: lanes, and per row its key and the ring entries holding that key, all
#: inside the row's window
TILE_EDGES = {
    "straddle": (2048, 4096, [(1, range(1000, 1100)), (2, [5, 2047]), (3, [])]),
    "whole_tile": (2048, 4096, [(4, range(1024, 2048)), (5, [3, 1023])]),
    "ragged_end": (1500, 4096, [(6, range(1490, 1500)), (7, [0, 1489])]),
    "cut_in_tile": (2048, 50, [(1, range(1000, 1101)), (2, [1200, 1201])]),
}


@pytest.mark.parametrize("case", list(TILE_EDGES))
def test_match_counts_and_lanes_at_ring_tile_edges(case):
    # tolerance: exact.  The count's (cnt, row_matched, offsets, total)
    # against the reference step's match lanes (rows in order, each row's
    # entries in entry order; the total is its lanes plus ss_matchovf),
    # then the whole step, lanes and state, against the reference
    import torch

    B, oc, plan = TILE_EDGES[case]
    ref_q, port_q = build_pair(BENCH_DDL, BENCH_SS, capacity=4, buffer=B, out_cap=oc)
    st = base_state(port_q)
    t = T0 + 50_000
    keys = np.full(B, 999)  # no row has key 999
    for key, entries in plan:
        keys[list(entries)] = key
    fill_ring(st, "r", t - 9_000 + np.arange(B) * 4, keys)
    st["max_ts"] = np.asarray(t, np.int64)
    rows = [{"ID": key, "V": i} for i, (key, _e) in enumerate(plan)]
    ts = [t] * len(rows)
    port_q.state = state_from_numpy(st, "cpu")
    parr = port_q.upload(port_q.layout.encode(PHostBatch.from_rows(
        _pschema(ref_q.source.schema), rows, timestamps=ts)))
    cnt, row_matched, offsets, total = port_q._ss_prepare("l", parr)["count"]
    emits, after = step_both(ref_q, port_q, st, "l", rows, ts)
    want_cnt = np.array([len(e) for _k, e in plan] + [0] * (4 - len(plan)))
    mi = emits["ord_a"][:oc][emits["emit_mask"][:oc]]
    assert int(total) == len(mi) + int(emits["ss_matchovf"]) == want_cnt.sum()
    if int(emits["ss_matchovf"]) == 0:
        np.testing.assert_array_equal(np.bincount(mi, minlength=4), want_cnt)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(row_matched.numpy(), want_cnt > 0)
    np.testing.assert_array_equal(offsets.numpy(), np.cumsum(want_cnt) - want_cnt)
    assert cnt.dtype == offsets.dtype == total.dtype == torch.int64
    # every match marks its entry, the cut ones included
    hit = np.zeros(B + 1, bool)
    for _key, entries in plan:
        hit[list(entries)] = True
    np.testing.assert_array_equal(after["ssr_matched"], hit)


@pytest.mark.parametrize("unexpired", [False, True], ids=["expired", "live"])
def test_cursor_wrap_and_overwrite_loss(unexpired):
    ref_q, port_q = build_pair(BENCH_DDL, BENCH_SS, capacity=8, buffer=8, out_cap=64)
    st = base_state(port_q)
    # left ring of B = 8, entries 0..5 hold seq 0..5; the cursor at 6
    old = T0 + (30_000 if unexpired else 0)
    fill_ring(st, "l", [old + i for i in range(6)], [1, 2, 3, 4, 5, 6])
    st["ssl_cursor"] = np.asarray(6, np.int64)
    st["ssl_smax"] = np.asarray(old + 5, np.int64)
    st["max_ts"] = np.asarray(old + 5, np.int64)
    t = T0 + 40_000  # 21 s retention: entries at T0 expired, at T0 + 30 s not
    rows = [{"ID": 10 + i, "V": i} for i in range(5)]
    emits, after = step_both(ref_q, port_q, st, "l", rows, [t + i for i in range(5)])
    assert int(emits["ss_lost"]) == (3 if unexpired else 0)  # targets 6, 7, 0, 1, 2
    assert after["ssl_seq"][[6, 7, 0, 1, 2]].tolist() == [6, 7, 8, 9, 10]
    assert int(after["ssl_cursor"]) == 11


def test_late_rows_are_not_admitted_and_the_last_writes_the_dump_entry():
    ref_q, port_q = build_pair(BENCH_DDL, BENCH_SS, capacity=8, buffer=16, out_cap=64)
    st = base_state(port_q)
    st["ssl_smax"] = np.asarray(T0 + 100_000, np.int64)
    st["max_ts"] = np.asarray(T0 + 100_000, np.int64)
    # retention 21 s: rows before T0 + 79 s are late; the last row is padding
    ts = [T0 + 90_000, T0 + 10_000, T0 + 95_000, T0 + 20_000, T0 + 78_999, T0 + 79_000, T0 + 5]
    rows = [{"ID": i, "V": 100 + i} for i in range(len(ts))]
    emits, after = step_both(ref_q, port_q, st, "l", rows, ts)
    B = port_q.ss_capacity
    assert after["ssl_live"][:4].tolist() == [True, True, True, False]
    assert int(after["ssl_cursor"]) == 3
    # the highest row not admitted (row 6, then the inactive padding rows
    # 7, whose fields are zeros) ends in the dump entry
    assert after["ssl_ts"][B] == 0 and not after["ssl_live"][B]


def test_rows_whose_window_closed_on_arrival_pad_at_once():
    ref_q, port_q = build_pair(BENCH_DDL, BENCH_SS, capacity=4, buffer=16, out_cap=64)
    st = base_state(port_q)
    st["max_ts"] = np.asarray(T0 + 50_000, np.int64)
    st["ssl_smax"] = np.asarray(T0 + 40_000, np.int64)
    # after 10 s + grace 1 s: a row at T0 + 38,999 closed before the clock
    # T0 + 50 s, one at T0 + 39,000 did not
    ts = [T0 + 38_999, T0 + 39_000, T0 + 60_000, T0 + 30_000]
    emits, after = step_both(ref_q, port_q, st, "l", [{"ID": i, "V": i} for i in range(4)], ts)
    assert emits["emit_mask"][64:].tolist() == [True, False, False, True]
    # the last row is late for admission (cm_side T0 + 60 s - 21 s): it pads
    # but is not buffered
    assert after["ssl_matched"][:3].tolist() == [True, False, False]
    assert int(after["ssl_cursor"]) == 3


@pytest.mark.parametrize("query,key_type", [
    (BENCH_SS, "BIGINT"), (OUTER_EAGER, "BIGINT"), (OUTER_GRACE, "BIGINT"),
    (OUTER_GRACE, "INT"), (OUTER_GRACE, "DOUBLE"), (OUTER_GRACE, "STRING"),
], ids=["left_grace", "outer_eager", "outer_grace", "int_key", "double_key", "string_key"])
def test_expiry_matches_reference(query, key_type):
    ref_q, port_q = build_pair(key_ddl(key_type), query, capacity=4, buffer=32, out_cap=64)
    rng = np.random.default_rng(len(query) + len(key_type))
    st = base_state(port_q)
    for side in ("l", "r"):
        k = 30
        keys = rng.integers(-3, 4, k)
        if key_type == "DOUBLE":
            keys = rng.standard_normal(k).view(np.int64)
        elif key_type == "INT":
            keys = rng.integers(-2**31, 2**31, k)
        fill_ring(st, side, T0 + rng.integers(0, 60_000, k), keys, kval=rng.random(k) > 0.1,
                  live=rng.random(k) > 0.2, matched=rng.random(k) > 0.6,
                  seq0=int(rng.integers(0, 1000)), at=1, values=rng.integers(-99, 99, k))
        st[f"ss{side}_smax"] = np.asarray(T0 + 60_000, np.int64)
    st["max_ts"] = np.asarray(T0 + 45_000, np.int64)
    emits = expire_both(ref_q, port_q, st)
    deferred = "GRACE" in query
    assert bool(emits["emit_mask"].any()) == deferred
