"""The EMIT FINAL and HAVING twins (``ops/suppress.py``: K17, K18, K19) and
K4's suppress mode against the JAX code, on targeted cases.

Each case crafts a store by hand (from the reference's ``init_state``) and
a micro-batch, and runs the reference's device step (``_step``: its
``pre_exchange`` suppress lanes, the suppress branch of ``post_exchange``
or the hpass branch of ``_emit_agg``), retention pass (``_evict``) or
``flush`` beside the port's on the same arrays; the new state (every slot,
the dump slot included) and every emit lane must be equal bit for bit.
The cases: a batch of padding only (the emission clock stays INT64_MIN);
a stream time that lands exactly on a window's close (inclusive) and one
just past its horizon (evicted unemitted); a late record in grace that
re-dirties an emitted window, which neither the next batches nor the
flush emit again; the expansion route's lanes, whose running maximum runs
over the tiled lanes; the dump slot's ``born`` (overflowed lanes) and
``hpass`` (the highest lane aimed at it); K4's suppress mode on a store of
every flag combination at the retention boundary.  Then the twins alone:
K17's emission clock is non-decreasing, so K18's sort is the identity;
K17's and K18's twins against the reference's lines written out in jax
over ``tests/torch_kernel_cases.py``'s CLOCK_CASES and CLOSE_CASES, and
that copy of K18's lines against the reference's own step on batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import suppress as sup
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.state import state_from_numpy
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from tests.test_torch_lowering import (DDL, HOUR, _as_tuples, _capture, assert_same_lanes,
                                       assert_same_state, plan_for)
from tests.torch_kernel_cases import CLOCK_CASES, CLOSE_CASES, clock_case, close_case

jax.config.update("jax_enable_x64", True)
I64 = np.iinfo(np.int64)
MIN = 60_000
H0 = 1_700_000_000_000 - 1_700_000_000_000 % HOUR  # an hour boundary

FINAL_GRACE = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT, SUM(LATENCY) AS S FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 10 MINUTES) GROUP BY URL EMIT FINAL;"
)
#: a horizon past the close: windows stay emittable for 2 h after it
FINAL_RETAINED = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR, RETENTION 4 HOURS, GRACE PERIOD 10 MINUTES) "
    "GROUP BY URL EMIT FINAL;"
)
HOP_FINAL = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT, MIN(LATENCY) AS MN FROM PAGE_VIEWS "
    "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 20 MINUTES, GRACE PERIOD 5 MINUTES) "
    "GROUP BY URL EMIT FINAL;"
)
HAVING = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT, AVG(LATENCY) AS A FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL HAVING AVG(LATENCY) > 100;"
)


class Pair:
    """The reference's and the port's query of one plan, with their emit
    lanes captured."""

    def __init__(self, sql, capacity=8, store=16):
        engine, plan, schema = plan_for(DDL, sql)
        self.ref = CompiledDeviceQuery(plan, engine.registry, capacity=capacity,
                                       store_capacity=store)
        self.port = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=capacity,
                                       store_capacity=store, device="cpu")
        self.schema = schema
        self.pschema = LogicalSchema.from_json(schema.to_json())
        self.ref_lanes, self.port_lanes = [], []
        _capture(self.ref, self.ref_lanes)
        _capture(self.port, self.port_lanes)

    def state(self):
        return {k: np.array(v) for k, v in jax.device_get(self.ref.state).items()}

    def set_state(self, st):
        self.ref.state = {k: jax.numpy.asarray(v) for k, v in st.items()}
        self.port.state = state_from_numpy(st, "cpu")
        self.port.dictionary._map.update(self.ref.dictionary._map)

    def encode(self, rows, ts):
        arrays = self.ref.layout.encode(RHostBatch.from_rows(self.schema, rows, timestamps=ts))
        got = self.port.layout.encode(PHostBatch.from_rows(self.pschema, rows, timestamps=ts))
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
        return arrays, got

    def process(self, rows, ts, where):
        arrays, got = self.encode(rows, ts)
        want = self.ref.process_arrays(arrays)
        out = self.port.process_arrays(got)
        assert _as_tuples(out) == _as_tuples(want), where
        self.check(where)
        return out

    def step(self, rows, ts, where):
        """The device step alone (no emission decode, no load check)."""
        arrays, got = self.encode(rows, ts)
        self.ref.state, want = self.ref._step(self.ref.state, arrays)
        emits = self.port._step(self.port.upload(got))
        for k in emits:
            np.testing.assert_array_equal(emits[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{where}: {k}")
        self.check(where)
        return emits

    def flush(self, t, where):
        want, got = self.ref.flush(t), self.port.flush(t)
        assert _as_tuples(got) == _as_tuples(want), where
        self.check(where)
        return got

    def check(self, where):
        assert_same_state(self.ref, self.port, where)
        assert_same_lanes(self.ref_lanes, self.port_lanes, where)


def row(url, lat=1.0):
    return {"URL": url, "USER_ID": 1, "LATENCY": lat}


def test_padding_batch_keeps_emit_clock_at_min():
    p = Pair(FINAL_GRACE)
    assert p.process([], [], "padding") == []
    assert p.port.state["emit_clock"].item() == I64.min
    assert p.port.state["row_clock"].item() == 8
    p.process([row("/a")], [H0 + MIN], "one row")
    assert p.port.state["emit_clock"].item() == H0 + MIN


def test_stream_time_on_the_close_emits():
    p = Pair(FINAL_GRACE)
    p.process([row("/a"), row("/b"), row("/a")], [H0 + MIN, H0 + 2 * MIN, H0 + 3 * MIN], "fill")
    close = H0 + HOUR + 10 * MIN  # end + grace = the horizon (retention = size + grace)
    got = p.process([row("/c")], [close], "close")
    assert [(e.key, e.row["CNT"]) for e in got] == [(("/a",), 2), (("/b",), 1)]
    assert p.port.state["emitted"].sum().item() == 2


def test_stream_time_past_the_horizon_evicts_unemitted():
    p = Pair(FINAL_GRACE)
    p.process([row("/a"), row("/b")], [H0 + MIN, H0 + 2 * MIN], "fill")
    got = p.process([row("/c")], [H0 + HOUR + 10 * MIN + 1], "past horizon")
    assert got == []
    st = p.state()
    assert st["grave"].sum() == 2 and not st["emitted"].any()
    assert (st["born"][st["grave"]] == I64.max).all()
    assert p.flush(H0 + 10 * HOUR, "flush") != []  # only /c's window is left


def test_late_record_in_grace_redirties_an_emitted_window_once():
    # a retained window (horizon 4 h past its start) emits when the stream
    # time passes its close; a row with a null key (it reaches the
    # emission clock, not the aggregate's) closes it, then a late row of
    # its key is still in grace for the aggregate's clock and re-dirties it
    p = Pair(FINAL_RETAINED)
    p.process([row("/a")], [H0 + MIN], "fill")
    got = p.process([row(None)], [H0 + HOUR + 10 * MIN + 5], "close by a null key")
    assert [(e.key, e.row["CNT"]) for e in got] == [(("/a",), 1)]
    assert p.process([row("/a")], [H0 + 30 * MIN], "late in grace") == []
    st = p.state()
    slot = int(np.nonzero(st["occ"])[0][0])
    assert st["dirty"][slot] and st["emitted"][slot] and st["a1"][slot] == 2
    assert p.process([row("/b")], [H0 + 2 * HOUR + 30 * MIN], "later") == []
    assert all(e.key != ("/a",) for e in p.flush(H0 + 10 * HOUR, "flush"))


def test_expansion_lanes_run_over_the_tiled_lanes():
    # k = 3; rows out of order: a hop >= 1 lane of an early row sees the
    # batch's later, larger timestamps in the lane scan and is cut
    p = Pair(HOP_FINAL, capacity=6, store=64)
    ts = [H0 + 50 * MIN, H0 + 100 * MIN, H0 + 21 * MIN, H0 + 64 * MIN, H0 + 99 * MIN,
          H0 + 40 * MIN]
    rows = [row(f"/{c}", float(i)) for i, c in enumerate("abcdab")]
    emits = p.step(rows, ts, "expanded")
    # the reference's rule, recomputed: the running max over the tiled
    # lanes cuts more than a running max over each row's own position
    arrays, got = p.encode(rows, ts)
    pre = p.port.pre_exchange(p.port.upload(got))
    assert pre["active"].shape[0] == 18 and emits["emit_mask"].shape[0] == 18
    per_row = torch.tensor(ts).cummax(0).values.repeat(3)
    assert bool((pre["active"] != (pre["wstart"] + HOUR + 5 * MIN > per_row)).any())
    p.step([row("/a")], [H0 + 3 * HOUR], "close all")
    p.flush(H0 + 10 * HOUR, "flush")


def test_dump_slot_born_takes_the_first_overflowed_lane():
    # a 4-slot store and 8 new keys: K2 overflows and the active lanes it
    # could not place aim at the dump slot, whose born takes the first one
    p = Pair(FINAL_GRACE, capacity=8, store=4)
    rows = [row(f"/k{i}") for i in range(8)]
    p.step(rows, [H0 + i * MIN for i in range(8)], "overflow")
    st = p.state()
    assert st["overflow"] > 0 and st["born"][-1] != I64.max
    p.step(rows, [H0 + HOUR + i * MIN for i in range(8)], "again")


def test_dump_slot_hpass_takes_the_highest_lane():
    p = Pair(HAVING, capacity=8, store=32)
    for b, lats in enumerate(([150.0, 50.0, 200.0], [10.0, 20.0, 300.0, 5.0], [500.0] * 6)):
        rows = [row(f"/u{i % 3}", lat) for i, lat in enumerate(lats)]
        p.step(rows, [H0 + (b * 8 + i) * MIN for i in range(len(rows))], f"batch {b}")
    st = p.state()
    assert st["hpass"][:-1].any()


def test_having_retraction_tombstones_and_reentry():
    p = Pair(HAVING, capacity=4, store=32)
    got = p.process([row("/a", 300.0)], [H0 + MIN], "passes")
    assert [e.row["CNT"] for e in got] == [1]
    got = p.process([row("/a", 0.0), row("/a", 0.0)], [H0 + 2 * MIN, H0 + 3 * MIN], "fails")
    assert [e.row for e in got] == [None]  # the retraction
    assert p.process([row("/a", 1.0)], [H0 + 4 * MIN], "still failing") == []
    got = p.process([row("/a", 900.0)], [H0 + 5 * MIN], "passes again")
    assert [e.row["CNT"] for e in got] == [5]


def test_evict_suppress_mode_keeps_dirty_windows():
    # every combination of occ, dirty and emitted, at, below and above the
    # retention boundary; then the flush of what stayed
    p = Pair(FINAL_GRACE, capacity=8, store=64)
    st = p.state()
    retention = p.ref.retention_ms
    assert retention == p.port.retention_ms == HOUR + 10 * MIN
    max_ts = H0 + 20 * HOUR
    st["max_ts"] = np.asarray(max_ts, np.int64)
    combos = [(o, d, e) for o in (True, False) for d in (True, False) for e in (True, False)]
    offsets = (-HOUR, -1, 0, 1)
    s = 0
    for off in offsets:
        for o, d, e in combos:
            st["occ"][s], st["dirty"][s], st["emitted"][s] = o, d, e
            st["wstart"][s] = max_ts - retention + off
            st["khash"][s] = 1000 + s
            st["born"][s] = s
            st["a0"][s], st["a1"][s] = st["wstart"][s] + 7, s + 1
            s += 1
    p.set_state(st)
    p.ref.state = p.ref._evict(p.ref.state)
    p.port._evict()
    p.check("evict")
    after = p.state()
    freed = st["occ"] & ~after["occ"]
    assert freed.any() and not (freed & st["dirty"]).any()
    assert (after["born"][freed] == I64.max).all() and not after["emitted"][freed].any()
    p.flush(max_ts, "flush after evict")


def test_evict_clears_hpass():
    p = Pair(HAVING, capacity=8, store=16)
    st = p.state()
    max_ts = H0 + 100 * HOUR
    st["max_ts"] = np.asarray(max_ts, np.int64)
    st["occ"][:4] = st["hpass"][:4] = st["dirty"][:4] = True
    st["wstart"][:4] = max_ts - p.ref.retention_ms + np.array([-HOUR, -1, 0, 1])
    st["hpass"][-1] = True
    p.set_state(st)
    p.ref.state = p.ref._evict(p.ref.state)
    p.port._evict()
    p.check("evict")
    assert list(p.state()["hpass"][:4]) == [False, False, True, True]


@pytest.mark.parametrize("k", [1, 3])
def test_emit_clock_is_sorted_so_the_sort_is_the_identity(k):
    rng = np.random.default_rng(k)
    n = 257
    ts = torch.from_numpy(H0 + rng.integers(-HOUR, HOUR, n))
    row_valid = torch.from_numpy(rng.random(n) > 0.2)
    active = torch.from_numpy(rng.random(n * k) > 0.3)
    wstart = torch.from_numpy(H0 + rng.integers(-2, 2, n * k) * HOUR)
    for clock in (I64.min, H0, H0 + 2 * HOUR):
        act, c0, cm = sup.suppress_clock_plain(ts, wstart, active, row_valid,
                                               torch.tensor(H0 - HOUR), torch.tensor(clock),
                                               HOUR, 10 * MIN)
        assert torch.equal(torch.sort(cm).values, cm)
        assert bool((cm >= clock).all())
        assert torch.equal(c0, torch.where(act, ts.repeat(k), torch.tensor(I64.min)))


def test_evict_plain_suppress_needs_born():
    layout = hs.StoreLayout(capacity=4, num_keys=1,
                            components=(hs.AggComponent("max", "int64", I64.min),))
    store = hs.init_store(layout, "cpu")
    store["born"] = torch.full((5,), I64.max)
    store["emitted"] = torch.zeros(5, dtype=torch.bool)
    store["occ"][0] = store["emitted"][0] = True
    store["max_ts"].fill_(10 * HOUR)
    hs.evict_plain(store, layout, HOUR, suppress=True)
    assert not store["occ"][0] and not store["emitted"][0] and store["grave"][0]


@jax.jit
def _reference_clock(ts, wstart, active, row_valid, max_ts, emit_clock, size, grace):
    """The suppress lanes of the reference's ``pre_exchange``
    (``ksql_tpu/runtime/lowering.py:3906-3931``) written out in jax on
    K17's inputs: the lanes are the rows tiled k times, as the expansion
    route tiles them; ``c0`` is the watermark contribution of the lanes
    that stay (its ``contribs[0]``)."""
    neg = jnp.int64(I64.min)
    lane_ts = jnp.tile(ts, active.shape[0] // ts.shape[0])
    cm = jnp.maximum(jax.lax.cummax(jnp.where(active, lane_ts, neg)), max_ts)
    act = active & (wstart + size + grace > cm)
    cm_emit = jnp.maximum(jax.lax.cummax(jnp.where(row_valid, ts, neg)), emit_clock)
    return act, jnp.where(act, lane_ts, neg), cm_emit


@pytest.mark.parametrize("case", list(CLOCK_CASES))
def test_suppress_clock_twin_equals_reference(case):
    # tolerance: exact (the lanes' cut and contribution, the emission clock)
    n, k, kind = CLOCK_CASES[case]
    args = clock_case(n, k, kind, seed=n + k)
    got = sup.suppress_clock(*args)  # CPU tensors: the twin
    want = _reference_clock(*(jnp.asarray(a.numpy()) for a in args[:6]), jnp.int64(args[6]),
                            jnp.int64(args[7]))
    for g, w, name in zip(got, want, ("active", "c0", "cm_emit")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    cut = int(args[2].sum() - got[0].sum())
    if kind == "late":
        assert not got[0].any() and int(args[2].sum()) > 0
    if kind == "inactive":
        assert not got[0].any() and bool((got[2] == args[5]).all())
    if kind in ("random", "wrap") and n > 1:
        assert cut > 0


@jax.jit
def _reference_close(st, comps_init, slots, active, cm_in, size, grace, retention):
    """The suppress branch of the reference's ``post_exchange``
    (``ksql_tpu/runtime/lowering.py:4003-4034``) written out in jax on
    K18's inputs: ``st`` the store's flags, ``wstart``, ``born``, the
    components (``a<j>``, their inits in ``comps_init``) and the two
    clocks; ``slots`` are K2's, ``cm_in`` K17's emission clock."""
    st = dict(st)
    cap = st["occ"].shape[0] - 1
    nn = active.shape[0]
    slot_or_dump = jnp.where(active, slots, cap)
    cm = jnp.sort(cm_in)
    m = cm.shape[0]
    ws = st["wstart"]
    close = ws + size + grace
    horizon = ws + retention
    pos = jnp.searchsorted(cm, close)
    t_first = cm[jnp.minimum(pos, m - 1)]
    reachable = (pos < m) & (t_first <= horizon)
    final_t = cm[m - 1]
    st["emit_clock"] = jnp.maximum(st["emit_clock"], final_t)
    order = st["row_clock"] + jnp.arange(nn, dtype=jnp.int64)
    st["born"] = st["born"].at[slot_or_dump].min(jnp.where(active, order, np.iinfo(np.int64).max))
    st["row_clock"] = st["row_clock"] + nn
    cand = st["occ"] & st["dirty"] & ~st["emitted"]
    emit_now = cand & reachable
    evict_now = cand & (close <= final_t) & ~reachable
    st["dirty"] = st["dirty"] & ~(emit_now | evict_now)
    st["emitted"] = st["emitted"] | emit_now
    st["occ"] = st["occ"] & ~evict_now
    st["grave"] = st["grave"] | evict_now
    st["born"] = jnp.where(evict_now, np.iinfo(np.int64).max, st["born"])
    for j, init in enumerate(comps_init):
        col = st[f"a{j}"]
        st[f"a{j}"] = jnp.where(evict_now, init.astype(col.dtype), col)
    return st, emit_now


#: the store entries K18 reads or writes (its scalar components' columns
#: besides)
_CLOSE_KEYS = ("occ", "grave", "dirty", "emitted", "born", "wstart", "emit_clock", "row_clock")


@pytest.mark.parametrize("scenario", ["emit", "evict", "hopping", "overflow"])
def test_reference_close_copy_agrees_with_the_reference_step(scenario, monkeypatch):
    """``_reference_close``, the copy the CLOSE_CASES test below holds the
    twin to, against the reference itself: the port's device step runs
    beside ``CompiledDeviceQuery._step`` (whose suppress branch is
    ``post_exchange``'s :4003-4034), each of the port's K18 calls also runs
    the copy on the same inputs and must equal it, and the port's state and
    lanes must equal the reference's after every batch (``Pair.check``).
    So the copy, the twin and the reference agree on these batches: a
    window emitting on its close, two evicted past their horizon, a hopping
    store's closes, and lanes overflowed to the dump slot."""
    # tolerance: exact (every flag, born, component bits, the clocks, the mask)
    twin = sup.suppress_close
    outcomes = []

    def checked(store, layout, slots, active, cm_emit, size_ms, grace_ms, retention_ms):
        comps = layout.components
        assert all(c.width == 1 for c in comps)
        keys = _CLOSE_KEYS + tuple(f"a{j}" for j in range(len(comps)))
        before = {k: jnp.asarray(store[k].numpy().copy()) for k in keys}
        want_st, want = _reference_close(before, [jnp.asarray(np.array(c.init, c.dtype)) for c in comps],
                                         jnp.asarray(slots.numpy()), jnp.asarray(active.numpy()),
                                         jnp.asarray(cm_emit.numpy()), jnp.int64(size_ms),
                                         jnp.int64(grace_ms), jnp.int64(retention_ms))
        got = twin(store, layout, slots, active, cm_emit, size_ms, grace_ms, retention_ms)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg="suppress_emit")
        for k in keys:
            g, w = store[k].numpy(), np.asarray(want_st[k])
            if w.dtype == np.float64:
                g, w = g.view(np.int64), w.view(np.int64)
            np.testing.assert_array_equal(g, w, err_msg=k)
        outcomes.append((int(got.sum()), int((np.asarray(before["occ"]) & ~store["occ"].numpy()).sum())))
        return got

    monkeypatch.setattr(sup, "suppress_close", checked)
    if scenario == "emit":
        p = Pair(FINAL_GRACE)
        p.step([row("/a"), row("/b"), row("/a")], [H0 + MIN, H0 + 2 * MIN, H0 + 3 * MIN], "fill")
        p.step([row("/c")], [H0 + HOUR + 10 * MIN], "close")
    elif scenario == "evict":
        p = Pair(FINAL_GRACE)
        p.step([row("/a"), row("/b")], [H0 + MIN, H0 + 2 * MIN], "fill")
        p.step([row("/c")], [H0 + HOUR + 10 * MIN + 1], "past horizon")
    elif scenario == "hopping":
        p = Pair(HOP_FINAL, capacity=6, store=64)
        ts = [H0 + 50 * MIN, H0 + 100 * MIN, H0 + 21 * MIN, H0 + 64 * MIN, H0 + 99 * MIN, H0 + 40 * MIN]
        p.step([row(f"/{c}", float(i)) for i, c in enumerate("abcdab")], ts, "expanded")
        p.step([row("/a")], [H0 + 3 * HOUR], "close all")
    else:
        p = Pair(FINAL_GRACE, capacity=8, store=4)
        rows = [row(f"/k{i}") for i in range(8)]
        p.step(rows, [H0 + i * MIN for i in range(8)], "overflow")
        p.step(rows, [H0 + HOUR + 10 * MIN + i * MIN for i in range(8)], "again")
        assert p.state()["born"][-1] != I64.max
    assert len(outcomes) == 2
    emitted, evicted = outcomes[-1]
    if scenario == "emit":
        assert emitted == 2 and evicted == 0
    elif scenario == "evict":
        assert emitted == 0 and evicted == 2
    else:
        assert emitted + evicted > 0


@pytest.mark.parametrize("case", list(CLOSE_CASES))
def test_suppress_close_twin_equals_reference(case):
    # tolerance: exact (every slot's flags, born and component bits, the
    # clocks, the emission mask)
    comps, st, slots, active, cm, size, grace, retention = close_case(case)
    capacity = st["occ"].shape[0] - 1
    layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c, d, i) for c, d, i in comps),
                            windowed=True)
    store = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    got = sup.suppress_close(store, layout, torch.from_numpy(slots), torch.from_numpy(active),
                             torch.from_numpy(cm), size, grace, retention)  # CPU tensors: the twin
    want_st, want = _reference_close({k: jnp.asarray(v) for k, v in st.items()},
                                     [jnp.asarray(np.array(i, d)) for _c, d, i in comps],
                                     jnp.asarray(slots), jnp.asarray(active), jnp.asarray(cm),
                                     jnp.int64(size), jnp.int64(grace), jnp.int64(retention))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg="suppress_emit")
    for k, v in want_st.items():
        g, w = store[k].numpy(), np.asarray(v)
        if w.dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=k)
    cand = st["occ"] & st["dirty"] & ~st["emitted"]
    evicted = int((st["occ"] & ~store["occ"].numpy()).sum())
    if case == "no_candidate":
        assert not cand.any() and not got.any()
    elif case == "all_emit":
        assert int(got.sum()) == int(cand.sum()) > 0 and evicted == 0
    elif case == "all_evict":
        assert evicted == int(cand.sum()) > 0 and not got.any()
    elif case == "close_on_cm":
        assert got.any()
    elif case == "on_horizon":
        assert got.any() and evicted > 0
