"""SESSION-window aggregation: the port against ``ksql_tpu``'s device backend.

Per step: ``TorchCompiledQuery`` and ``CompiledDeviceQuery`` are built from
the same plan and fed the same micro-batches (``process_arrays`` on the
``BatchLayout.encode`` arrays, checked equal first); after EVERY batch the
whole state dict (every slot, the dump slot included) and every emit lane
must be equal bit for bit, float bits included, and so must the decoded
SinkEmits.  The queries are ``tests/test_device_session.py``'s (COUNT, SUM,
MIN over SESSION 10 s), the same with GRACE PERIOD 5 SECONDS (late rows
drop, stored sessions expire), a DOUBLE column under SUM/MIN/MAX with -0.0
and NaN values, and BASELINE #5's (``bench.py:668``).  The traffic has
out-of-order and bridging rows, duplicate timestamps and null keys, and
both growths fire in it: the session slots (``sess_ovf``) and the store
(``_grow``).

End to end: the port's ``run_plan`` over ``test_device_session.py``'s
feeds, a record a tick, against the reference engine's device backend and
the row oracle; and the refusals the reference makes.
"""

import json

import jax
import numpy as np
import pytest

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import run_plan, run_until_quiescent, start_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from tests.test_device_session import DDL, FEED, SQL
from tests.test_device_session import _run as engine_run
from tests.test_torch_join import _pschema, _same_bits, assert_same_nested_state, plan_of
from tests.test_torch_lowering import _capture

jax.config.update("jax_enable_x64", True)

GRACE = SQL.replace("SESSION (10 SECONDS)", "SESSION (10 SECONDS, GRACE PERIOD 5 SECONDS)")
D_DDL = ("CREATE STREAM SRC (ID BIGINT KEY, V BIGINT, D DOUBLE) "
         "WITH (kafka_topic='src', value_format='JSON');")
DOUBLES = ("CREATE TABLE S AS SELECT ID, SUM(D) AS SD, MIN(D) AS MN, MAX(D) AS MX, "
           "COUNT(D) AS C FROM SRC WINDOW SESSION (10 SECONDS) GROUP BY ID EMIT CHANGES;")
# BASELINE #5 (bench.py:668-692, bench_session)
PV_DDL = ("CREATE STREAM PAGE_VIEWS (URL STRING, USER_ID BIGINT, VIEWTIME BIGINT) "
          "WITH (KAFKA_TOPIC='page_views', VALUE_FORMAT='JSON');")
BENCH = ("CREATE TABLE SESSIONS AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
         "WINDOW SESSION (30 SECONDS) GROUP BY URL EMIT CHANGES;")
QUERIES = {"src": (DDL, SQL), "grace": (DDL, GRACE), "doubles": (D_DDL, DOUBLES),
           "bench": (PV_DDL, BENCH)}
_SPECIAL_D = (-0.0, 0.0, float("nan"), -1.5, 2.25)


def build_pair(ddl, sql, capacity, store, slots):
    engine, plan = plan_of([ddl], sql)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, store_capacity=store)
    ref_q.session_slots = slots
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=capacity, store_capacity=store, device="cpu",
                                session_slots=slots)
    return ref_q, port_q


def session_traffic(seed, name, n_batches, capacity, keys, gap_ms):
    """Batches of 1..capacity rows: keys over ``keys`` values (8% null),
    time rising by up to about a gap a row, with out-of-order rows (up to 4
    gaps back: some bridge two sessions, some are late past a grace), and
    repeated timestamps.  Rows match the query's source (``name``)."""
    rng = np.random.default_rng(seed)
    t, out = 1_000_000, []
    for _ in range(n_batches):
        rows, ts = [], []
        for _ in range(int(rng.integers(1, capacity + 1))):
            if rng.random() > 0.1:  # else a duplicate timestamp
                t += int(rng.integers(0, gap_ms + gap_ms // 2))
            k = None if rng.random() < 0.08 else int(rng.integers(0, keys))
            if name == "bench":
                row = {"URL": None if k is None else f"/page/{k}", "USER_ID": int(rng.integers(1, 1000)),
                       "VIEWTIME": t}
            else:
                row = {"ID": k, "V": int(rng.integers(-50, 50))}
                if name == "doubles":
                    r = rng.random()
                    row["D"] = (None if r < 0.1 else _SPECIAL_D[int(rng.integers(0, len(_SPECIAL_D)))]
                                if r < 0.5 else float(rng.uniform(-100, 100)))
            rows.append(row)
            ts.append(t - int(rng.integers(0, 4 * gap_ms)) if rng.random() < 0.25 else t)
        out.append((rows, ts))
    return out


def _emits(emits):
    """SinkEmits as tuples, floats by ``repr`` (NaN equals NaN, -0.0 is not
    0.0)."""
    def norm(row):
        return row if row is None else {k: repr(v) if isinstance(v, float) else v
                                        for k, v in row.items()}
    return [(e.key, norm(e.row), e.ts, e.window) for e in emits]


def run_session_parity(ddl, sql, batches, capacity, store, slots):
    """Drive both queries through ``batches``; the encoded arrays, the
    decoded emits, the full state (bits) and every emit lane (bits) are
    compared after each batch.  Returns both queries and the emits."""
    ref_q, port_q = build_pair(ddl, sql, capacity, store, slots)
    ref_lanes, port_lanes = [], []
    _capture(ref_q, ref_lanes)
    _capture(port_q, port_lanes)
    schema = ref_q.source.schema
    n_emits = 0
    for i, (rows, ts) in enumerate(batches):
        where = f"batch {i}"
        arrays = ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts))
        got_arrays = port_q.layout.encode(PHostBatch.from_rows(_pschema(schema), rows, timestamps=ts))
        assert set(arrays) == set(got_arrays)
        for k in arrays:
            np.testing.assert_array_equal(got_arrays[k], arrays[k])
        n_lanes = len(ref_lanes)
        want, got = ref_q.process_arrays(arrays), port_q.process_arrays(got_arrays)
        assert _emits(got) == _emits(want), where
        n_emits += len(want)
        assert (port_q.session_slots, port_q.store_capacity) == \
            (ref_q.session_slots, ref_q.store_capacity), where
        assert_same_nested_state(ref_q, port_q, where)
        assert len(port_lanes) == len(ref_lanes) == n_lanes + (1 if want else 0), where
        if want:
            lr, lp = ref_lanes[-1], port_lanes[-1]
            assert set(lp) == set(lr) - {"dec_envelope"}, where
            for k in lp:
                _same_bits(lp[k], lr[k], f"{where}: lane {k}")
    return ref_q, port_q, n_emits


@pytest.mark.parametrize("name", list(QUERIES))
def test_session_state_parity_per_step(name):
    ddl, sql = QUERIES[name]
    gap = 30_000 if name == "bench" else 10_000
    # 5 keys, S = 2 slots: out-of-order rows open more than two sessions
    # per key (sess_ovf doubles S); a 16-slot store fills past 0.75 and grows
    batches = session_traffic(len(name), name, 30, capacity=8, keys=5, gap_ms=gap)
    ref_q, q, n_emits = run_session_parity(ddl, sql, batches, capacity=8, store=16, slots=2)
    assert n_emits > 40
    assert q.session_grows >= 1 and q.session_slots >= 4
    assert q.grows >= 1 and q.store_capacity >= 32
    assert int(q.state["overflow"]) == 0


def test_grace_drops_late_rows_and_keeps_expired_sessions():
    # a row gap + grace (15 s) or more behind the running stream time
    # drops; stored sessions that ended that far back no longer merge and
    # are not deleted (no tombstone): key 1's new session takes rank 0 and
    # overwrites that slot, its expired rank-1 session stays occupied
    ref_q, q, _ = run_session_parity(DDL, GRACE, [
        ([{"ID": 1, "V": 1}, {"ID": 2, "V": 2}, {"ID": 1, "V": 3}], [1000, 1500, 50_000]),
        ([{"ID": 1, "V": 4}, {"ID": 1, "V": 5}], [200_000, 1200]),  # 1200: dropped
    ], capacity=4, store=16, slots=2)
    assert int(q.state["occ"].sum()) == int(np.asarray(ref_q.state["occ"]).sum()) == 3
    assert int(q.state["grave"].sum()) == 0
    emits = q.process_arrays(q.layout.encode(PHostBatch.from_rows(
        _pschema(ref_q.source.schema), [{"ID": 1, "V": 6}], timestamps=[200_500])))
    assert [(e.row["CNT"], e.window) for e in emits if e.row] == [(2, (200_000, 200_500))]
    assert [e.window for e in emits if e.row is None] == [(200_000, 200_000)]


# ----------------------------------------------------------- end to end
def port_session_feed(sql, feed, ddl=DDL, **kw):
    """``test_device_session.py::_run`` on the port's runner: each record
    produced and polled in turn (capacity 1: one change per record)."""
    _engine, plan = plan_of([ddl], sql)
    broker = PBroker()
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), broker, device="cpu", capacity=1,
                   store_capacity=64, **kw)
    for k, v, ts in feed:
        broker.topic("src").produce(PRecord(key=k, value=json.dumps({"V": v}), timestamp=ts))
        run_until_quiescent(h)
    h.executor.drain()
    sink = plan.physical_plan.topic
    return h, [(r.key, r.value, r.timestamp, r.window) for r in broker.topic(sink).all_records()]


@pytest.mark.parametrize("feed", ["feed", "slot_growth"])
def test_session_feed_equals_device_backend_and_oracle(feed):
    records = FEED if feed == "feed" else [(1, i, 100_000 * (6 - i)) for i in range(6)]
    _e, handle, dev = engine_run("device", feed=records)
    assert handle.backend == "device"
    _e, _h, ora = engine_run("oracle", feed=records)
    h, port = port_session_feed(SQL, records)
    assert port == dev
    assert port == ora
    if feed == "feed":  # the bridging row merges two sessions away
        assert sum(value is None for _k, value, _t, _w in port) >= 2
    else:
        assert h.executor.query.session_slots >= 6 and h.executor.query.session_grows >= 1


def test_run_plan_batched_equals_per_batch_reference():
    # the bench plan through run_plan in 16-row batches (the executor's
    # batched mode): a session query is never pipelined, so the sink holds
    # every batch's emits in order, as the reference's process_arrays gives
    batches = session_traffic(3, "bench", 6, capacity=16, keys=4, gap_ms=30_000)
    rows = [(r, t) for rs, ts in batches for r, t in zip(rs, ts)]
    ref_q, _q = build_pair(PV_DDL, BENCH, 16, 64, 2)
    schema = ref_q.source.schema
    want = []
    for i in range(0, len(rows), 16):
        chunk = rows[i:i + 16]
        want += ref_q.process(RHostBatch.from_rows(schema, [r for r, _t in chunk],
                                                   timestamps=[t for _r, t in chunk]))
    _engine, plan = plan_of([PV_DDL], BENCH)
    broker = PBroker()
    for r, t in rows:
        broker.create_topic("page_views").produce(PRecord(key=None, value=json.dumps(r), timestamp=t))
    ex = run_plan(json.loads(json.dumps(plan_to_json(plan))), broker, device="cpu", capacity=16,
                  store_capacity=64, session_slots=2)
    assert ex.query.pipeline and ex.query._pending_emits is None
    got = [(r.key, None if r.value is None else json.loads(r.value), r.timestamp, r.window)
           for r in broker.topic("SESSIONS").all_records()]
    assert got == [(e.key[0], None if e.row is None else {"CNT": e.row["CNT"]}, e.ts, e.window)
                   for e in want]
    assert any(v is None for _k, v, _t, _w in got) and len(got) > 20


@pytest.mark.parametrize("name,sql", [
    ("having", SQL.replace("GROUP BY ID", "GROUP BY ID HAVING COUNT(*) > 1")),
    ("emit_final", SQL.replace("EMIT CHANGES", "EMIT FINAL")),
])
def test_refusals_like_reference(name, sql):
    engine, plan = plan_of([DDL], sql)
    with pytest.raises(Exception, match="SESSION|Filter|HAVING|EMIT FINAL"):
        CompiledDeviceQuery(plan, engine.registry, capacity=8)
    with pytest.raises(DeviceUnsupported):
        TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                           capacity=8, device="cpu")


def test_session_over_join_refused_like_reference():
    ddls = ["CREATE TABLE USERS (ID BIGINT PRIMARY KEY, REGION STRING) "
            "WITH (KAFKA_TOPIC='users', VALUE_FORMAT='JSON');",
            "CREATE STREAM CLICKS (USER_ID BIGINT, URL STRING) "
            "WITH (KAFKA_TOPIC='clicks', VALUE_FORMAT='JSON');"]
    sql = ("CREATE TABLE T AS SELECT U.REGION, COUNT(*) AS CNT FROM CLICKS C "
           "JOIN USERS U ON C.USER_ID = U.ID WINDOW SESSION (10 SECONDS) "
           "GROUP BY U.REGION EMIT CHANGES;")
    engine, plan = plan_of(ddls, sql)
    with pytest.raises(Exception, match="SESSION"):
        CompiledDeviceQuery(plan, engine.registry, capacity=8)
    with pytest.raises(DeviceUnsupported, match="SESSION"):
        TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                           capacity=8, device="cpu")
