"""EMIT FINAL: TorchCompiledQuery against CompiledDeviceQuery.

Every case runs through ``test_torch_lowering.run_parity``: the same plan,
the same encoded micro-batches, and after EVERY step and after the final
``flush(stream_time)`` the full state dict (``born``, ``emitted``,
``emit_clock``, ``row_clock`` and the dump slot included) and every emit
lane compared bit for bit, integers, bools, hashes and the float64 folds
alike (no tolerance).  The cases are ``test_device_parity.py``'s
``test_emit_final_tumbling``, ``test_slicing.py``'s EMIT FINAL hopping
rows (expansion route, the reference's fallback reason), grace with late
records that re-dirty an emitted window, EMIT FINAL with HAVING (a filter
at emission), EMIT FINAL over a stream-table join, store growth and the
retention pass (K4's suppress mode) mid-stream.  End to end, the port's
runner and executor must write the reference's sink: the SQL of
``test_engine_device.py``'s ``test_emit_final_through_engine`` per tick,
and batched against the reference's DeviceExecutor with ``flush_time``.
"""

import json

import numpy as np
import pytest

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.device_executor import DeviceExecutor
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu.runtime.topics import Broker as RBroker
from ksql_tpu.runtime.topics import Record as RRecord
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import run_until_quiescent, start_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from ksql_tpu_torch.state import state_to_numpy
from tests.test_device_parity import gen_rows as parity_rows
from tests.test_engine_device import ROWS as ENGINE_ROWS
from tests.test_engine_device import _run as engine_run
from tests.test_slicing import plan_for as slicing_plan_for
from tests.test_torch_join import assert_same_nested_state
from tests.test_torch_lowering import (
    DDL,
    HOUR,
    PV_DDL,
    assert_same_state,
    gen_batches,
    plan_for,
    run_parity,
)

FINAL_NO_GRACE = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 0 SECONDS) GROUP BY URL EMIT FINAL;"
)
FINAL_GRACE = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT, SUM(LATENCY) AS S, MIN(LATENCY) AS MN "
    "FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 40 MINUTES) "
    "GROUP BY URL EMIT FINAL;"
)


def chunks(rows, size):
    return [([r for r, _ in rows[i:i + size]], [t for _, t in rows[i:i + size]])
            for i in range(0, len(rows), size)]


def late_batches(seed, n_batches, rows, urls=12, step=200_000, late_ms=(50, 90)):
    """Records ``step`` ms apart on average, with 10% of them ``late_ms``
    minutes behind the stream time: some in grace (they re-dirty windows
    that may have emitted), some past it (dropped)."""
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    out = []
    for _ in range(n_batches):
        batch, ts = [], []
        for _ in range(rows):
            t += int(rng.integers(0, 2 * step))
            late = rng.random() < 0.1
            batch.append({"URL": f"/p/{int(rng.zipf(1.4)) % urls}" if rng.random() > 0.03 else None,
                          "USER_ID": int(rng.integers(1, 50)),
                          "LATENCY": float(rng.uniform(-1.0, 500.0)) if rng.random() > 0.1 else None})
            ts.append(t - int(rng.integers(*late_ms)) * 60_000 if late else t)
        out.append((batch, ts))
    return out


def emitted_windows(q):
    st = state_to_numpy(q.state)
    return int(st["emitted"].sum())


def test_emit_final_tumbling():
    # tests/test_device_parity.py::test_emit_final_tumbling's rows, batches
    # of 16 into 32-row micro-batches, and its flush 10 h past the last row
    rows = parity_rows(250, seed=4)
    last_ts = max(t for _, t in rows)
    _ref, q = run_parity(DDL, FINAL_NO_GRACE, chunks(rows, 16), capacity=32, store=256,
                         flush_to=last_ts + 10 * HOUR)
    assert q.grace_ms == 0 and q.retention_ms == HOUR
    assert not q.pipeline


def test_emit_final_grace_with_late_records_and_evict():
    # in-grace late records re-dirty emitted windows (which never emit
    # again); the retention pass every 3 batches keeps the dirty ones
    batches = late_batches(1, 14, 24)
    ref_q, q = run_parity(DDL, FINAL_GRACE, batches, capacity=24, store=512, evict_interval=3,
                          flush_to=batches[-1][1][-1] + 5 * HOUR)
    st = state_to_numpy(q.state)
    assert q.evictions >= 4 and st["grave"].any()
    assert (st["emitted"] & st["dirty"]).any() or (st["emitted"] & st["occ"]).any()


def test_emit_final_grow_carries_born_and_emitted():
    # a small store grows twice mid-stream: the rebuild carries born,
    # emitted and both clocks (assert_same_state after every step)
    batches = late_batches(2, 12, 32, urls=60, step=60_000)
    ref_q, q = run_parity(DDL, FINAL_GRACE, batches, capacity=32, store=64,
                          flush_to=batches[-1][1][-1] + 5 * HOUR)
    assert q.grows >= 2 and q.store_capacity == ref_q.store_capacity
    assert emitted_windows(q) > 0


def test_emit_final_hopping_keeps_expansion_with_reason():
    # tests/test_slicing.py::test_emit_final_grace_boundary_keeps_expansion_with_reason
    rows = [
        ({"URL": "/a", "USER_ID": 1, "LATENCY": 1.0}, 500),
        ({"URL": "/a", "USER_ID": 2, "LATENCY": 2.0}, 3_500),
        ({"URL": "/b", "USER_ID": 3, "LATENCY": 3.0}, 6_500),
        ({"URL": "/a", "USER_ID": 4, "LATENCY": 4.0}, 3_900),
        ({"URL": "/a", "USER_ID": 5, "LATENCY": 5.0}, 12_000),
    ]
    sql = ("CREATE TABLE T AS SELECT URL, COUNT(*) AS CNT, SUM(USER_ID) AS S "
           "FROM PAGE_VIEWS WINDOW HOPPING (SIZE 4 SECONDS, "
           "ADVANCE BY 2 SECONDS, GRACE PERIOD 2 SECONDS) "
           "GROUP BY URL EMIT FINAL;")
    for size in (1, 2, 5):
        ref_q, q = run_parity(DDL, sql, chunks(rows, size), capacity=size, store=64,
                              flush_to=30_000)
        assert not q.sliced and q.expansion == 2
        assert q.windowing_fallback == ref_q.windowing_fallback
        assert "EMIT FINAL" in q.windowing_fallback


def test_emit_final_hopping_late_lanes():
    # k = 3 hops: lanes of hops >= 1 see the whole batch's running maximum
    sql = ("CREATE TABLE T AS SELECT URL, COUNT(*) AS CNT, MAX(LATENCY) AS MX FROM PAGE_VIEWS "
           "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 20 MINUTES, GRACE PERIOD 30 MINUTES) "
           "GROUP BY URL EMIT FINAL;")
    batches = late_batches(3, 12, 20, urls=8, step=300_000, late_ms=(20, 70))
    _ref, q = run_parity(DDL, sql, batches, capacity=20, store=256, evict_interval=4,
                         flush_to=batches[-1][1][-1] + 4 * HOUR)
    assert q.expansion == 3 and emitted_windows(q) > 0


def test_emit_final_with_having_filters_at_emission():
    sql = ("CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT, AVG(LATENCY) AS A FROM PAGE_VIEWS "
           "WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 30 MINUTES) GROUP BY URL "
           "HAVING COUNT(*) > 2 EMIT FINAL;")
    batches = late_batches(4, 10, 32, urls=10, step=150_000)
    _ref, q = run_parity(DDL, sql, batches, capacity=32, store=256,
                         flush_to=batches[-1][1][-1] + 3 * HOUR)
    assert "hpass" not in q.state


def test_emit_final_over_stream_table_join():
    ddls = ("CREATE TABLE USERS (ID BIGINT PRIMARY KEY, REGION STRING) "
            "WITH (KAFKA_TOPIC='users', VALUE_FORMAT='JSON');"
            "CREATE STREAM CLICKS (USER_ID BIGINT, URL STRING) "
            "WITH (KAFKA_TOPIC='clicks', VALUE_FORMAT='JSON');")
    sql = ("CREATE TABLE T AS SELECT U.REGION, COUNT(*) AS CNT FROM CLICKS C "
           "JOIN USERS U ON C.USER_ID = U.ID WINDOW TUMBLING (SIZE 1 HOUR, "
           "GRACE PERIOD 10 MINUTES) GROUP BY U.REGION EMIT FINAL;")
    engine = KsqlEngine()
    engine.execute_sql(ddls)
    results = engine.execute_sql(sql)
    plan = engine.queries[next(r.query_id for r in results if r.query_id)].plan
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=16, store_capacity=64,
                                table_store_capacity=16)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=16, store_capacity=64, table_store_capacity=16,
                                device="cpu")
    users = engine.metastore.get_source("USERS").schema
    clicks = engine.metastore.get_source("CLICKS").schema
    pusers = LogicalSchema.from_json(users.to_json())
    pclicks = LogicalSchema.from_json(clicks.to_json())
    rng = np.random.default_rng(5)
    urows = [{"ID": i, "REGION": f"r{i % 3}"} for i in range(10)]
    ts0 = 1_700_000_000_000
    ref_q.process_table(RHostBatch.from_rows(users, urows, timestamps=[ts0] * 10),
                        np.zeros(10, bool))
    port_q.process_table(PHostBatch.from_rows(pusers, urows, timestamps=[ts0] * 10),
                         np.zeros(10, bool))
    t = ts0
    n_emits = 0
    for b in range(10):
        rows, ts = [], []
        for _ in range(16):
            t += int(rng.integers(0, 900_000))
            rows.append({"USER_ID": int(rng.integers(0, 14)), "URL": "/x"})
            ts.append(t)
        want = ref_q.process(RHostBatch.from_rows(clicks, rows, timestamps=ts))
        got = port_q.process(PHostBatch.from_rows(pclicks, rows, timestamps=ts))
        assert [(e.key, e.row, e.ts, e.window) for e in got] == \
            [(e.key, e.row, e.ts, e.window) for e in want], b
        assert_same_nested_state(ref_q, port_q, f"batch {b}")
        n_emits += len(want)
    want, got = ref_q.flush(t + 2 * HOUR), port_q.flush(t + 2 * HOUR)
    assert [(e.key, e.row, e.ts, e.window) for e in got] == \
        [(e.key, e.row, e.ts, e.window) for e in want]
    assert_same_nested_state(ref_q, port_q, "flush")
    assert n_emits + len(want) > 0


def test_emit_final_through_engine_sql():
    # tests/test_engine_device.py::test_emit_final_through_engine: a tick
    # per record, then flush_time(60 s); the port's sink equals the
    # reference engine's on its device backend and on the row oracle
    sql = ("CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PV "
           "WINDOW TUMBLING (SIZE 2 SECONDS, GRACE PERIOD 0 SECONDS) "
           "GROUP BY URL EMIT FINAL;")
    _e, h_dev, out_dev = engine_run(sql, "device", flush_to=60_000)
    _e, _h, out_ora = engine_run(sql, "oracle", flush_to=60_000)
    assert out_dev == out_ora and h_dev.backend == "device"
    broker = PBroker()
    broker.create_topic("pv")
    h = start_plan(json.loads(json.dumps(plan_to_json(h_dev.plan))), broker, device="cpu",
                   capacity=8, store_capacity=64)
    assert not h.executor.query.pipeline
    for i, row in enumerate(ENGINE_ROWS):
        broker.topic("pv").produce(PRecord(key=None, value=json.dumps(row), timestamp=i * 1000,
                                           partition=0))
        run_until_quiescent(h)
        h.executor.drain()
    h.executor.flush_time(60_000)
    sink = h_dev.plan.physical_plan.topic
    got = [(r.key, r.value, r.timestamp, r.window) for r in broker.topic(sink).all_records()]
    assert got == out_dev and len(got) > 0


@pytest.mark.parametrize("sql", [
    FINAL_GRACE,
    "CREATE TABLE C AS SELECT URL, SUM(USER_ID) AS S, AVG(USER_ID) AS A FROM PAGE_VIEWS "
    "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 30 MINUTES, GRACE PERIOD 20 MINUTES) "
    "GROUP BY URL EMIT FINAL;",
])
def test_batched_sink_equals_reference_executor(sql):
    # the reference's DeviceExecutor over the same JSON records in batches
    # of 32 (suppress plans never pipeline), then flush_time past the end
    batches = late_batches(6, 8, 32)
    recs = [(json.dumps(r), t) for rows, ts in batches for r, t in zip(rows, ts)]
    e = KsqlEngine()
    e.execute_sql(DDL)
    results = e.execute_sql(sql)
    plan = e.queries[next(r.query_id for r in results if r.query_id)].plan
    broker = RBroker()
    broker.create_topic("page_views")
    ref = DeviceExecutor(plan, broker, e.registry, batch_size=32, per_record=False,
                         store_capacity=256)
    ref._native_fields = None
    for i, (value, ts) in enumerate(recs):
        ref.process("page_views", RRecord(key=None, value=value, timestamp=ts, partition=0, offset=i))
    ref.drain()
    end = max(t for _, t in recs) + 6 * HOUR
    ref.flush_time(end)
    topic = plan.physical_plan.topic
    want = [(r.key, r.value, r.timestamp, r.window) for r in broker.topic(topic).all_records()]
    pbroker = PBroker()
    ptopic = pbroker.create_topic("page_views")
    for value, ts in recs:
        ptopic.produce(PRecord(key=None, value=value, timestamp=ts, partition=0))
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), pbroker, device="cpu",
                   capacity=32, store_capacity=256)
    run_until_quiescent(h)
    h.executor.drain()
    h.executor.flush_time(end)
    got = [(r.key, r.value, r.timestamp, r.window) for r in pbroker.topic(topic).all_records()]
    assert got == want and len(got) > 10


def test_slicing_plan_helper_agrees():
    # the hopping EMIT FINAL plan of test_slicing.py builds on both packages
    engine = KsqlEngine()
    engine.execute_sql(DDL)
    plan = slicing_plan_for(engine, "CREATE TABLE T AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
                                    "WINDOW HOPPING (SIZE 4 SECONDS, ADVANCE BY 2 SECONDS) "
                                    "GROUP BY URL EMIT FINAL;")
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=4, store_capacity=16)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=4, store_capacity=16,
                                device="cpu")
    assert port_q.grace_ms == ref_q.grace_ms == 0
    assert port_q.retention_ms == ref_q.retention_ms == 4_000
    assert port_q.windowing_fallback == ref_q.windowing_fallback
    assert_same_state(ref_q, port_q, "init")


def test_flagship_final_plan_with_pv_traffic():
    # BASELINE #1's traffic shape with no grace: a window emits only in the
    # batch whose stream times hit its end exactly, others are evicted
    # unemitted once passed; the flush emits the open ones
    batches = gen_batches(8, 8, 64, urls=40, ts_step=40_000, pv=True)
    sql = ("CREATE TABLE PV_COUNTS_FINAL AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
           "WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 0 SECONDS) GROUP BY URL EMIT FINAL;")
    _ref, q = run_parity(PV_DDL, sql, batches, capacity=64, store=256,
                         flush_to=batches[-1][1][-1] + HOUR)
    # the load check ran K4's suppress mode and compacted its graves away
    assert q.evictions >= 1 and q.compactions >= 1


def test_session_and_table_aggregation_refusals():
    # the reference's words for the shapes it refuses with a suppress
    engine, plan, _ = plan_for(DDL, "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
                                    "WINDOW SESSION (1 MINUTE) GROUP BY URL EMIT FINAL;")
    with pytest.raises(Exception, match="EMIT FINAL SESSION windows on device"):
        CompiledDeviceQuery(plan, engine.registry, capacity=8)
    with pytest.raises(Exception, match="EMIT FINAL SESSION windows on device"):
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu")
