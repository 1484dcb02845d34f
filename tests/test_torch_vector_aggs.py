"""Vector aggregates through TorchCompiledQuery against CompiledDeviceQuery.

Both queries are built from the same plan and fed the same micro-batches;
after every step the full state dict (every column, every slot, the dump
slot included) must be bit-equal, the decoded SinkEmits equal, and every
emit lane equal on the emitted lanes (the emission masks equal): the
port's wide gather (K6) fills only the lanes that may emit, the reference
every lane.  The queries
are ``tests/test_device_parity.py``'s vector cases (test_collect_topk_parity,
test_vector_agg_batch_edges, test_collect_windowed_parity) and HISTOGRAM,
ATTR, HOPPING on the expansion route, COLLECT_SET and TOPK over doubles
with -0.0, +0.0 and NaN, EARLIEST/LATEST_BY_OFFSET(n, false) over nulls, a
store that grows with its width-K columns, the state budget's slot count,
a mid-stream hand-over of the reference's state, HAVING, and the sink's
bytes against the reference's executor.  Tolerance: none.
"""

import json

import jax
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
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import run_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from ksql_tpu_torch.state import state_from_numpy
from test_torch_lowering import DDL, PV_DDL, _as_tuples, _capture, assert_same_state, gen_batches, plan_for

jax.config.update("jax_enable_x64", True)

COLLECT_TOPK = (
    "CREATE TABLE C AS SELECT URL, COLLECT_LIST(USER_ID) AS CL, COLLECT_SET(USER_ID) AS CS, "
    "TOPK(LATENCY, 3) AS TK, TOPKDISTINCT(USER_ID, 2) AS TD, LATEST_BY_OFFSET(USER_ID, 3) AS L3 "
    "FROM PAGE_VIEWS GROUP BY URL;"
)
BATCH_EDGES = (
    "CREATE TABLE C AS SELECT URL, LATEST_BY_OFFSET(USER_ID, 3) L3, "
    "TOPKDISTINCT(USER_ID, 2) TD FROM PAGE_VIEWS GROUP BY URL;"
)
COLLECT_WINDOWED = (
    "CREATE TABLE C AS SELECT URL, COLLECT_LIST(USER_ID) AS CL "
    "FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOURS) GROUP BY URL;"
)
HISTOGRAM_ATTR = (
    "CREATE TABLE C AS SELECT USER_ID, HISTOGRAM(URL) AS H, ATTR(URL) AS A, ATTR(LATENCY) AS AL "
    "FROM PAGE_VIEWS GROUP BY USER_ID;"
)
HOPPING = (
    "CREATE TABLE C AS SELECT URL, COLLECT_LIST(USER_ID) AS CL, COLLECT_LIST(URL) AS CU, "
    "TOPK(USER_ID, 2) AS TK FROM PAGE_VIEWS "
    "WINDOW HOPPING (SIZE 1 HOURS, ADVANCE BY 20 MINUTES) GROUP BY URL;"
)
DOUBLES = (
    "CREATE TABLE C AS SELECT URL, COLLECT_SET(LATENCY) AS CS, TOPK(LATENCY, 3) AS TK, "
    "TOPKDISTINCT(LATENCY, 3) AS TD, HISTOGRAM(URL) AS H FROM PAGE_VIEWS GROUP BY URL;"
)
NULLS = (
    "CREATE TABLE C AS SELECT URL, EARLIEST_BY_OFFSET(LATENCY, 2, false) AS E2, "
    "LATEST_BY_OFFSET(LATENCY, 3, false) AS L3, EARLIEST_BY_OFFSET(USER_ID, 2) AS EU, "
    "COLLECT_LIST(LATENCY) AS CL FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOURS) GROUP BY URL;"
)
PV_VECTORS = (
    "CREATE TABLE PV_VECTORS AS SELECT URL, "
    "COLLECT_LIST(USER_ID) AS CL, COLLECT_SET(USER_ID) AS CS, "
    "TOPK(USER_ID, 3) AS TK, TOPKDISTINCT(USER_ID, 3) AS TD, "
    "EARLIEST_BY_OFFSET(USER_ID, 3) AS E3, LATEST_BY_OFFSET(USER_ID, 3) AS L3 "
    "FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;"
)


def assert_same_lanes(ref_lanes, port_lanes, where):
    """The same lanes, dtypes and shapes and the same emission mask; every
    lane equal on the emitted rows (the other rows of a value read from
    vector state — the 2-D lanes, ATTR's value — are the wide gather's
    unwritten rows in the port)."""
    assert len(ref_lanes) == len(port_lanes), where
    for lr, lp in zip(ref_lanes, port_lanes):
        assert set(lp) == set(lr) - {"dec_envelope"}, where
        rows = lr["emit_mask"]
        np.testing.assert_array_equal(lp["emit_mask"], rows)
        for k in lp:
            got, want = lp[k], lr[k]
            assert got.dtype == want.dtype and got.shape == want.shape, (where, k)
            if got.ndim and got.shape[0] == rows.shape[0]:
                got, want = got[rows], want[rows]
            if got.dtype == np.float64:
                got, want = got.view(np.int64), want.view(np.int64)
            np.testing.assert_array_equal(got, want, err_msg=f"{where}: {k}")


def _same_emits(got, want) -> bool:
    """SinkEmits equal, a NaN equal to a NaN and -0.0 apart from +0.0 (by
    their reprs)."""
    return repr(_as_tuples(got)) == repr(_as_tuples(want))


def run_vector_parity(ddl, query, batches, capacity, store, pipeline=False, handoff_at=None):
    engine, plan, schema = plan_for(ddl, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, store_capacity=store)
    port_plan = plan_from_json(json.loads(json.dumps(plan_to_json(plan))))
    port_q = TorchCompiledQuery(port_plan, capacity=capacity, store_capacity=store, device="cpu")
    assert port_q.store_capacity == ref_q.store_capacity
    port_schema = LogicalSchema.from_json(schema.to_json())
    ref_q.pipeline = port_q.pipeline = pipeline
    ref_lanes, port_lanes = [], []
    _capture(ref_q, ref_lanes)
    _capture(port_q, port_lanes)
    n_emits = 0
    for i, (rows, ts) in enumerate(batches):
        if i == handoff_at:
            # the reference's mid-stream state carried into a fresh port query
            port_q = TorchCompiledQuery(port_plan, capacity=capacity,
                                        store_capacity=ref_q.store_capacity, device="cpu")
            port_q.pipeline = pipeline
            port_q.state = state_from_numpy(jax.device_get(ref_q.state), "cpu")
            port_q.dictionary._map.update(ref_q.dictionary._map)
            port_q._batches = ref_q._batches
            _capture(port_q, port_lanes)
        arrays = ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts))
        got_arrays = port_q.layout.encode(PHostBatch.from_rows(port_schema, rows, timestamps=ts))
        want = ref_q.process_arrays(arrays)
        got = port_q.process_arrays(got_arrays)
        assert _same_emits(got, want), f"batch {i}"
        n_emits += len(want)
        assert port_q.store_capacity == ref_q.store_capacity, f"batch {i}"
        assert_same_state(ref_q, port_q, f"batch {i}")
        assert_same_lanes(ref_lanes, port_lanes, f"batch {i}")
    if pipeline:
        want, got = ref_q.flush_pipeline(), port_q.flush_pipeline()
        assert _same_emits(got, want)
        assert_same_lanes(ref_lanes, port_lanes, "flush")
        n_emits += len(want)
    assert n_emits > 0
    return ref_q, port_q


def test_collect_topk_parity():
    run_vector_parity(DDL, COLLECT_TOPK, gen_batches(11, 16, 16, urls=6, users=8), 16, 64)


def test_vector_agg_batch_edges():
    # >K contributions to one key in one batch (the ring wraps) and in-batch
    # duplicates that must not hide distinct values from TOPKDISTINCT
    rows = [{"URL": u, "USER_ID": v, "LATENCY": float(v)} for u, v in
            [("a", 1), ("a", 2), ("a", 3), ("a", 4), ("a", 5), ("b", 5), ("b", 5), ("b", 4),
             ("a", 6), ("b", 5)]]
    ts = [1_700_000_000_000 + i * 1000 for i in range(len(rows))]
    run_vector_parity(DDL, BATCH_EDGES, [(rows, ts), (rows[::-1], ts)], 16, 64)


def test_collect_windowed_parity_pipelined():
    run_vector_parity(DDL, COLLECT_WINDOWED, gen_batches(12, 12, 32, urls=10, ts_step=400_000),
                      32, 256, pipeline=True)


def test_histogram_and_attr_parity():
    run_vector_parity(DDL, HISTOGRAM_ATTR, gen_batches(13, 12, 32, urls=7, users=5), 32, 64)


def test_hopping_expansion_route_parity():
    _ref, q = run_vector_parity(DDL, HOPPING, gen_batches(14, 10, 16, urls=6, ts_step=300_000),
                                16, 128)
    assert not q.sliced and q.windowing_fallback.startswith("non-decomposable aggregate")


def _float_batches(seed, n_batches=10, rows=24):
    """LATENCY drawn from -0.0, +0.0, NaN and a few doubles, nulls included."""
    rng = np.random.default_rng(seed)
    pool = [-0.0, 0.0, float("nan"), 1.5, -2.0, 7.25, None]
    out, t = [], 1_700_000_000_000
    for _ in range(n_batches):
        batch = [{"URL": f"/page/{int(rng.integers(0, 4))}", "USER_ID": int(rng.integers(1, 5)),
                  "LATENCY": pool[int(rng.integers(0, len(pool)))]} for _ in range(rows)]
        ts = [t + 1000 * i for i in range(rows)]
        t += 1000 * rows
        out.append((batch, ts))
    return out


def test_doubles_with_signed_zeros_and_nans_parity():
    run_vector_parity(DDL, DOUBLES, _float_batches(15), 32, 64)


def test_nulls_and_ignore_nulls_false_parity():
    run_vector_parity(DDL, NULLS, gen_batches(16, 10, 24, urls=5, ts_step=500_000), 24, 64)


def test_grow_carries_width_k_columns_and_handoff():
    # 300 URLs into 64 slots: the store doubles while it holds vector state;
    # the port takes the reference's state over halfway
    _ref, q = run_vector_parity(PV_DDL, PV_VECTORS,
                                gen_batches(17, 10, 64, urls=300, ts_step=30_000, pv=True), 64, 64,
                                handoff_at=5)
    assert q.grows >= 1


def test_state_budget_clamps_the_slot_count_as_the_reference():
    engine, plan, _schema = plan_for(PV_DDL, PV_VECTORS)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=16, store_capacity=1 << 20)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=16,
                                store_capacity=1 << 20, device="cpu")
    assert port_q.store_capacity == ref_q.store_capacity == 8192
    row = sum(np.dtype(c.dtype).itemsize * c.width for c in port_q.store_layout.components)
    assert row == 18150


def test_having_over_vector_aggregates_parity():
    query = ("CREATE TABLE C AS SELECT URL, COLLECT_LIST(USER_ID) AS CL, TOPK(USER_ID, 2) AS TK "
             "FROM PAGE_VIEWS GROUP BY URL HAVING COUNT(*) > 3;")
    _ref, q = run_vector_parity(DDL, query, gen_batches(18, 10, 16, urls=6), 16, 64)
    assert "hpass" in q.state


def test_emit_final_over_vector_aggregates_is_refused():
    # K18 resets an evicted window's scalar components only
    _engine, plan, _schema = plan_for(DDL, (
        "CREATE TABLE C AS SELECT URL, COLLECT_LIST(USER_ID) AS CL FROM PAGE_VIEWS "
        "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT FINAL;"))
    with pytest.raises(DeviceUnsupported, match="COLLECT_LIST under EMIT FINAL on device"):
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=16,
                           device="cpu")


def test_batched_sink_bytes_equal_reference_executor():
    ddl = ("CREATE STREAM PV (URL STRING, UID BIGINT, LAT DOUBLE) "
           "WITH (kafka_topic='pv', key_format='JSON', value_format='JSON');")
    query = ("CREATE TABLE C AS SELECT URL, COLLECT_LIST(UID) AS CL, COLLECT_SET(LAT) AS CS, "
             "TOPK(LAT, 2) AS TK, LATEST_BY_OFFSET(URL, 2) AS LU, HISTOGRAM(URL) AS H "
             "FROM PV WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;")
    rng = np.random.default_rng(3)
    recs, t = [], 1_700_000_000_000
    for _ in range(300):
        t += int(rng.integers(0, 60_000))
        row = {"URL": f"/p/{int(rng.zipf(1.5)) % 9}", "UID": int(rng.integers(1, 9)),
               "LAT": [None, -0.0, 2.5, 3.75][int(rng.integers(0, 4))]}
        recs.append((json.dumps(row), t))
    e = KsqlEngine()
    e.execute_sql(ddl)
    results = e.execute_sql(query)
    plan = e.queries[next(r.query_id for r in results if r.query_id)].plan
    broker = RBroker()
    broker.create_topic("pv")
    ref = DeviceExecutor(plan, broker, e.registry, batch_size=32, per_record=False, store_capacity=64)
    ref._native_fields = None
    for i, (value, ts) in enumerate(recs):
        ref.process("pv", RRecord(key=None, value=value, timestamp=ts, partition=0, offset=i))
    ref.drain()
    want = [(r.key, r.value, r.timestamp, r.window) for r in broker.topic("C").all_records()]
    pbroker = PBroker()
    topic = pbroker.create_topic("pv")
    for value, ts in recs:
        topic.produce(PRecord(key=None, value=value, timestamp=ts, partition=0))
    run_plan(json.loads(json.dumps(plan_to_json(plan))), pbroker, device="cpu", capacity=32,
             store_capacity=64)
    got = [(r.key, r.value, r.timestamp, r.window) for r in pbroker.topic("C").all_records()]
    assert len(got) > 50 and any('"H":{' in v for _k, v, _t, _w in got)
    assert got == want
