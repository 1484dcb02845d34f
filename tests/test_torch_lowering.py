"""TorchCompiledQuery against the reference's CompiledDeviceQuery.

Both are built from the same plan (the port decodes the reference's
``plan_to_json``), fed the same micro-batches, and compared after EVERY
step: the full state dict (every column, every slot, the dump slot
included) and every emit lane the port produces, bit for bit, plus the
decoded SinkEmits.  The cases are the flagship (BASELINE #1) and the
tumbling, unwindowed, stateless and two-key cases of test_device_parity.py,
with store growth (``_grow``), the retention pass, the pipelined double
buffer, and a hand-over of mid-stream reference state.  ``run_parity`` is
also the harness of the hopping cases (``test_torch_hopping.py``).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution import steps as rst
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.common.errors import QueryRuntimeException
from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

jax.config.update("jax_enable_x64", True)

HOUR = 3_600_000
DDL = (
    "CREATE STREAM PAGE_VIEWS (URL STRING, USER_ID BIGINT, LATENCY DOUBLE) "
    "WITH (KAFKA_TOPIC='page_views', KEY_FORMAT='JSON', VALUE_FORMAT='JSON');"
)
PV_DDL = (
    "CREATE STREAM PAGE_VIEWS (URL STRING, USER_ID BIGINT, VIEWTIME BIGINT) "
    "WITH (KAFKA_TOPIC='page_views', VALUE_FORMAT='JSON');"
)
FLAGSHIP = (
    "CREATE TABLE PV_COUNTS AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;"
)
TUMBLING = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;"
)
UNWINDOWED = (
    "CREATE TABLE C AS SELECT USER_ID, SUM(LATENCY) AS S, AVG(LATENCY) AS A, "
    "MIN(LATENCY) AS MN, MAX(LATENCY) AS MX, COUNT(LATENCY) AS C "
    "FROM PAGE_VIEWS GROUP BY USER_ID;"
)
STATELESS = (
    "CREATE STREAM S AS SELECT URL, USER_ID, LATENCY * 2 AS L2 "
    "FROM PAGE_VIEWS WHERE LATENCY > 100 EMIT CHANGES;"
)
TWO_KEYS = (
    "CREATE TABLE C AS SELECT URL, USER_ID, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "GROUP BY URL, USER_ID;"
)


def plan_for(ddl, query):
    engine = KsqlEngine()
    engine.execute_sql(ddl)
    results = engine.execute_sql(query)
    qid = next(r.query_id for r in results if r.query_id)
    plan = engine.queries[qid].plan
    return engine, plan, engine.metastore.get_source(plan.source_names[0]).schema


def gen_batches(seed, n_batches, rows, urls=40, users=30, ts_step=120_000, pv=False):
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    out = []
    for _ in range(n_batches):
        batch, ts = [], []
        for _ in range(rows):
            t += int(rng.integers(0, 2 * ts_step))
            row = {
                "URL": f"/page/{int(rng.zipf(1.3)) % urls}" if rng.random() > 0.05 else None,
                "USER_ID": int(rng.integers(1, users)),
            }
            if pv:
                row["VIEWTIME"] = t
            else:
                row["LATENCY"] = float(rng.uniform(0.1, 500.0)) if rng.random() > 0.1 else None
            batch.append(row)
            # a few late records reach back past the window's grace
            ts.append(t - (int(rng.integers(30, 40)) * HOUR if rng.random() < 0.03 else 0))
        out.append((batch, ts))
    return out


def _capture(q, sink):
    orig = q._decode_emits

    def wrapped(emits, *a, **k):
        sink.append({name: np.asarray(v) for name, v in emits.items()})
        return orig(emits, *a, **k)

    q._decode_emits = wrapped


def _as_tuples(emits):
    return [(e.key, e.row, e.ts, e.window) for e in emits]


def assert_same_state(ref_q, port_q, where):
    want = {k: np.asarray(v) for k, v in jax.device_get(ref_q.state).items()}
    got = state_to_numpy(port_q.state)
    assert set(got) == set(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}: {k}")


def assert_same_lanes(ref_lanes, port_lanes, where):
    assert len(ref_lanes) == len(port_lanes), where
    for lr, lp in zip(ref_lanes, port_lanes):
        # dec_envelope is the DECIMAL-SUM exactness lane, which the port
        # emits only when a DECIMAL SUM is among the aggregates (none here);
        # the reference's must be 0
        assert set(lp) == set(lr) - {"dec_envelope"}, where
        assert int(lr.get("dec_envelope", np.zeros(1)).sum()) == 0
        for k in lp:
            assert lp[k].dtype == lr[k].dtype, (where, k)
            np.testing.assert_array_equal(lp[k], lr[k], err_msg=f"{where}: {k}")


def run_parity(ddl, query, batches, capacity, store, pipeline=False,
               evict_interval=None, handoff_at=None, flush_to=None, **query_kw):
    """``query_kw`` (``sliced``, ``slice_ring_max``) goes to both queries;
    ``flush_to`` ends the run with ``flush(flush_to)`` on both (EMIT
    FINAL's end-of-input close), compared as every step is."""
    engine, plan, schema = plan_for(ddl, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, store_capacity=store,
                                **query_kw)
    port_plan = plan_from_json(json.loads(json.dumps(plan_to_json(plan))))
    port_q = TorchCompiledQuery(port_plan, capacity=capacity, store_capacity=store, device="cpu",
                                **query_kw)
    port_schema = LogicalSchema.from_json(schema.to_json())
    ref_q.pipeline = port_q.pipeline = pipeline
    if evict_interval is not None:
        ref_q.EVICT_INTERVAL = port_q.EVICT_INTERVAL = evict_interval
    ref_lanes, port_lanes = [], []
    _capture(ref_q, ref_lanes)
    _capture(port_q, port_lanes)
    n_emits = 0
    for i, (rows, ts) in enumerate(batches):
        if i == handoff_at:
            # carry the reference's mid-stream state into a fresh port query
            port_q = TorchCompiledQuery(port_plan, capacity=capacity,
                                        store_capacity=ref_q.store_capacity, device="cpu",
                                        **query_kw)
            port_q.pipeline = pipeline
            port_q.EVICT_INTERVAL = ref_q.EVICT_INTERVAL
            if ref_q.sliced:
                port_q._resize_ring(ref_q.slice_ring)
                port_q._mirror_max_ts = ref_q._mirror_max_ts
                port_q._host_min_slice = ref_q._host_min_slice
            port_q.state = state_from_numpy(jax.device_get(ref_q.state), "cpu")
            port_q.dictionary._map.update(ref_q.dictionary._map)
            port_q._batches = ref_q._batches
            port_q._seen_overflow = ref_q._seen_overflow
            _capture(port_q, port_lanes)
        arrays = ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts))
        got_arrays = port_q.layout.encode(PHostBatch.from_rows(port_schema, rows, timestamps=ts))
        assert set(arrays) == set(got_arrays)
        for k in arrays:
            np.testing.assert_array_equal(got_arrays[k], arrays[k])
        want = ref_q.process_arrays(arrays)
        got = port_q.process_arrays(got_arrays)
        assert _as_tuples(got) == _as_tuples(want), f"batch {i}"
        n_emits += len(want)
        assert port_q.store_capacity == ref_q.store_capacity, f"batch {i}"
        assert_same_state(ref_q, port_q, f"batch {i}")
        assert_same_lanes(ref_lanes, port_lanes, f"batch {i}")
    if pipeline:
        want, got = ref_q.flush_pipeline(), port_q.flush_pipeline()
        assert _as_tuples(got) == _as_tuples(want)
        assert_same_lanes(ref_lanes, port_lanes, "flush")
        n_emits += len(want)
    if flush_to is not None:
        want, got = ref_q.flush(flush_to), port_q.flush(flush_to)
        assert _as_tuples(got) == _as_tuples(want), "flush_to"
        assert_same_state(ref_q, port_q, "flush_to")
        assert_same_lanes(ref_lanes, port_lanes, "flush_to")
        n_emits += len(want)
    assert n_emits > 0
    return ref_q, port_q


def test_flagship_parity_with_growth():
    batches = gen_batches(1, 10, 64, urls=300, ts_step=30_000, pv=True)
    _, q = run_parity(PV_DDL, FLAGSHIP, batches, capacity=64, store=128)
    assert q.grows >= 2


def test_flagship_parity_pipelined_with_evict():
    # ~40 h of event time: windows leave the 25 h retention, the periodic
    # pass (every 4 batches here) turns them into graves
    batches = gen_batches(2, 16, 48, urls=60, ts_step=100_000, pv=True)
    ref_q, q = run_parity(PV_DDL, FLAGSHIP, batches, capacity=48, store=256,
                          pipeline=True, evict_interval=4)
    assert q.evictions >= 3
    assert bool(np.asarray(ref_q.state["grave"]).any()) or q.compactions > 0


def test_tumbling_count_group_by_url_parity():
    run_parity(DDL, TUMBLING, gen_batches(3, 12, 16, urls=8, ts_step=200_000), capacity=16, store=64)


def test_unwindowed_sum_avg_min_max_parity():
    run_parity(DDL, UNWINDOWED, gen_batches(4, 12, 32, users=50), capacity=32, store=32)


def test_stateless_filter_project_parity():
    run_parity(DDL, STATELESS, gen_batches(5, 8, 25), capacity=25, store=64)


def test_group_by_two_keys_parity():
    _, q = run_parity(DDL, TWO_KEYS, gen_batches(6, 12, 32, urls=20, users=20), capacity=32, store=64)
    assert q.grows >= 1


def test_handoff_of_midstream_reference_state():
    # the reference runs the first half (growth, graves, near-full store);
    # the port takes over from its state and must continue bit for bit
    batches = gen_batches(7, 16, 32, urls=200, ts_step=150_000, pv=True)
    _, q = run_parity(PV_DDL, FLAGSHIP, batches, capacity=32, store=64,
                      evict_interval=4, handoff_at=8)
    assert int(q.state["overflow"]) == 0


def test_retention_pass_matches_reference_at_the_boundary():
    # slots whose window start + retention lands just below, on and just
    # above the stream time: only the strictly older ones expire
    engine, plan, _schema = plan_for(PV_DDL, FLAGSHIP)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=8, store_capacity=16)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8,
                                store_capacity=16, device="cpu")
    st = {k: np.array(v) for k, v in jax.device_get(ref_q.state).items()}
    max_ts = 100 * HOUR
    retention = ref_q.retention_ms
    assert retention == port_q.retention_ms == 25 * HOUR
    st["max_ts"] = np.array(max_ts, np.int64)
    st["occ"][:6] = True
    st["dirty"][:6] = True
    st["wstart"][:6] = max_ts - retention + np.array([-HOUR, -1, 0, 1, HOUR, 0])
    st["a0"][:6] = st["wstart"][:6] + 5
    st["a1"][:6] = np.arange(1, 7)
    st["occ"][5] = False  # a free slot never expires
    ref_q.state = {k: jax.numpy.asarray(v) for k, v in st.items()}
    port_q.state = state_from_numpy(st, "cpu")
    ref_q.state = ref_q._evict(ref_q.state)
    port_q._evict()
    assert_same_state(ref_q, port_q, "evict")
    assert list(np.asarray(ref_q.state["grave"])[:6]) == [True, True, False, False, False, False]


def test_overflow_raises_like_reference():
    # a store with no time to grow: both lose rows in the same batch and
    # fail loudly (the reference's _react_to_load contract)
    engine, plan, schema = plan_for(PV_DDL, FLAGSHIP)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=256, store_capacity=64)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=256,
                                store_capacity=64, device="cpu")
    pschema = LogicalSchema.from_json(schema.to_json())
    rows = [{"URL": f"/u/{i}", "USER_ID": 1, "VIEWTIME": 0} for i in range(200)]
    ts = [1_700_000_000_000] * len(rows)
    with pytest.raises(Exception, match="overflowed") as ref_err:
        ref_q.process(RHostBatch.from_rows(schema, rows, timestamps=ts))
    with pytest.raises(QueryRuntimeException, match="overflowed") as port_err:
        port_q.process(PHostBatch.from_rows(pschema, rows, timestamps=ts))
    assert str(port_err.value).split(";")[0] == str(ref_err.value).split(";")[0]
    assert_same_state(ref_q, port_q, "overflow")


#: two keyed streams for the stream-stream join cases (ss_join_grace's DDL)
SS_DDL = (
    "CREATE STREAM LEFTS (ID BIGINT KEY, V BIGINT) WITH (KAFKA_TOPIC='lt', VALUE_FORMAT='JSON');"
    "CREATE STREAM RIGHTS (ID BIGINT KEY, V BIGINT) WITH (KAFKA_TOPIC='rt', VALUE_FORMAT='JSON');"
)
SS_AGG = ("CREATE TABLE C AS SELECT L.ID, COUNT(*) AS CNT FROM LEFTS L JOIN RIGHTS R "
          "WITHIN 10 SECONDS ON L.ID = R.ID ")
UNSUPPORTED = {
    # TUMBLING and HOPPING EMIT FINAL and HAVING over EMIT CHANGES run on the
    # port (tests/test_torch_emit_final.py, test_torch_having.py); these
    # cases keep shapes that both packages refuse
    "hopping_emit_final": SS_AGG + "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 20 MINUTES) "
                                   "GROUP BY L.ID EMIT FINAL;",
    # SESSION windows run on the port (tests/test_torch_session.py); HAVING
    # over them stays refused, as the reference refuses it
    "session": "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
               "WINDOW SESSION (5 MINUTES) GROUP BY URL HAVING COUNT(*) > 1;",
    "emit_final": "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
                  "WINDOW SESSION (5 MINUTES) GROUP BY URL EMIT FINAL;",
    "having": SS_AGG + "GROUP BY L.ID HAVING COUNT(*) > 3;",
    # vector aggregates run on the port (tests/test_torch_vector_aggs.py);
    # over SESSION windows both packages refuse them
    "collect_list": "CREATE TABLE C AS SELECT URL, COLLECT_LIST(USER_ID) AS CL FROM PAGE_VIEWS "
                    "WINDOW SESSION (5 MINUTES) GROUP BY URL;",
    "partition_by": "CREATE STREAM S AS SELECT URL, USER_ID FROM PAGE_VIEWS PARTITION BY USER_ID;",
    # the device function table (ABS, ROUND, ...) runs on the port
    # (tests/test_torch_expr.py); a function outside it stays refused, by
    # both packages
    "function": "CREATE TABLE C AS SELECT URL, CONCAT(URL, 'x') AS A, COUNT(*) AS N FROM PAGE_VIEWS "
                "GROUP BY URL;",
}
#: the cases over the two keyed streams
UNSUPPORTED_SS = ("hopping_emit_final", "having")
#: a table aggregation over USERS (tests/test_engine_device.py:121); table
#: aggregations run on the port (tests/test_torch_table_agg.py), and the
#: planner refuses MIN over a table and EMIT FINAL without a window before
#: any device sees them, so these two cases are hand edits of its plan
TABLE_DDL = ("CREATE TABLE USERS (ID INT PRIMARY KEY, REGION STRING, AMT INT) "
             "WITH (kafka_topic='u', value_format='JSON');")
TABLE_AGG = ("CREATE TABLE C AS SELECT REGION, COUNT(*) AS N, SUM(AMT) AS S FROM USERS "
             "GROUP BY REGION;")


def _edit_table_agg(edit):
    engine, plan, schema = plan_for(TABLE_DDL, TABLE_AGG)
    return engine, dataclasses.replace(plan, physical_plan=edit(plan.physical_plan)), schema


def _min_over_table(sink):
    """SUM(AMT) -> MIN(AMT) in the TableAggregate under the sink's select."""
    select = sink.source
    agg = select.source
    calls = tuple(dataclasses.replace(c, function="MIN") if c.function.upper() == "SUM" else c
                  for c in agg.aggregations)
    return dataclasses.replace(sink, source=dataclasses.replace(
        select, source=dataclasses.replace(agg, aggregations=calls)))


def _suppress_over_table(sink):
    return dataclasses.replace(sink, source=rst.TableSuppress(source=sink.source,
                                                              schema=sink.source.schema))


def _latest_over_table(sink):
    """SUM(AMT) -> LATEST_BY_OFFSET(AMT): the offsets do not invert, so a
    table aggregation refuses them (the planner lets the edit through)."""
    select = sink.source
    agg = select.source
    calls = tuple(dataclasses.replace(c, function="LATEST_BY_OFFSET") if c.function.upper() == "SUM"
                  else c for c in agg.aggregations)
    return dataclasses.replace(sink, source=dataclasses.replace(
        select, source=dataclasses.replace(agg, aggregations=calls)))


UNSUPPORTED["min_table_agg"] = lambda: _edit_table_agg(_min_over_table)
UNSUPPORTED["latest_table_agg"] = lambda: _edit_table_agg(_latest_over_table)
UNSUPPORTED["suppress_table_agg"] = lambda: _edit_table_agg(_suppress_over_table)


def _unsupported(name):
    case = UNSUPPORTED[name]
    if callable(case):
        return case()
    return plan_for(SS_DDL if name in UNSUPPORTED_SS else DDL, case)


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_plan_raises(name):
    _engine, plan, _schema = _unsupported(name)
    with pytest.raises(DeviceUnsupported):
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=16, device="cpu")


@pytest.mark.parametrize("name", ["hopping_emit_final", "session", "emit_final", "having",
                                  "collect_list", "min_table_agg", "suppress_table_agg", "function",
                                  "latest_table_agg"])
def test_refusal_message_is_the_references(name):
    # the EMIT FINAL, HAVING, vector-over-SESSION and table-aggregation
    # shapes still refused: the reference refuses them too, with the same
    # words
    engine, plan, _schema = _unsupported(name)
    with pytest.raises(Exception) as ref_err:
        CompiledDeviceQuery(plan, engine.registry, capacity=8, store_capacity=16)
    with pytest.raises(DeviceUnsupported) as port_err:
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=16,
                           device="cpu")
    assert str(port_err.value) == str(ref_err.value)
