"""Stream-table joins: the port against ``ksql_tpu``'s device backend.

Per step: ``TorchCompiledQuery`` and ``CompiledDeviceQuery`` are built from
the same plan and fed the same table-changelog batches (rows and the
``delete`` lane, through ``process_table``) and stream batches (through
``process_arrays``); after EVERY step the whole state dict (each join
table store ``jtab``/``jtab<i>`` and the aggregate store, dump rows
included) and every emit lane must be equal, floats compared by their
bits.  The queries are ``tests/test_device_join.py``'s four, BASELINE #3's
``ENRICHED`` and the two n-way chains of ``tests/test_engine_device.py``,
with table-store growth across steps.

End to end: the port's ``start_plan``/``run_until_quiescent`` against the
reference engine on its device backend and on the row oracle, record for
record, on ``test_device_join.py``'s ``FEED`` per record, and the batched
``JOIN_AGG`` burst against the reference executor.
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
from ksql_tpu_torch.runner import run_until_quiescent, start_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from ksql_tpu_torch.state import state_to_numpy
from tests.test_device_join import (
    CLICKS_DDL,
    FEED,
    INNER_JOIN,
    JOIN_AGG,
    JOIN_FILTER_AGG,
    LEFT_JOIN,
    USERS_DDL,
)
from tests.test_device_join import _run as engine_run
from tests.test_torch_lowering import _as_tuples, _capture, assert_same_lanes

jax.config.update("jax_enable_x64", True)

# BASELINE #3 (bench.py:534, bench_stream_table_join)
ENRICHED = (
    "CREATE STREAM ENRICHED AS SELECT C.USER_ID, C.URL, U.REGION "
    "FROM CLICKS C LEFT JOIN USERS U ON C.USER_ID = U.ID "
    "WHERE U.REGION <> 'excluded' EMIT CHANGES;"
)
# the n-way chains of tests/test_engine_device.py:310-345
NWAY_DDL = (
    "CREATE STREAM S (ID INT KEY, UID INT, PID INT, V INT) "
    "WITH (kafka_topic='s', value_format='JSON');",
    "CREATE TABLE U (UID INT PRIMARY KEY, UNAME STRING) "
    "WITH (kafka_topic='u', value_format='JSON');",
    "CREATE TABLE P (PID INT PRIMARY KEY, PNAME STRING) "
    "WITH (kafka_topic='p', value_format='JSON');",
)
NWAY_STREAM = (
    "CREATE STREAM J AS SELECT S.PID, S.UID, UNAME, PNAME, V FROM S "
    "LEFT JOIN U ON S.UID = U.UID LEFT JOIN P ON S.PID = P.PID;"
)
NWAY_AGG = (
    "CREATE TABLE G AS SELECT UNAME, COUNT(*) C, SUM(V) SV FROM S "
    "JOIN U ON S.UID = U.UID JOIN P ON S.PID = P.PID GROUP BY UNAME;"
)
CU_DDL = (USERS_DDL, CLICKS_DDL)
REGIONS = ["eu", "us", "ap", "excluded", None]


def plan_of(ddls, query):
    engine = KsqlEngine()
    for d in ddls:
        engine.execute_sql(d)
    results = engine.execute_sql(query)
    return engine, engine.queries[next(r.query_id for r in results if r.query_id)].plan


def _same_bits(got, want, where):
    assert got.dtype == want.dtype, where
    if got.dtype.kind == "f":
        got, want = got.view(np.int64), want.view(np.int64)
    np.testing.assert_array_equal(got, want, err_msg=where)


def assert_same_nested_state(ref_q, port_q, where):
    def cmp(want, got, path):
        assert set(got) == set(want), path
        for k, w in want.items():
            if isinstance(w, dict):
                cmp(w, got[k], f"{path}.{k}")
            else:
                _same_bits(got[k], np.asarray(w), f"{path}.{k}")

    cmp(jax.device_get(ref_q.state), state_to_numpy(port_q.state), where)


def _pschema(schema):
    return LogicalSchema.from_json(schema.to_json())


def run_join_parity(ddls, query, steps, capacity, store=64, table_store=16, pipeline=False):
    """Drive both queries through ``steps``: ``("T", idx, rows, ts,
    deletes)`` is a table batch of probe ``idx``, ``("S", rows, ts)`` a
    stream batch; full state and emits are compared after each.  Returns
    both queries and the number of steps after which a table store held
    graves (a grow drops them)."""
    engine, plan = plan_of(ddls, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, store_capacity=store,
                                table_store_capacity=table_store)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=capacity, store_capacity=store, device="cpu",
                                table_store_capacity=table_store)
    ref_q.pipeline = port_q.pipeline = pipeline
    ref_lanes, port_lanes = [], []
    _capture(ref_q, ref_lanes)
    _capture(port_q, port_lanes)
    sschema = ref_q.source.schema
    n_emits = 0
    grave_steps = 0
    for i, step in enumerate(steps):
        where = f"step {i} ({step[0]})"
        if step[0] == "T":
            _, idx, rows, ts, dels = step
            tschema = ref_q.join_chain[idx].table_source.schema
            ref_q.process_table(RHostBatch.from_rows(tschema, rows, timestamps=ts),
                                np.asarray(dels, bool), idx=idx)
            port_q.process_table(PHostBatch.from_rows(_pschema(tschema), rows, timestamps=ts),
                                 np.asarray(dels, bool), idx=idx)
        else:
            _, rows, ts = step
            arrays = ref_q.layout.encode(RHostBatch.from_rows(sschema, rows, timestamps=ts))
            got_arrays = port_q.layout.encode(PHostBatch.from_rows(_pschema(sschema), rows, timestamps=ts))
            assert set(arrays) == set(got_arrays)
            for k in arrays:
                np.testing.assert_array_equal(got_arrays[k], arrays[k])
            want = ref_q.process_arrays(arrays)
            got = port_q.process_arrays(got_arrays)
            assert _as_tuples(got) == _as_tuples(want), where
            n_emits += len(want)
            assert_same_lanes(ref_lanes, port_lanes, where)
        assert [j.capacity for j in port_q.join_chain] == [j.capacity for j in ref_q.join_chain], where
        assert port_q.store_capacity == ref_q.store_capacity, where
        assert_same_nested_state(ref_q, port_q, where)
        grave_steps += any(bool(port_q.state[port_q._jtab_key(j)]["grave"].any())
                           for j in range(len(port_q.join_chain)))
    if pipeline:
        want, got = ref_q.flush_pipeline(), port_q.flush_pipeline()
        assert _as_tuples(got) == _as_tuples(want)
        assert_same_lanes(ref_lanes, port_lanes, "flush")
        n_emits += len(want)
    assert n_emits > 0
    return ref_q, port_q, grave_steps


# ------------------------------------------------------------- data
def user_steps(seed, n_batches, rows, keys, capacity, t0=0):
    """Table batches of USERS changes: repeated keys in one batch,
    tombstones of present and absent keys, delete + re-insert pairs and
    null keys."""
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for _ in range(n_batches):
        batch, ts, dels = [], [], []
        for _ in range(rows):
            t += 1
            k = int(rng.integers(0, keys))
            u = rng.random()
            if u < 0.12:  # tombstone (the key may be absent)
                batch.append({"ID": k, "NAME": None, "REGION": None})
                dels.append(True)
            elif u < 0.16:  # null key: never reaches the store
                batch.append({"ID": None, "NAME": "nobody", "REGION": "eu"})
                dels.append(False)
            else:
                batch.append({"ID": k, "NAME": f"n{k}_{t}",
                              "REGION": REGIONS[int(rng.integers(0, len(REGIONS)))]})
                dels.append(False)
            ts.append(t)
            if u > 0.93 and len(batch) < rows - 1:  # delete + re-insert in one batch
                batch.append({"ID": k, "NAME": None, "REGION": None})
                dels.append(True)
                batch.append({"ID": k, "NAME": f"re{k}", "REGION": "us"})
                dels.append(False)
                ts += [t, t]
            batch, ts, dels = batch[:rows], ts[:rows], dels[:rows]
        out.append(("T", 0, batch, ts, dels))
    return out, t


def click_steps(seed, n_batches, rows, keys, t0):
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for _ in range(n_batches):
        batch, ts = [], []
        for _ in range(rows):
            t += int(rng.integers(1, 1000))
            uid = int(rng.integers(0, 2 * keys)) if rng.random() > 0.05 else None
            batch.append({"USER_ID": uid, "URL": f"/p{int(rng.integers(0, 7))}"})
            ts.append(t)
        out.append(("S", batch, ts))
    return out, t


def interleaved(seed, capacity, keys, rounds):
    steps, t = user_steps(seed, 2, capacity, keys, capacity)
    for r in range(rounds):
        s, t = click_steps(seed + 100 + r, 2, capacity, keys, t)
        steps += s
        u, t = user_steps(seed + 200 + r, 1, capacity, keys, capacity, t)
        steps += u
    return steps


@pytest.mark.parametrize("name,query,pipeline", [
    ("left", LEFT_JOIN, False),
    ("inner", INNER_JOIN, True),
    ("join_agg", JOIN_AGG, False),
    ("join_filter_agg", JOIN_FILTER_AGG, True),
    ("enriched", ENRICHED, True),
])
def test_join_state_parity_with_table_growth(name, query, pipeline):
    # 60 keys through a 16-slot table store: it must grow (twice) between steps
    steps = interleaved(len(name), capacity=16, keys=60, rounds=3)
    _ref_q, q, grave_steps = run_join_parity(CU_DDL, query, steps, capacity=16, store=16,
                                             table_store=16, pipeline=pipeline)
    assert q.table_grows >= 2 and q.table_store_capacity >= 64
    assert grave_steps >= 1, "the tombstones should leave graves"


def nway_steps(seed, capacity, rounds):
    rng = np.random.default_rng(seed)
    steps, t = [], 0
    for r in range(rounds):
        for idx, (col, name) in enumerate((("UID", "UNAME"), ("PID", "PNAME"))):
            rows, ts, dels = [], [], []
            for _ in range(capacity):
                t += 1
                k = int(rng.integers(0, 20))
                dead = rng.random() < 0.15
                rows.append({col: k, name: None if dead else f"{name[0].lower()}{k}_{t}"})
                ts.append(t)
                dels.append(dead)
            steps.append(("T", idx, rows, ts, dels))
        rows, ts = [], []
        for i in range(capacity):
            t += 3
            rows.append({"ID": i, "UID": int(rng.integers(0, 30)) if rng.random() > 0.05 else None,
                         "PID": int(rng.integers(0, 30)), "V": int(rng.integers(-5, 50))})
            ts.append(t)
        steps.append(("S", rows, ts))
    return steps


@pytest.mark.parametrize("query", [NWAY_STREAM, NWAY_AGG], ids=["stream", "agg"])
def test_nway_chain_state_parity(query):
    steps = nway_steps(7, capacity=8, rounds=4)
    _ref_q, q, _graves = run_join_parity(NWAY_DDL, query, steps, capacity=8, store=32, table_store=16)
    assert len(q.join_chain) == 2 and set(q.state) >= {"jtab", "jtab0"}
    assert q.table_grows >= 1


def test_table_store_growth_preserves_contents():
    # tests/test_device_join.py::test_table_store_growth_preserves_contents
    # on the port: 40 distinct keys through a 16-slot store
    engine, plan = plan_of(CU_DDL, LEFT_JOIN)
    q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu",
                           table_store_capacity=16)
    uschema = _pschema(engine.metastore.get_source("USERS").schema)
    for start in range(0, 40, 8):
        rows = [{"ID": k, "NAME": f"u{k}", "REGION": "eu"} for k in range(start, start + 8)]
        q.process_table(PHostBatch.from_rows(uschema, rows, timestamps=[0] * 8), np.zeros(8, bool))
    assert q.table_store_capacity >= 64
    cschema = _pschema(engine.metastore.get_source("CLICKS").schema)
    emits = q.process(PHostBatch.from_rows(
        cschema, [{"USER_ID": k, "URL": "/x"} for k in [0, 17, 39, 99]], timestamps=[1, 2, 3, 4]))
    assert {e.row["USER_ID"]: e.row["NAME"] for e in emits} == {0: "u0", 17: "u17", 39: "u39", 99: None}


def test_table_overflow_raises_like_reference():
    # a table batch wider than its store: both lose rows in the same batch
    engine, plan = plan_of(CU_DDL, LEFT_JOIN)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=64, table_store_capacity=16)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=64, device="cpu",
                                table_store_capacity=16)
    tschema = ref_q.join_chain[0].table_source.schema
    rows = [{"ID": k, "NAME": "x", "REGION": "eu"} for k in range(40)]
    with pytest.raises(Exception, match="overflowed") as ref_err:
        ref_q.process_table(RHostBatch.from_rows(tschema, rows, timestamps=[0] * 40), np.zeros(40, bool))
    with pytest.raises(Exception, match="overflowed") as port_err:
        port_q.process_table(PHostBatch.from_rows(_pschema(tschema), rows, timestamps=[0] * 40),
                             np.zeros(40, bool))
    assert str(port_err.value) == str(ref_err.value)
    assert_same_nested_state(ref_q, port_q, "overflow")


REFUSED = {
    "right_join": ("CREATE STREAM J AS SELECT C.USER_ID, U.NAME FROM CLICKS C "
                   "RIGHT JOIN USERS U ON C.USER_ID = U.ID;"),
    # foreign-key and table-table joins run since their slice; over one
    # topic on both sides they stay refused, as in the reference
    "fk_join": ("CREATE TABLE F AS SELECT U.ID, U.NAME, R.ZONE FROM USERS U "
                "JOIN REGIONS_SAME R ON U.REGION = R.NAME;"),
    # stream-stream joins run since their slice; an aggregation over one
    # stays refused, as in the reference
    "ss_join": ("CREATE TABLE J AS SELECT C.USER_ID, COUNT(*) AS N FROM CLICKS C "
                "JOIN CLICKS2 D WITHIN 10 SECONDS ON C.USER_ID = D.USER_ID GROUP BY C.USER_ID;"),
    "tt_join": ("CREATE TABLE T AS SELECT U.ID, U.NAME, V.REGION FROM USERS U "
                "JOIN USERS_ALIAS V ON U.ID = V.ID;"),
    "same_topic_chain": ("CREATE STREAM J AS SELECT C.USER_ID, U.NAME, V.REGION FROM CLICKS C "
                         "LEFT JOIN USERS U ON C.USER_ID = U.ID LEFT JOIN USERS_ALIAS V "
                         "ON C.USER_ID = V.ID;"),
}
REFUSED_DDL = CU_DDL + (
    "CREATE STREAM CLICKS2 (USER_ID BIGINT, URL STRING) "
    "WITH (kafka_topic='clicks2', value_format='JSON');",
    "CREATE TABLE USERS2 (ID BIGINT PRIMARY KEY, NAME STRING, REGION STRING) "
    "WITH (kafka_topic='users2', value_format='JSON');",
    "CREATE TABLE USERS_ALIAS (ID BIGINT PRIMARY KEY, NAME STRING, REGION STRING) "
    "WITH (kafka_topic='users', value_format='JSON');",
    "CREATE TABLE REGIONS (NAME STRING PRIMARY KEY, ZONE STRING) "
    "WITH (kafka_topic='regions', value_format='JSON');",
    "CREATE TABLE REGIONS_SAME (NAME STRING PRIMARY KEY, ZONE STRING) "
    "WITH (kafka_topic='users', value_format='JSON');",
)


@pytest.mark.parametrize("name", list(REFUSED))
def test_unsupported_join_plan_raises(name):
    engine, plan = plan_of(REFUSED_DDL, REFUSED[name])
    with pytest.raises(Exception) as ref_err:
        CompiledDeviceQuery(plan, engine.registry, capacity=8)
    with pytest.raises(DeviceUnsupported) as port_err:
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu")
    # in the reference's words
    assert str(port_err.value) == str(ref_err.value)


# ----------------------------------------------------------- end to end
def port_feed(query, feed, capacity, ddls=CU_DDL, per_step=True):
    """The port's runner over ``feed`` ((side, key, value, ts) as in
    test_device_join.py): each record produced and polled in turn (or all
    at once), with the engine's drain at the end."""
    _engine, plan = plan_of(ddls, query)
    broker = PBroker()
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), broker, device="cpu",
                   capacity=capacity, store_capacity=64, table_store_capacity=16)
    for side, key, val, ts in feed:
        broker.topic("users" if side == "U" else "clicks").produce(
            PRecord(key=key, value=None if val is None else json.dumps(val), timestamp=ts))
        if per_step:
            run_until_quiescent(h)
            h.executor.drain()
    run_until_quiescent(h)
    h.executor.drain()
    sink = plan.physical_plan.topic
    return h.executor, [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]


@pytest.mark.parametrize("query", [LEFT_JOIN, INNER_JOIN, JOIN_AGG, JOIN_FILTER_AGG, ENRICHED],
                         ids=["left", "inner", "join_agg", "join_filter_agg", "enriched"])
def test_feed_per_record_equals_device_backend_and_oracle(query):
    _e, handle, dev = engine_run(query, "device")
    assert handle.backend == "device"
    _e, _h, ora = engine_run(query, "oracle")
    _ex, port = port_feed(query, FEED, capacity=1)
    assert len(port) >= 3
    assert port == dev
    assert port == ora


def test_batched_join_agg_burst_equals_reference_executor_and_oracle():
    # test_device_join.py::test_device_join_batched_mode_final_state: the
    # table primed first, then a burst of stream rows over several batches
    table = [f for f in FEED if f[0] == "U" and f[2] is not None][:2]
    clicks = [("C", None, {"USER_ID": 1 + (i % 3), "URL": f"/p{i % 5}"}, 100 + i) for i in range(37)]
    engine, plan = plan_of(CU_DDL, JOIN_AGG)
    broker = RBroker()
    for t in ("users", "clicks"):
        broker.create_topic(t)
    ref = DeviceExecutor(plan, broker, engine.registry, batch_size=4, per_record=False)
    ref._native_fields = None
    for part in (table, clicks):
        for i, (side, key, val, ts) in enumerate(part):
            ref.process("users" if side == "U" else "clicks",
                        RRecord(key=key, value=json.dumps(val), timestamp=ts, partition=0, offset=i))
        ref.drain()
    want = [(r.key, r.value, r.timestamp) for r in broker.topic(plan.physical_plan.topic).all_records()]

    pbroker = PBroker()
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), pbroker, device="cpu", capacity=4,
                   store_capacity=64)
    for part in (table, clicks):
        for side, key, val, ts in part:
            pbroker.topic("users" if side == "U" else "clicks").produce(
                PRecord(key=key, value=json.dumps(val), timestamp=ts))
        run_until_quiescent(h)
        h.executor.drain()
    got = [(r.key, r.value, r.timestamp) for r in pbroker.topic(plan.physical_plan.topic).all_records()]
    assert h.executor.query.pipeline and len(got) > 3
    assert got == want
    # and the final table equals the oracle's materialized state
    e_ora, _h = _oracle_burst(table, clicks)
    ora = {tuple(r[k] for k in ("REGION",)): (r["CNT"], r["NAMES"])
           for r in e_ora.execute_sql("SELECT * FROM E;")[0].rows}
    last = {}
    for key, value, _ts in got:
        v = json.loads(value)
        last[(json.loads(key) if key and key.startswith('"') else key,)] = (v["CNT"], v["NAMES"])
    assert last == ora


def _oracle_burst(table, clicks):
    e, handle, _ = engine_run(JOIN_AGG, "oracle", per_record=True, feed=table)
    for _side, key, val, ts in clicks:
        e.broker.topic("clicks").produce(RRecord(key=key, value=json.dumps(val), timestamp=ts))
    e.run_until_quiescent()
    return e, handle


def test_start_plan_subscribes_to_every_source_topic_sorted():
    _engine, plan = plan_of(NWAY_DDL, NWAY_STREAM)
    h = start_plan(plan_to_json(plan), PBroker(), device="cpu", capacity=4)
    assert h.executor.source_topics == ["p", "s", "u"]
    assert h.consumer.topic_names == ["p", "s", "u"]


def test_aggregate_store_grow_keeps_every_table_store():
    # an aggregation over an n-way chain whose aggregate store grows: both
    # table stores come through the rebuild unchanged (the reference's
    # _grow sets aside only "jtab" and fails on "jtab0")
    engine, plan = plan_of(NWAY_DDL, NWAY_AGG)
    q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=8,
                           device="cpu", table_store_capacity=16)
    for idx, (col, name) in enumerate((("UID", "UNAME"), ("PID", "PNAME"))):
        schema = _pschema(engine.metastore.get_source("UP"[idx]).schema)
        rows = [{col: k, name: f"{name[0]}{k}"} for k in range(8)]
        q.process_table(PHostBatch.from_rows(schema, rows, timestamps=[0] * 8), np.zeros(8, bool), idx=idx)
    tables = {k: v for k, v in state_to_numpy(q.state).items() if isinstance(v, dict)}
    sschema = _pschema(engine.metastore.get_source("S").schema)
    counts = {}
    for b in range(4):
        rows = [{"ID": i, "UID": (3 * b + i) % 8, "PID": i, "V": 1} for i in range(8)]
        for e in q.process(PHostBatch.from_rows(sschema, rows, timestamps=[10 * b + i for i in range(8)])):
            counts[e.row["UNAME"]] = e.row["C"]
    assert q.grows >= 1
    after = {k: v for k, v in state_to_numpy(q.state).items() if isinstance(v, dict)}
    assert set(after) == set(tables) == {"jtab", "jtab0"}
    for key in tables:
        for col in tables[key]:
            np.testing.assert_array_equal(after[key][col], tables[key][col])
    assert counts == {f"U{k}": 4 for k in range(8)}


def test_ring_resize_keeps_the_table_store():
    # a hopping aggregation over a join: the first stream batch spans 40 h
    # and widens the empty sliced store's ring; the table must survive
    hop = ("CREATE TABLE H AS SELECT U.REGION, COUNT(*) AS C FROM CLICKS C JOIN USERS U "
           "ON C.USER_ID = U.ID WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 15 MINUTES) "
           "GROUP BY U.REGION EMIT CHANGES;")
    engine, plan = plan_of(CU_DDL, hop)
    q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=64,
                           device="cpu", table_store_capacity=16)
    assert q.sliced
    uschema = _pschema(engine.metastore.get_source("USERS").schema)
    q.process_table(PHostBatch.from_rows(uschema, [{"ID": k, "NAME": "n", "REGION": "eu"} for k in range(4)],
                                         timestamps=[0] * 4), np.zeros(4, bool))
    ring = q.slice_ring
    t0 = 1_700_000_000_000
    ts = [t0] + [t0 + 40 * 3_600_000] * 7
    emits = q.process(PHostBatch.from_rows(_pschema(engine.metastore.get_source("CLICKS").schema),
                                           [{"USER_ID": k % 4, "URL": "/x"} for k in range(8)], timestamps=ts))
    assert q.slice_ring > ring
    assert int(q.state["jtab"]["occ"].sum()) == 4
    assert emits and all(e.row["REGION"] == "eu" for e in emits)


def test_batched_interleaved_feed_equals_reference_executor():
    # table changes and clicks interleaved record by record through both
    # executors in batched mode: a table record runs the pending stream
    # rows first, a stream row the pending table batch, and the pipelined
    # emits of a stream batch overtaken by a table batch keep their values
    rng = np.random.default_rng(11)
    feed, t = [], 0
    for _ in range(300):
        t += 1
        if rng.random() < 0.3:
            k = int(rng.integers(0, 12))
            val = None if rng.random() < 0.2 else {"NAME": f"n{t}", "REGION": REGIONS[int(rng.integers(0, 4))]}
            feed.append(("users", k, val, t))
        else:
            uid = int(rng.integers(0, 15))
            feed.append(("clicks", None, {"USER_ID": uid, "URL": f"/p{uid % 3}"}, t))
    for query in (ENRICHED, JOIN_AGG):
        engine, plan = plan_of(CU_DDL, query)
        broker = RBroker()
        for topic in ("users", "clicks"):
            broker.create_topic(topic)
        ref = DeviceExecutor(plan, broker, engine.registry, batch_size=8, per_record=False)
        ref._native_fields = None
        ex = start_plan(json.loads(json.dumps(plan_to_json(plan))), PBroker(), device="cpu", capacity=8,
                        store_capacity=64, table_store_capacity=16).executor
        for i, (topic, key, val, ts) in enumerate(feed):
            value = None if val is None else json.dumps(val)
            ref.process(topic, RRecord(key=key, value=value, timestamp=ts, partition=0, offset=i))
            ex.process(topic, PRecord(key=key, value=value, timestamp=ts, partition=0, offset=i))
            if i % 97 == 96:
                ref.drain()
                ex.drain()
        ref.drain()
        ex.drain()
        sink = plan.physical_plan.topic
        want = [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]
        got = [(r.key, r.value, r.timestamp) for r in ex.sink_writer.broker.topic(sink).all_records()]
        assert len(got) > 20
        assert got == want
