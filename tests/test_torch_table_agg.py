"""Table aggregation and table transforms: TorchCompiledQuery against
CompiledDeviceQuery.

Both queries are built from the same plan (the committed plan files
``users_by_region.json``, ``customer_orders.json`` and ``big_spenders.json``
are the reference engine's plans of the queries below) and fed the same
batches of table changes through ``process_table_changes``: each change its
key's old row and new row, as the executors build them.  After EVERY batch
the full state dict (every column, every slot, the dump row included) must
be bit-equal, the decoded SinkEmits equal (NaN equal to NaN, -0.0 apart
from +0.0), and every emit lane equal on the emitted rows (the port's wide
gather fills only the lanes that may emit).  Traffic: inserts, value
updates in the same group, group migrations, deletes, re-inserts, rows that
cross the WHERE both ways and null group keys, in batches of 8 and 16 and
per record; a store that grows; a hand-over of the reference's state.  End
to end, the reference's own table-aggregation sequence
(``tests/test_engine_device.py:126``) through the port's runner must give
the oracle backend's sink, and batched runs the reference executor's sink
bytes.  Tolerance: none (the CPU twins fold in row order, as XLA does).
"""

import json

import jax
import numpy as np
import pytest

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.common.config import RUNTIME_BACKEND, KsqlConfig
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
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from test_torch_lowering import _capture, assert_same_state, plan_for
from test_torch_vector_aggs import _same_emits, assert_same_lanes

jax.config.update("jax_enable_x64", True)

USERS_DDL = ("CREATE TABLE USERS (ID INT PRIMARY KEY, REGION STRING, AMT INT) "
             "WITH (kafka_topic='u', value_format='JSON');")
ORDERS_DDL = ("CREATE TABLE ORDERS (ID BIGINT PRIMARY KEY, CUSTOMER_ID BIGINT, STATUS STRING, "
              "AMOUNT DOUBLE) WITH (kafka_topic='orders', value_format='JSON');")
USERS_BY_REGION = ("CREATE TABLE USERS_BY_REGION AS SELECT REGION, COUNT(*) C, SUM(AMT) S, "
                   "AVG(AMT) A, STDDEV_SAMPLE(AMT) SD FROM USERS GROUP BY REGION;")
CUSTOMER_ORDERS = ("CREATE TABLE CUSTOMER_ORDERS AS SELECT CUSTOMER_ID, COUNT(*) AS N, "
                   "SUM(AMOUNT) AS TOTAL, COLLECT_LIST(ID) AS ORDER_IDS, HISTOGRAM(STATUS) AS "
                   "BY_STATUS FROM ORDERS WHERE STATUS <> 'CANCELLED' GROUP BY CUSTOMER_ID "
                   "EMIT CHANGES;")
BIG_SPENDERS = "CREATE TABLE BIG_SPENDERS AS SELECT ID, REGION, AMT FROM USERS WHERE AMT > 500;"
#: CORRELATION over a table (STDDEV_POP has no undo: the planner refuses it
#: over a table), a filter under the aggregate and HAVING over it
STATS = ("CREATE TABLE ST AS SELECT REGION, STDDEV_SAMPLE(AMT) P, CORRELATION(AMT, ID) R, "
         "COUNT(AMT) N FROM USERS WHERE ID <> 3 GROUP BY REGION HAVING COUNT(*) > 1;")
PLANS = {"users_by_region": (USERS_DDL, USERS_BY_REGION),
         "customer_orders": (ORDERS_DDL, CUSTOMER_ORDERS),
         "big_spenders": (USERS_DDL, BIG_SPENDERS),
         "stats": (USERS_DDL, STATS)}
T0 = 1_700_000_000_000


def _user_row(rng, k, old, regions=5):
    """A USERS row: 70% of updates keep the region, 20% migrate, some
    regions null; AMT crosses 500 both ways."""
    r = rng.random()
    if old is not None and r < 0.7:
        region = old["REGION"]
    else:
        region = None if rng.random() < 0.06 else f"r{int(rng.integers(0, regions))}"
    return {"ID": k, "REGION": region, "AMT": int(rng.integers(0, 1001))}


STATUS_NEXT = {"NEW": "SHIPPED", "SHIPPED": "DELIVERED", "DELIVERED": "DELIVERED",
               "CANCELLED": "NEW"}


def _order_row(rng, k, old, customers=6):
    """An ORDERS row: a new order is NEW; an update moves its status on
    (NEW -> SHIPPED -> DELIVERED), cancels it (it leaves the WHERE) or
    reopens a cancelled one (it comes back), sometimes moves it to another
    customer; null customers, amounts in quarters with +-0.0."""
    if old is None:
        status = "NEW"
        cust = None if rng.random() < 0.05 else int(rng.integers(0, customers))
    else:
        status = "CANCELLED" if rng.random() < 0.15 else STATUS_NEXT[old["STATUS"]]
        cust = old["CUSTOMER_ID"] if rng.random() < 0.85 else int(rng.integers(0, customers))
    amount = [0.0, -0.0, float(rng.integers(1, 400)) / 4][int(rng.integers(0, 3))]
    return {"ID": k, "CUSTOMER_ID": cust, "STATUS": status, "AMOUNT": amount}


def table_traffic(seed, n_batches, per_batch, make_row, n_keys, p_delete=0.12):
    """Batches of table changes ``(key, old, new, ts)`` over ``n_keys``
    keys: inserts, updates, deletes and re-inserts (a key can change more
    than once in a batch)."""
    rng = np.random.default_rng(seed)
    table, t, out = {}, T0, []
    for _ in range(n_batches):
        batch = []
        for _ in range(per_batch):
            k = int(rng.integers(0, n_keys))
            old = table.get(k)
            new = None if old is not None and rng.random() < p_delete else make_row(rng, k, old)
            if new is None:
                table.pop(k)
            else:
                table[k] = new
            t += int(rng.integers(0, 5000))
            batch.append(((k,), old, new, t))
        out.append(batch)
    return out


def _batches(HB, schema, changes):
    keys = [c[0] for c in changes]
    ts = [c[3] for c in changes]
    new = HB.from_rows(schema, [c[2] or {} for c in changes], timestamps=ts)
    old = HB.from_rows(schema, [c[1] or {} for c in changes], timestamps=ts)
    has_old = np.array([c[1] is not None for c in changes], bool)
    has_new = np.array([c[2] is not None for c in changes], bool)
    return new, old, keys, has_new, has_old, ts


def run_table_parity(name, batches, capacity, store, pipeline=True, handoff_at=None):
    """The plan ``name`` on both packages over ``batches`` of changes;
    everything compared after every batch.  ``pipeline`` is the executors'
    setting for batched plans (the load check's headroom)."""
    ddl, query = PLANS[name]
    engine, plan, schema = plan_for(ddl, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, store_capacity=store)
    port_plan = plan_from_json(json.loads(json.dumps(plan_to_json(plan))))
    port_q = TorchCompiledQuery(port_plan, capacity=capacity, store_capacity=store, device="cpu")
    assert (port_q.table_agg, port_q.table_mode) == (ref_q.table_agg, ref_q.table_mode)
    assert port_q.store_capacity == ref_q.store_capacity
    port_schema = LogicalSchema.from_json(schema.to_json())
    ref_q.pipeline = port_q.pipeline = pipeline
    ref_lanes, port_lanes = [], []
    _capture(ref_q, ref_lanes)
    _capture(port_q, port_lanes)
    n_emits = 0
    for i, changes in enumerate(batches):
        if i == handoff_at:
            # the reference's mid-stream state carried into a fresh port query
            port_q = TorchCompiledQuery(port_plan, capacity=capacity,
                                        store_capacity=ref_q.store_capacity, device="cpu")
            port_q.pipeline = pipeline
            port_q.state = state_from_numpy(jax.device_get(ref_q.state), "cpu")
            port_q.dictionary._map.update(ref_q.dictionary._map)
            _capture(port_q, port_lanes)
        for chunk in range(0, len(changes), capacity):
            part = changes[chunk: chunk + capacity]
            want = ref_q.process_table_changes(*_batches(RHostBatch, schema, part))
            got = port_q.process_table_changes(*_batches(PHostBatch, port_schema, part))
            assert _same_emits(got, want), f"batch {i}"
            n_emits += len(want)
            assert port_q.store_capacity == ref_q.store_capacity, f"batch {i}"
            assert_same_state(ref_q, port_q, f"batch {i}")
            assert_same_lanes(ref_lanes, port_lanes, f"batch {i}")
    assert n_emits > 0
    return ref_q, port_q


@pytest.mark.parametrize("capacity", [8, 16])
def test_users_by_region_parity(capacity):
    batches = table_traffic(1, 12, capacity, _user_row, 24)
    run_table_parity("users_by_region", batches, capacity, 64)


@pytest.mark.parametrize("capacity", [8, 16])
def test_customer_orders_parity(capacity):
    batches = table_traffic(2, 14, capacity, _order_row, 30)
    _ref, q = run_table_parity("customer_orders", batches, capacity, 64)
    # lists of several order ids
    assert int(q.state["a3"][:-1].max()) >= 2  # COLLECT_LIST's logical counts


@pytest.mark.parametrize("capacity", [8, 16])
def test_big_spenders_parity(capacity):
    batches = table_traffic(3, 12, capacity, _user_row, 24)
    ref, _q = run_table_parity("big_spenders", batches, capacity, 64)
    assert ref.table_mode


def test_correlation_and_having_parity():
    run_table_parity("stats", table_traffic(4, 12, 16, _user_row, 24), 16, 64)


@pytest.mark.parametrize("name", ["users_by_region", "customer_orders", "big_spenders"])
def test_per_record_parity(name):
    # capacity 1: every change its own batch (no pipelining)
    make = _order_row if name == "customer_orders" else _user_row
    batches = table_traffic(5, 4, 12, make, 10)
    run_table_parity(name, batches, 1, 16, pipeline=False)


@pytest.mark.parametrize("name", ["users_by_region", "customer_orders"])
def test_store_grow_is_exact(name):
    # many groups into a small store: it doubles (host rebuild) mid-run
    if name == "customer_orders":
        batches = table_traffic(6, 10, 8, lambda r, k, o: _order_row(r, k, o, customers=40), 60)
    else:
        batches = table_traffic(6, 10, 8, lambda r, k, o: _user_row(r, k, o, regions=40), 60)
    _ref, q = run_table_parity(name, batches, 8, 16, pipeline=False)
    assert q.grows >= 1


@pytest.mark.parametrize("name", ["users_by_region", "customer_orders", "big_spenders"])
def test_handoff_of_reference_state(name):
    # the port takes the reference's state (the store, or a transform's
    # clock) over halfway
    make = _order_row if name == "customer_orders" else _user_row
    run_table_parity(name, table_traffic(9, 8, 8, make, 20), 8, 32, handoff_at=4)


def test_state_carries_the_reference_store_unchanged():
    # state_from_numpy / state_to_numpy carry a table aggregation's store
    # (every component, the width-K lists and maps, the scalars) bit for bit
    batches = table_traffic(7, 6, 8, _order_row, 20)
    ref, q = run_table_parity("customer_orders", batches, 8, 32)
    want = {k: np.asarray(v) for k, v in jax.device_get(ref.state).items()}
    back = state_to_numpy(state_from_numpy(want, "cpu"))
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k].reshape(-1).view(np.uint8),
                                      want[k].reshape(-1).view(np.uint8), err_msg=k)


def test_budget_clamps_customer_orders_as_the_reference():
    engine, plan, _ = plan_for(ORDERS_DDL, CUSTOMER_ORDERS)
    ref = CompiledDeviceQuery(plan, engine.registry, capacity=16, store_capacity=1 << 17)
    port = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=16,
                              store_capacity=1 << 17, device="cpu")
    assert port.store_capacity == ref.store_capacity == 8192


TABLE_DDL = USERS_DDL
#: tests/test_engine_device.py:126
TABLE_CHANGES = [
    (1, {"REGION": "we", "AMT": 10}),
    (2, {"REGION": "we", "AMT": 5}),
    (1, {"REGION": "ea", "AMT": 10}),  # group migration
    (3, {"REGION": "ea", "AMT": 7}),
    (2, None),                          # delete -> undo only
    (3, {"REGION": "ea", "AMT": 9}),    # value update
]


def _oracle_sink(query):
    e = KsqlEngine(KsqlConfig({RUNTIME_BACKEND: "oracle"}))
    e.execute_sql(TABLE_DDL)
    e.execute_sql(query)
    t = e.broker.topic("u")
    for i, (k, v) in enumerate(TABLE_CHANGES):
        t.produce(RRecord(key=k, value=v and json.dumps(v), timestamp=i * 10, partition=0))
        e.run_until_quiescent()
    handle = list(e.queries.values())[0]
    sink = handle.plan.physical_plan.topic
    return handle.plan, [(r.key, r.value, r.timestamp) for r in e.broker.topic(sink).all_records()]


@pytest.mark.parametrize("query", [
    "CREATE TABLE BY_REGION AS SELECT REGION, COUNT(*) C, SUM(AMT) S, AVG(AMT) A, "
    "STDDEV_SAMPLE(AMT) SD FROM USERS GROUP BY REGION;",
    BIG_SPENDERS.replace("500", "6"),
])
def test_reference_table_changes_through_run_plan_equal_oracle(query):
    plan, want = _oracle_sink(query)
    broker = PBroker()
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), broker, device="cpu", capacity=1,
                   store_capacity=16)
    topic = broker.topic("u")
    for i, (k, v) in enumerate(TABLE_CHANGES):
        topic.produce(PRecord(key=k, value=v and json.dumps(v), timestamp=i * 10, partition=0))
        run_until_quiescent(h)
        h.executor.drain()
    sink = plan.physical_plan.topic
    got = [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]
    assert got and got == want


def _records(name, seed, n):
    """``n`` JSON changelog records of the plan's table (tombstones for
    deletes), with their keys and timestamps."""
    make = _order_row if name == "customer_orders" else _user_row
    out = []
    for batch in table_traffic(seed, 1, n, make, 25):
        for (k,), _old, new, ts in batch:
            value = None if new is None else json.dumps({c: v for c, v in new.items() if c != "ID"})
            out.append((k, value, ts))
    return out


@pytest.mark.parametrize("name", ["users_by_region", "customer_orders", "big_spenders"])
def test_batched_sink_bytes_equal_reference_executor(name):
    ddl, query = PLANS[name]
    engine, plan, _ = plan_for(ddl, query)
    src = plan.physical_plan
    while not hasattr(src, "topic") or src is plan.physical_plan:
        src = src.source
    recs = _records(name, 8, 200)
    broker = RBroker()
    broker.create_topic(src.topic)
    ref = DeviceExecutor(plan, broker, engine.registry, batch_size=16, per_record=False,
                         store_capacity=64)
    ref._native_fields = None
    for i, (k, value, ts) in enumerate(recs):
        ref.process(src.topic, RRecord(key=k, value=value, timestamp=ts, partition=0, offset=i))
    ref.drain()
    sink = plan.physical_plan.topic
    want = [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]
    pbroker = PBroker()
    topic = pbroker.create_topic(src.topic)
    for k, value, ts in recs:
        topic.produce(PRecord(key=k, value=value, timestamp=ts, partition=0))
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), pbroker, device="cpu", capacity=16,
                   store_capacity=64)
    run_until_quiescent(h)
    h.executor.drain()
    got = [(r.key, r.value, r.timestamp) for r in pbroker.topic(sink).all_records()]
    assert len(got) > 20 and got == want
    if name == "big_spenders":
        assert any(v is None for _k, v, _t in got)  # tombstones where a change leaves the WHERE


def test_a_key_changed_twice_in_a_batch_keeps_the_references_phantom():
    # the reference's batch rule undoes every old row before it applies any
    # new one: a key inserted into a new group and moved on in the same
    # batch misses its undo (the group does not exist yet), so the first
    # group keeps a phantom row; the port keeps the rule bit for bit (the
    # per-record oracle, capacity 1, has no phantom)
    batch = [((1,), None, {"ID": 1, "REGION": "a", "AMT": 5}, T0),
             ((1,), {"ID": 1, "REGION": "a", "AMT": 5}, {"ID": 1, "REGION": "b", "AMT": 7}, T0 + 1)]
    ref, q = run_table_parity("users_by_region", [batch], 8, 16)
    last = {e.key: e.row for e in q.process_table_changes(
        *_batches(PHostBatch, LogicalSchema.from_json(q.source.schema.to_json()),
                  [((2,), None, {"ID": 2, "REGION": "a", "AMT": 1}, T0 + 2)]))}
    assert last[("a",)]["C"] == 2  # the phantom and the new row
