"""HAVING over EMIT CHANGES aggregations: TorchCompiledQuery against
CompiledDeviceQuery.

The port keeps each slot's last verdict (``hpass``) and emits a
retraction tombstone (``row = None``) when a slot that passed stops
passing, as the reference does; K19 ``having_verdict`` is the step.  Every
case runs through ``test_torch_lowering.run_parity``: after EVERY step the
full state dict (``hpass`` and its dump slot included) and every emit lane
(the ``tombstone`` lane included) bit for bit, no tolerance.  The cases
are ``test_device_parity.py``'s ``test_having_filter``, a predicate that
flips both ways, HAVING over HOPPING (the reference's fallback reason),
two filters and a projection after the HAVING, store growth and the
retention pass mid-stream, pipelined, and end to end through the runner
against the reference's DeviceExecutor.
"""

import json

import numpy as np
import pytest

from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.device_executor import DeviceExecutor
from ksql_tpu.runtime.topics import Broker as RBroker
from ksql_tpu.runtime.topics import Record as RRecord
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import run_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from ksql_tpu_torch.state import state_to_numpy
from tests.test_device_parity import gen_rows as parity_rows
from tests.test_torch_lowering import DDL, PV_DDL, gen_batches, plan_for, run_parity

HAVING_COUNT = (
    "CREATE TABLE C AS SELECT USER_ID, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "GROUP BY USER_ID HAVING COUNT(*) > 3;"
)
#: the average latency of a key crosses 250 both ways as rows come in
FLIPPING = (
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT, AVG(LATENCY) AS A FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 2 HOURS) GROUP BY URL HAVING AVG(LATENCY) > 250;"
)


def chunks(rows, size):
    return [([r for r, _ in rows[i:i + size]], [t for _, t in rows[i:i + size]])
            for i in range(0, len(rows), size)]


def count_tombstones(port_q):
    """A decode hook that counts the tombstone rows the query emits."""
    seen = []
    orig = port_q._decode_emits

    def wrapped(emits, *a, **k):
        out = orig(emits, *a, **k)
        seen.extend(e for e in out if e.row is None)
        return out

    port_q._decode_emits = wrapped
    return seen


def test_having_filter():
    # tests/test_device_parity.py::test_having_filter's rows and query
    rows = parity_rows(300, seed=3)
    _ref, q = run_parity(DDL, HAVING_COUNT, chunks(rows, 16), capacity=32, store=256)
    assert "hpass" in q.state and bool(q.state["hpass"].any())


def test_flipping_predicate_emits_tombstones():
    batches = gen_batches(21, 14, 24, urls=10, ts_step=200_000)
    _ref, q = run_parity(DDL, FLIPPING, batches, capacity=24, store=128)
    # a replay that counts the tombstone rows: the verdict flipped both ways
    _engine, plan, schema = plan_for(DDL, FLIPPING)
    port = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                              capacity=24, store_capacity=128, device="cpu")
    seen = count_tombstones(port)
    pschema = LogicalSchema.from_json(schema.to_json())
    passes = 0
    for rows, ts in batches:
        passes += sum(e.row is not None for e in
                      port.process(PHostBatch.from_rows(pschema, rows, timestamps=ts)))
    assert len(seen) > 0 and passes > len(seen)


def test_having_two_filters_and_projection():
    sql = ("CREATE TABLE C AS SELECT URL, COUNT(*) * 10 AS C10, SUM(LATENCY) AS S "
           "FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL "
           "HAVING COUNT(*) > 2 AND SUM(LATENCY) < 1500;")
    _ref, q = run_parity(DDL, sql, gen_batches(22, 12, 24, urls=8, ts_step=150_000),
                         capacity=24, store=128)
    assert "hpass" in q.state


def test_having_hopping_keeps_expansion_with_reason():
    sql = ("CREATE TABLE C AS SELECT URL, AVG(LATENCY) AS A FROM PAGE_VIEWS "
           "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 30 MINUTES) GROUP BY URL "
           "HAVING AVG(LATENCY) > 200;")
    ref_q, q = run_parity(DDL, sql, gen_batches(23, 10, 24, urls=10, ts_step=200_000),
                          capacity=24, store=256)
    assert not q.sliced and q.windowing_fallback == ref_q.windowing_fallback
    assert "HAVING retraction" in q.windowing_fallback


def test_having_grow_and_retention_pipelined():
    # a small store grows and the retention pass (every 3 batches) clears
    # the verdicts of the slots it frees; emission lags a batch
    batches = gen_batches(24, 16, 32, urls=80, ts_step=300_000, pv=True)
    sql = ("CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
           "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL HAVING COUNT(*) > 1;")
    ref_q, q = run_parity(PV_DDL, sql, batches, capacity=32, store=256, pipeline=True,
                          evict_interval=3)
    assert q.grows >= 1 and q.evictions >= 4
    assert state_to_numpy(q.state)["hpass"].dtype == np.bool_


def test_having_unwindowed_flip_pipelined():
    sql = ("CREATE TABLE C AS SELECT USER_ID, AVG(LATENCY) AS A, MAX(LATENCY) AS MX "
           "FROM PAGE_VIEWS GROUP BY USER_ID HAVING AVG(LATENCY) > 240;")
    run_parity(DDL, sql, gen_batches(25, 12, 20, users=6), capacity=20, store=32,
               pipeline=True)


@pytest.mark.parametrize("sql", [
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 MINUTE) GROUP BY URL HAVING COUNT(*) > 3 EMIT CHANGES;",
    "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 MINUTE) GROUP BY URL HAVING AVG(USER_ID) > 25 EMIT CHANGES;",
])
def test_batched_sink_equals_reference_executor(sql):
    # possible_fraud.json's and pv_having_retract.json's shapes through the
    # runner (pipelined batches of 32) against the reference's DeviceExecutor
    rng = np.random.default_rng(26)
    t = 1_700_000_000_000
    recs = []
    for _ in range(400):
        t += int(rng.integers(0, 4_000))
        row = {"URL": f"/p/{int(rng.zipf(1.5)) % 6}", "USER_ID": int(rng.integers(1, 50)),
               "LATENCY": 1.0}
        recs.append((json.dumps(row), t))
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
    topic = plan.physical_plan.topic
    want = [(r.key, r.value, r.timestamp, r.window) for r in broker.topic(topic).all_records()]
    pbroker = PBroker()
    ptopic = pbroker.create_topic("page_views")
    for value, ts in recs:
        ptopic.produce(PRecord(key=None, value=value, timestamp=ts, partition=0))
    ex = run_plan(json.loads(json.dumps(plan_to_json(plan))), pbroker, device="cpu", capacity=32,
                  store_capacity=256)
    assert ex.query.pipeline
    got = [(r.key, r.value, r.timestamp, r.window) for r in pbroker.topic(topic).all_records()]
    assert got == want and len(got) > 10
