"""Primary-key table-table joins: TorchCompiledQuery against CompiledDeviceQuery.

Both queries are built from the same plan and fed the same single-side
batches of table changes through ``process_tt`` (each change its key's old
and new row, a delete's new row its key alone, as both executors'
``_change_batches`` build them).  After EVERY batch the two-sided store
``ttab`` (every column, every slot, the dump row included) must be bit-equal
and the decoded SinkEmits equal (NaN equal to NaN, -0.0 apart from +0.0).
Traffic: inserts, updates, deletes and re-inserts of keys on both sides,
keys changed twice in a batch, null values, doubles with -0.0, rows that
cross the post-join WHERE both ways; INNER, LEFT, RIGHT and FULL OUTER; a
store that grows twice.  End to end, the reference engine's table-table
sequence (``tests/test_engine_device.py:227``) through the port's runner
must give the oracle's and the device backend's sinks.  Tolerance: none.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ksql_tpu.common.config import RUNTIME_BACKEND, KsqlConfig
from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution import steps as rsteps
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.device_executor import DeviceExecutor
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu.runtime.topics import Record as RRecord
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import run_until_quiescent, start_plan
from ksql_tpu_torch.runtime.device_executor import _change_batches
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from test_torch_join import assert_same_nested_state, plan_of
from test_torch_vector_aggs import _same_emits

jax.config.update("jax_enable_x64", True)

TT_DDL = (
    "CREATE TABLE L (ID INT PRIMARY KEY, A INT, NM STRING) WITH (kafka_topic='lt', value_format='JSON');",
    "CREATE TABLE R (ID INT PRIMARY KEY, B DOUBLE, TAG STRING) "
    "WITH (kafka_topic='rt', value_format='JSON');",
)
JOIN_TYPES = {"INNER": "JOIN", "LEFT": "LEFT JOIN", "RIGHT": "RIGHT JOIN", "OUTER": "FULL OUTER JOIN"}
T0 = 1_700_000_000_000


def tt_query(jt, where=" WHERE A IS NULL OR A < 70"):
    key = "ROWKEY" if jt == "OUTER" else "L.ID"
    return f"CREATE TABLE J AS SELECT {key}, A, B, NM, TAG FROM L {JOIN_TYPES[jt]} R ON L.ID = R.ID{where};"


def _l_row(rng, k, old):
    return {"ID": k, "A": None if rng.random() < 0.05 else int(rng.integers(0, 100)),
            "NM": None if rng.random() < 0.1 else f"n{int(rng.integers(0, 4))}"}


def _r_row(rng, k, old):
    b = [0.0, -0.0, None, float(rng.integers(1, 400)) / 4][int(rng.integers(0, 4))]
    return {"ID": k, "B": b, "TAG": f"t{int(rng.integers(0, 3))}"}


def side_traffic(seed, n_batches, per_batch, n_keys, rows, p_delete=0.15):
    """Single-side batches ``(side, changes)``, a change ``(key, old, new,
    ts)``: inserts, updates, deletes and re-inserts over ``n_keys`` keys
    of each side (a key can change twice in a batch; a delete of an absent
    key is dropped, as the decoder drops it).  ``rows`` maps a side to its
    row maker."""
    rng = np.random.default_rng(seed)
    tables = {"l": {}, "r": {}}
    t, out = T0, []
    for b in range(n_batches):
        side = "lr"[b % 2] if rng.random() < 0.7 else "lr"[int(rng.integers(0, 2))]
        changes = []
        for _ in range(per_batch):
            k = int(rng.integers(0, n_keys))
            old = tables[side].get(k)
            new = None if old is not None and rng.random() < p_delete else rows[side](rng, k, old)
            if new is None:
                del tables[side][k]
            else:
                tables[side][k] = new
            t += int(rng.integers(0, 5000))
            changes.append(((k,), old, new, t))
        out.append((side, changes))
    return out


def _tuples(changes):
    return [(k, old, new, ts, 0, i) for i, (k, old, new, ts) in enumerate(changes)]


def build_pair(ddl, query, capacity, store, plan=None):
    """The plan on both packages (``plan``: a plan to use instead of the
    query's)."""
    engine, qplan = plan_of(ddl, query)
    plan = plan or qplan
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, table_store_capacity=store)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=capacity, device="cpu", table_store_capacity=store)
    return ref_q, port_q


def run_tt_parity(ref_q, port_q, traffic, capacity):
    """``traffic`` through ``process_tt`` of both; everything compared
    after every batch.  Returns the emits the reference made."""
    sources = {"l": (ref_q.tt_left_source, port_q.tt_left_source),
               "r": (ref_q.tt_right_source, port_q.tt_right_source)}
    n_emits = 0
    for i, (side, changes) in enumerate(traffic):
        rsrc, psrc = sources[side]
        for c in range(0, len(changes), capacity):
            part = _tuples(changes[c: c + capacity])
            want = ref_q.process_tt(side, *DeviceExecutor._change_batches(rsrc.schema, part))
            got = port_q.process_tt(side, *_change_batches(psrc.schema, part))
            assert _same_emits(got, want), f"batch {i}"
            assert port_q.tt_store_capacity == ref_q.tt_store_capacity, f"batch {i}"
            assert_same_nested_state(ref_q, port_q, f"batch {i}")
            n_emits += len(want)
    return n_emits


@pytest.mark.parametrize("jt", list(JOIN_TYPES))
def test_process_tt_parity(jt):
    ref_q, port_q = build_pair(TT_DDL, tt_query(jt), 8, 64)
    assert port_q.table_mode and port_q.tt_join is not None
    traffic = side_traffic(11, 16, 8, 20, {"l": _l_row, "r": _r_row})
    assert run_tt_parity(ref_q, port_q, traffic, 8) > 20


def test_process_tt_per_record_parity():
    ref_q, port_q = build_pair(TT_DDL, tt_query("LEFT", ""), 1, 16)
    traffic = side_traffic(12, 30, 1, 8, {"l": _l_row, "r": _r_row})
    assert run_tt_parity(ref_q, port_q, traffic, 1) > 10


def test_tt_store_grows_twice_like_the_reference():
    ref_q, port_q = build_pair(TT_DDL, tt_query("OUTER"), 8, 16)
    traffic = side_traffic(13, 14, 8, 60, {"l": _l_row, "r": _r_row})
    run_tt_parity(ref_q, port_q, traffic, 8)
    assert port_q.tt_store_capacity >= 64 and port_q.table_grows >= 2


def test_tt_overflow_raises_like_the_reference():
    ref_q, port_q = build_pair(TT_DDL, tt_query("INNER"), 64, 16)
    changes = _tuples([((k,), None, {"ID": k, "A": 1, "NM": "x"}, T0) for k in range(40)])
    schema = ref_q.tt_left_source.schema
    with pytest.raises(Exception, match="overflowed") as ref_err:
        ref_q.process_tt("l", *DeviceExecutor._change_batches(schema, changes))
    with pytest.raises(Exception, match="overflowed") as port_err:
        port_q.process_tt("l", *_change_batches(port_q.tt_left_source.schema, changes))
    assert str(port_err.value) == str(ref_err.value)
    assert_same_nested_state(ref_q, port_q, "overflow")


# ---------------------------------------------------------------- traps
def _step(ref_q, port_q, side, changes):
    """One batch on both, compared; returns the port's emits."""
    part = _tuples(changes)
    rsrc = ref_q.tt_left_source if side == "l" else ref_q.tt_right_source
    psrc = port_q.tt_left_source if side == "l" else port_q.tt_right_source
    want = ref_q.process_tt(side, *DeviceExecutor._change_batches(rsrc.schema, part))
    got = port_q.process_tt(side, *_change_batches(psrc.schema, part))
    assert _same_emits(got, want)
    assert_same_nested_state(ref_q, port_q, f"{side} {changes}")
    return got


def _side_filter_plan(jt):
    """The query's plan with its WHERE (``L_A > 5``) moved under the
    join's left side: a TableFilter on a side, which SQL cannot write."""
    _engine, plan = plan_of(TT_DDL, tt_query(jt, " WHERE L.A > 5"))
    select = plan.physical_plan.source
    filt = select.source
    join = filt.source
    assert isinstance(filt, rsteps.TableFilter) and isinstance(join, rsteps.TableTableJoin)
    side_filter = rsteps.TableFilter(source=join.left, predicate=filt.predicate, schema=join.left.schema)
    select = dataclasses.replace(select, source=dataclasses.replace(join, left=side_filter))
    return dataclasses.replace(plan, physical_plan=dataclasses.replace(plan.physical_plan, source=select))


def test_a_change_its_side_filter_drops_still_claims_and_wins():
    # the reference's rule: the dropped row is `touched` (a valid key), so it
    # claims the slot, wins the side update, sets l_live True and writes
    # every l_m_* False
    ref_q, port_q = build_pair(TT_DDL, tt_query("LEFT"), 4, 16, plan=_side_filter_plan("LEFT"))
    assert len(port_q.tt_left_ops) == 2
    got = _step(ref_q, port_q, "l", [((1,), None, {"ID": 1, "A": 2, "NM": "x"}, T0)])
    assert got == []
    st = port_q.state["ttab"]
    slot = int(st["occ"].nonzero()[0])
    assert bool(st["l_live"][slot]) and not bool(st["l_m_L_NM"][slot])


def test_joined_rows_read_the_other_side_before_the_batch():
    # a right batch that inserts and then deletes key 1 joins against the
    # left as it stood before the batch, and each change reads its own row
    ref_q, port_q = build_pair(TT_DDL, tt_query("INNER", ""), 4, 16)
    _step(ref_q, port_q, "l", [((1,), None, {"ID": 1, "A": 3, "NM": "x"}, T0)])
    r1 = {"ID": 1, "B": 2.5, "TAG": "t"}
    got = _step(ref_q, port_q, "r", [((1,), None, r1, T0 + 1), ((1,), r1, None, T0 + 2)])
    assert [e.row is None for e in got] == [False, True]


def test_a_delete_emits_under_the_change_key():
    # a delete is a key-only new row: its tombstone carries the key
    ref_q, port_q = build_pair(TT_DDL, tt_query("LEFT", ""), 4, 16)
    row = {"ID": 7, "A": 1, "NM": "x"}
    _step(ref_q, port_q, "l", [((7,), None, row, T0)])
    got = _step(ref_q, port_q, "l", [((7,), row, None, T0 + 1)])
    assert [(e.key, e.row) for e in got] == [((7,), None)]


def test_rebuild_keeps_a_deleted_keys_slot():
    # a grow re-inserts every occupied slot, a deleted key's (not live) too
    ref_q, port_q = build_pair(TT_DDL, tt_query("OUTER", ""), 8, 16)
    rows = [((k,), None, {"ID": k, "A": k, "NM": "x"}, T0 + k) for k in range(6)]
    _step(ref_q, port_q, "l", rows)
    _step(ref_q, port_q, "l", [((k,), rows[k][2], None, T0 + 10 + k) for k in range(3)])
    _step(ref_q, port_q, "r", [((k,), None, {"ID": k, "B": 1.0, "TAG": "t"}, T0 + 20 + k)
                               for k in range(10, 14)])
    assert port_q.table_grows == 1
    st = port_q.state["ttab"]
    assert int(st["occ"].sum()) == 10 and int(st["l_live"].sum()) == 3


def test_same_topic_tt_join_refused_like_the_reference():
    ddl = TT_DDL + ("CREATE TABLE L2 (ID INT PRIMARY KEY, A INT, NM STRING) "
                    "WITH (kafka_topic='lt', value_format='JSON');",)
    _engine, plan = plan_of(ddl, "CREATE TABLE J AS SELECT L.ID, L.A, L2.NM FROM L JOIN L2 ON L.ID = L2.ID;")
    with pytest.raises(DeviceUnsupported, match="same-topic table-table join on device"):
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu")


# ----------------------------------------------------------- end to end
#: tests/test_engine_device.py:227: (topic, key, value or None, timestamp)
ENGINE_DDL = ("CREATE TABLE L (ID INT PRIMARY KEY, A INT, NM STRING) "
              "WITH (kafka_topic='lt', value_format='JSON');",
              "CREATE TABLE R (ID INT PRIMARY KEY, B INT) WITH (kafka_topic='rt', value_format='JSON');")
ENGINE_SEQ = [(t, k, v, i * 10) for i, (t, k, v) in enumerate([
    ("lt", 1, {"A": 10, "NM": "x"}), ("rt", 1, {"B": 100}), ("rt", 2, {"B": 200}),
    ("lt", 2, {"A": 20, "NM": "y"}), ("lt", 1, {"A": 11, "NM": "x2"}), ("rt", 1, None),
    ("lt", 2, None), ("rt", 2, {"B": 201})])]
ENGINE_CASES = [("JOIN", "L.ID, A, B, NM"), ("LEFT JOIN", "L.ID, A, B, NM"),
                ("RIGHT JOIN", "L.ID, A, B, NM"), ("FULL OUTER JOIN", "ROWKEY, A, B, NM")]


def engine_sink(backend, ddl, query, seq):
    """The reference engine's sink of ``query`` over ``seq`` ((topic, key,
    value or None, ts)), one record a tick; and the plan."""
    e = KsqlEngine(KsqlConfig({RUNTIME_BACKEND: backend}))
    for d in ddl:
        e.execute_sql(d)
    e.execute_sql(query)
    for topic, k, v, ts in seq:
        e.broker.topic(topic).produce(RRecord(key=k, value=v and json.dumps(v), timestamp=ts,
                                              partition=0))
        e.run_until_quiescent()
    h = list(e.queries.values())[0]
    sink = h.plan.physical_plan.topic
    return h.plan, [(r.key, r.value, r.timestamp) for r in e.broker.topic(sink).all_records()]


def port_sink(plan, seq, capacity=1, per_tick=True, **kw):
    """The port's runner over ``seq``: one record a tick, or (``per_tick``
    False) all of them produced before one tick."""
    broker = PBroker()
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), broker, device="cpu",
                   capacity=capacity, **kw)
    for topic, k, v, ts in seq:
        broker.topic(topic).produce(PRecord(key=k, value=v and json.dumps(v), timestamp=ts,
                                            partition=0))
        if per_tick:
            run_until_quiescent(h)
            h.executor.drain()
    run_until_quiescent(h)
    h.executor.drain()
    sink = plan.physical_plan.topic
    return [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]


@pytest.mark.parametrize("jt,sel", ENGINE_CASES)
def test_engine_sequence_through_run_plan_equals_oracle(jt, sel):
    query = f"CREATE TABLE J AS SELECT {sel} FROM L {jt} R ON L.ID = R.ID;"
    plan, oracle = engine_sink("oracle", ENGINE_DDL, query, ENGINE_SEQ)
    _plan, device = engine_sink("device-only", ENGINE_DDL, query, ENGINE_SEQ)
    assert oracle == device
    assert port_sink(plan, ENGINE_SEQ) == oracle


@pytest.mark.parametrize("jt,sel", ENGINE_CASES)
def test_batched_runner_equals_the_oracle_in_read_order(jt, sel):
    # the sequence produced before one tick at batch size 8: the consumer
    # reads lt's changes, then rt's; a key changed twice in a batch and the
    # side switch keep the per-record oracle's sink over that order
    query = f"CREATE TABLE J AS SELECT {sel} FROM L {jt} R ON L.ID = R.ID;"
    read_order = sorted(ENGINE_SEQ, key=lambda r: r[0])
    plan, oracle = engine_sink("oracle", ENGINE_DDL, query, read_order)
    got = port_sink(plan, ENGINE_SEQ, capacity=8, per_tick=False, table_store_capacity=64)
    assert got == oracle
