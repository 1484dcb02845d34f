"""Foreign-key table-table joins: TorchCompiledQuery against CompiledDeviceQuery.

Both queries are built from the same plan and fed the same changes, one a
step (the reference refuses a batched foreign-key join), through
``process_fk``.  After EVERY step both stores, ``fkl`` (the left rows with
their foreign keys) and ``fkr`` (the right rows), must be bit-equal in every
column and slot, the dump row included, and the decoded SinkEmits equal in
order: a right change's emits in the reference's host order (by the repr of
the left key).  The port's K24 compacts a right change's matches, so its
emit lanes are laid out apart from the reference's ``capacity + 1``; only
the decoded emits are compared.  Traffic: orders that migrate between
customers, amount updates, deletes and re-inserts; customers renamed,
deleted and re-inserted, so a change fans out over all of a customer's
orders; null foreign keys; INNER and LEFT; a WHERE in the chain; INT and
STRING order keys; stores that grow together.  End to end, the reference
engine's foreign-key sequence (``tests/test_engine_device.py:357``)
through the port's runner must give the oracle's and the device backend's
sinks.  Tolerance: none.
"""

import json

import jax
import numpy as np
import pytest

from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.device_executor import DeviceExecutor
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import start_plan
from ksql_tpu_torch.runtime.device_executor import _change_batches
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from test_torch_join import assert_same_nested_state, plan_of
from test_torch_tt_join import build_pair, engine_sink, port_sink
from test_torch_vector_aggs import _same_emits

jax.config.update("jax_enable_x64", True)

T0 = 1_700_000_000_000


def fk_ddl(oid="INT"):
    return (f"CREATE TABLE ORDERS (OID {oid} PRIMARY KEY, UID INT, AMT INT) "
            "WITH (kafka_topic='o', value_format='JSON');",
            "CREATE TABLE USERS (UID INT PRIMARY KEY, UNAME STRING, TIER INT) "
            "WITH (kafka_topic='u', value_format='JSON');")


def fk_query(jt, where=""):
    return (f"CREATE TABLE J AS SELECT ORDERS.OID, AMT, UNAME, TIER FROM ORDERS {jt} USERS "
            f"ON ORDERS.UID = USERS.UID{where};")


def fk_traffic(seed, n, n_orders, n_users, oid=int, p_right=0.35, p_delete=0.12):
    """``n`` changes ``(side, key, old, new, ts)``: orders inserted,
    migrated to another customer (a third of their updates), their amount
    changed, deleted and re-inserted, now and then with a null customer;
    customers inserted, renamed, re-tiered, deleted and re-inserted."""
    rng = np.random.default_rng(seed)
    tables = {"l": {}, "r": {}}
    t, out = T0, []
    for _ in range(n):
        side = "r" if rng.random() < p_right else "l"
        if side == "l":
            k = oid(int(rng.integers(0, n_orders)))
        else:
            k = int(rng.integers(0, n_users))
        old = tables[side].get(k)
        if old is not None and rng.random() < p_delete:
            new = None
        elif side == "l":
            uid = old["UID"] if old is not None and rng.random() < 0.6 else int(rng.integers(0, n_users))
            new = {"OID": k, "UID": None if rng.random() < 0.05 else uid,
                   "AMT": int(rng.integers(0, 500))}
        else:
            new = {"UID": k, "UNAME": f"u{int(rng.integers(0, 50))}",
                   "TIER": None if rng.random() < 0.1 else int(rng.integers(0, 3))}
        if new is None:
            del tables[side][k]
        else:
            tables[side][k] = new
        t += int(rng.integers(0, 5000))
        out.append((side, (k,), old, new, t))
    return out


def run_fk_parity(ref_q, port_q, traffic):
    """``traffic`` through ``process_fk`` of both, one change a step;
    everything compared after every step.  Returns the emits made."""
    sources = {"l": (ref_q.fk_left_source, port_q.fk_left_source),
               "r": (ref_q.fk_right_source, port_q.fk_right_source)}
    n_emits = 0
    for i, (side, key, old, new, ts) in enumerate(traffic):
        rsrc, psrc = sources[side]
        part = [(key, old, new, ts, 0, i)]
        want = ref_q.process_fk(side, *DeviceExecutor._change_batches(rsrc.schema, part))
        got = port_q.process_fk(side, *_change_batches(psrc.schema, part))
        assert _same_emits(got, want), f"step {i} ({side})"
        assert port_q.fk_store_capacity == ref_q.fk_store_capacity, f"step {i}"
        assert_same_nested_state(ref_q, port_q, f"step {i}")
        n_emits += len(want)
    return n_emits


@pytest.mark.parametrize("jt", ["JOIN", "LEFT JOIN"])
@pytest.mark.parametrize("where", ["", " WHERE AMT > 100"])
def test_process_fk_parity(jt, where):
    ref_q, port_q = build_pair(fk_ddl(), fk_query(jt, where), 1, 64)
    assert port_q.fk_join is not None and not port_q.table_mode
    assert run_fk_parity(ref_q, port_q, fk_traffic(21, 90, 24, 6)) > 30


def test_process_fk_parity_with_string_order_keys():
    # the left key decodes from its repr by type: a STRING key is its hash
    ref_q, port_q = build_pair(fk_ddl("STRING"), fk_query("LEFT JOIN"), 1, 64)
    assert run_fk_parity(ref_q, port_q, fk_traffic(22, 60, 16, 5, oid=lambda k: f"o{k}")) > 20


def test_fk_stores_grow_together_like_the_reference():
    ref_q, port_q = build_pair(fk_ddl(), fk_query("LEFT JOIN"), 1, 16)
    run_fk_parity(ref_q, port_q, fk_traffic(23, 70, 40, 10, p_right=0.2))
    assert port_q.fk_store_capacity >= 32 and port_q.table_grows >= 1
    assert port_q.state["fkl"]["occ"].shape == port_q.state["fkr"]["occ"].shape


# ---------------------------------------------------------------- traps
def _one(ref_q, port_q, side, key, old, new, ts=T0):
    return run_fk_parity(ref_q, port_q, [(side, (key,), old, new, ts)])


def test_a_right_change_fans_out_over_every_matching_order_and_never_the_dump():
    # process_fk at batch size 2 (the executors run 1): order 9 changed twice
    # in a left batch leaves its first foreign key, customer 3, in the dump
    # row, which is never live, so customer 3's change re-joins its 4 live
    # orders only
    ref_q, port_q = build_pair(fk_ddl(), fk_query("LEFT JOIN"), 2, 64)

    def left(changes):
        part = [(c[0], c[1], c[2], T0 + i, 0, i) for i, c in enumerate(changes)]
        want = ref_q.process_fk("l", *DeviceExecutor._change_batches(ref_q.fk_left_source.schema, part))
        got = port_q.process_fk("l", *_change_batches(port_q.fk_left_source.schema, part))
        assert _same_emits(got, want)

    for k in range(0, 6, 2):
        left([((j,), None, {"OID": j, "UID": 4 if j == 2 else 3, "AMT": j}) for j in (k, k + 1)])
    a, b = {"OID": 9, "UID": 3, "AMT": 1}, {"OID": 9, "UID": 5, "AMT": 1}
    left([((9,), None, a), ((9,), a, b)])
    st = port_q.state["fkl"]
    assert bool(st["fkvalid"][-1]) and int(st["fkrepr"][-1]) == 3 and not bool(st["live"][-1])
    n = run_fk_parity(ref_q, port_q, [("r", (3,), None, {"UID": 3, "UNAME": "ann", "TIER": 1}, T0)])
    assert n == 5  # orders 0, 1, 3, 4, 5


def test_left_rows_record_their_foreign_key_at_the_dump_too():
    # fkrepr/fkvalid ride K9's targets: an order changed twice in a left
    # batch (process_fk takes one; the executors run one change a step)
    # leaves its first change's foreign key in the dump row
    ref_q, port_q = build_pair(fk_ddl(), fk_query("JOIN"), 2, 16)
    a, b = {"OID": 1, "UID": 9, "AMT": 5}, {"OID": 1, "UID": 8, "AMT": 6}
    part = [((1,), None, a, T0, 0, 0), ((1,), a, b, T0 + 1, 0, 1)]
    got = port_q.process_fk("l", *_change_batches(port_q.fk_left_source.schema, part))
    want = ref_q.process_fk("l", *DeviceExecutor._change_batches(ref_q.fk_left_source.schema, part))
    assert _same_emits(got, want)
    assert_same_nested_state(ref_q, port_q, "twice")
    st = port_q.state["fkl"]
    assert bool(st["fkvalid"][-1]) and not bool(st["live"][-1])
    assert int(st["fkrepr"][-1]) == 9


@pytest.mark.parametrize("where,tombstones", [("", 1), (" WHERE AMT > 100", 0)])
def test_a_left_delete_tombstones_only_through_a_filter_free_chain(where, tombstones):
    ref_q, port_q = build_pair(fk_ddl(), fk_query("LEFT JOIN", where), 1, 16)
    row = {"OID": 1, "UID": 9, "AMT": 5}
    _one(ref_q, port_q, "l", 1, None, row)
    part = [((1,), row, None, T0 + 1, 0, 1)]
    got = port_q.process_fk("l", *_change_batches(port_q.fk_left_source.schema, part))
    want = ref_q.process_fk("l", *DeviceExecutor._change_batches(ref_q.fk_left_source.schema, part))
    assert _same_emits(got, want)
    assert sum(e.row is None for e in got) == tombstones


def test_a_deleted_customer_is_found_but_not_live():
    # K8's live mode: the right slot keeps its key after a delete, so the
    # walk finds it and the join pads (LEFT) or drops (INNER)
    for jt, rows in (("LEFT JOIN", 1), ("JOIN", 0)):
        ref_q, port_q = build_pair(fk_ddl(), fk_query(jt), 1, 16)
        user = {"UID": 2, "UNAME": "bo", "TIER": 0}
        _one(ref_q, port_q, "r", 2, None, user)
        _one(ref_q, port_q, "r", 2, user, None)
        part = [((5,), None, {"OID": 5, "UID": 2, "AMT": 1}, T0, 0, 0)]
        got = port_q.process_fk("l", *_change_batches(port_q.fk_left_source.schema, part))
        want = ref_q.process_fk("l", *DeviceExecutor._change_batches(ref_q.fk_left_source.schema, part))
        assert _same_emits(got, want) and len(got) == rows
        assert all(e.row["UNAME"] is None for e in got)


def test_batched_fk_join_refused_with_the_references_words():
    _engine, plan = plan_of(fk_ddl(), fk_query("JOIN"))
    with pytest.raises(DeviceUnsupported, match="batched fk join on device"):
        start_plan(json.loads(json.dumps(plan_to_json(plan))), PBroker(), device="cpu", capacity=8)


def test_same_topic_fk_join_refused_like_the_reference():
    ddl = fk_ddl() + ("CREATE TABLE U2 (UID INT PRIMARY KEY, UNAME STRING) "
                      "WITH (kafka_topic='o', value_format='JSON');",)
    _engine, plan = plan_of(ddl, "CREATE TABLE J AS SELECT ORDERS.OID, UNAME FROM ORDERS JOIN U2 "
                                 "ON ORDERS.UID = U2.UID;")
    with pytest.raises(DeviceUnsupported, match="same-topic fk join on device"):
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=1, device="cpu")


# ----------------------------------------------------------- end to end
#: tests/test_engine_device.py:357: (topic, key, value or None, timestamp)
ENGINE_DDL = ("CREATE TABLE ORDERS (OID INT PRIMARY KEY, UID INT, AMT INT) "
              "WITH (kafka_topic='o', value_format='JSON');",
              "CREATE TABLE USERS (UID INT PRIMARY KEY, UNAME STRING) "
              "WITH (kafka_topic='u', value_format='JSON');")
ENGINE_SEQ = [(t, k, v, i * 10) for i, (t, k, v) in enumerate([
    ("o", 1, {"UID": 10, "AMT": 5}), ("u", 10, {"UNAME": "ann"}), ("o", 2, {"UID": 10, "AMT": 7}),
    ("o", 3, {"UID": 11, "AMT": 9}), ("u", 10, {"UNAME": "ANN2"}), ("o", 1, {"UID": 11, "AMT": 6}),
    ("u", 10, None), ("o", 2, None)])]


@pytest.mark.parametrize("jt", ["JOIN", "LEFT JOIN"])
def test_engine_sequence_through_run_plan_equals_oracle(jt):
    query = f"CREATE TABLE J AS SELECT ORDERS.OID, AMT, UNAME FROM ORDERS {jt} USERS ON ORDERS.UID = USERS.UID;"
    plan, oracle = engine_sink("oracle", ENGINE_DDL, query, ENGINE_SEQ)
    _plan, device = engine_sink("device-only", ENGINE_DDL, query, ENGINE_SEQ)
    assert oracle == device
    assert port_sink(plan, ENGINE_SEQ) == oracle
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), PBroker(), device="cpu", capacity=1)
    assert h.executor.source_topics == ["o", "u"]
