"""Scalar EARLIEST/LATEST_BY_OFFSET, DECIMAL aggregation, CAST/CASE/functions
in aggregating plans and struct field paths: the port's TorchCompiledQuery
against the reference's CompiledDeviceQuery, per step.

Both queries are built from the same plan and fed the same encoded
micro-batches; after every batch the full state (every slot, the dump slot
and ``agg_seq`` included) and every emit lane (``dec_envelope`` too) must
be equal by their bits, and so must the decoded SinkEmits.  The shapes are
unwindowed, TUMBLING, HOPPING (the expansion route, with the reference's
``windowing_fallback`` reason) and SESSION, one run across store grows and
session-slot doublings, the committed ``pv_offsets*.json`` and
``current_location.json`` queries, and (x), (x, true) and (x, false) over
INTEGER, BIGINT, DOUBLE, DECIMAL, STRING and BOOLEAN with NULLs.  DECIMAL
SUM is checked in and past its 2^53 envelope (tests/test_engine_device.py
:398 and :441); struct paths against the reference engine's sink
(tests/test_engine_device.py:185).  Tolerance: none.
"""

import json
import math

import jax
import numpy as np
import pytest

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.common.config import KsqlConfig
from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu.runtime.topics import Record as RRecord
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.common.errors import QueryRuntimeException
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runner import run_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from tests.test_torch_join import _pschema, _same_bits, assert_same_nested_state, plan_of
from tests.test_torch_lowering import PV_DDL, _capture
from tests.test_torch_plan_file import CTAS, DDL as PLAN_DDL
from tests.test_torch_session import run_session_parity

jax.config.update("jax_enable_x64", True)

HOUR = 3_600_000
E_DDL = ("CREATE STREAM E (K STRING, I INT, B BIGINT, D DOUBLE, S STRING, F BOOLEAN, "
         "DEC DECIMAL(10, 2)) WITH (kafka_topic='e', value_format='JSON');")
OFFSETS = ("SELECT K, LATEST_BY_OFFSET(D) AS LD, EARLIEST_BY_OFFSET(D) AS ED, "
           "LATEST_BY_OFFSET(I, false) AS LI, EARLIEST_BY_OFFSET(B, false) AS EB, "
           "LATEST_BY_OFFSET(S, true) AS LS, EARLIEST_BY_OFFSET(F) AS EF, "
           "LATEST_BY_OFFSET(DEC) AS LDEC, COUNT(*) AS N FROM E ")
QUERIES = {
    "unwindowed": "CREATE TABLE T AS " + OFFSETS + "GROUP BY K;",
    "tumbling": "CREATE TABLE T AS " + OFFSETS + "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY K;",
    "hopping": "CREATE TABLE T AS " + OFFSETS
               + "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 20 MINUTES) GROUP BY K;",
    "decimal": "CREATE TABLE T AS SELECT K, SUM(DEC) AS S, MIN(DEC) AS MN, MAX(DEC) AS MX, "
               "AVG(DEC) AS A, LATEST_BY_OFFSET(DEC, false) AS L, COUNT(DEC) AS C FROM E "
               "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY K;",
    # DECIMAL SUM slices (an 'add'): its envelope lane on the sliced route
    "decimal_sliced": "CREATE TABLE T AS SELECT K, SUM(DEC) AS S, MAX(DEC) AS MX, COUNT(*) AS N FROM E "
                      "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 20 MINUTES) GROUP BY K;",
    "expressions": "CREATE TABLE T AS SELECT K, SUM(CASE WHEN I > 0 THEN 1 WHEN I < -20 THEN -1 END) AS SC, "
                   "MAX(ABS(D)) AS MA, MIN(ROUND(D)) AS MR, SUM(CAST(D AS DECIMAL(9, 1))) AS SD, "
                   "LATEST_BY_OFFSET(COALESCE(S, K)) AS LC, MAX(GREATEST(B, CAST(I AS BIGINT))) AS G, "
                   "EARLIEST_BY_OFFSET(CAST(B AS INT)) AS EC FROM E GROUP BY K;",
}
_SPECIAL_D = (-0.0, 0.0, float("nan"), 1.5, -2.25)


def e_batches(seed, n_batches, rows, keys=12, step=90_000, nulls=0.15):
    """Batches of E rows: keys over ``keys`` values (5% NULL), every value
    column NULL with ``nulls`` probability, doubles with -0.0, +0.0 and
    NaN, DECIMALs of two places, time rising ``step`` ms a row on average
    with a few rows out of order."""
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    out = []
    for _ in range(n_batches):
        rows_, ts = [], []
        for _ in range(rows):
            t += int(rng.integers(0, 2 * step))

            def val(make):
                return None if rng.random() < nulls else make()
            rows_.append({
                "K": None if rng.random() < 0.05 else f"k{int(rng.integers(0, keys))}",
                "I": val(lambda: int(rng.integers(-40, 40))),
                "B": val(lambda: int(rng.integers(-10**12, 10**12))),
                "D": val(lambda: _SPECIAL_D[int(rng.integers(0, 5))] if rng.random() < 0.3
                         else float(rng.normal(0, 100))),
                "S": val(lambda: f"s{int(rng.integers(0, 5))}"),
                "F": val(lambda: bool(rng.random() < 0.5)),
                "DEC": val(lambda: f"{int(rng.integers(-10**6, 10**6)) / 100:.2f}"),
            })
            ts.append(t - (int(rng.integers(1, 30)) * 60_000 if rng.random() < 0.05 else 0))
        out.append((rows_, ts))
    return out


def _same_emits(got, want, where):
    assert repr([(e.key, e.row, e.ts, e.window) for e in got]) == \
        repr([(e.key, e.row, e.ts, e.window) for e in want]), where


def run_stream_parity(ddl, query, batches, capacity, store, **kw):
    """Drive both queries through ``batches``: the encoded arrays, the
    decoded emits, the full state and every emit lane (``dec_envelope``
    included) are compared by their bits after each batch."""
    engine, plan = plan_of([ddl], query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity, store_capacity=store, **kw)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=capacity, store_capacity=store, device="cpu", **kw)
    assert port_q.windowing_fallback == getattr(ref_q, "windowing_fallback", None)
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
        want, got = ref_q.process_arrays(arrays), port_q.process_arrays(got_arrays)
        _same_emits(got, want, where)
        n_emits += len(want)
        assert port_q.store_capacity == ref_q.store_capacity, where
        assert_same_nested_state(ref_q, port_q, where)
        lr, lp = ref_lanes[-1], port_lanes[-1]
        envelope = any(s.device.exact_abs_bound is not None for s in port_q.agg_specs)
        assert set(lp) == (set(lr) if envelope else set(lr) - {"dec_envelope"}), where
        for k in lp:
            _same_bits(lp[k], lr[k], f"{where}: lane {k}")
    assert n_emits > 0
    return ref_q, port_q


@pytest.mark.parametrize("name", list(QUERIES))
def test_per_step_parity(name):
    kw = {"sliced": False} if name == "hopping" else {}
    ref_q, port_q = run_stream_parity(E_DDL, QUERIES[name], e_batches(len(name), 6, 48), capacity=48,
                                      store=2048, **kw)
    assert port_q.sliced == (name == "decimal_sliced")
    if "LATEST_BY_OFFSET" in QUERIES[name] or "EARLIEST" in QUERIES[name]:
        assert int(port_q.state["agg_seq"]) == 6 * 48  # advanced by the capacity a batch


def test_hopping_takes_the_expansion_route_with_the_references_reason():
    _ref_q, port_q = run_stream_parity(E_DDL, QUERIES["hopping"], e_batches(3, 3, 32), capacity=32,
                                       store=2048)
    assert not port_q.sliced and port_q.expansion == 3
    assert port_q.windowing_fallback.startswith("non-decomposable aggregate LATEST_BY_OFFSET")


def test_parity_across_grows():
    _ref_q, port_q = run_stream_parity(E_DDL, QUERIES["tumbling"], e_batches(9, 12, 16, keys=100),
                                       capacity=16, store=128)
    assert port_q.grows >= 1
    assert "agg_seq" in port_q.state


def test_pipelined_parity_with_the_arrival_sequence():
    engine, plan = plan_of([E_DDL], QUERIES["unwindowed"])
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=32, store_capacity=256)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=32, store_capacity=256,
                                device="cpu")
    ref_q.pipeline = port_q.pipeline = True
    schema = ref_q.source.schema
    for rows, ts in e_batches(21, 5, 32):
        want = ref_q.process_arrays(ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts)))
        got = port_q.process_arrays(port_q.layout.encode(PHostBatch.from_rows(_pschema(schema), rows,
                                                                              timestamps=ts)))
        _same_emits(got, want, "pipelined")
    _same_emits(port_q.flush_pipeline(), ref_q.flush_pipeline(), "flush")
    assert_same_nested_state(ref_q, port_q, "end")


SESSION = ("CREATE TABLE T AS SELECT K, LATEST_BY_OFFSET(D) AS LD, EARLIEST_BY_OFFSET(D, false) AS ED, "
           "LATEST_BY_OFFSET(S) AS LS, EARLIEST_BY_OFFSET(I) AS EI, COUNT(*) AS N, SUM(DEC) AS SD "
           "FROM E WINDOW SESSION (2 MINUTES) GROUP BY K EMIT CHANGES;")


@pytest.mark.parametrize("slots,store", [(8, 256), (2, 64)])
def test_session_per_step_parity(slots, store):
    """The segment merge's argset branch, and the sequence advanced by the
    batch; (2, 64) doubles the session slots and grows the store."""
    _ref_q, port_q, n = run_session_parity(E_DDL, SESSION, e_batches(5, 6, 40, step=40_000),
                                           capacity=40, store=store, slots=slots)
    assert n > 0 and int(port_q.state["agg_seq"]) == 6 * 40
    if slots == 2:
        assert port_q.session_grows >= 1 and port_q.grows >= 1


def _pv_batches(seed, n_batches, rows, step=30_000, urls=30):
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    out = []
    for _ in range(n_batches):
        rows_, ts = [], []
        for _ in range(rows):
            t += int(rng.integers(0, 2 * step))
            rows_.append({"URL": f"/page/{int(rng.zipf(1.3)) % urls}",
                          "USER_ID": None if rng.random() < 0.1 else int(rng.integers(1, 1000)),
                          "VIEWTIME": t})
            ts.append(t)
        out.append((rows_, ts))
    return out


@pytest.mark.parametrize("name", ["pv_offsets.json", "pv_offsets_hopping.json"])
def test_committed_offsets_plans_per_step(name):
    run_stream_parity(PV_DDL, CTAS[name], _pv_batches(2, 6, 64), capacity=64, store=1024)


def test_committed_session_offsets_plan_per_step():
    run_session_parity(PV_DDL, CTAS["pv_offsets_session.json"], _pv_batches(4, 6, 64, step=8_000),
                       capacity=64, store=256, slots=4)


def test_current_location_plan_per_step():
    ddl = PLAN_DDL["current_location.json"][0]
    rng = np.random.default_rng(6)
    batches = []
    for b in range(5):
        rows = [{"PROFILEID": f"p{int(rng.integers(0, 60))}",
                 "LATITUDE": None if rng.random() < 0.1 else float(rng.uniform(-90, 90)),
                 "LONGITUDE": float(rng.uniform(-180, 180))} for _ in range(64)]
        batches.append((rows, [1000 * (64 * b + i) for i in range(64)]))
    _ref_q, port_q = run_stream_parity(ddl, CTAS["current_location.json"], batches, capacity=64, store=256)
    assert [c.combine for c in port_q.store_layout.components] == \
        ["max", "max", "argset", "argset", "max", "argset", "argset"]


# ------------------------------------------------------- DECIMAL SUM envelope
DEC_DDL = ("CREATE STREAM D (K STRING, SMALL DECIMAL(12, 2), BIG DECIMAL(14, 2)) "
           "WITH (kafka_topic='dec', value_format='JSON');")


def _dec_plan(col):
    return plan_of([DEC_DDL], f"CREATE TABLE C AS SELECT K, SUM({col}) AS S FROM D GROUP BY K EMIT CHANGES;")


def test_decimal_sum_in_envelope_sums_exactly():
    """tests/test_engine_device.py:398, in-envelope half: DECIMAL(12, 2)
    runs on the port and sums exactly."""
    _engine, plan = _dec_plan("SMALL")
    broker = PBroker()
    topic = broker.create_topic("dec")
    for i in range(6):
        topic.produce(PRecord(key=None, value=json.dumps({"K": "a", "SMALL": "1000.25", "BIG": "1000.25"}),
                              timestamp=i))
    run_plan(plan_to_json(plan), broker, device="cpu", capacity=1, store_capacity=16)
    last = broker.topic(plan.physical_plan.topic).all_records()[-1]
    assert float(json.loads(last.value)["S"]) == pytest.approx(6001.50)


def test_decimal_sum_past_envelope_is_refused_in_the_references_words():
    """tests/test_engine_device.py:398, the other half: DECIMAL(14, 2) can
    pass 2^53 scaled units within the certified headroom."""
    engine, plan = _dec_plan("BIG")
    with pytest.raises(Exception) as ref_err:
        CompiledDeviceQuery(plan, engine.registry, capacity=8, store_capacity=16)
    with pytest.raises(DeviceUnsupported) as port_err:
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=16, device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    assert "2^53" in str(port_err.value)


def test_decimal_wider_than_fifteen_digits_is_refused_in_the_references_words():
    ddl = "CREATE STREAM W (K STRING, X DECIMAL(18, 2)) WITH (kafka_topic='w', value_format='JSON');"
    engine, plan = plan_of([ddl], "CREATE TABLE C AS SELECT K, MAX(X) AS M FROM W GROUP BY K;")
    with pytest.raises(Exception) as ref_err:
        CompiledDeviceQuery(plan, engine.registry, capacity=8, store_capacity=16)
    with pytest.raises(DeviceUnsupported) as port_err:
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=16, device="cpu")
    assert str(port_err.value) == str(ref_err.value)


def test_decimal_sum_runtime_envelope_breach_stops_loudly():
    """tests/test_engine_device.py:441: a key whose accumulated sum passes
    2^53 scaled units stops the emission instead of decoding a drifted
    value."""
    _engine, plan = _dec_plan("SMALL")
    q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=64, device="cpu")
    schema = _pschema(_engine.metastore.get_source("D").schema)
    hb = PHostBatch.from_rows(schema, [{"K": "k", "SMALL": "1.00"}] * 4, timestamps=[0, 1, 2, 3])
    assert len(q.process(hb)) > 0  # a healthy in-envelope emission
    q.state["a1"] += 2 ** 53
    hb2 = PHostBatch.from_rows(schema, [{"K": "k", "SMALL": "1.00"}], timestamps=[4])
    with pytest.raises(QueryRuntimeException, match="2\\^53-exact envelope"):
        q.process(hb2)


# ------------------------------------------------------------- struct paths
NESTED_DDL = ("CREATE STREAM S (ID INT KEY, INFO STRUCT<NAME STRING, AGE INT>, "
              "TAGS ARRAY<STRING>, M MAP<STRING,INT>) WITH (kafka_topic='t', value_format='JSON');")
NESTED_ROWS = [
    (1, {"INFO": {"NAME": "ann", "AGE": 30}, "TAGS": ["a", "b"], "M": {"x": 1}}),
    (2, {"INFO": {"NAME": "bob", "AGE": 10}, "TAGS": ["a", "b"], "M": None}),
    (3, {"INFO": {"NAME": "cat", "AGE": 44}, "TAGS": ["c"], "M": {"y": 2}}),
    (4, {"INFO": None, "TAGS": ["a", "b"], "M": {}}),
    (5, {"INFO": {"NAME": None, "AGE": 19}, "TAGS": None, "M": {"z": 3}}),
]
NESTED = {
    # passthrough of the nested columns, a path next to its bare struct
    "passthrough": "CREATE STREAM O AS SELECT ID, INFO, TAGS, M, INFO->NAME N FROM S WHERE INFO->AGE > 18;",
    # paths only: the struct itself never reaches the card
    "paths_only": "CREATE STREAM P AS SELECT ID, INFO->NAME AS N, INFO->AGE * 2 AS A2 FROM S "
                  "WHERE INFO->AGE IS NOT NULL;",
    "group_by_array": "CREATE TABLE G WITH (KEY_FORMAT='JSON') AS SELECT TAGS, COUNT(*) C, "
                      "MAX(INFO->AGE) AS MA FROM S GROUP BY TAGS;",
}


@pytest.mark.parametrize("name", list(NESTED))
def test_struct_paths_and_nested_passthrough_match_the_reference_engine(name):
    """tests/test_engine_device.py:185: the reference engine's sink (row
    oracle, a record a tick) against the port's ``run_plan`` at capacity
    1 over the same records."""
    e = KsqlEngine(KsqlConfig({"ksql.runtime.backend": "oracle"}))
    e.execute_sql(NESTED_DDL)
    results = e.execute_sql(NESTED[name])
    plan = e.queries[next(r.query_id for r in results if r.query_id)].plan
    for i, (k, v) in enumerate(NESTED_ROWS):
        e.broker.topic("t").produce(RRecord(key=k, value=json.dumps(v), timestamp=i * 10, partition=0))
        e.run_until_quiescent()
    sink = plan.physical_plan.topic
    want = [(r.key, r.value, r.timestamp) for r in e.broker.topic(sink).all_records()]
    broker = PBroker()
    for i, (k, v) in enumerate(NESTED_ROWS):
        broker.create_topic("t").produce(PRecord(key=k, value=json.dumps(v), timestamp=i * 10))
    ex = run_plan(plan_to_json(plan), broker, device="cpu", capacity=1, store_capacity=16)
    got = [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]
    assert got == want and want
    layout = {s.name: s for s in ex.query.layout.specs}
    if name == "paths_only":
        assert "INFO" not in layout and {"INFO->NAME", "INFO->AGE"} <= set(layout)
    if name == "passthrough":
        assert {"INFO", "INFO->NAME", "INFO->AGE"} <= set(layout)


def test_division_by_a_constant_is_the_references_reciprocal_product():
    """ROADMAP C11 and C13: the reference's jitted step divides by a
    constant as XLA's algebraic simplifier rewrites it, ``x * (1 / c)``:
    956 / 10.0 comes out 95.60000000000001, not the IEEE quotient 95.6.
    The port's compiled step gives the reference's bits for each constant
    form XLA folds (a DOUBLE or DECIMAL literal, a CAST of an integer
    literal, a negative, a power of two, 0.0 and -0.0, the DECIMAL branch;
    constant arithmetic, nested, whose own divisions are the IEEE quotient
    since XLA folds them before any rewrite; a device function or a CASE of
    constants) and the quotient where the divisor reads a column."""
    ddl = "CREATE STREAM V (X BIGINT, D DOUBLE) WITH (kafka_topic='v', value_format='JSON');"
    forms = ["CAST(X AS DOUBLE) / 10.0", "CAST(X AS DOUBLE) / CAST(10 AS DOUBLE)", "CAST(X AS DOUBLE) / 10",
             "CAST(X AS DOUBLE) / -10.0", "CAST(X AS DOUBLE) / 3.0", "CAST(X AS DOUBLE) / 4.0",
             "CAST(X AS DOUBLE) / 0.0", "CAST(X AS DOUBLE) / -0.0", "X / 10.0",
             "CAST(X AS DECIMAL(10, 2)) / CAST(3 AS DECIMAL(4, 1))", "CAST(X AS DOUBLE) / D",
             "CAST(X AS DOUBLE) / (5.0 * 2.0)", "CAST(X AS DOUBLE) / (5.0 / 3.0)",
             "CAST(X AS DOUBLE) / (10.0 / 3.0 * 3.0)", "CAST(X AS DOUBLE) / (0.1 + 0.2)",
             "CAST(X AS DOUBLE) / (7.0 - 4.0 % 3.0)", "CAST(X AS DOUBLE) / -(5.0 * 2.0)",
             "CAST(X AS DOUBLE) / CAST(5 * 2 AS DOUBLE)", "CAST(X AS DOUBLE) / (10 / 3)",
             "CAST(X AS DOUBLE) / ABS(-10.0)", "CAST(X AS DOUBLE) / SQRT(10.0)",
             "CAST(X AS DOUBLE) / GREATEST(3.0, 7.0 / 3.0)",
             "CAST(X AS DOUBLE) / CASE WHEN 1 < 2 THEN 10.0 ELSE 3.0 END",
             "CAST(X AS DOUBLE) / CASE 3 WHEN 3 THEN 7.0 ELSE 1.0 END",
             "CAST(X AS DOUBLE) / CASE WHEN false THEN 1.0 END",
             "CAST(X AS DOUBLE) / (D * 2.0)", "CAST(X AS DOUBLE) / ABS(D)"]
    sel = ", ".join(f"{f} AS Y{k}" for k, f in enumerate(forms))
    engine, plan = plan_of([ddl], f"CREATE STREAM Q AS SELECT {sel} FROM V;")
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=8, store_capacity=16)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, store_capacity=16,
                                device="cpu")
    schema = ref_q.source.schema
    xs = [956, 7, -3, 0, 100003, 123456789]
    rows, ts = [{"X": x, "D": 10.0} for x in xs], [0] * len(xs)
    want = ref_q.process_arrays(ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts)))
    got = port_q.process_arrays(port_q.layout.encode(PHostBatch.from_rows(_pschema(schema), rows,
                                                                          timestamps=ts)))
    assert [repr(r.row) for r in got] == [repr(r.row) for r in want]
    assert want[0].row["Y0"] == got[0].row["Y0"] == 956 * 0.1 == 95.60000000000001
    assert want[0].row["Y10"] == got[0].row["Y10"] == 956 / 10.0 == 95.6
    assert want[0].row["Y11"] == got[0].row["Y11"] == 95.60000000000001
    assert got[0].row["Y12"] == 956 * (1 / (5.0 / 3.0)) != 956 * (1 / (5.0 * (1 / 3.0)))
    assert want[0].row["Y25"] == got[0].row["Y25"] == 956 / 20.0


#: ROADMAP C14: forms whose reference bits come from three rewrites of XLA's
#: algebraic simplifier (the HLO of the reference's step on the CPU): the
#: DECIMAL cast's ``/ 10^s`` becomes a product with the reciprocal, ROUND's
#: ``/ pow(10, s)`` a product with ``pow(10, -s)`` (for a column ``s`` too),
#: and a product by a constant of a product by a constant multiplies the
#: constants first (``CAST(D AS DECIMAL(10, 1)) * 1.5`` is ``floor(..) *
#: (0.1 * 1.5)``), inside a fully constant divisor as well
ROUNDING_FORMS = {
    "round": ["ROUND(D, 0)", "ROUND(D, 1)", "ROUND(D, 2)", "ROUND(D, 3)", "ROUND(D, -1)",
              "ROUND(D, -2)", "ROUND(D, S)", "ROUND(D, 1) * 1.5", "ROUND(D, 2) / 3.0",
              "ROUND(D, S) * 1.5", "ROUND(D * 1.1, 1)", "ROUND(D * 1.1, S)", "D * 1.1 * 1.3"],
    "decimal_cast": ["CAST(D AS DECIMAL(10, 1))", "CAST(D AS DECIMAL(10, 2))",
                     "CAST(D AS DECIMAL(12, 3))", "CAST(D AS DECIMAL(10, 1)) * 1.5",
                     "1.5 * CAST(D AS DECIMAL(10, 1))", "CAST(D AS DECIMAL(10, 1)) * 1.5 * 1.1",
                     "CAST(D AS DECIMAL(10, 1)) + CAST(D AS DECIMAL(10, 2))",
                     "CAST(D AS DECIMAL(10, 1)) / CAST(D AS DECIMAL(10, 2))",
                     "CAST(D AS DECIMAL(10, 1)) / 3.0",
                     "CAST(D AS DECIMAL(10, 1)) / CAST(3 AS DECIMAL(4, 1))",
                     "CAST(D * 1.1 AS DECIMAL(10, 1))",
                     "CAST(CAST(D AS DECIMAL(10, 1)) AS DOUBLE) * 1.5"],
    "constant_divisor": ["CAST(X AS DOUBLE) / (CAST(7 AS DECIMAL(4, 1)) * 1.5)",
                         "CAST(X AS DOUBLE) / CAST(7.7 AS DECIMAL(4, 1))",
                         "CAST(X AS DOUBLE) / ROUND(2.35, 1)",
                         "CAST(X AS DOUBLE) / (ROUND(2.35, 1) * 1.5)",
                         "CAST(X AS DECIMAL(10, 2)) / CAST(3 AS DECIMAL(4, 1))"],
}


def _both_steps(forms, rows):
    """The reference's and the port's compiled step over ``rows``: the
    emitted rows of ``SELECT <forms> FROM V``."""
    ddl = "CREATE STREAM V (X BIGINT, D DOUBLE, S INT) WITH (kafka_topic='v', value_format='JSON');"
    sel = ", ".join(f"{f} AS Y{k}" for k, f in enumerate(forms))
    engine, plan = plan_of([ddl], f"CREATE STREAM Q AS SELECT {sel} FROM V;")
    n = len(rows)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=n, store_capacity=16)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=n, store_capacity=16,
                                device="cpu")
    schema = ref_q.source.schema
    ts = [0] * n
    want = ref_q.process_arrays(ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts)))
    got = port_q.process_arrays(port_q.layout.encode(PHostBatch.from_rows(_pschema(schema), rows,
                                                                          timestamps=ts)))
    return [r.row for r in want], [r.row for r in got]


@pytest.mark.parametrize("group", list(ROUNDING_FORMS))
def test_rounding_divisions_are_the_references_products(group):
    """ROADMAP C14: ROUND and the DECIMAL cast, alone, under a product or
    a quotient by a constant, and inside a constant divisor, give the
    reference's compiled step's bits in the port's compiled step, over 256
    seeded rows (values of one to three places, the smallest cases of
    C14 first, and a scale column S from -2 to 3)."""
    rng = np.random.default_rng(14)
    n = 256
    ds = [2.35, 90.1, 2.85, 1.005, -2.35, 123.456, 0.15, 2.675, -90.1, 0.0, -0.0, 1.5, -2.5]
    ds += [round(float(u), int(k)) for u, k in zip(rng.uniform(-1000, 1000, n - len(ds)),
                                                   rng.integers(1, 4, n - len(ds)))]
    rows = [{"X": int(rng.integers(-10**6, 10**6)), "D": d, "S": int(rng.integers(-2, 4))}
            for d in ds]
    want, got = _both_steps(ROUNDING_FORMS[group], rows)
    assert len(want) == n
    assert [repr(r) for r in got] == [repr(r) for r in want]
    if group == "round":
        assert want[0]["Y1"] == 24 * 0.1 == 2.4000000000000004 != 24 / 10
    elif group == "decimal_cast":
        # 90.1 -> 901 * (0.1 * 1.5) = 135.15000000000003, which rounds up;
        # the quotient's 901 / 10 * 1.5 = 135.14999999999998 rounds down
        assert str(want[1]["Y3"]) == "135.2" and 901 / 10 * 1.5 < 135.15
    else:
        c = 70 * (0.1 * 1.5)
        assert c == 10.500000000000002
        assert want[0]["Y0"] == rows[0]["X"] * float(np.float64(1.0) / np.float64(c))


def _rounding_rows(n=64):
    rng = np.random.default_rng(15)
    return [{"X": int(x), "D": float(d), "S": 1}
            for x, d in zip(rng.integers(-10**6, 10**6, n), rng.uniform(-1000, 1000, n))]


def test_a_rounded_constant_divisor_is_program_dependent_in_the_reference():
    """ROADMAP C14: the reference folds a fully constant ROUND divisor by
    where it stands in its program.  ROUND(10.37, 1) is floor(104.2) *
    10^-1 = 10.4.  Alone, the step multiplies CAST(X AS DOUBLE) by 10 *
    (1 / 104) = 0.09615384615384616 (the divisor's product taken apart);
    after D / ROUND(10.37, 1) the same expression multiplies by 1 / 10.4 =
    0.09615384615384615, and D takes the split constant.  The port keeps
    the program's order of its constant ROUNDs (``round_program``) and
    gives both programs' bits."""
    rows = _rounding_rows()
    split = float(np.float64(10.0) * (np.float64(1.0) / np.float64(104.0)))
    whole = float(np.float64(1.0) / np.float64(10.4))
    assert split == 0.09615384615384616 and whole == 0.09615384615384615
    alone_ref, alone_port = _both_steps(["CAST(X AS DOUBLE) / ROUND(10.37, 1)"], rows)
    pair_ref, pair_port = _both_steps(["D / ROUND(10.37, 1)", "CAST(X AS DOUBLE) / ROUND(10.37, 1)"],
                                      rows)
    xs = [r["X"] for r in rows]
    assert [r["Y0"] for r in alone_ref] == [x * split for x in xs]
    assert [r["Y1"] for r in pair_ref] == [x * whole for x in xs]
    assert [r["Y0"] for r in pair_ref] == [r["D"] * split for r in rows]
    # the reference disagrees with itself on the same expression, and the
    # port with it in both programs
    assert any(a["Y0"] != b["Y1"] for a, b in zip(alone_ref, pair_ref))
    assert [repr(r) for r in alone_port] == [repr(r) for r in alone_ref]
    assert [repr(r) for r in pair_port] == [repr(r) for r in pair_ref]


#: ROADMAP C14's family: a constant ROUND divisor used once and twice, in
#: one expression and in two, after a product, a sum or a filter that met
#: it first, beside another constant divisor, over other literals and
#: scales, under a product, chained with itself, and a DECIMAL cast's
#: (a chain onto another constant ROUND follows, below)
R = "ROUND(10.37, 1)"
C14_FAMILY = {
    "alone": [f"CAST(X AS DOUBLE) / {R}"],
    "alone_d": [f"D / {R}"],
    "twice_d_first": [f"D / {R}", f"CAST(X AS DOUBLE) / {R}"],
    "twice_x_first": [f"CAST(X AS DOUBLE) / {R}", f"D / {R}"],
    "same_twice": [f"CAST(X AS DOUBLE) / {R}", f"CAST(X AS DOUBLE) / {R}"],
    "thrice": [f"D / {R}", f"CAST(X AS DOUBLE) / {R}", f"D / {R}"],
    "one_expression": [f"D / {R} + CAST(X AS DOUBLE) / {R}"],
    "after_a_product": [f"{R} * D", f"CAST(X AS DOUBLE) / {R}"],
    "before_a_product": [f"CAST(X AS DOUBLE) / {R}", f"{R} * D"],
    "after_a_sum": [f"{R} + D", f"CAST(X AS DOUBLE) / {R}"],
    "inside_a_divisor_first": [f"CAST(X AS DOUBLE) / ({R} * 1.5)", f"CAST(X AS DOUBLE) / {R}"],
    "inside_a_divisor_after": [f"CAST(X AS DOUBLE) / {R}", f"CAST(X AS DOUBLE) / ({R} * 1.5)"],
    "beside_another": ["D / ROUND(2.35, 1)", f"CAST(X AS DOUBLE) / {R}"],
    "other_literals": ["CAST(X AS DOUBLE) / ROUND(123.456, 2)", "D / ROUND(1234.5, -1)",
                       "D / ROUND(0.3, 1)", "D / ROUND(7.7, 1)"],
    "under_a_product": [f"CAST(X AS DOUBLE) / {R} * 1.5"],
    "chained_with_itself": [f"CAST(X AS DOUBLE) / {R} / {R}"],
    "decimal_cast": ["CAST(X AS DOUBLE) / CAST(10.37 AS DECIMAL(4, 1))",
                     "D / CAST(10.37 AS DECIMAL(4, 1))"],
}


@pytest.mark.parametrize("rows", [64, 1])
@pytest.mark.parametrize("case", list(C14_FAMILY))
def test_rounded_constant_divisors_are_the_references(case, rows):
    """ROADMAP C14's family, bit for bit over 64 seeded rows and at one
    lane (where XLA folds every such divisor whole)."""
    data = _rounding_rows(rows)
    want, got = _both_steps(C14_FAMILY[case], data)
    assert [repr(r) for r in got] == [repr(r) for r in want]


def test_chains_of_different_rounded_divisors_stay_apart():
    """ROADMAP C14: a division chained onto a division by another
    constant ROUND.  XLA merges the chain and multiplies by ``(1 / (F1 *
    F2)) * (10^s1 * 10^s2)`` (``F = floor(c * 10^s + 0.5)``), neither
    the split nor the whole reciprocals' product; at one lane by ``1 /
    ((F2 * R1) * 10^-s2)``.  The port gives these two programs' bits at 8
    lanes and at one (a product of the two split reciprocals was one unit
    in the last place away)."""
    for forms, ref8, ref1 in (
            (["CAST(X AS DOUBLE) / ROUND(10.37, 1) / ROUND(7.7, 1)"], 0.012487512487512488,
             0.012487512487512486),
            (["CAST(X AS DOUBLE) / ROUND(123.456, 2) / ROUND(0.3, 1)"], 0.026999298018251527,
             0.026999298018251523)):
        for lanes, ref in ((8, ref8), (1, ref1)):
            want, got = _both_steps(forms, [{"X": 1, "D": 1.0, "S": 1}] * lanes)
            assert want[0]["Y0"] == ref
            assert [repr(r) for r in got] == [repr(r) for r in want]


#: ROADMAP C14's chains of two different constant ROUND divisors: the
#: pin's two programs, the chain reversed, a negative scale, after a
#: program met either ROUND (in a division or a product) or another one,
#: before later divisions by each (the second still splits), twice, and
#: literals drawn at random (scales -1 to 2)
R2 = "ROUND(7.7, 1)"
CHAIN = f"CAST(X AS DOUBLE) / {R} / {R2}"
C14_CHAINS = {
    "pin": [CHAIN],
    "pin_other": ["CAST(X AS DOUBLE) / ROUND(123.456, 2) / ROUND(0.3, 1)"],
    "reversed": [f"CAST(X AS DOUBLE) / {R2} / {R}"],
    "negative_scale": ["CAST(X AS DOUBLE) / ROUND(1234.5, -1) / ROUND(2.35, 1)"],
    "met_first": [f"D / {R}", CHAIN],
    "met_second": [f"D / {R2}", CHAIN],
    "met_in_a_product": [f"{R} * D", CHAIN],
    "met_another": ["D / ROUND(2.35, 1)", CHAIN],
    "later_divisions": [CHAIN, f"D / {R}", f"D / {R2}"],
    "twice": [CHAIN, f"D / {R} / {R2}"],
    "drawn_a": ["CAST(X AS DOUBLE) / ROUND(475.23, 0) / ROUND(474.3, -1)"],
    "drawn_b": ["D / ROUND(13.83, 1) / ROUND(269.095, 2)"],
    "drawn_c": ["CAST(X AS DOUBLE) / ROUND(409.8, -1) / ROUND(393.559, -1)"],
    "drawn_d": ["D / ROUND(3.6, 1) / ROUND(359.97, 2)"],
}


@pytest.mark.parametrize("rows", [1, 4, 8, 16, 64, 256])
@pytest.mark.parametrize("case", list(C14_CHAINS))
def test_two_rounded_divisor_chains_are_the_references(case, rows):
    """ROADMAP C14's chains of two ROUND divisors, bit for bit at 1 to 256
    lanes (:func:`ksql_tpu_torch.compiler.torch_expr._round_chain`)."""
    data = _rounding_rows(rows)
    want, got = _both_steps(C14_CHAINS[case], data)
    assert [repr(r) for r in got] == [repr(r) for r in want]


#: what the rule does not fit (ROADMAP C14, open): (forms, lanes, the
#: reference's first value, the port's).  A chain of three fits no order
#: that follows from the two-ROUND rule in every drawn program (``(1 / (F1
#: * F2 * F3)) * (10^s1 * 10^s2 * 10^s3)`` fits 13 of 14 at 8 lanes, the
#: last below); ``x / (R1 * R2)`` fits no one order in every program
#: (``x * (10^s1 / (F1 * R2))`` 17 of 22 drawn at 8 lanes, ``x * (1 / ((F2
#: * R1) * 10^-s2))`` 22 of 22 there but 16 of 20 in a second draw, and
#: neither where the program met R1 first); at one lane 3 of 20 drawn
#: chains of two fit no order tried
C14_APART = {
    "three": (["CAST(X AS DOUBLE) / ROUND(10.37, 1) / ROUND(7.7, 1) / ROUND(0.3, 1)"], 1,
              0.04162504162504161, 0.04162504162504162),
    "three_drawn": (["CAST(X AS DOUBLE) / ROUND(241.1, 2) / ROUND(211.387, 0) / ROUND(12.29, 1)"], 8,
                    1.598141476528983e-06, 1.5981414765289834e-06),
    "product": (["CAST(X AS DOUBLE) / (ROUND(10.37, 1) * ROUND(7.7, 1))"], 8, 0.012487512487512486,
                0.012487512487512488),
    "one_lane_drawn": (["CAST(X AS DOUBLE) / ROUND(264.3, 0) / ROUND(31.22, 2)"], 1,
                       0.00012132859666491953, 0.00012132859666491954),
    "three_drawn_eight": (["CAST(X AS DOUBLE) / ROUND(187.2, -1) / ROUND(330.28, 2) / ROUND(103.67, 1)"], 8,
                          1.5366868212158497e-07, 1.53668682121585e-07),
}


@pytest.mark.parametrize("case", list(C14_APART))
def test_rounded_divisor_forms_the_rule_does_not_fit_stay_apart(case):
    """ROADMAP C14, still open: these programs stay one or two units in
    the last place from the reference."""
    forms, lanes, ref, port = C14_APART[case]
    want, got = _both_steps(forms, [{"X": 1, "D": 1.0, "S": 1}] * lanes)
    assert want[0]["Y0"] == ref and got[0]["Y0"] == port
    ulps = abs(int(np.float64(ref).view(np.int64)) - int(np.float64(port).view(np.int64)))
    assert 1 <= ulps <= 2


def test_a_folded_divisor_is_evaluated_once_per_node(monkeypatch):
    """The lowering compiles its expressions every batch; a constant
    divisor's value is evaluated the first time its node is seen and then
    read back, per node (0.0 and -0.0 compare equal as nodes but are
    different divisors)."""
    from ksql_tpu_torch.compiler import torch_expr as te
    from ksql_tpu_torch.execution import expressions as pex

    ten = pex.DoubleLiteral(10.0)
    zero, neg_zero = pex.DoubleLiteral(0.0), pex.DoubleLiteral(-0.0)
    assert te._folded_constant(ten) == 10.0
    got = [te._folded_constant(zero), te._folded_constant(neg_zero)]
    assert [math.copysign(1.0, v) for v in got] == [1.0, -1.0]

    def refuse(*_a, **_k):
        raise AssertionError("a folded divisor was evaluated again")

    monkeypatch.setattr(te, "TorchExprCompiler", refuse)
    assert te._folded_constant(ten) == 10.0
    assert [math.copysign(1.0, te._folded_constant(v)) for v in (zero, neg_zero)] == [1.0, -1.0]
    assert te._folded_constant(pex.ColumnRef("X")) is None


@pytest.mark.parametrize("shape", ["emit_final", "having"])
def test_offsets_under_emit_final_and_having(shape):
    """K18 resets an evicted window's argset cells with the rest of its
    scalars; K19's HAVING verdict reads the offsets' finalized values."""
    from tests.test_torch_emit_final import late_batches
    from tests.test_torch_lowering import DDL, run_parity

    sel = ("CREATE TABLE C AS SELECT URL, LATEST_BY_OFFSET(LATENCY) AS L, "
           "EARLIEST_BY_OFFSET(USER_ID, false) AS E, COUNT(*) AS N FROM PAGE_VIEWS ")
    batches = late_batches(3, 10, 24)
    if shape == "emit_final":
        run_parity(DDL, sel + "WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 40 MINUTES) GROUP BY URL "
                   "EMIT FINAL;", batches, capacity=24, store=512, evict_interval=3,
                   flush_to=batches[-1][1][-1] + 5 * HOUR)
    else:
        run_parity(DDL, sel + "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL HAVING LATEST_BY_OFFSET(LATENCY) > 100;",
                   batches, capacity=24, store=512)
