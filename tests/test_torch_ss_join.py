"""Stream-stream windowed joins: the port against ``ksql_tpu``'s device backend.

Per step: ``TorchCompiledQuery`` and ``CompiledDeviceQuery`` are built from
the same plan and fed the same batches of each side (``process_ss``, whose
``BatchLayout.encode`` arrays are checked equal first), the tick's expiry
(``ss_expire_host``) and the end-of-input flush; after EVERY step the whole
state dict (both rings, the dump entries included) and every emit lane
must be equal.  The queries are ``tests/test_device_join.py``'s four
(INNER, LEFT, FULL OUTER, LEFT with GRACE) and BASELINE #4's
(``bench.py:610``), over seeded traffic with null keys, late rows, ring
wraps, ring growth and match-lane growth.

End to end: the port's ``start_plan`` over ``SS_FEED`` against the
reference engine on its device backend and on the row oracle, record for
record; the ring-growth replay of ``test_ss_buffer_growth_replays_batch``;
the refusal of a batched self-join.
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
from ksql_tpu_torch.runner import run_until_quiescent, start_plan
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.topics import Broker as PBroker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from tests.test_device_join import SS_DDL, SS_FEED, SS_GRACE, SS_INNER, SS_LEFT, SS_OUTER
from tests.test_device_join import _run_ss as engine_run_ss
from tests.test_torch_join import _pschema, assert_same_nested_state, plan_of
from tests.test_torch_lowering import _as_tuples, _capture, assert_same_lanes

jax.config.update("jax_enable_x64", True)

# BASELINE #4 (bench.py:610, bench_stream_stream_join)
BENCH_DDL = (
    "CREATE STREAM LEFTS (ID BIGINT KEY, V BIGINT) WITH (KAFKA_TOPIC='lt', VALUE_FORMAT='JSON');",
    "CREATE STREAM RIGHTS (ID BIGINT KEY, V BIGINT) WITH (KAFKA_TOPIC='rt', VALUE_FORMAT='JSON');",
)
BENCH_SS = (
    "CREATE STREAM J AS SELECT L.ID, L.V AS LV, R.V AS RV FROM LEFTS L "
    "LEFT JOIN RIGHTS R WITHIN 10 SECONDS GRACE PERIOD 1 SECOND "
    "ON L.ID = R.ID EMIT CHANGES;"
)
SS_QUERIES = {"inner": (SS_DDL, SS_INNER), "left": (SS_DDL, SS_LEFT), "outer": (SS_DDL, SS_OUTER),
              "grace": (SS_DDL, SS_GRACE), "bench": (BENCH_DDL, BENCH_SS)}


def build_pair(ddl, sql, capacity, buffer, out_cap):
    engine, plan = plan_of(ddl, sql)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=capacity,
                                ss_buffer_capacity=buffer, ss_out_capacity=out_cap)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=capacity, device="cpu", ss_buffer_capacity=buffer,
                                ss_out_capacity=out_cap)
    return ref_q, port_q


def ss_traffic(seed, n_batches, capacity, keys, string_values, step_ms=700, late_frac=0.1,
               null_frac=0.06):
    """Batches alternating left and right (sizes 1..capacity), keys over
    0..keys-1 with null keys, timestamps rising by about ``step_ms`` a
    record with late rows (up to 40 s back), and an expiry after most
    batches: ``("l"|"r", rows, ts)`` and ``("x",)`` steps."""
    rng = np.random.default_rng(seed)
    steps, t = [], 1_000_000
    for b in range(n_batches):
        side = "lr"[b % 2] if rng.random() > 0.2 else "lr"[int(rng.integers(0, 2))]
        rows, ts = [], []
        for _ in range(int(rng.integers(1, capacity + 1))):
            t += int(rng.integers(0, 2 * step_ms))
            key = None if rng.random() < null_frac else int(rng.integers(0, keys))
            v = f"{side}{t}" if string_values else int(rng.integers(-1000, 1000))
            rows.append({"ID": key, "V": v})
            ts.append(t - int(rng.integers(0, 40_000)) if rng.random() < late_frac else t)
        steps.append((side, rows, ts))
        if rng.random() < 0.8:
            steps.append(("x",))
    return steps


def run_ss_parity(ddl, sql, steps, capacity, buffer, out_cap, flush_to):
    """Drive both queries through ``steps`` and a final flush; full state,
    emits and emit lanes are compared after each step.  Returns both
    queries and the number of emits."""
    ref_q, port_q = build_pair(ddl, sql, capacity, buffer, out_cap)
    ref_lanes, port_lanes = [], []
    _capture(ref_q, ref_lanes)
    _capture(port_q, port_lanes)
    n_emits = 0
    for i, step in enumerate(steps + [("f", flush_to)]):
        where = f"step {i} ({step[0]})"
        if step[0] in "lr":
            side, rows, ts = step
            src = ref_q.source if side == "l" else ref_q.right_source
            rlay = ref_q.layout if side == "l" else ref_q.right_layout
            play = port_q.layout if side == "l" else port_q.right_layout
            rhb = RHostBatch.from_rows(src.schema, rows, timestamps=ts)
            phb = PHostBatch.from_rows(_pschema(src.schema), rows, timestamps=ts)
            want_arrays, got_arrays = rlay.encode(rhb), play.encode(phb)
            assert set(want_arrays) == set(got_arrays)
            for k in want_arrays:
                np.testing.assert_array_equal(got_arrays[k], want_arrays[k])
            want, got = ref_q.process_ss(rhb, side), port_q.process_ss(phb, side)
        elif step[0] == "x":
            want, got = ref_q.ss_expire_host(), port_q.ss_expire_host()
        else:
            want, got = ref_q.flush(step[1]), port_q.flush(step[1])
        assert _as_tuples(got) == _as_tuples(want), where
        n_emits += len(want)
        assert_same_lanes(ref_lanes, port_lanes, where)
        assert (port_q.ss_capacity, port_q.ss_out_cap) == (ref_q.ss_capacity, ref_q.ss_out_cap), where
        assert_same_nested_state(ref_q, port_q, where)
    return ref_q, port_q, n_emits


@pytest.mark.parametrize("name", list(SS_QUERIES))
def test_ss_state_parity_per_step(name):
    ddl, sql = SS_QUERIES[name]
    # rings of 16 (capacity 8 x 2) hold about 11 s of one side: the eager
    # queries (24 h default grace) overwrite live entries and grow; the
    # GRACE queries (21-22 s retention) wrap and grow too
    steps = ss_traffic(len(name), 40, capacity=8, keys=6, string_values=ddl is SS_DDL)
    ref_q, q, n_emits = run_ss_parity(ddl, sql, steps, capacity=8, buffer=16, out_cap=4,
                                      flush_to=10**7)
    assert n_emits > 20
    assert q.ss_out_grows >= 1 and q.ss_grows >= 1
    assert q.ss_capacity == ref_q.ss_capacity and q.ss_out_cap == ref_q.ss_out_cap


def test_ss_grace_ring_wraps_without_growth():
    # records ~2 s apart through rings of 64 with 21 s of retention: the
    # cursor wraps every ~256 s of event time and never overwrites a live
    # entry, so the rings keep their size
    steps = ss_traffic(5, 60, capacity=8, keys=4, string_values=False, step_ms=2000,
                       late_frac=0.05)
    _ref_q, q, n_emits = run_ss_parity(BENCH_DDL, BENCH_SS, steps, capacity=8, buffer=64,
                                       out_cap=64, flush_to=10**8)
    assert n_emits > 20 and q.ss_grows == 0
    assert int(q.state["ssl_cursor"]) > 64 and int(q.state["ssr_cursor"]) > 64


def test_ss_buffer_growth_replays_batch():
    # tests/test_device_join.py::test_ss_buffer_growth_replays_batch on the
    # port, beside the reference: 24 left rows of one key and ts overflow
    # the 8-entry ring, then one right row matches all 24
    ref_q, q = build_pair(SS_DDL, SS_INNER, capacity=8, buffer=8, out_cap=4)
    lschema, rschema = ref_q.source.schema, ref_q.right_source.schema
    for start in range(0, 24, 8):
        rows = [{"ID": 1, "V": f"l{start + i}"} for i in range(8)]
        ref_q.process_ss(RHostBatch.from_rows(lschema, rows, timestamps=[1000] * 8), "l")
        q.process_ss(PHostBatch.from_rows(_pschema(lschema), rows, timestamps=[1000] * 8), "l")
    assert q.ss_capacity >= 24 and q.ss_capacity == ref_q.ss_capacity
    want = ref_q.process_ss(RHostBatch.from_rows(rschema, [{"ID": 1, "V": "r"}], timestamps=[1500]), "r")
    emits = q.process_ss(PHostBatch.from_rows(_pschema(rschema), [{"ID": 1, "V": "r"}],
                                              timestamps=[1500]), "r")
    assert len(emits) == 24
    assert q.ss_out_cap >= 24 and q.ss_out_cap == ref_q.ss_out_cap
    assert sorted(e.row["LV"] for e in emits) == sorted(f"l{i}" for i in range(24))
    assert _as_tuples(emits) == _as_tuples(want)
    assert_same_nested_state(ref_q, q, "after the replay")


# ----------------------------------------------------------- end to end
def port_ss_feed(sql, capacity=4, flush_to=100_000):
    """``tests/test_device_join.py::_run_ss`` on the port's runner: each
    record produced, polled and drained in turn, then ``flush_time``."""
    _engine, plan = plan_of(SS_DDL, sql)
    broker = PBroker()
    h = start_plan(json.loads(json.dumps(plan_to_json(plan))), broker, device="cpu",
                   capacity=capacity, ss_buffer_capacity=8)
    for side, key, v, ts in SS_FEED:
        broker.topic("lt" if side == "L" else "rt").produce(
            PRecord(key=key, value=json.dumps({"V": v}), timestamp=ts))
        run_until_quiescent(h)
        h.executor.drain()
    h.executor.flush_time(flush_to)
    sink = plan.physical_plan.topic
    return h, [(r.key, r.value, r.timestamp) for r in broker.topic(sink).all_records()]


@pytest.mark.parametrize("sql", [SS_INNER, SS_LEFT, SS_OUTER, SS_GRACE],
                         ids=["inner", "left", "outer", "grace"])
def test_ss_feed_equals_device_backend_and_oracle(sql):
    _e, handle, dev = engine_run_ss(sql, "device", flush_to=100_000)
    assert handle.backend == "device"
    _e, _h, ora = engine_run_ss(sql, "oracle", flush_to=100_000)
    h, port = port_ss_feed(sql)
    assert h.executor.source_topics == ["lt", "rt"]
    assert len(port) >= 2
    assert port == dev
    assert port == ora


def test_batched_self_join_is_refused():
    ddl = (SS_DDL[0], "CREATE STREAM LEFTS2 (ID BIGINT KEY, V STRING) "
           "WITH (kafka_topic='lt', value_format='JSON');")
    _engine, plan = plan_of(ddl, "CREATE STREAM J AS SELECT L.ID, L.V AS LV, R.V AS RV FROM LEFTS L "
                            "JOIN LEFTS2 R WITHIN 10 SECONDS ON L.ID = R.ID EMIT CHANGES;")
    with pytest.raises(DeviceUnsupported, match="self-join"):
        start_plan(plan_to_json(plan), PBroker(), device="cpu", capacity=4)
    h = start_plan(plan_to_json(plan), PBroker(), device="cpu", capacity=1)
    assert h.executor.source_topics == ["lt"]
