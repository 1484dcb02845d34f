"""Push taps end to end on ``device="cpu"`` against the reference engine.

The reference side is ``KsqlEngine`` with ``PushQuerySession``s under
``auto.offset.reset=latest`` (the push registry's tap path); the port's
is ``start_push_registry`` with its ``PushQuerySession``s, each opened on
the plan JSON the reference plans for the same SQL and the query's LIMIT.
Both get the same DDL, the same produced records and the sessions in the
same order, and every session's ``poll()`` output must be equal in order,
gap markers compared without their session and pipeline ids.  Cases: the
tap corpus of ``tests/test_tap_kernel.py`` on one pipeline (fused and host
taps, LIMIT, the fused/host tap counts), churn within the lane capacity
(no program rebuild) and a grow past it (one), a small ring whose slow tap
takes the eviction gap marker, detach, linger and reap, listener mode over
``PV_STREAM`` run by ``start_plan`` (device emit blocks feed the kernel on
both sides), and the standalone pipeline at capacity 1 against 1,024.
"""

import json

import pytest

from ksql_tpu.analyzer.analyzer import analyze_query
from ksql_tpu.common import config as cfg
from ksql_tpu.common.config import KsqlConfig
from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.topics import Record as RRecord
from ksql_tpu.server.rest import PushQuerySession as RSession
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.runner import start_plan, start_push_registry
from ksql_tpu_torch.runtime.topics import Broker
from ksql_tpu_torch.runtime.topics import Record as PRecord
from ksql_tpu_torch.server.push_session import PushQuerySession as PSession

DDL = ("CREATE STREAM S (ID BIGINT, V BIGINT, P DOUBLE, TAG STRING) "
       "WITH (kafka_topic='s', value_format='JSON');")
PV_DDL = ("CREATE STREAM PAGE_VIEWS (URL STRING, USER_ID BIGINT, VIEWTIME BIGINT) "
          "WITH (KAFKA_TOPIC='page_views', VALUE_FORMAT='JSON');")
CSAS = "CREATE STREAM PV_STREAM AS SELECT URL, USER_ID, VIEWTIME FROM PAGE_VIEWS EMIT CHANGES;"
#: the port's keywords for the reference's knobs
KNOBS = {"ring_size": cfg.PUSH_REGISTRY_RING_SIZE, "max_poll_rows": cfg.PUSH_REGISTRY_MAX_POLL_ROWS,
         "capacity_min": cfg.PUSH_FUSED_CAPACITY_MIN, "min_taps": cfg.PUSH_FUSED_MIN_TAPS,
         "linger_ms": cfg.PUSH_REGISTRY_LINGER_MS, "fused": cfg.PUSH_FUSED_ENABLE}

#: tests/test_tap_kernel.py:70: comparisons, AND/OR/NOT, IS NULL,
#: arithmetic projections, LIMIT, string equality, BETWEEN and one LIKE
#: (host) on the same pipeline, and a pure projection
CORPUS = [
    "SELECT ID, V FROM S WHERE V % 2 = 0 EMIT CHANGES;",
    "SELECT ID FROM S WHERE V > 10 AND V <= 30 EMIT CHANGES;",
    "SELECT ID, V * 2 + 1 AS W FROM S WHERE NOT (V < 5) EMIT CHANGES;",
    "SELECT ID FROM S WHERE V IS NULL OR TAG = 't1' EMIT CHANGES;",
    "SELECT ID, P FROM S WHERE P >= 7.5 EMIT CHANGES;",
    "SELECT ID FROM S WHERE TAG <> 't0' EMIT CHANGES LIMIT 4;",
    "SELECT V + ID AS SUMMED FROM S WHERE V BETWEEN 6 AND 40 EMIT CHANGES;",
    "SELECT ID FROM S WHERE TAG LIKE 't%' EMIT CHANGES;",
    "SELECT ID, TAG FROM S WHERE V IN (3, 9, 27) OR P IS NULL EMIT CHANGES LIMIT 5;",
    "SELECT ID, V FROM S EMIT CHANGES;",
]


class Pair:
    """The reference engine and the port's registry over the same DDL."""

    def __init__(self, ddl=(DDL,), backend="oracle", port_kw=None, upstream=None, **knobs):
        props = {cfg.RUNTIME_BACKEND: backend, cfg.QUERY_RETRY_BACKOFF_INITIAL_MS: 1}
        props.update({KNOBS[k]: v for k, v in knobs.items()})
        self.ref = KsqlEngine(KsqlConfig(props))
        self.planner = KsqlEngine(KsqlConfig({cfg.RUNTIME_BACKEND: "oracle"}))
        for d in ddl:
            self.ref.execute_sql(d)
            self.planner.execute_sql(d)
        self.ref.session_properties["auto.offset.reset"] = "latest"
        self.broker = Broker()
        self.reg = start_push_registry(self.broker, device="cpu", **knobs, **(port_kw or {}))
        self.handle = None
        if upstream is not None:
            self.handle = start_plan(upstream, self.broker, device="cpu", capacity=1024)
            self.reg.register_upstream("PV_STREAM", self.handle)
        self.sessions = []

    def open(self, sql):
        q = self.planner.parse(sql)[0].statement
        a = analyze_query(q, self.planner.metastore, self.planner.registry)
        plan = plan_to_json(self.planner.planner.plan(a, "transient_test").plan)
        pair = (RSession(self.ref, sql), PSession(self.reg, json.loads(json.dumps(plan)), q.limit))
        self.sessions.append(pair)
        return pair

    def produce(self, topic, rows, ts0=0):
        for k, row in enumerate(rows):
            v = json.dumps(row)
            self.ref.broker.topic(topic).produce(RRecord(key=None, value=v, timestamp=ts0 + k))
            self.broker.create_topic(topic).produce(PRecord(key=None, value=v, timestamp=ts0 + k))

    def poll_all(self, pairs=None):
        for r, p in pairs or self.sessions:
            got_r, got_p = r.poll(), p.poll()
            assert _norm(got_p) == _norm(got_r)
            assert p.done() == r.done()

    def close(self):
        self.ref.shutdown()
        self.planner.shutdown()
        self.reg.stop_all()


def _norm(rows):
    out = []
    for r in rows:
        if "__gap__" in r:
            out.append({"__gap__": {k: v for k, v in r["__gap__"].items()
                                    if k not in ("queryId", "pipeline")}})
        else:
            out.append(r)
    return out


def _s_rows(n, start=0):
    """tests/test_tap_kernel.py's records: NULL V every 7th, NULL TAG every 11th."""
    rows = []
    for i in range(start, start + n):
        row = {"ID": i, "V": i, "P": i * 0.5, "TAG": f"t{i % 3}"}
        if i % 7 == 3:
            row["V"] = None
        if i % 11 == 5:
            row["TAG"] = None
        rows.append(row)
    return rows


def _pv_rows(n, start=0):
    return [{"URL": f"/page/{(i * 7) % 23}", "USER_ID": (i * 37) % 300 if i % 19 else None,
             "VIEWTIME": 1000 * i} for i in range(start, start + n)]


def test_corpus_on_one_pipeline_matches_reference():
    t = Pair()
    try:
        for sql in CORPUS:
            t.open(sql)
        r, p = t.ref.push_registry.stats(), t.reg.stats()
        assert p["pipelines"] == r["pipelines"] == 1
        assert p["residual"]["fused-taps"] == r["residual"]["fused-taps"] == len(CORPUS) - 2
        assert p["residual"]["host-taps"] == r["residual"]["host-taps"] == 2
        for rnd in range(3):
            t.produce("s", _s_rows(30, 30 * rnd), ts0=30 * rnd)
            t.poll_all()
        assert t.reg.stats()["residual"]["kernel-evals-total"] >= 3
        assert t.reg.stats()["delivered-rows-total"] == t.ref.push_registry.stats()["delivered-rows-total"]
        assert any(k.startswith("push residual stays host-side") for k in t.reg.fallback_reasons)
    finally:
        t.close()


#: taps over CAST and CASE (K25's SQLCAST and SELECT opcodes), the CASE and
#: a cast also in the projection (the host interpreter's copies)
CAST_CASE_TAPS = [
    "SELECT ID, CAST(P AS INT) AS PI FROM S WHERE CAST(P AS INT) > 4 EMIT CHANGES;",
    "SELECT ID FROM S WHERE CAST(P AS INT) > 9 EMIT CHANGES;",
    "SELECT ID, CAST(P AS DECIMAL(4, 1)) AS PD FROM S WHERE CAST(V AS DOUBLE) * 0.5 >= 6.0 EMIT CHANGES;",
    "SELECT ID FROM S WHERE CAST(V AS DOUBLE) * 1.5 >= 20.0 EMIT CHANGES;",
    "SELECT ID, CASE WHEN V > 10 THEN 'big' ELSE 'small' END AS SZ FROM S "
    "WHERE CASE WHEN V > 10 THEN V ELSE ID END % 3 = 0 EMIT CHANGES;",
    "SELECT ID FROM S WHERE CASE WHEN V > 4 THEN V ELSE ID END % 3 = 1 EMIT CHANGES;",
    "SELECT ID FROM S WHERE CASE TAG WHEN 't1' THEN V END > 5 EMIT CHANGES;",
    "SELECT ID FROM S WHERE CASE TAG WHEN 't2' THEN V END > 20 EMIT CHANGES;",
]


def test_cast_and_case_taps_are_fused_and_match_reference():
    t = Pair()
    try:
        for sql in CAST_CASE_TAPS:
            t.open(sql)
        r, p = t.ref.push_registry.stats(), t.reg.stats()
        assert p["residual"]["fused-taps"] == r["residual"]["fused-taps"] == len(CAST_CASE_TAPS)
        for rnd in range(3):
            t.produce("s", _s_rows(30, 30 * rnd), ts0=30 * rnd)
            t.poll_all()
        assert t.reg.stats()["delivered-rows-total"] == t.ref.push_registry.stats()["delivered-rows-total"] > 0
        assert not t.reg.fallback_reasons
    finally:
        t.close()


def test_function_call_tap_is_still_refused_at_attach_in_the_same_words():
    """The host interpreter has no UDF library yet: a tap whose WHERE
    calls a function is refused when it attaches, as before the device
    compiler took the function table."""
    t = Pair()
    try:
        q = "SELECT ID FROM S WHERE ABS(V) > 3 EMIT CHANGES;"
        a = analyze_query(t.planner.parse(q)[0].statement, t.planner.metastore, t.planner.registry)
        plan = plan_to_json(t.planner.planner.plan(a, "transient_fn").plan)
        with pytest.raises(DeviceUnsupported) as err:
            PSession(t.reg, json.loads(json.dumps(plan)))
        assert str(err.value) == "push residual expression FunctionCall"
    finally:
        t.close()


def test_single_tap_below_min_taps_runs_on_the_host():
    t = Pair()
    try:
        t.open(CORPUS[0])
        t.produce("s", _s_rows(20))
        t.poll_all()
        pipe = next(iter(t.reg.pipelines.values()))
        assert pipe.kernel.evaluations == 0  # one fused tap: below min-taps
    finally:
        t.close()


def _mod(mod, r):
    return f"SELECT ID, V FROM S WHERE V % {mod} = {r} EMIT CHANGES;"


def test_churn_within_capacity_rebuilds_nothing_and_a_grow_once():
    t = Pair(capacity_min=4)
    try:
        pairs = [t.open(_mod(100, i)) for i in range(3)]
        nxt = 0

        def pump(n=10):
            nonlocal nxt
            t.produce("s", _s_rows(n, nxt), ts0=nxt)
            nxt += n
            t.poll_all(pairs)

        pump()
        kernel = next(iter(t.reg.pipelines.values())).kernel
        rkernel = next(iter(t.ref.push_registry.pipelines.values())).kernel
        assert kernel.compile_epochs == rkernel.compile_epochs == 1
        pairs.append(t.open(_mod(100, 3)))  # fills the last lane: a parameter write
        pump()
        assert kernel.compile_epochs == 1
        r, p = pairs.pop()
        r.close()
        p.close()
        pairs.append(t.open(_mod(100, 7)))  # detach + attach within capacity
        pump()
        assert kernel.compile_epochs == 1
        pairs.append(t.open(_mod(100, 4)))  # the 5th lane: capacity 4 -> 8
        pump()
        assert kernel.compile_epochs == rkernel.compile_epochs == 2
        pump()
        assert kernel.compile_epochs == 2
        grp = next(iter(kernel.groups.values()))
        assert grp.capacity == 8 and grp.program_builds == 2
    finally:
        t.close()


def test_small_ring_evicts_a_slow_tap_with_the_same_gap_marker():
    t = Pair(ring_size=16, max_poll_rows=1000)
    try:
        fast, slow = t.open(_mod(2, 0)), t.open(_mod(2, 1))
        assert fast[1].tap.fused and slow[1].tap.fused
        rows = [{"ID": i, "V": i, "P": 0.0, "TAG": "t"} for i in range(48)]
        t.produce("s", rows[:8])
        t.poll_all()
        for i in range(8, 48):
            t.produce("s", rows[i:i + 1], ts0=i)
            t.poll_all([fast])
        got_r, got_p = slow[0].poll(), slow[1].poll()
        assert _norm(got_p) == _norm(got_r)
        gaps = [r["__gap__"] for r in got_p if "__gap__" in r]
        assert len(gaps) == 1 and gaps[0]["evicted"] and gaps[0]["skippedRows"] > 0
        assert slow[1].tap.evicted_rows == gaps[0]["skippedRows"]
        pipe = next(iter(t.reg.pipelines.values()))
        rpipe = next(iter(t.ref.push_registry.pipelines.values()))
        assert pipe.healthy_row_count() == rpipe.healthy_row_count() == 16
    finally:
        t.close()


def test_detach_linger_and_reap():
    t = Pair(linger_ms=60_000)
    try:
        a, b = t.open(_mod(3, 0)), t.open(_mod(3, 1))
        t.produce("s", _s_rows(12))
        t.poll_all()
        pipe_id = next(iter(t.reg.pipelines.values())).id
        for r, p in (a, b):
            r.close()
            p.close()
        assert t.reg.stats()["pipelines"] == t.ref.push_registry.stats()["pipelines"] == 1
        c = t.open(_mod(3, 2))  # inside the linger window: the warm pipeline
        assert next(iter(t.reg.pipelines.values())).id == pipe_id
        t.produce("s", _s_rows(12, 12), ts0=12)
        t.poll_all([c])
        c[0].close()
        c[1].close()
        now = 1e18
        t.reg.sweep(now_ms=now)
        t.ref.push_registry.sweep(now_ms=now)
        assert t.reg.stats()["pipelines"] == t.ref.push_registry.stats()["pipelines"] == 0
    finally:
        t.close()


def test_non_shareable_push_query_is_refused():
    t = Pair()
    try:
        with pytest.raises(DeviceUnsupported):
            q = "SELECT ID, COUNT(*) AS C FROM S GROUP BY ID EMIT CHANGES;"
            a = analyze_query(t.planner.parse(q)[0].statement, t.planner.metastore,
                              t.planner.registry)
            plan = plan_to_json(t.planner.planner.plan(a, "transient_agg").plan)
            PSession(t.reg, json.loads(json.dumps(plan)))
    finally:
        t.close()


PV_TAPS = (
    [f"SELECT URL, VIEWTIME FROM PV_STREAM WHERE USER_ID % 16 = {i} EMIT CHANGES;" for i in range(6)]
    + [f"SELECT URL, USER_ID FROM PV_STREAM WHERE URL = '/page/{k}' AND VIEWTIME >= {t} EMIT CHANGES;"
       for k, t in ((0, 0), (5, 20_000), (7, 0))]
    + ["SELECT URL, USER_ID FROM PV_STREAM WHERE URL LIKE '/page/1%' EMIT CHANGES;",
       "SELECT URL, VIEWTIME FROM PV_STREAM WHERE USER_ID % 16 = 9 EMIT CHANGES LIMIT 7;"]
)


def test_listener_mode_device_blocks_match_reference():
    with open("ksql_tpu_torch/plans/pv_stream.json") as f:
        upstream = json.load(f)
    t = Pair(ddl=(PV_DDL, CSAS), backend="device", upstream=upstream)
    try:
        for sql in PV_TAPS:
            t.open(sql)
        pipe = next(iter(t.reg.pipelines.values()))
        rpipe = next(iter(t.ref.push_registry.pipelines.values()))
        assert pipe.mode == rpipe.mode == "listener"
        for rnd in range(3):
            t.produce("page_views", _pv_rows(300, 300 * rnd), ts0=300_000 * rnd)
            t.poll_all()
        assert pipe.kernel.block_spans > 0 and rpipe.kernel.block_spans > 0
        assert pipe.kernel.block_spans == pipe.kernel.evaluations
        assert sum(len(p.rows) for _, p in t.sessions) > 100
    finally:
        t.close()


@pytest.mark.parametrize("taps", ["page_views", "corpus"])
def test_standalone_capacity_1_and_1024_deliver_the_same_rows(taps):
    """The reference's standalone pipeline runs per record; a batched one
    (capacity 1,024) delivers the same rows, each run against the
    reference's too."""
    runs = {}
    for cap in (1, 1024):
        if taps == "page_views":
            t = Pair(ddl=(PV_DDL,), port_kw={"capacity": cap})
            sqls = [sql.replace("PV_STREAM", "PAGE_VIEWS") for sql in PV_TAPS]
        else:
            t = Pair(port_kw={"capacity": cap})
            sqls = CORPUS
        try:
            for sql in sqls:
                t.open(sql)
            for rnd in range(2):
                if taps == "page_views":
                    t.produce("page_views", _pv_rows(200, 200 * rnd), ts0=200_000 * rnd)
                else:
                    t.produce("s", _s_rows(40, 40 * rnd), ts0=40 * rnd)
                t.poll_all()
            runs[cap] = [_norm(p.rows) for _, p in t.sessions]
        finally:
            t.close()
    assert runs[1] == runs[1024]
    assert sum(map(len, runs[1])) > 50


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_negated_between_and_in_over_null_keep_the_references_split(fused):
    """The reference's fused path passes a NULL value through NOT BETWEEN
    and NOT IN (the rewrite into comparisons makes each false, the NOT
    true), while its host path drops it (the interpreter's NULL): the port
    keeps both, path for path (ROADMAP C)."""
    t = Pair(fused=fused)
    try:
        pairs = [t.open("SELECT ID FROM S WHERE V NOT BETWEEN 6 AND 40 EMIT CHANGES;"),
                 t.open("SELECT ID FROM S WHERE V NOT IN (1, 2) EMIT CHANGES;")]
        t.produce("s", [{"ID": i, "V": None if i % 2 else i, "P": 0.0, "TAG": "t"} for i in range(6)])
        t.poll_all()
        ids = [[r["ID"] for r in p.rows] for _, p in pairs]
        assert ids == ([[0, 1, 2, 3, 4, 5], [0, 1, 3, 4, 5]] if fused else [[0, 2, 4], [0, 4]])
    finally:
        t.close()
