"""The committed plans stay what the JAX engine builds today.

``ksql_tpu_torch/plans/pv_counts_tumbling.json`` (BASELINE #1),
``pv_stats_hopping.json`` (BASELINE #2), ``enriched_join.json``
(BASELINE #3), ``ss_join_grace.json`` (BASELINE #4), ``pv_sessions.json``
(BASELINE #5), ``pv_counts_final.json`` and ``pv_stats_hopping_final.json``
(BASELINE #1 and #2 with EMIT FINAL), ``possible_fraud.json`` (ksqlDB's
HAVING example over the page views), ``pv_having_retract.json`` (a
HAVING predicate that flips both ways), ``pv_vectors.json`` (COLLECT_LIST,
COLLECT_SET, TOPK, TOPKDISTINCT, EARLIEST/LATEST_BY_OFFSET(n)) and
``pv_user_pages.json`` (HISTOGRAM), ``users_by_region.json`` and
``customer_orders.json`` (table aggregations), ``big_spenders.json``
(a table transform), ``user_accounts.json`` (a table-table join) and
``orders_enriched.json`` (a foreign-key join), ``current_location.json``
(the ksqlDB quickstart's LATEST_BY_OFFSET view over riderLocations) and
``pv_offsets.json`` with its HOPPING and SESSION variants (EARLIEST/
LATEST_BY_OFFSET, CAST, CASE, ABS and a DECIMAL SUM) are the serialized physical plans
that ``chip_smoke.py`` runs (the port has no SQL front end yet): each must
equal ``plan_to_json`` of the plan the reference engine builds from the
bench's DDL (``bench.py``'s tumbling COUNT(*) and hopping
SUM/AVG/MIN/MAX over the page-view stream, its clicks-users LEFT JOIN, its
stream-stream LEFT JOIN with GRACE and its SESSION COUNT(*), the EMIT
FINAL and HAVING variants and the vector aggregates over the page views,
the reference's own USERS table and an ORDERS table, and BASELINE #3's
USERS joined to an ACCOUNTS table and from customer_orders' ORDERS),
and the port's decoder must read it back
to the same JSON.

The push taps' plans (chip_smoke.py's phases 20 and 21) are held the same
way: ``pv_stream.json`` (the upstream CSAS over the page views),
``pv_identity.json`` (``SELECT * FROM PAGE_VIEWS EMIT CHANGES`` as the
reference's standalone pipeline plans and wraps it, which the port's
``identity_plan`` must also build) and the ``tap_<kind>_<source>.json``
templates (the bench's ``USER_ID % 256 = i`` tap, a ``URL = k AND
VIEWTIME >= t`` tap and a LIKE tap over PAGE_VIEWS and over PV_STREAM),
each equal to the reference's plan of its push query; and chip_smoke's
rewrite of a template's literals must equal the reference's plan of the
query with those literals.
"""

import json
import os

import pytest

import bench
import chip_smoke
from ksql_tpu.analyzer.analyzer import analyze_query
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu_torch.execution import expressions as pex
from ksql_tpu_torch.execution.steps import PLAN_FORMAT_VERSION, plan_from_json
from ksql_tpu_torch.server.push_registry import identity_plan, residual_chain

PLANS = os.path.join(os.path.dirname(__file__), os.pardir, "ksql_tpu_torch", "plans")
#: pv_offsets' select list
OFFSETS_SELECT = (
    "SELECT URL, EARLIEST_BY_OFFSET(USER_ID) AS FIRST_USER, "
    "LATEST_BY_OFFSET(CAST(USER_ID AS DOUBLE) * 0.1, false) AS LAST_SCORE, "
    "SUM(CASE WHEN USER_ID > 500 THEN 1 ELSE 0 END) AS HIGH_USERS, "
    "MAX(ABS(USER_ID - 500)) AS MAX_DIST, "
    "SUM(CAST(USER_ID AS DECIMAL(10, 2))) AS USER_SUM FROM PAGE_VIEWS "
)
CTAS = {
    "pv_counts_tumbling.json": (
        "CREATE TABLE PV_COUNTS AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
        "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;"
    ),
    # bench.py:212-216, bench_hopping_multi_udaf
    "pv_stats_hopping.json": (
        "CREATE TABLE PV_STATS AS SELECT URL, SUM(USER_ID) AS S, AVG(USER_ID) AS A, "
        "MIN(USER_ID) AS MN, MAX(USER_ID) AS MX FROM PAGE_VIEWS "
        "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 15 MINUTES) GROUP BY URL EMIT CHANGES;"
    ),
    # bench.py:540-551, bench_stream_table_join
    "enriched_join.json": (
        "CREATE STREAM ENRICHED AS SELECT C.USER_ID, C.URL, U.REGION "
        "FROM CLICKS C LEFT JOIN USERS U ON C.USER_ID = U.ID "
        "WHERE U.REGION <> 'excluded' EMIT CHANGES;"
    ),
    # bench.py:624-628, bench_stream_stream_join
    "ss_join_grace.json": (
        "CREATE STREAM J AS SELECT L.ID, L.V AS LV, R.V AS RV FROM LEFTS L "
        "LEFT JOIN RIGHTS R WITHIN 10 SECONDS GRACE PERIOD 1 SECOND "
        "ON L.ID = R.ID EMIT CHANGES;"
    ),
    # bench.py:674-675, bench_session
    "pv_sessions.json": (
        "CREATE TABLE SESSIONS AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
        "WINDOW SESSION (30 SECONDS) GROUP BY URL EMIT CHANGES;"
    ),
    # BASELINE #1 as tests/test_device_parity.py::test_emit_final_tumbling
    # runs it: no grace, EMIT FINAL
    "pv_counts_final.json": (
        "CREATE TABLE PV_COUNTS_FINAL AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
        "WINDOW TUMBLING (SIZE 1 HOUR, GRACE PERIOD 0 SECONDS) GROUP BY URL EMIT FINAL;"
    ),
    # BASELINE #2 with EMIT FINAL (grace 0 by default)
    "pv_stats_hopping_final.json": (
        "CREATE TABLE PV_STATS_FINAL AS SELECT URL, SUM(USER_ID) AS S, AVG(USER_ID) AS A, "
        "MIN(USER_ID) AS MN, MAX(USER_ID) AS MX FROM PAGE_VIEWS "
        "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 15 MINUTES) GROUP BY URL EMIT FINAL;"
    ),
    # ksqlDB's possible_fraud example (COUNT(*) > 3 per minute), per URL
    "possible_fraud.json": (
        "CREATE TABLE POSSIBLE_FRAUD AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
        "WINDOW TUMBLING (SIZE 1 MINUTE) GROUP BY URL HAVING COUNT(*) > 3 EMIT CHANGES;"
    ),
    # a verdict that flips both ways on the page views: retraction tombstones
    "pv_having_retract.json": (
        "CREATE TABLE PV_HAVING_RETRACT AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
        "WINDOW TUMBLING (SIZE 1 MINUTE) GROUP BY URL HAVING AVG(USER_ID) > 500 EMIT CHANGES;"
    ),
    # the vector aggregates over the page views: every collect mode but
    # the histogram's, both top-K modes
    "pv_vectors.json": (
        "CREATE TABLE PV_VECTORS AS SELECT URL, "
        "COLLECT_LIST(USER_ID) AS CL, COLLECT_SET(USER_ID) AS CS, "
        "TOPK(USER_ID, 3) AS TK, TOPKDISTINCT(USER_ID, 3) AS TD, "
        "EARLIEST_BY_OFFSET(USER_ID, 3) AS E3, LATEST_BY_OFFSET(USER_ID, 3) AS L3 "
        "FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;"
    ),
    # each user's pages an hour: the histogram over dictionary-coded strings
    "pv_user_pages.json": (
        "CREATE TABLE USER_PAGES AS SELECT USER_ID, HISTOGRAM(URL) AS PAGES "
        "FROM PAGE_VIEWS WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY USER_ID EMIT CHANGES;"
    ),
    # a table aggregation: tests/test_engine_device.py:140's query over its USERS
    "users_by_region.json": (
        "CREATE TABLE USERS_BY_REGION AS SELECT REGION, COUNT(*) C, SUM(AMT) S, AVG(AMT) A, "
        "STDDEV_SAMPLE(AMT) SD FROM USERS GROUP BY REGION;"
    ),
    # a customer's open orders: COLLECT_LIST's and HISTOGRAM's undo, a WHERE
    "customer_orders.json": (
        "CREATE TABLE CUSTOMER_ORDERS AS SELECT CUSTOMER_ID, COUNT(*) AS N, "
        "SUM(AMOUNT) AS TOTAL, COLLECT_LIST(ID) AS ORDER_IDS, HISTOGRAM(STATUS) AS BY_STATUS "
        "FROM ORDERS WHERE STATUS <> 'CANCELLED' GROUP BY CUSTOMER_ID EMIT CHANGES;"
    ),
    # a table transform: a filter and a projection over a table
    "big_spenders.json": (
        "CREATE TABLE BIG_SPENDERS AS SELECT ID, REGION, AMT FROM USERS WHERE AMT > 500;"
    ),
    # a primary-key table-table join: a user's profile beside their account
    "user_accounts.json": (
        "CREATE TABLE USER_ACCOUNTS AS SELECT U.ID, U.NAME, U.REGION, A.BALANCE, A.TIER "
        "FROM USERS U LEFT JOIN ACCOUNTS A ON U.ID = A.ID;"
    ),
    # a foreign-key table-table join: orders beside their customer
    "orders_enriched.json": (
        "CREATE TABLE ORDERS_ENRICHED AS SELECT O.ID, O.AMOUNT, O.STATUS, U.NAME, U.REGION "
        "FROM ORDERS O LEFT JOIN USERS U ON O.CUSTOMER_ID = U.ID;"
    ),
    # the ksqlDB quickstart's first materialized view (docs.ksqldb.io,
    # "Quickstart", step 6)
    "current_location.json": (
        "CREATE TABLE CURRENTLOCATION AS SELECT PROFILEID, LATEST_BY_OFFSET(LATITUDE) AS LA, "
        "LATEST_BY_OFFSET(LONGITUDE) AS LO FROM RIDERLOCATIONS GROUP BY PROFILEID EMIT CHANGES;"
    ),
    # the scalar offsets beside CAST, CASE, ABS and a DECIMAL SUM over the
    # page views, per URL and hour, and over its HOPPING and SESSION windows
    "pv_offsets.json": "CREATE TABLE PV_OFFSETS AS " + OFFSETS_SELECT
                       + "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;",
    "pv_offsets_hopping.json": "CREATE TABLE PV_OFFSETS_HOPPING AS " + OFFSETS_SELECT
                               + "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 15 MINUTES) GROUP BY URL "
                               "EMIT CHANGES;",
    "pv_offsets_session.json": "CREATE TABLE PV_OFFSETS_SESSION AS " + OFFSETS_SELECT
                               + "WINDOW SESSION (30 SECONDS) GROUP BY URL EMIT CHANGES;",
}
#: tests/test_engine_device.py:121
USERS_DDL = ("CREATE TABLE USERS (ID INT PRIMARY KEY, REGION STRING, AMT INT) "
             "WITH (kafka_topic='u', value_format='JSON');")
#: BASELINE #3's USERS (bench.py:541-543)
BASELINE3_USERS_DDL = ("CREATE TABLE USERS (ID BIGINT PRIMARY KEY, NAME STRING, REGION STRING) "
                       "WITH (KAFKA_TOPIC='users', VALUE_FORMAT='JSON');")
ACCOUNTS_DDL = ("CREATE TABLE ACCOUNTS (ID BIGINT PRIMARY KEY, BALANCE DOUBLE, TIER STRING) "
                "WITH (KAFKA_TOPIC='accounts', VALUE_FORMAT='JSON');")
#: customer_orders.json's ORDERS
ORDERS_DDL = ("CREATE TABLE ORDERS (ID BIGINT PRIMARY KEY, CUSTOMER_ID BIGINT, STATUS STRING, "
              "AMOUNT DOUBLE) WITH (kafka_topic='orders', value_format='JSON');")
#: the quickstart's stream (docs.ksqldb.io, "Quickstart", step 3)
RIDER_DDL = ("CREATE STREAM RIDERLOCATIONS (PROFILEID VARCHAR, LATITUDE DOUBLE, LONGITUDE DOUBLE) "
             "WITH (KAFKA_TOPIC='locations', VALUE_FORMAT='JSON', PARTITIONS=1);")
#: the DDL each plan's query reads (bench.py:149, :541-546)
DDL = {
    "pv_counts_tumbling.json": [bench.PV_DDL],
    "pv_stats_hopping.json": [bench.PV_DDL],
    "enriched_join.json": [
        "CREATE TABLE USERS (ID BIGINT PRIMARY KEY, NAME STRING, REGION STRING) "
        "WITH (KAFKA_TOPIC='users', VALUE_FORMAT='JSON');",
        "CREATE STREAM CLICKS (USER_ID BIGINT, URL STRING) "
        "WITH (KAFKA_TOPIC='clicks', VALUE_FORMAT='JSON');",
    ],
    "pv_sessions.json": [bench.PV_DDL],
    "pv_counts_final.json": [bench.PV_DDL],
    "pv_stats_hopping_final.json": [bench.PV_DDL],
    "possible_fraud.json": [bench.PV_DDL],
    "pv_having_retract.json": [bench.PV_DDL],
    "pv_vectors.json": [bench.PV_DDL],
    "pv_user_pages.json": [bench.PV_DDL],
    "ss_join_grace.json": [
        "CREATE STREAM LEFTS (ID BIGINT KEY, V BIGINT) WITH (KAFKA_TOPIC='lt', VALUE_FORMAT='JSON');",
        "CREATE STREAM RIGHTS (ID BIGINT KEY, V BIGINT) WITH (KAFKA_TOPIC='rt', VALUE_FORMAT='JSON');",
    ],
    "users_by_region.json": [USERS_DDL],
    "customer_orders.json": [ORDERS_DDL],
    "big_spenders.json": [USERS_DDL],
    "user_accounts.json": [BASELINE3_USERS_DDL, ACCOUNTS_DDL],
    "orders_enriched.json": [ORDERS_DDL, BASELINE3_USERS_DDL],
    "current_location.json": [RIDER_DDL],
    "pv_offsets.json": [bench.PV_DDL],
    "pv_offsets_hopping.json": [bench.PV_DDL],
    "pv_offsets_session.json": [bench.PV_DDL],
}
SINKS = {"pv_counts_tumbling.json": "PV_COUNTS", "pv_stats_hopping.json": "PV_STATS",
         "enriched_join.json": "ENRICHED", "ss_join_grace.json": "J",
         "pv_sessions.json": "SESSIONS", "pv_counts_final.json": "PV_COUNTS_FINAL",
         "pv_stats_hopping_final.json": "PV_STATS_FINAL", "possible_fraud.json": "POSSIBLE_FRAUD",
         "pv_having_retract.json": "PV_HAVING_RETRACT", "pv_vectors.json": "PV_VECTORS",
         "pv_user_pages.json": "USER_PAGES", "users_by_region.json": "USERS_BY_REGION",
         "customer_orders.json": "CUSTOMER_ORDERS", "big_spenders.json": "BIG_SPENDERS",
         "user_accounts.json": "USER_ACCOUNTS", "orders_enriched.json": "ORDERS_ENRICHED",
         "current_location.json": "CURRENTLOCATION", "pv_offsets.json": "PV_OFFSETS",
         "pv_offsets_hopping.json": "PV_OFFSETS_HOPPING", "pv_offsets_session.json": "PV_OFFSETS_SESSION"}


def _committed(name):
    with open(os.path.join(PLANS, name)) as f:
        return json.load(f)


def _check_equals_reference(name):
    engine = bench._engine()
    plan = bench._plan_of(engine, DDL[name] + [CTAS[name]])
    assert _committed(name) == json.loads(json.dumps(plan_to_json(plan)))


def _check_decodes(name):
    obj = _committed(name)
    plan = plan_from_json(obj)
    assert {"version": PLAN_FORMAT_VERSION, "plan": pex.encode(plan)} == obj
    assert plan.physical_plan.topic == SINKS[name]


def test_plan_file_equals_reference_engine_plan():
    _check_equals_reference("pv_counts_tumbling.json")


def test_port_decodes_plan_file_losslessly():
    _check_decodes("pv_counts_tumbling.json")


def test_hopping_plan_file_equals_reference_engine_plan():
    _check_equals_reference("pv_stats_hopping.json")


def test_port_decodes_hopping_plan_file_losslessly():
    _check_decodes("pv_stats_hopping.json")


def test_join_plan_file_equals_reference_engine_plan():
    _check_equals_reference("enriched_join.json")


def test_port_decodes_join_plan_file_losslessly():
    _check_decodes("enriched_join.json")


def test_ss_join_plan_file_equals_reference_engine_plan():
    _check_equals_reference("ss_join_grace.json")


def test_port_decodes_ss_join_plan_file_losslessly():
    _check_decodes("ss_join_grace.json")


def test_session_plan_file_equals_reference_engine_plan():
    _check_equals_reference("pv_sessions.json")


def test_port_decodes_session_plan_file_losslessly():
    _check_decodes("pv_sessions.json")


#: the EMIT FINAL and HAVING plans of chip_smoke.py's phases 12-13r
FINAL_AND_HAVING = ("pv_counts_final.json", "pv_stats_hopping_final.json",
                    "possible_fraud.json", "pv_having_retract.json")


@pytest.mark.parametrize("name", FINAL_AND_HAVING)
def test_final_and_having_plan_files_equal_reference_engine_plans(name):
    _check_equals_reference(name)


@pytest.mark.parametrize("name", FINAL_AND_HAVING)
def test_port_decodes_final_and_having_plan_files_losslessly(name):
    _check_decodes(name)


#: the vector-aggregate plans of chip_smoke.py's phases 14 and 14h
VECTORS = ("pv_vectors.json", "pv_user_pages.json")


@pytest.mark.parametrize("name", VECTORS)
def test_vector_plan_files_equal_reference_engine_plans(name):
    _check_equals_reference(name)


@pytest.mark.parametrize("name", VECTORS)
def test_port_decodes_vector_plan_files_losslessly(name):
    _check_decodes(name)


#: the table aggregation and table transform plans of chip_smoke.py's
#: phases 15, 16 and 17
TABLE_PLANS = ("users_by_region.json", "customer_orders.json", "big_spenders.json")


@pytest.mark.parametrize("name", TABLE_PLANS)
def test_table_plan_files_equal_reference_engine_plans(name):
    _check_equals_reference(name)


@pytest.mark.parametrize("name", TABLE_PLANS)
def test_port_decodes_table_plan_files_losslessly(name):
    _check_decodes(name)


#: the table-table and foreign-key join plans of chip_smoke.py's phases 18
#: and 19
JOIN_PLANS = ("user_accounts.json", "orders_enriched.json")


@pytest.mark.parametrize("name", JOIN_PLANS)
def test_table_join_plan_files_equal_reference_engine_plans(name):
    _check_equals_reference(name)


@pytest.mark.parametrize("name", JOIN_PLANS)
def test_port_decodes_table_join_plan_files_losslessly(name):
    _check_decodes(name)


#: the offsets' plans of chip_smoke.py's phases 22, 23, 23h and 23s
OFFSET_PLANS = ("current_location.json", "pv_offsets.json", "pv_offsets_hopping.json",
                "pv_offsets_session.json")


@pytest.mark.parametrize("name", OFFSET_PLANS)
def test_offset_plan_files_equal_reference_engine_plans(name):
    _check_equals_reference(name)


@pytest.mark.parametrize("name", OFFSET_PLANS)
def test_port_decodes_offset_plan_files_losslessly(name):
    _check_decodes(name)


@pytest.mark.parametrize("name", OFFSET_PLANS)
def test_reference_keeps_offset_plans_on_device(name):
    """The reference's CompiledDeviceQuery takes each offsets plan (the
    DECIMAL(10, 2) SUM inside its 2^53 envelope), and so does the port."""
    from ksql_tpu.runtime.lowering import CompiledDeviceQuery
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    engine = bench._engine()
    plan = bench._plan_of(engine, DDL[name] + [CTAS[name]])
    CompiledDeviceQuery(plan, engine.registry, capacity=8, store_capacity=16)
    q = TorchCompiledQuery(plan_from_json(_committed(name)), capacity=8, store_capacity=16, device="cpu")
    assert q._needs_seq


PV_STREAM = "CREATE STREAM PV_STREAM AS SELECT URL, USER_ID, VIEWTIME FROM PAGE_VIEWS EMIT CHANGES;"
CTAS["pv_stream.json"] = PV_STREAM
DDL["pv_stream.json"] = [bench.PV_DDL]
SINKS["pv_stream.json"] = "PV_STREAM"


def test_upstream_plan_file_equals_reference_engine_plan():
    _check_equals_reference("pv_stream.json")


def test_port_decodes_upstream_plan_file_losslessly():
    _check_decodes("pv_stream.json")


#: the push queries of the tap templates
TAP_SQL = {
    "mod": "SELECT URL, VIEWTIME FROM {S} WHERE USER_ID % 256 = {i} EMIT CHANGES;",
    "url": "SELECT URL, USER_ID FROM {S} WHERE URL = '{k}' AND VIEWTIME >= {t} EMIT CHANGES;",
    "like": "SELECT URL, USER_ID FROM {S} WHERE URL LIKE '/page/1%' EMIT CHANGES;",
}
TEMPLATE_ARGS = {"i": 0, "k": "/page/0", "t": 0}
SOURCES = ("PAGE_VIEWS", "PV_STREAM")


def _push_plan(sql, query_id="transient_tap"):
    """plan_to_json of the reference's plan of a push query over the page
    views or PV_STREAM."""
    engine = bench._engine()
    engine.execute_sql(bench.PV_DDL)
    engine.execute_sql(PV_STREAM)
    a = analyze_query(engine.parse(sql)[0].statement, engine.metastore, engine.registry)
    plan = engine.planner.plan(a, query_id).plan
    return engine, plan


def _tap_file(kind, source):
    return f"tap_{kind}_{source.lower()}.json"


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("kind", sorted(TAP_SQL))
def test_tap_template_files_equal_reference_plans(kind, source):
    _, plan = _push_plan(TAP_SQL[kind].format(S=source, **TEMPLATE_ARGS))
    assert _committed(_tap_file(kind, source)) == json.loads(json.dumps(plan_to_json(plan)))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("kind", sorted(TAP_SQL))
def test_port_decodes_tap_template_files_losslessly(kind, source):
    obj = _committed(_tap_file(kind, source))
    plan = plan_from_json(obj)
    assert {"version": PLAN_FORMAT_VERSION, "plan": pex.encode(plan)} == obj
    chain = residual_chain(plan)
    assert chain is not None and chain[-1].source_name == source


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("i", [0, 17, 255])
def test_mod_tap_rewrite_equals_reference_plan(i, source):
    _, plan = _push_plan(TAP_SQL["mod"].format(S=source, i=i))
    got = chip_smoke.tap_plan(_committed(_tap_file("mod", source)), {0: i})
    assert got == json.loads(json.dumps(plan_to_json(plan)))


@pytest.mark.parametrize("k,t", [("/page/5", 17), ("/page/12", 1_700_000_170_000)])
def test_url_tap_rewrite_equals_reference_plan(k, t):
    """A VIEWTIME bound past int32 is a LongLiteral, as the parser types it."""
    _, plan = _push_plan(TAP_SQL["url"].format(S="PAGE_VIEWS", k=k, t=t))
    got = chip_smoke.tap_plan(_committed(_tap_file("url", "PAGE_VIEWS")), {"/page/0": k, 0: t})
    assert got == json.loads(json.dumps(plan_to_json(plan)))


def test_identity_plan_file_equals_reference_standalone_plan():
    """The reference's standalone pipeline plans ``SELECT *`` over the
    source and wraps it in a throwaway sink; the port's ``identity_plan``
    builds the same plan from the tap's source step."""
    qid = "pushreg_1_page_views"
    engine, plan = _push_plan("SELECT * FROM PAGE_VIEWS EMIT CHANGES;", qid)
    wrapped = json.loads(json.dumps(plan_to_json(engine._wrap_transient_plan(plan, qid))))
    committed = _committed("pv_identity.json")
    assert committed == wrapped
    assert {"version": PLAN_FORMAT_VERSION, "plan": pex.encode(plan_from_json(committed))} == committed
    source = residual_chain(plan_from_json(_committed(_tap_file("mod", "PAGE_VIEWS"))))[-1]
    assert {"version": PLAN_FORMAT_VERSION, "plan": pex.encode(identity_plan(source, qid))} == committed
