"""The committed flagship plan stays what the JAX engine builds today.

``ksql_tpu_torch/plans/pv_counts_tumbling.json`` is the serialized physical
plan that ``chip_smoke.py`` runs (the port has no SQL front end yet): it
must equal ``plan_to_json`` of the plan the reference engine builds for the
bench's page-view stream and its tumbling COUNT(*) table, and the port's
decoder must read it back to the same JSON.
"""

import json
import os

import bench
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu_torch.execution import expressions as pex
from ksql_tpu_torch.execution.steps import PLAN_FORMAT_VERSION, plan_from_json

PLAN_FILE = os.path.join(
    os.path.dirname(__file__), os.pardir, "ksql_tpu_torch", "plans", "pv_counts_tumbling.json"
)
CTAS = (
    "CREATE TABLE PV_COUNTS AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
    "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL EMIT CHANGES;"
)


def _committed():
    with open(PLAN_FILE) as f:
        return json.load(f)


def test_plan_file_equals_reference_engine_plan():
    engine = bench._engine()
    plan = bench._plan_of(engine, [bench.PV_DDL, CTAS])
    assert _committed() == json.loads(json.dumps(plan_to_json(plan)))


def test_port_decodes_plan_file_losslessly():
    obj = _committed()
    plan = plan_from_json(obj)
    assert {"version": PLAN_FORMAT_VERSION, "plan": pex.encode(plan)} == obj
    assert plan.physical_plan.topic == "PV_COUNTS"
