"""Physical-plan IR: the serializable ExecutionStep DAG.

Copy of ``ksql_tpu/execution/steps.py``: every step type and the versioned
JSON codec, so ``plan_from_json`` reads the JAX package's plan JSON
unchanged (steps the port does not run still decode, and then raise
DeviceUnsupported in ``runtime/lowering.py``).

Every step carries its resolved output ``schema`` (the reference equivalently
resolves via StepSchemaResolver and embeds schemas in serialized plans) and a
``ctx`` step name used for state-store naming and query topology display.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.execution.expressions import Expression, encode, decode, node
from ksql_tpu_torch.parser.ast_nodes import JoinType, WindowExpression


class ExecutionStep:
    """Marker base.  Fields by convention: ``source`` (or left/right) child
    steps, ``schema`` output schema, ``ctx`` step name."""

    schema: LogicalSchema
    ctx: str

    def sources(self) -> Tuple["ExecutionStep", ...]:
        out = []
        for attr in ("source", "left", "right"):
            child = getattr(self, attr, None)
            if isinstance(child, ExecutionStep):
                out.append(child)
        return tuple(out)


@node
class FormatInfo:
    """Key/value serde formats for a step boundary (Formats.java analog).

    ``wrap_single_values`` mirrors SerdeFeature WRAP/UNWRAP_SINGLES on the
    value side (None = format default, i.e. wrapped); single key columns are
    always unwrapped for formats that support it (SerdeFeaturesFactory
    .buildKeyFeatures)."""

    key_format: str = "KAFKA"
    value_format: str = "JSON"
    wrap_single_values: Optional[bool] = None
    key_wrapped: bool = False  # inferred-record keys keep their envelope
    value_delimiter: Optional[str] = None  # DELIMITED custom delimiter
    key_delimiter: Optional[str] = None  # DELIMITED key delimiter


@node
class AggCall:
    """One aggregation: function + argument expressions over the pre-agg
    schema + trailing literal args (e.g. TOPK k)."""

    function: str
    args: Tuple[Expression, ...] = ()
    distinct: bool = False


# ------------------------------------------------------------------ sources


@node
class StreamSource(ExecutionStep):
    source_name: str
    topic: str
    schema: LogicalSchema
    formats: FormatInfo
    timestamp_column: Optional[str] = None
    timestamp_format: Optional[str] = None
    header_columns: Tuple = ()
    ctx: str = "Source"


@node
class WindowedStreamSource(ExecutionStep):
    source_name: str
    topic: str
    schema: LogicalSchema
    formats: FormatInfo
    window_type: str = "TUMBLING"
    window_size_ms: Optional[int] = None
    timestamp_column: Optional[str] = None
    timestamp_format: Optional[str] = None
    ctx: str = "Source"


@node
class TableSource(ExecutionStep):
    """Table source; materializes the changelog into a state store
    (SourceBuilderBase.java:45 forced materialization)."""

    source_name: str
    topic: str
    schema: LogicalSchema
    formats: FormatInfo
    timestamp_column: Optional[str] = None
    timestamp_format: Optional[str] = None
    state_store_name: str = ""
    header_columns: Tuple = ()
    ctx: str = "Source"


@node
class WindowedTableSource(ExecutionStep):
    source_name: str
    topic: str
    schema: LogicalSchema
    formats: FormatInfo
    window_type: str = "TUMBLING"
    window_size_ms: Optional[int] = None
    timestamp_column: Optional[str] = None
    timestamp_format: Optional[str] = None
    state_store_name: str = ""
    ctx: str = "Source"


# ----------------------------------------------------------- row transforms


@node
class StreamFilter(ExecutionStep):
    source: ExecutionStep
    predicate: Expression
    schema: LogicalSchema
    ctx: str = "Filter"


@node
class TableFilter(ExecutionStep):
    source: ExecutionStep
    predicate: Expression
    schema: LogicalSchema
    ctx: str = "Filter"


@node
class StreamSelect(ExecutionStep):
    """Projection: (alias, expression) pairs over the source schema.
    ``key_names`` optionally renames the (passed-through) key columns."""

    source: ExecutionStep
    selects: Tuple[Tuple[str, Expression], ...]
    schema: LogicalSchema
    key_names: Optional[Tuple[str, ...]] = None
    ctx: str = "Project"


@node
class TableSelect(ExecutionStep):
    source: ExecutionStep
    selects: Tuple[Tuple[str, Expression], ...]
    schema: LogicalSchema
    key_names: Optional[Tuple[str, ...]] = None
    ctx: str = "Project"


@node
class StreamSelectKey(ExecutionStep):
    """Re-key (PARTITION BY / join co-partitioning) — the shuffle boundary:
    lowered to an ICI all-to-all instead of a repartition topic."""

    source: ExecutionStep
    key_expressions: Tuple[Expression, ...]
    schema: LogicalSchema
    ctx: str = "PartitionBy"


@node
class TableSelectKey(ExecutionStep):
    source: ExecutionStep
    key_expressions: Tuple[Expression, ...]
    schema: LogicalSchema
    ctx: str = "PartitionBy"


@node
class StreamFlatMap(ExecutionStep):
    """UDTF explode (KudtfFlatMapper analog): selects may mix scalar
    expressions and table-function calls; each input row emits the cartesian
    alignment of its table-function outputs."""

    source: ExecutionStep
    table_functions: Tuple[Tuple[str, Expression], ...]  # (alias, FunctionCall)
    schema: LogicalSchema
    ctx: str = "FlatMap"


# ------------------------------------------------------------- aggregation


@node
class StreamGroupBy(ExecutionStep):
    source: ExecutionStep
    group_by_expressions: Tuple[Expression, ...]
    schema: LogicalSchema
    ctx: str = "GroupBy"


@node
class StreamGroupByKey(ExecutionStep):
    source: ExecutionStep
    schema: LogicalSchema
    ctx: str = "GroupByKey"


@node
class TableGroupBy(ExecutionStep):
    source: ExecutionStep
    group_by_expressions: Tuple[Expression, ...]
    schema: LogicalSchema
    ctx: str = "GroupBy"


@node
class StreamAggregate(ExecutionStep):
    """Unwindowed aggregate over a grouped stream.  ``non_agg_columns`` are
    the group-key columns carried into the value; ``aggregations`` produce
    KSQL_AGG_VARIABLE_i columns (KudafAggregator.java:56 semantics)."""

    source: ExecutionStep
    non_agg_columns: Tuple[str, ...]
    aggregations: Tuple[AggCall, ...]
    schema: LogicalSchema
    state_store_name: str = ""
    ctx: str = "Aggregate"


@node
class StreamWindowedAggregate(ExecutionStep):
    source: ExecutionStep
    non_agg_columns: Tuple[str, ...]
    aggregations: Tuple[AggCall, ...]
    window: WindowExpression
    schema: LogicalSchema
    state_store_name: str = ""
    ctx: str = "Aggregate"


@node
class TableAggregate(ExecutionStep):
    """Aggregate over a grouped *table*: handles retractions via undo
    (KudafUndoAggregator analog)."""

    source: ExecutionStep
    non_agg_columns: Tuple[str, ...]
    aggregations: Tuple[AggCall, ...]
    schema: LogicalSchema
    state_store_name: str = ""
    ctx: str = "Aggregate"


@node
class TableSuppress(ExecutionStep):
    """EMIT FINAL buffering (TableSuppressBuilder.java:39)."""

    source: ExecutionStep
    schema: LogicalSchema
    ctx: str = "Suppress"


# ------------------------------------------------------------------- joins


@node
class StreamStreamJoin(ExecutionStep):
    left: ExecutionStep
    right: ExecutionStep
    join_type: JoinType
    left_key: Expression
    right_key: Expression
    before_ms: int = 0
    after_ms: int = 0
    grace_ms: Optional[int] = None
    schema: LogicalSchema = None  # type: ignore[assignment]
    left_alias: str = "L"
    right_alias: str = "R"
    ctx: str = "Join"


@node
class StreamTableJoin(ExecutionStep):
    left: ExecutionStep
    right: ExecutionStep
    join_type: JoinType
    left_key: Expression
    right_key: Expression
    schema: LogicalSchema = None  # type: ignore[assignment]
    left_alias: str = "L"
    right_alias: str = "R"
    ctx: str = "Join"


@node
class TableTableJoin(ExecutionStep):
    left: ExecutionStep
    right: ExecutionStep
    join_type: JoinType
    left_key: Expression
    right_key: Expression
    schema: LogicalSchema = None  # type: ignore[assignment]
    left_alias: str = "L"
    right_alias: str = "R"
    ctx: str = "Join"


@node
class ForeignKeyTableTableJoin(ExecutionStep):
    left: ExecutionStep
    right: ExecutionStep
    join_type: JoinType
    foreign_key_expression: Expression
    schema: LogicalSchema = None  # type: ignore[assignment]
    left_alias: str = "L"
    right_alias: str = "R"
    ctx: str = "FkJoin"


# ------------------------------------------------------------------- sinks


@node
class StreamSink(ExecutionStep):
    source: ExecutionStep
    topic: str
    formats: FormatInfo
    schema: LogicalSchema
    timestamp_column: Optional[str] = None
    timestamp_format: Optional[str] = None
    # SR-schema-id sinks append schema columns absent from the query with
    # these write-defaults: ((name, default), ...)
    value_defaults: tuple = ()
    ctx: str = "Sink"


@node
class TableSink(ExecutionStep):
    source: ExecutionStep
    topic: str
    formats: FormatInfo
    schema: LogicalSchema
    timestamp_column: Optional[str] = None
    timestamp_format: Optional[str] = None
    # SR-schema-id sinks append schema columns absent from the query with
    # these write-defaults: ((name, default), ...)
    value_defaults: tuple = ()
    ctx: str = "Sink"


# ------------------------------------------------------------ plan wrappers


@node
class QueryPlan:
    """A complete persistent-query plan (QueryPlan.java analog)."""

    query_id: str
    sink_name: Optional[str]
    physical_plan: ExecutionStep
    source_names: Tuple[str, ...] = ()


PLAN_FORMAT_VERSION = 1


def plan_to_json(plan: QueryPlan) -> Dict[str, Any]:
    return {"version": PLAN_FORMAT_VERSION, "plan": encode(plan)}


def plan_from_json(obj: Dict[str, Any]) -> QueryPlan:
    version = obj.get("version", 1)
    if version > PLAN_FORMAT_VERSION:
        raise ValueError(f"plan format version {version} is newer than supported "
                         f"{PLAN_FORMAT_VERSION}")
    return decode(obj["plan"])
