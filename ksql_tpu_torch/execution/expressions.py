"""SQL expression tree.

Analog of the reference's 45-node expression tree
(ksqldb-execution/.../execution/expression/tree/).  Nodes are immutable
dataclasses, JSON-serializable (plans embed expressions), and consumed by
three backends:

* the row interpreter (parity oracle / literal resolution) —
  ``execution/interpreter.py``;
* the columnar JAX compiler (device path) — ``compiler/jax_compiler.py``;
* the SQL formatter (EXPLAIN / DESCRIBE output) — ``format_expression``.
"""

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from ksql_tpu_torch.common.types import SqlType

# --------------------------------------------------------------- registry

NODE_TYPES: Dict[str, type] = {}
ENUM_TYPES: Dict[str, type] = {}


def node(cls):
    """Register an AST/expression dataclass for JSON round-trip."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    NODE_TYPES[cls.__name__] = cls
    return cls


def register_enum(cls):
    ENUM_TYPES[cls.__name__] = cls
    return cls


def encode(value: Any) -> Any:
    """Generic JSON encoding for node trees."""
    from ksql_tpu_torch.common.schema import LogicalSchema

    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, bytes):
        return {"bytes": value.hex()}
    if isinstance(value, enum.Enum):
        return {"enum": f"{type(value).__name__}.{value.name}"}
    if isinstance(value, SqlType):
        return {"sqlType": value.to_json()}
    if isinstance(value, LogicalSchema):
        return {"schema": value.to_json()}
    if isinstance(value, (list, tuple)):
        return [encode(v) for v in value]
    if type(value).__name__ in NODE_TYPES:
        return {
            "node": type(value).__name__,
            "fields": {
                f.name: encode(getattr(value, f.name)) for f in dataclasses.fields(value)
            },
        }
    if isinstance(value, dict):
        return {"dict": [[encode(k), encode(v)] for k, v in value.items()]}
    raise TypeError(f"cannot encode {type(value).__name__}: {value!r}")


def decode(obj: Any) -> Any:
    from ksql_tpu_torch.common.schema import LogicalSchema

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return tuple(decode(v) for v in obj)
    if isinstance(obj, dict):
        if "bytes" in obj and len(obj) == 1:
            return bytes.fromhex(obj["bytes"])
        if "enum" in obj and len(obj) == 1:
            cls_name, member = obj["enum"].split(".")
            return ENUM_TYPES[cls_name][member]
        if "sqlType" in obj and len(obj) == 1:
            return SqlType.from_json(obj["sqlType"])
        if "schema" in obj and len(obj) == 1:
            return LogicalSchema.from_json(obj["schema"])
        if "dict" in obj and len(obj) == 1:
            return {decode(k): decode(v) for k, v in obj["dict"]}
        if "node" in obj:
            cls = NODE_TYPES[obj["node"]]
            kwargs = {k: decode(v) for k, v in obj["fields"].items()}
            return cls(**kwargs)
    raise TypeError(f"cannot decode {obj!r}")


class Expression:
    """Marker base class for expression nodes."""

    def __str__(self) -> str:
        return format_expression(self)


# ---------------------------------------------------------------- literals


@node
class NullLiteral(Expression):
    pass


@node
class BooleanLiteral(Expression):
    value: bool


@node
class IntegerLiteral(Expression):
    value: int  # INT32 range


@node
class LongLiteral(Expression):
    value: int


@node
class DoubleLiteral(Expression):
    value: float


@node
class DecimalLiteral(Expression):
    text: str  # exact textual form, e.g. "1.23"


@node
class StringLiteral(Expression):
    value: str


@node
class BytesLiteral(Expression):
    value: bytes


# --------------------------------------------------------------- references


@node
class ColumnRef(Expression):
    """Possibly source-qualified column reference (`s.col` or `col`)."""

    name: str
    source: Optional[str] = None


@node
class Dereference(Expression):
    """Struct field access: base->field."""

    base: Expression
    field: str


@node
class Subscript(Expression):
    """array[idx] (1-based per reference semantics) or map['key']."""

    base: Expression
    index: Expression


@node
class StructAll(Expression):
    """`base->*` struct-field expansion; only legal as a top-level select
    item, expanded by the analyzer into one column per struct field."""

    base: Expression


# -------------------------------------------------------------- operations


@register_enum
class ArithOp(enum.Enum):
    ADD = "+"
    SUBTRACT = "-"
    MULTIPLY = "*"
    DIVIDE = "/"
    MODULUS = "%"


@register_enum
class CompareOp(enum.Enum):
    EQ = "="
    NEQ = "<>"
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="
    IS_DISTINCT_FROM = "IS DISTINCT FROM"
    IS_NOT_DISTINCT_FROM = "IS NOT DISTINCT FROM"


@register_enum
class LogicOp(enum.Enum):
    AND = "AND"
    OR = "OR"


@node
class ArithmeticBinary(Expression):
    op: ArithOp
    left: Expression
    right: Expression


@node
class ArithmeticUnary(Expression):
    op: ArithOp  # ADD or SUBTRACT
    operand: Expression


@node
class Comparison(Expression):
    op: CompareOp
    left: Expression
    right: Expression


@node
class LogicalBinary(Expression):
    op: LogicOp
    left: Expression
    right: Expression


@node
class Not(Expression):
    operand: Expression


@node
class IsNull(Expression):
    operand: Expression


@node
class IsNotNull(Expression):
    operand: Expression


@node
class Between(Expression):
    value: Expression
    lower: Expression
    upper: Expression
    negated: bool = False


@node
class InList(Expression):
    value: Expression
    items: Tuple[Expression, ...]
    negated: bool = False


@node
class Like(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[str] = None
    negated: bool = False


@node
class Cast(Expression):
    operand: Expression
    target: SqlType


# ------------------------------------------------------------ conditionals


@node
class WhenClause(Expression):
    condition: Expression
    result: Expression


@node
class SearchedCase(Expression):
    """CASE WHEN c THEN r ... [ELSE d] END"""

    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression] = None


@node
class SimpleCase(Expression):
    """CASE operand WHEN v THEN r ... [ELSE d] END"""

    operand: Expression
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression] = None


# ---------------------------------------------------------------- functions


@node
class FunctionCall(Expression):
    name: str
    args: Tuple[Expression, ...] = ()
    distinct: bool = False  # COUNT(DISTINCT x)


@node
class LambdaExpression(Expression):
    params: Tuple[str, ...]
    body: Expression


@node
class LambdaVariable(Expression):
    name: str


# --------------------------------------------------------- constructor exprs


@node
class CreateArray(Expression):
    items: Tuple[Expression, ...]


@node
class CreateMap(Expression):
    entries: Tuple[Tuple[Expression, Expression], ...]


@node
class CreateStruct(Expression):
    fields: Tuple[Tuple[str, Expression], ...]


# ------------------------------------------------------------ typed literals


@node
class TimeLiteral(Expression):
    text: str


@node
class DateLiteral(Expression):
    text: str


@node
class TimestampLiteral(Expression):
    text: str


@node
class IntervalUnit(Expression):
    """e.g. the `SECONDS` in SIZE 30 SECONDS (used inside window exprs)."""

    unit: str


# ---------------------------------------------------------------- traversal


def walk(expr: Any):
    """Pre-order traversal over all Expression nodes in a tree."""
    if isinstance(expr, Expression):
        yield expr
        for f in dataclasses.fields(expr):
            yield from walk(getattr(expr, f.name))
    elif isinstance(expr, (list, tuple)):
        for item in expr:
            yield from walk(item)


def rewrite(expr: Any, fn) -> Any:
    """Bottom-up rewrite: fn(node) -> replacement (or the node unchanged)."""
    if isinstance(expr, Expression):
        changed = {}
        for f in dataclasses.fields(expr):
            old = getattr(expr, f.name)
            new = rewrite(old, fn)
            if new is not old:
                changed[f.name] = new
        if changed:
            expr = dataclasses.replace(expr, **changed)
        return fn(expr)
    if isinstance(expr, tuple):
        return tuple(rewrite(item, fn) for item in expr)
    if isinstance(expr, list):
        return [rewrite(item, fn) for item in expr]
    return expr


def referenced_columns(expr: Any) -> List[str]:
    return [e.name for e in walk(expr) if isinstance(e, ColumnRef)]


# ---------------------------------------------------------------- formatting


def _fmt_str(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def format_expression(e: Any) -> str:
    """Round-trippable SQL text (ExpressionFormatter analog)."""
    if isinstance(e, NullLiteral):
        return "null"
    if isinstance(e, BooleanLiteral):
        return "true" if e.value else "false"
    if isinstance(e, (IntegerLiteral, LongLiteral)):
        return str(e.value)
    if isinstance(e, DoubleLiteral):
        return repr(e.value)
    if isinstance(e, DecimalLiteral):
        return e.text
    if isinstance(e, StringLiteral):
        return _fmt_str(e.value)
    if isinstance(e, BytesLiteral):
        return f"X'{e.value.hex()}'"
    if isinstance(e, ColumnRef):
        return f"{e.source}.{e.name}" if e.source else e.name
    if isinstance(e, Dereference):
        return f"{format_expression(e.base)}->{e.field}"
    if isinstance(e, Subscript):
        return f"{format_expression(e.base)}[{format_expression(e.index)}]"
    if isinstance(e, StructAll):
        return f"{format_expression(e.base)}->*"
    if isinstance(e, ArithmeticBinary):
        return f"({format_expression(e.left)} {e.op.value} {format_expression(e.right)})"
    if isinstance(e, ArithmeticUnary):
        return f"{e.op.value}{format_expression(e.operand)}"
    if isinstance(e, Comparison):
        return f"({format_expression(e.left)} {e.op.value} {format_expression(e.right)})"
    if isinstance(e, LogicalBinary):
        return f"({format_expression(e.left)} {e.op.value} {format_expression(e.right)})"
    if isinstance(e, Not):
        return f"(NOT {format_expression(e.operand)})"
    if isinstance(e, IsNull):
        return f"({format_expression(e.operand)} IS NULL)"
    if isinstance(e, IsNotNull):
        return f"({format_expression(e.operand)} IS NOT NULL)"
    if isinstance(e, Between):
        neg = "NOT " if e.negated else ""
        return (
            f"({format_expression(e.value)} {neg}BETWEEN "
            f"{format_expression(e.lower)} AND {format_expression(e.upper)})"
        )
    if isinstance(e, InList):
        neg = "NOT " if e.negated else ""
        items = ", ".join(format_expression(i) for i in e.items)
        return f"({format_expression(e.value)} {neg}IN ({items}))"
    if isinstance(e, Like):
        neg = "NOT " if e.negated else ""
        esc = f" ESCAPE {_fmt_str(e.escape)}" if e.escape else ""
        return f"({format_expression(e.value)} {neg}LIKE {format_expression(e.pattern)}{esc})"
    if isinstance(e, Cast):
        return f"CAST({format_expression(e.operand)} AS {e.target})"
    if isinstance(e, SearchedCase):
        whens = " ".join(
            f"WHEN {format_expression(w.condition)} THEN {format_expression(w.result)}"
            for w in e.when_clauses
        )
        els = f" ELSE {format_expression(e.default)}" if e.default is not None else ""
        return f"(CASE {whens}{els} END)"
    if isinstance(e, SimpleCase):
        whens = " ".join(
            f"WHEN {format_expression(w.condition)} THEN {format_expression(w.result)}"
            for w in e.when_clauses
        )
        els = f" ELSE {format_expression(e.default)}" if e.default is not None else ""
        return f"(CASE {format_expression(e.operand)} {whens}{els} END)"
    if isinstance(e, FunctionCall):
        d = "DISTINCT " if e.distinct else ""
        return f"{e.name}({d}{', '.join(format_expression(a) for a in e.args)})"
    if isinstance(e, LambdaExpression):
        params = ", ".join(e.params)
        params = f"({params})" if len(e.params) != 1 else params
        return f"{params} => {format_expression(e.body)}"
    if isinstance(e, LambdaVariable):
        return e.name
    if isinstance(e, CreateArray):
        return f"ARRAY[{', '.join(format_expression(i) for i in e.items)}]"
    if isinstance(e, CreateMap):
        inner = ", ".join(
            f"{format_expression(k)}:={format_expression(v)}" for k, v in e.entries
        )
        return f"MAP({inner})"
    if isinstance(e, CreateStruct):
        inner = ", ".join(f"{n}:={format_expression(v)}" for n, v in e.fields)
        return f"STRUCT({inner})"
    if isinstance(e, TimeLiteral):
        return f"TIME {_fmt_str(e.text)}"
    if isinstance(e, DateLiteral):
        return f"DATE {_fmt_str(e.text)}"
    if isinstance(e, TimestampLiteral):
        return f"TIMESTAMP {_fmt_str(e.text)}"
    raise TypeError(f"cannot format {type(e).__name__}")
