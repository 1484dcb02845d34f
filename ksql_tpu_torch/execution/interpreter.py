"""Row-oriented expression typing and evaluation (trimmed copy of
``ksql_tpu/execution/interpreter.py``).

Expressions compile once against a schema into a closure tree, then
evaluate per row.  The push taps' host residual path and the projection
of fused taps' matched rows run through it, as the reference's oracle
``FilterNode``/``SelectNode`` do.

The copy covers the node types the tap corpus needs: literals, column
references, arithmetic, comparison, AND/OR/NOT, IS [NOT] NULL, BETWEEN, IN,
LIKE, searched and simple CASE, and CAST between the numeric types
(DECIMAL included), BOOLEAN, the temporals and to STRING from a string,
integer or boolean, with the reference's semantics (three-valued logic,
Java integer division and modulus, a NULL operand makes a comparison false,
Java's saturating double-to-integer and wrapping integer narrowing, DECIMAL
rounded HALF_UP with an error past its precision, an evaluation error
yields NULL and reports through ``on_error``).  Function calls, the other
casts (string parsing, a double or temporal to STRING, nested types),
struct/array/map nodes, lambdas, temporal literals and temporal-string
coercions raise :class:`DeviceUnsupported` when compiled, so such a push
session is refused at attach; function calls wait for the UDF library.
"""

from __future__ import annotations

import decimal as _decimal
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.types import SqlBaseType, SqlType
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution import expressions as ex

Row = Mapping[str, Any]
Evaluator = Callable[..., Any]  # (row) -> value


class TypeResolver:
    """Column name -> SqlType.  Qualified refs look up 'SOURCE.NAME' first."""

    def __init__(self, columns: Mapping[str, SqlType]):
        self.columns = dict(columns)

    def key_for(self, name: str, source: Optional[str]) -> str:
        if source:
            q = f"{source}.{name}"
            if q in self.columns:
                return q
        if name in self.columns:
            return name
        raise DeviceUnsupported(f"unknown column {source + '.' if source else ''}{name}")


class CompiledExpr:
    """A typed, compiled expression."""

    def __init__(self, fn: Evaluator, sql_type: Optional[SqlType]):
        self._fn = fn
        self.sql_type = sql_type  # None = untyped NULL literal

    def __call__(self, row: Row) -> Any:
        return self._fn(row)


def common_numeric_type(a: SqlType, b: SqlType) -> SqlType:
    """Binary-op result type for numerics (``common_numeric_type`` of the
    reference's ``common/types.py``)."""
    if not (a.is_numeric() and b.is_numeric()):
        raise DeviceUnsupported(f"arithmetic on {a}/{b}")
    order = [SqlBaseType.INTEGER, SqlBaseType.BIGINT, SqlBaseType.DECIMAL, SqlBaseType.DOUBLE]
    base = order[max(order.index(a.base), order.index(b.base))]
    if base == SqlBaseType.DECIMAL:
        ap = a.precision if a.base == SqlBaseType.DECIMAL else (10 if a.base == SqlBaseType.INTEGER else 19)
        asc = a.scale if a.base == SqlBaseType.DECIMAL else 0
        bp = b.precision if b.base == SqlBaseType.DECIMAL else (10 if b.base == SqlBaseType.INTEGER else 19)
        bsc = b.scale if b.base == SqlBaseType.DECIMAL else 0
        scale = max(asc, bsc)
        precision = max(ap - asc, bp - bsc) + scale + 1
        return SqlType.decimal(min(precision, 38), scale)
    return SqlType.of(base)


class ExpressionCompiler:
    def __init__(self, resolver: TypeResolver,
                 on_error: Optional[Callable[[str, Exception], None]] = None):
        self.resolver = resolver
        self.on_error = on_error or (lambda expr, e: None)

    def compile(self, expr: ex.Expression) -> CompiledExpr:
        fn, t = self._compile(expr)
        return CompiledExpr(self._guard(fn, expr), t)

    def _guard(self, fn: Evaluator, expr: ex.Expression) -> Evaluator:
        text = None

        def guarded(row: Row):
            nonlocal text
            try:
                return fn(row)
            except Exception as e:  # evaluation error -> NULL + processing log
                if text is None:
                    text = ex.format_expression(expr)
                self.on_error(text, e)
                return None

        return guarded

    def _compile(self, e: ex.Expression) -> Tuple[Evaluator, Optional[SqlType]]:
        m = getattr(self, "_c_" + type(e).__name__, None)
        if m is None:
            raise DeviceUnsupported(f"push residual expression {type(e).__name__}")
        return m(e)

    # ------------------------------------------------------------ literals
    def _c_NullLiteral(self, e):
        return (lambda r: None), None

    def _literal(self, val, t):
        return (lambda r: val), t

    def _c_BooleanLiteral(self, e):
        return self._literal(e.value, T.BOOLEAN)

    def _c_IntegerLiteral(self, e):
        return self._literal(e.value, T.INTEGER)

    def _c_LongLiteral(self, e):
        return self._literal(e.value, T.BIGINT)

    def _c_DoubleLiteral(self, e):
        return self._literal(e.value, T.DOUBLE)

    def _c_DecimalLiteral(self, e):
        text = e.text.lstrip("-")
        digits = text.replace(".", "").lstrip("0")
        precision = max(len(digits), 1)
        scale = len(text.split(".")[1]) if "." in text else 0
        return self._literal(_decimal.Decimal(e.text), SqlType.decimal(max(precision, scale), scale))

    def _c_StringLiteral(self, e):
        return self._literal(e.value, T.STRING)

    def _c_BytesLiteral(self, e):
        return self._literal(e.value, T.BYTES)

    # ---------------------------------------------------------- references
    def _c_ColumnRef(self, e):
        key = self.resolver.key_for(e.name, e.source)
        return (lambda r: r.get(key)), self.resolver.columns[key]

    # ---------------------------------------------------------- arithmetic
    def _c_ArithmeticUnary(self, e):
        fn0, t0 = self._compile(e.operand)
        if e.op == ex.ArithOp.ADD:
            return fn0, t0

        def fn(r):
            v = fn0(r)
            return None if v is None else -v

        return fn, t0

    def _c_ArithmeticBinary(self, e):
        lf, ltype = self._compile(e.left)
        rf, rtype = self._compile(e.right)
        op = e.op
        if op == ex.ArithOp.ADD and (
            (ltype and ltype.base == SqlBaseType.STRING)
            or (rtype and rtype.base == SqlBaseType.STRING)
        ):
            def concat(r):
                a, b = lf(r), rf(r)
                if a is None or b is None:
                    return None
                return str(a) + str(b)

            return concat, T.STRING
        if ltype is None or rtype is None:
            out_t = ltype or rtype or T.BIGINT
        else:
            out_t = common_numeric_type(ltype, rtype)
        int_out = out_t.base in (SqlBaseType.INTEGER, SqlBaseType.BIGINT)
        dec_out = out_t.base == SqlBaseType.DECIMAL
        dbl_out = out_t.base == SqlBaseType.DOUBLE
        py_op = _ARITH[op]

        def fn(r):
            a, b = lf(r), rf(r)
            if a is None or b is None:
                return None
            if dec_out:
                a, b = _to_decimal(a), _to_decimal(b)
            elif dbl_out:
                if isinstance(a, _decimal.Decimal):
                    a = float(a)
                if isinstance(b, _decimal.Decimal):
                    b = float(b)
            return py_op(a, b, int_out)

        return fn, out_t

    # ---------------------------------------------------------- comparison
    def _c_Comparison(self, e):
        lf, ltype = self._compile(e.left)
        rf, rtype = self._compile(e.right)
        op = e.op
        if op == ex.CompareOp.IS_DISTINCT_FROM:
            return (lambda r: not _sql_equal(lf(r), rf(r))), T.BOOLEAN
        if op == ex.CompareOp.IS_NOT_DISTINCT_FROM:
            return (lambda r: _sql_equal(lf(r), rf(r))), T.BOOLEAN
        if isinstance(e.left, ex.NullLiteral) or isinstance(e.right, ex.NullLiteral):
            raise DeviceUnsupported("comparison with NULL")
        l_coerce = r_coerce = None
        if ltype is not None and rtype is not None:
            lb, rb = ltype.base, rtype.base
            comparable = lb == rb or (ltype.is_numeric() and rtype.is_numeric())
            eq_only = {SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT, SqlBaseType.BOOLEAN}
            if lb == rb and lb in eq_only and op not in (ex.CompareOp.EQ, ex.CompareOp.NEQ):
                comparable = False
            if not comparable:
                # temporal-string coercions and the ROWTIME text forms stay
                # with the reference (ROADMAP A5)
                raise DeviceUnsupported(f"compare {ltype} to {rtype}")
            if lb == SqlBaseType.DECIMAL and rb == SqlBaseType.DOUBLE:
                l_coerce = float
            elif rb == SqlBaseType.DECIMAL and lb == SqlBaseType.DOUBLE:
                r_coerce = float
        cmp = _COMPARE[op]

        def fn(r):
            a, b = lf(r), rf(r)
            # NULL operand -> false, not NULL (SqlToJavaVisitor.nullCheckPrefix)
            if a is None or b is None:
                return False
            if l_coerce is not None:
                a = l_coerce(a)
            if r_coerce is not None:
                b = r_coerce(b)
            return cmp(a, b)

        return fn, T.BOOLEAN

    # ------------------------------------------------------------- logical
    def _c_LogicalBinary(self, e):
        lf, _ = self._compile(e.left)
        rf, _ = self._compile(e.right)
        if e.op == ex.LogicOp.AND:
            def conj(r):
                a = lf(r)
                if a is False:
                    return False
                b = rf(r)
                if b is False:
                    return False
                if a is None or b is None:
                    return None
                return True

            return conj, T.BOOLEAN

        def disj(r):
            a = lf(r)
            if a is True:
                return True
            b = rf(r)
            if b is True:
                return True
            if a is None or b is None:
                return None
            return False

        return disj, T.BOOLEAN

    def _c_Not(self, e):
        f, _ = self._compile(e.operand)

        def fn(r):
            v = f(r)
            return None if v is None else (not v)

        return fn, T.BOOLEAN

    def _c_IsNull(self, e):
        f, _ = self._compile(e.operand)
        return (lambda r: f(r) is None), T.BOOLEAN

    def _c_IsNotNull(self, e):
        f, _ = self._compile(e.operand)
        return (lambda r: f(r) is not None), T.BOOLEAN

    def _c_Between(self, e):
        vf, vt = self._compile(e.value)
        lo, lot = self._compile(e.lower)
        hi, hit = self._compile(e.upper)
        for bt in (lot, hit):
            if vt is not None and bt is not None and (
                bt.base == SqlBaseType.STRING and vt.base != SqlBaseType.STRING
            ):
                raise DeviceUnsupported(f"BETWEEN {vt} and {bt}")
        lo_c = float if vt is not None and vt.base == SqlBaseType.DOUBLE and lot is not None \
            and lot.base == SqlBaseType.DECIMAL else None
        hi_c = float if vt is not None and vt.base == SqlBaseType.DOUBLE and hit is not None \
            and hit.base == SqlBaseType.DECIMAL else None
        negated = e.negated

        def fn(r):
            v, a, b = vf(r), lo(r), hi(r)
            if v is None or a is None or b is None:
                return None
            if lo_c is not None:
                a = lo_c(a)
            if hi_c is not None:
                b = hi_c(b)
            if isinstance(v, _decimal.Decimal) and (isinstance(a, float) or isinstance(b, float)):
                v = float(v)
            res = a <= v <= b
            return (not res) if negated else res

        return fn, T.BOOLEAN

    def _c_InList(self, e):
        vf, vt = self._compile(e.value)
        items = []
        for item in e.items:
            f, it = self._compile(item)
            if vt is not None and it is not None and not (
                it.base == vt.base or (vt.is_numeric() and it.is_numeric())
            ):
                # cross-type literal coercion stays with the reference
                raise DeviceUnsupported(f"IN list item {it} against {vt}")
            items.append(f)
        negated = e.negated

        def fn(r):
            v = vf(r)
            if v is None:
                return None
            saw_null = False
            for itf in items:
                item = itf(r)
                if item is None:
                    saw_null = True
                elif _sql_equal(v, item):
                    return not negated
            if saw_null:
                return None
            return negated

        return fn, T.BOOLEAN

    # --------------------------------------------------------- conditionals
    def _c_SearchedCase(self, e):
        whens = [(self._compile(w.condition)[0], self._compile(w.result)) for w in e.when_clauses]
        default = self._compile(e.default) if e.default is not None else None
        out_t = next((t for _, (_, t) in whens if t is not None), None)
        if out_t is None and default is not None:
            out_t = default[1]
        if out_t is None:
            raise DeviceUnsupported("Invalid Case expression. All case branches have NULL type")
        when_fns = [(c, rf) for c, (rf, _) in whens]
        dfn = default[0] if default else (lambda r: None)

        def fn(r):
            for cond, res in when_fns:
                if cond(r) is True:
                    return res(r)
            return dfn(r)

        return fn, out_t

    def _c_SimpleCase(self, e):
        op_f, _ = self._compile(e.operand)
        whens = [(self._compile(w.condition)[0], self._compile(w.result)) for w in e.when_clauses]
        default = self._compile(e.default) if e.default is not None else None
        out_t = next((t for _, (_, t) in whens if t is not None), None)
        if out_t is None and default is not None:
            out_t = default[1]
        when_fns = [(c, rf) for c, (rf, _) in whens]
        dfn = default[0] if default else (lambda r: None)

        def fn(r):
            v = op_f(r)
            if v is not None:
                for cond, res in when_fns:
                    c = cond(r)
                    if c is not None and _sql_equal(v, c):
                        return res(r)
            return dfn(r)

        return fn, out_t

    # ---------------------------------------------------------------- cast
    def _c_Cast(self, e):
        f, src_t = self._compile(e.operand)
        caster = make_caster(src_t, e.target)

        def fn(r):
            v = f(r)
            return None if v is None else caster(v)

        return fn, e.target

    def _c_Like(self, e):
        vf, _ = self._compile(e.value)
        pf, _ = self._compile(e.pattern)
        escape = e.escape
        negated = e.negated
        cache: Dict[str, re.Pattern] = {}

        def fn(r):
            v, p = vf(r), pf(r)
            if v is None or p is None:
                return None
            rx = cache.get(p)
            if rx is None:
                rx = _like_to_regex(p, escape)
                cache[p] = rx
            res = rx.fullmatch(v) is not None
            return (not res) if negated else res

        return fn, T.BOOLEAN


class _CastError(ArithmeticError):
    """A cast the value cannot take (the reference's FunctionException):
    the row's expression is NULL and the error reported."""


def make_caster(src: Optional[SqlType], target: SqlType) -> Callable[[Any], Any]:
    """The reference's ``make_caster`` for the casts this copy takes (module
    docstring); raises :class:`DeviceUnsupported` for the others."""
    tb = target.base
    sb = src.base if src is not None else None
    if sb is not None and sb == tb and tb != SqlBaseType.DECIMAL:
        return lambda v: v
    if tb == SqlBaseType.STRING and sb in (None, SqlBaseType.STRING, SqlBaseType.INTEGER,
                                           SqlBaseType.BIGINT, SqlBaseType.BOOLEAN):
        return lambda v: ("true" if v else "false") if isinstance(v, bool) else str(v)
    numeric_src = sb is None or (src.is_numeric() if src is not None else False)
    if tb in (SqlBaseType.INTEGER, SqlBaseType.BIGINT) and numeric_src:
        bits = 32 if tb == SqlBaseType.INTEGER else 64
        half, full = 1 << (bits - 1), 1 << bits

        def to_int(v):
            if isinstance(v, float):
                # Java double->int/long saturates: NaN -> 0, past the range
                # to MIN/MAX
                if math.isnan(v):
                    return 0
                if v >= half:
                    return half - 1
                if v < -half:
                    return -half
                return math.trunc(v)
            # integral narrowing (BIGINT/DECIMAL source) wraps
            return (math.trunc(v) + half) % full - half
        return to_int
    if tb == SqlBaseType.DOUBLE and numeric_src:
        return float
    if tb == SqlBaseType.DECIMAL and numeric_src:
        scale = target.scale or 0
        precision = target.precision or scale
        quantum = _decimal.Decimal(1).scaleb(-scale)
        limit = _decimal.Decimal(10) ** (precision - scale)

        def to_dec(v):
            # HALF_UP = ties away from zero (Java BigDecimal)
            out = _to_decimal(v).quantize(quantum, rounding=_decimal.ROUND_HALF_UP)
            if abs(out) >= limit:
                raise _CastError(
                    f"Numeric field overflow: A field with precision {precision} "
                    f"and scale {scale} must round to an absolute value less "
                    f"than 10^{precision - scale}. Got {v}")
            return out
        return to_dec
    if tb == SqlBaseType.TIMESTAMP and sb in (None, SqlBaseType.INTEGER, SqlBaseType.BIGINT,
                                              SqlBaseType.TIME, SqlBaseType.DATE):
        if sb == SqlBaseType.DATE:
            return lambda v: int(v) * 86_400_000
        return int
    if tb in (SqlBaseType.DATE, SqlBaseType.TIME) and sb in (None, SqlBaseType.INTEGER,
                                                             SqlBaseType.BIGINT,
                                                             SqlBaseType.TIMESTAMP):
        if sb != SqlBaseType.TIMESTAMP:
            return int
        if tb == SqlBaseType.DATE:
            return lambda v: v // 86_400_000
        return lambda v: v % 86_400_000
    raise DeviceUnsupported(f"push residual CAST {sb.value if sb else 'NULL'} AS {tb.value}")


def _java_int_div(a, b, int_out: bool):
    if int_out:
        if b == 0:
            raise ZeroDivisionError("division by zero")
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q
    if isinstance(a, _decimal.Decimal) or isinstance(b, _decimal.Decimal):
        # BigDecimal division by zero is an ArithmeticException (-> null+log)
        return _to_decimal(a) / _to_decimal(b)
    # Java double division by zero yields Infinity/NaN, not an error
    if b == 0:
        a = float(a)
        if a == 0 or a != a:  # 0/0 and NaN/0 are NaN
            return float("nan")
        return float("inf") if a > 0 else float("-inf")
    return a / b


def _java_mod(a, b, int_out: bool):
    if b == 0:
        if int_out:
            raise ZeroDivisionError("modulus by zero")
        if isinstance(a, _decimal.Decimal) or isinstance(b, _decimal.Decimal):
            # BigDecimal.remainder(ZERO) throws -> null (not NaN)
            raise ZeroDivisionError("decimal modulus by zero")
        return float("nan")
    if int_out:
        r = abs(a) % abs(b)
        return r if a >= 0 else -r
    if isinstance(a, _decimal.Decimal) and isinstance(b, _decimal.Decimal):
        r = abs(a) % abs(b)
        return r if a >= 0 else -r
    return math.fmod(a, b)


_ARITH = {
    ex.ArithOp.ADD: lambda a, b, i: a + b,
    ex.ArithOp.SUBTRACT: lambda a, b, i: a - b,
    ex.ArithOp.MULTIPLY: lambda a, b, i: a * b,
    ex.ArithOp.DIVIDE: _java_int_div,
    ex.ArithOp.MODULUS: _java_mod,
}

_COMPARE = {
    ex.CompareOp.EQ: lambda a, b: _sql_equal(a, b),
    ex.CompareOp.NEQ: lambda a, b: not _sql_equal(a, b),
    ex.CompareOp.LT: lambda a, b: a < b,
    ex.CompareOp.LTE: lambda a, b: a <= b,
    ex.CompareOp.GT: lambda a, b: a > b,
    ex.CompareOp.GTE: lambda a, b: a >= b,
}


def _to_decimal(v: Any) -> _decimal.Decimal:
    if isinstance(v, _decimal.Decimal):
        return v
    if isinstance(v, float):
        return _decimal.Decimal(repr(v))
    return _decimal.Decimal(v)


def _sql_equal(a: Any, b: Any) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, _decimal.Decimal) and isinstance(b, float):
        return float(a) == b
    if isinstance(b, _decimal.Decimal) and isinstance(a, float):
        return a == float(b)
    return a == b


def _like_to_regex(pattern: str, escape: Optional[str]) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out), re.DOTALL)
