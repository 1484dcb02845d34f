"""Columnar expression compiler: SQL expression tree → torch tensor ops.

The port of ``ksql_tpu/compiler/jax_expr.py``.  Every sub-expression
evaluates to a :class:`DCol` — ``(data, valid)`` tensors over the batch, SQL
three-valued logic riding the ``valid`` mask.  STRING/BYTES columns are
hash-encoded (``runtime/device.py``): ``data`` holds the stable 64-bit hash,
so equality and GROUP BY work on the card.

It covers column references, literals, comparison, arithmetic,
AND/OR/NOT, IS [NOT] NULL, BETWEEN and IN (rewritten into comparisons
and ORs, as the reference does), CAST, searched and simple CASE, struct
field access (through the flattened ``ROOT->F.G`` path columns the batch
layout extracts) and the device function table (``AS_VALUE``, ABS, ROUND,
FLOOR, CEIL, EXP, LN, SQRT, SIGN, GREATEST, LEAST, COALESCE, IFNULL), with
the reference's rules and refusals.  Every other node raises
:class:`DeviceUnsupported`.  The tensors live on the compiler's ``device``;
the arithmetic is elementwise torch and runs eagerly on the card, as XLA
fused it on the TPU.

Two of XLA's conversions are spelled out, since torch leaves them to the
platform: a float to an integer saturates (NaN to 0), and float min/max
let NaN win and put -0.0 below +0.0.  So are three rewrites of XLA's
algebraic simplifier that change bits: a division by a constant is a
product with its reciprocal (the DECIMAL cast's ``/ 10^s`` too), ROUND's
``/ 10^s`` is a product with ``10^-s``, and a product by a constant of a
column that is itself a product by a constant multiplies the constants
first (:attr:`DCol.scaled`).  A division by a constant ROUND(c, s) takes
one of two reciprocals by where it stands in its program, and a chain of
divisions by two different ones a constant of its own (ROADMAP C14,
:func:`round_program`).  On the CPU, EXP, LN and SQRT take
numpy's correctly rounded results (torch's vectorized float64 kernels are
off by one unit in the last place for some inputs); XLA's CPU exp and log
are not correctly rounded either, so those two agree with the reference to
one unit in the last place, not bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.batch import stable_hash64
from ksql_tpu_torch.common.types import SqlBaseType, SqlType
from ksql_tpu_torch.execution import expressions as ex


class DeviceUnsupported(Exception):
    """Expression or step the port's device path does not run."""


# hash-encoded on device: data column holds stable_hash64 of the value
_HASHED = (
    SqlBaseType.STRING, SqlBaseType.BYTES,
    SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT,
)
# numeric promotion order (SqlBaseType.canImplicitlyCast)
_NUM_ORDER = [
    SqlBaseType.INTEGER,
    SqlBaseType.BIGINT,
    SqlBaseType.DECIMAL,
    SqlBaseType.DOUBLE,
]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(t: SqlType) -> torch.dtype:
    """The tensor dtype a column of SQL type ``t`` has on the device."""
    if t.base in _HASHED:
        return torch.int64
    return _TORCH_DTYPES[np.dtype(t.device_dtype())]


@dataclasses.dataclass
class DCol:
    """A device column: fixed-width data + validity, typed.

    A vector aggregate's output (COLLECT_LIST, TOPK, ...) has 2-D ``data``
    (rows, K) with ``valid`` marking the present entries and
    ``elem_valid`` the non-null ones; a map (HISTOGRAM) adds ``aux``, the
    per-entry counts decoded as the map's values.  Such columns pass
    through to the sink only."""

    data: torch.Tensor
    valid: torch.Tensor  # bool, same shape
    sql_type: SqlType
    elem_valid: Optional[torch.Tensor] = None
    aux: Optional[torch.Tensor] = None
    #: ``(base, factor)`` when ``data`` is ``base * factor`` by a constant
    #: float64 ``factor``: XLA's simplifier folds a further product by a
    #: constant into the factor, ``(A * c1) * c2 -> A * (c1 * c2)``
    scaled: Optional[Tuple[torch.Tensor, float]] = None

    @property
    def hashed(self) -> bool:
        return self.sql_type.base in _HASHED


def const_col(value, sql_type: SqlType, n: int, device) -> DCol:
    """Broadcast a Python literal to a batch column."""
    dt = torch_dtype(sql_type)
    if value is None:
        return DCol(
            torch.zeros(n, dtype=dt, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
            sql_type,
        )
    if sql_type.base in _HASHED:
        value = stable_hash64(value)
    return DCol(
        torch.full((n,), value, dtype=dt, device=device),
        torch.ones(n, dtype=torch.bool, device=device),
        sql_type,
    )


def promoted_type(ta: SqlType, tb: SqlType) -> SqlType:
    """The type a binary numeric op computes in: the wider operand's, a
    DECIMAL as DOUBLE.  Raises for a non-numeric operand."""
    a, b = ta.base, tb.base
    if a not in _NUM_ORDER or b not in _NUM_ORDER:
        raise DeviceUnsupported(f"arithmetic on {a}/{b}")
    out = _NUM_ORDER[max(_NUM_ORDER.index(a), _NUM_ORDER.index(b))]
    if out == SqlBaseType.DECIMAL:
        out = SqlBaseType.DOUBLE  # device DECIMAL = f64 (documented deviation)
    return SqlType.of(out)


_EQUALITY = (
    ex.CompareOp.EQ,
    ex.CompareOp.NEQ,
    ex.CompareOp.IS_DISTINCT_FROM,
    ex.CompareOp.IS_NOT_DISTINCT_FROM,
)


def compare_type(ta: SqlType, tb: SqlType, op) -> SqlType:
    """The type a comparison's operands meet in: two numerics in
    :func:`promoted_type`, anything else in the type both must share
    (STRING and BYTES by their hashes, so under equality only).  Raises
    for what the card cannot compare."""
    a, b = ta.base, tb.base
    if a in _HASHED or b in _HASHED:
        if a != b:
            raise DeviceUnsupported(f"compare {a} vs {b}")
        if op not in _EQUALITY:
            raise DeviceUnsupported("string ordering on device")
        return ta
    if ta.is_numeric() and tb.is_numeric():
        return promoted_type(ta, tb)
    if a == b:  # BOOLEAN, TIME/DATE/TIMESTAMP
        return ta
    raise DeviceUnsupported(f"compare {a} vs {b}")


def between_expr(e: ex.Between) -> ex.Expression:
    """BETWEEN as the compilers evaluate it: ``value >= lower AND value <=
    upper``, under NOT when negated."""
    lo = ex.Comparison(ex.CompareOp.GTE, e.value, e.lower)
    hi = ex.Comparison(ex.CompareOp.LTE, e.value, e.upper)
    both = ex.LogicalBinary(ex.LogicOp.AND, lo, hi)
    return ex.Not(both) if e.negated else both


def in_list_terms(e: ex.InList) -> list:
    """IN's items as the equalities ``value = item`` that the compilers OR
    together, left to right (the OR is negated for NOT IN; no item is
    FALSE)."""
    return [ex.Comparison(ex.CompareOp.EQ, e.value, item) for item in e.items]


def deref_root(e: "ex.Dereference"):
    """The base expression under a Dereference chain."""
    cur = e
    while isinstance(cur, ex.Dereference):
        cur = cur.base
    return cur


def deref_fields(e: "ex.Dereference"):
    """Field path of a Dereference chain, outermost-last."""
    chain = []
    cur = e
    while isinstance(cur, ex.Dereference):
        chain.append(cur.field)
        cur = cur.base
    return tuple(reversed(chain))


def deref_synth_name(root: str, fields) -> str:
    """The flattened path column's name (shared by the batch layout that
    extracts it and the compiler that resolves it)."""
    return f"{root}->" + ".".join(fields)


def saturating_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float tensor converted to the integer ``dtype`` as XLA converts:
    truncated toward zero by the conversion, saturated at the type's range,
    NaN to 0 (torch's own conversion is undefined there)."""
    info = torch.iinfo(dtype)
    hi = float(info.max) + 1.0  # 2^31 or 2^63, exact in float64
    inside = (x > -hi - 1.0) & (x < hi) if dtype == torch.int32 else (x >= -hi) & (x < hi)
    safe = torch.where(inside, x, torch.zeros_like(x)).to(dtype)
    big = torch.full_like(safe, info.max)
    small = torch.full_like(safe, info.min)
    return torch.where(x >= hi, big, torch.where(x <= -hi - (1.0 if dtype == torch.int32 else 0.0),
                                                 small, safe))


def _promote(a: DCol, b: DCol) -> tuple:
    """Numeric promotion for binary ops; returns (a', b', result_type)."""
    t = promoted_type(a.sql_type, b.sql_type)
    dt = torch_dtype(t)
    return a.data.to(dt), b.data.to(dt), t


def _repr64(col: DCol) -> torch.Tensor:
    """Raw 64-bit key repr of a column (hash for strings, bitcast for f64,
    widened int otherwise) — ``lowering.py:_repr64`` of the reference."""
    b = col.sql_type.base
    if b in _HASHED:
        return col.data
    if b in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL):
        return col.data.to(torch.float64).view(torch.int64)
    return col.data.to(torch.int64)


def decode_key64(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A key column of ``dtype`` from its 64-bit repr, the inverse of
    :func:`_repr64` (``_decode_key64`` of the reference): float64 by its
    bits, bool as nonzero, narrower ints truncated, int64 as it is."""
    if dtype == torch.float64:
        return data.view(torch.float64)
    if dtype == torch.bool:
        return data != 0
    return data if dtype == torch.int64 else data.to(dtype)


def _decode_repr(data: np.ndarray, sql_type: SqlType) -> np.ndarray:
    if sql_type.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL):
        return data.view(np.float64)
    return data


_NUMERIC_LITERALS = (ex.IntegerLiteral, ex.LongLiteral, ex.DoubleLiteral, ex.DecimalLiteral)


#: the nodes that are a constant when every operand is one (XLA folds
#: them: its algebraic simplifier hoists an elementwise op of broadcast
#: constants into one scalar op, which constant folding then evaluates)
_FOLDED_NODES = (ex.Cast, ex.ArithmeticUnary, ex.ArithmeticBinary, ex.Comparison,
                 ex.LogicalBinary, ex.Not, ex.IsNull, ex.IsNotNull, ex.Between, ex.InList,
                 ex.SearchedCase, ex.SimpleCase, ex.WhenClause, ex.FunctionCall)


def _operands(e):
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ex.Expression):
            yield v
        elif isinstance(v, tuple):
            yield from (x for x in v if isinstance(x, ex.Expression))


def _is_folded(e) -> bool:
    if isinstance(e, _NUMERIC_LITERALS):
        return isinstance(e, ex.DecimalLiteral) or e.value is not None
    if isinstance(e, (ex.BooleanLiteral, ex.NullLiteral)):
        return True
    if isinstance(e, ex.FunctionCall) and e.name.upper() not in DEVICE_FUNCTIONS:
        return False
    return isinstance(e, _FOLDED_NODES) and all(_is_folded(o) for o in _operands(e))


#: folded divisors by node: id -> (node, value); the node is held so its
#: id stays its own (nodes compare 0.0 and -0.0 equal, so not by value)
_FOLDED: Dict[int, Tuple[object, Optional[float]]] = {}
_FOLDED_SIZE = 256


def _folded_constant(e) -> Optional[float]:
    """The value of a divisor that XLA sees as a constant — an expression
    of numeric and boolean literals: casts, arithmetic, comparisons, CASE
    and the device functions, nested — as float64, else None.  It is
    evaluated once per node by the compiler's own rules on a one-row CPU
    column, so a CAST rounds, saturates or nulls as it does on the card
    (a NULL result is None).  A division inside it is the IEEE quotient:
    XLA folds the constant before any reciprocal rewrite reaches it.  A
    DECIMAL cast or ROUND inside it is not: their rounded numerator is no
    constant when the simplifier first sees it, so it takes the reciprocal
    and a following product by a constant is reassociated, as in a
    column (``CAST(7 AS DECIMAL(4, 1)) * 1.5`` is ``70 * (0.1 * 1.5)``,
    10.500000000000002)."""
    if not _is_folded(e):
        return None
    hit = _FOLDED.get(id(e))
    if hit is not None and hit[0] is e:
        return hit[1]
    compiler = TorchExprCompiler({}, 1, "cpu")
    compiler.folding = True
    col = compiler.compile(e)
    value = None
    if bool(col.valid[0]) and col.sql_type.is_numeric():
        value = float(col.data.to(torch.float64)[0])
    if len(_FOLDED) >= _FOLDED_SIZE:
        _FOLDED.pop(next(iter(_FOLDED)))
    _FOLDED[id(e)] = (e, value)
    return value


#: the constant ROUND nodes compiled so far in the current program, by
#: repr; None outside a :func:`round_program`
_ROUND_TRACE: contextvars.ContextVar[Optional[set]] = contextvars.ContextVar(
    "ksql_round_trace", default=None)


@contextlib.contextmanager
def round_program(seen: Optional[set] = None):
    """One of the reference's jitted programs (a step), as far as its
    constant ROUNDs go (ROADMAP C14).  Within one program XLA splits the
    reciprocal of the first constant ``ROUND(c, s)`` it meets when that
    one is a division's divisor: ``x / ROUND(c, s)`` becomes ``x * (10^s
    * (1 / F))``, ``F = floor(c * 10^s + 0.5)``; every later division by
    the same ROUND, and every one after it met the ROUND elsewhere (a
    product, a filter), takes ``1 / ROUND(c, s)`` whole, and so does each
    at one lane (``f64[1]`` arrays fold first).  The lowering runs each
    of its steps inside this context, which keeps the ROUNDs compiled in
    its order and yields them; a nested one joins the outer program, and
    ``seen`` carries on a program that ran in parts (the stream-stream
    step's two halves).  Outside it every division takes the whole
    reciprocal."""
    outer = _ROUND_TRACE.get()
    if outer is not None:
        yield outer
        return
    rounds = set() if seen is None else seen
    token = _ROUND_TRACE.set(rounds)
    try:
        yield rounds
    finally:
        _ROUND_TRACE.reset(token)


def _round_parts(e) -> Optional[Tuple[np.float64, np.float64, np.float64]]:
    """``(F, 10^s, 10^-s)``, ``F = floor(c * 10^s + 0.5)``, for a constant
    ``ROUND(c, s)`` node, else None."""
    if not (isinstance(e, ex.FunctionCall) and e.name.upper() == "ROUND" and len(e.args) == 2
            and _is_folded(e)):
        return None
    c, s = _folded_constant(e.args[0]), _folded_constant(e.args[1])
    if c is None or s is None:
        return None
    p = np.power(np.float64(10.0), np.float64(s))
    return np.floor(np.float64(c) * p + np.float64(0.5)), p, np.power(np.float64(10.0), np.float64(-s))


def _round_split(e) -> Optional[float]:
    """``10^s * (1 / floor(c * 10^s + 0.5))`` for a constant ``ROUND(c,
    s)`` node (the reciprocal XLA takes apart), else None."""
    parts = _round_parts(e)
    if parts is None:
        return None
    f, p, _q = parts
    with np.errstate(divide="ignore"):
        return float(p * (np.float64(1.0) / f))


def _is_round_division(e) -> bool:
    return (isinstance(e, ex.ArithmeticBinary) and e.op == ex.ArithOp.DIVIDE
            and _round_parts(e.right) is not None)


def _round_chain(e, lanes: int) -> Optional[float]:
    """The constant by which XLA multiplies ``x`` in ``x / R1 / R2``, two
    different constant ROUNDs (``R = F * 10^-s``) chained onto an ``x``
    that is no division by one itself, else None (ROADMAP C14).  Over more
    than one lane ``(1 / (F1 * F2)) * (10^s1 * 10^s2)``, whatever its
    program met before; at one lane ``1 / ((F2 * R1) * 10^-s2)``."""
    if not (_is_round_division(e) and _is_round_division(e.left)) or _is_round_division(e.left.left):
        return None
    if repr(e.left.right) == repr(e.right):
        return None
    (f1, p1, q1), (f2, p2, q2) = _round_parts(e.left.right), _round_parts(e.right)
    one = np.float64(1.0)
    with np.errstate(divide="ignore"):
        if lanes > 1:
            return float((one / (f1 * f2)) * (p1 * p2))
        return float(one / ((f2 * (f1 * q1)) * q2))


class TorchExprCompiler:
    """Compiles expressions against an environment of named DCols.

    ``env`` maps column name → DCol (pseudocolumns ROWTIME/WINDOWSTART/...
    included by the lowering when available).  String literals are learned
    into ``dictionary`` so emitted constants decode back to their text.
    """

    def __init__(self, env: Dict[str, DCol], n: int, device, dictionary=None):
        self.env = env
        self.n = n
        self.device = device
        self.dictionary = dictionary

    def compile(self, e: ex.Expression) -> DCol:
        m = getattr(self, "_c_" + type(e).__name__, None)
        if m is None:
            raise DeviceUnsupported(f"expression {type(e).__name__}")
        return m(e)

    def _const(self, value, sql_type: SqlType) -> DCol:
        return const_col(value, sql_type, self.n, self.device)

    # -------------------------------------------------------------- leaves
    def _c_NullLiteral(self, e) -> DCol:
        return self._const(None, T.STRING)

    def _c_BooleanLiteral(self, e) -> DCol:
        return self._const(e.value, T.BOOLEAN)

    def _c_IntegerLiteral(self, e) -> DCol:
        return self._const(e.value, T.INTEGER)

    def _c_LongLiteral(self, e) -> DCol:
        return self._const(e.value, T.BIGINT)

    def _c_DoubleLiteral(self, e) -> DCol:
        return self._const(e.value, T.DOUBLE)

    def _c_DecimalLiteral(self, e) -> DCol:
        return self._const(float(e.text), T.DOUBLE)

    def _c_StringLiteral(self, e) -> DCol:
        if self.dictionary is not None and e.value is not None:
            self.dictionary.learn_value(e.value)
        return self._const(e.value, T.STRING)

    def _c_BytesLiteral(self, e) -> DCol:
        if self.dictionary is not None and e.value is not None:
            self.dictionary.learn_value(e.value)
        return self._const(e.value, T.BYTES)

    def _c_ColumnRef(self, e) -> DCol:
        col = self.env.get(e.name)
        if col is None and e.source:
            col = self.env.get(f"{e.source}.{e.name}")
        if col is None:
            raise DeviceUnsupported(f"column {e.name} not on device")
        return col

    # ---------------------------------------------------------- arithmetic
    def _c_ArithmeticBinary(self, e) -> DCol:
        seen = _ROUND_TRACE.get()
        if (seen is not None and e.op == ex.ArithOp.DIVIDE and isinstance(e.left, ex.ArithmeticBinary)
                and e.left.op == ex.ArithOp.DIVIDE and repr(e.left.right) == repr(e.right)
                and _round_split(e.right) is not None):
            # x / R / R by one constant ROUND: XLA divides by the folded
            # R * R, so neither division splits
            seen.add(repr(e.right))
        chain = None if seen is None or self.folding or not self.folds_literals else _round_chain(e, self.n)
        if chain is not None:
            return self._divide_round_chain(e, chain)
        a = self.compile(e.left)
        split = self._split_divisor(e)  # before the divisor's ROUND is compiled
        b = self.compile(e.right)
        da, db, t = _promote(a, b)
        valid = a.valid & b.valid
        op = e.op
        scaled = None
        if op == ex.ArithOp.ADD:
            out = da + db
        elif op == ex.ArithOp.SUBTRACT:
            out = da - db
        elif op == ex.ArithOp.MULTIPLY:
            return self._multiply(e, a, b, da, db, valid, t)
        elif op in (ex.ArithOp.DIVIDE, ex.ArithOp.MODULUS):
            decimal_op = (
                a.sql_type.base == SqlBaseType.DECIMAL
                and b.sql_type.base == SqlBaseType.DECIMAL
            )
            integral = not da.is_floating_point()
            if integral or decimal_op:
                # Java int division truncates toward zero; /0 → error →
                # null.  DECIMAL/0 is an ArithmeticException → null too
                zero = db == 0
                safe = torch.where(zero, torch.ones_like(db), db)
                if integral:
                    # MIN / -1 wraps to MIN (remainder 0) in XLA; the
                    # divisor 1 gives the same lanes without a trap
                    wrap = (da == torch.iinfo(da.dtype).min) & (db == -1)
                    safe = torch.where(wrap, torch.ones_like(db), safe)
                if op == ex.ArithOp.DIVIDE:
                    if integral:
                        out = torch.div(da, safe, rounding_mode="trunc")
                    else:
                        out, scaled = self._divide(a, da, safe, e.right, nonzero=True)
                else:
                    out = torch.fmod(da, safe)
                valid = valid & ~zero
            elif op == ex.ArithOp.DIVIDE:
                # IEEE: inf/nan, stays valid (Java double)
                out, scaled = self._divide(a, da, db, e.right, split=split)
            else:
                out = torch.where(
                    db != 0,
                    torch.fmod(da, torch.where(db == 0, torch.ones_like(db), db)),
                    torch.full_like(da, float("nan")),
                )
        else:  # pragma: no cover
            raise DeviceUnsupported(f"arith op {op}")
        return DCol(out, valid, t, scaled=scaled)

    #: whether a literal is a compile-time constant (K25's lane compiler
    #: reads literals from per-lane parameters, which are not)
    folds_literals = True
    #: whether this compiler evaluates a constant divisor
    #: (:func:`_folded_constant`), whose own divisions are IEEE quotients
    folding = False

    def _constant(self, e) -> Optional[float]:
        """The value of ``e`` when XLA sees it as a constant, else None."""
        return _folded_constant(e) if self.folds_literals else None

    def _times(self, col: DCol, x: torch.Tensor, c: float):
        """``x * c`` (``x`` the float64 data of ``col``) by a constant as
        XLA's simplifier computes it: a column that is ``base * f`` by a
        constant ``f`` becomes ``base * (f * c)``.  Returns the product
        and its :attr:`DCol.scaled`."""
        if col.scaled is not None and x is col.data:
            base, f = col.scaled
            c = float(np.float64(f) * np.float64(c))
            return base * c, (base, c)
        return x * c, (x, c)

    def _multiply(self, e, a: DCol, b: DCol, da, db, valid, t) -> DCol:
        """A product; by a constant (of a float column that is no constant
        itself, or is a product by one) it is reassociated as XLA does."""
        if da.is_floating_point():
            for col, x, expr, other in ((a, da, e.left, e.right), (b, db, e.right, e.left)):
                c = self._constant(other)
                if c is not None and (col.scaled is not None or self._constant(expr) is None):
                    out, scaled = self._times(col, x, c)
                    return DCol(out, valid, t, scaled=scaled)
        return DCol(da * db, valid, t)

    def _divide_round_chain(self, e, c: float) -> DCol:
        """``x / R1 / R2`` (:func:`_round_chain`): ``x`` times ``c``.  The
        program meets R1 (a later division by it takes the whole
        reciprocal) but not R2 (a later division by it still splits)."""
        a = self.compile(e.left.left)
        r1 = self.compile(e.left.right)
        da, _db, t = _promote(a, r1)
        out, scaled = self._times(a, da, c)
        return DCol(out, a.valid & r1.valid, promoted_type(t, T.DOUBLE), scaled=scaled)

    def _split_divisor(self, e) -> Optional[float]:
        """The split reciprocal of ``e``'s divisor when ``e`` divides by a
        constant ROUND that its program has not met yet, over more than
        one lane (:func:`round_program`), else None."""
        seen = _ROUND_TRACE.get()
        if (seen is None or e.op != ex.ArithOp.DIVIDE or self.folding or not self.folds_literals
                or self.n <= 1 or repr(e.right) in seen):
            return None
        return _round_split(e.right)

    def _divide(self, a: DCol, x: torch.Tensor, y: torch.Tensor, divisor, nonzero=False,
                split=None):
        """``x / y`` (``x`` the float64 data of ``a``) as the reference's
        jitted step computes it: XLA's algebraic simplifier turns a
        division by a constant into a product with the constant's
        reciprocal (``x * (1 / c)``, the reciprocal rounded once in
        float64), which is not always the IEEE quotient, and reassociates
        it with a product by a constant (:meth:`_times`).  The constant
        forms are those of :func:`_folded_constant`; ``nonzero`` is the
        DECIMAL branch's divisor, where a zero reads as 1; ``split`` a
        constant ROUND divisor's split reciprocal (:meth:`_split_divisor`).
        Returns the result and its :attr:`DCol.scaled`."""
        if split is not None:
            return self._times(a, x, split)
        c = None if self.folding else self._constant(divisor)
        if c is None:
            return x / y, None
        if nonzero and c == 0:
            c = 1.0
        with np.errstate(divide="ignore"):
            return self._times(a, x, float(np.float64(1.0) / np.float64(c)))

    def _c_ArithmeticUnary(self, e) -> DCol:
        v = self.compile(e.operand)
        if not v.sql_type.is_numeric():
            raise DeviceUnsupported("unary arith on non-numeric")
        data = -v.data if e.op == ex.ArithOp.SUBTRACT else v.data
        return DCol(data, v.valid, v.sql_type)

    # ---------------------------------------------------------- comparison
    def _c_Comparison(self, e) -> DCol:
        a, b = self.compile(e.left), self.compile(e.right)
        op = e.op
        dt = torch_dtype(compare_type(a.sql_type, b.sql_type, op))
        da, db = a.data.to(dt), b.data.to(dt)
        valid = a.valid & b.valid
        if op in (ex.CompareOp.EQ, ex.CompareOp.IS_NOT_DISTINCT_FROM):
            out = da == db
        elif op in (ex.CompareOp.NEQ, ex.CompareOp.IS_DISTINCT_FROM):
            out = da != db
        elif op == ex.CompareOp.LT:
            out = da < db
        elif op == ex.CompareOp.LTE:
            out = da <= db
        elif op == ex.CompareOp.GT:
            out = da > db
        else:
            out = da >= db
        if op == ex.CompareOp.IS_DISTINCT_FROM:
            # null-safe: NULL is distinct from non-NULL, not from NULL
            out = torch.where(valid, out, a.valid != b.valid)
        elif op == ex.CompareOp.IS_NOT_DISTINCT_FROM:
            out = torch.where(valid, out, a.valid == b.valid)
        else:
            # NULL operand -> false, not NULL (SqlToJavaVisitor.nullCheckPrefix)
            out = out & valid
        return DCol(out, torch.ones_like(valid), T.BOOLEAN)

    # ------------------------------------------------------------- logical
    def _c_LogicalBinary(self, e) -> DCol:
        a, b = self.compile(e.left), self.compile(e.right)
        ad, bd = a.data.to(torch.bool), b.data.to(torch.bool)
        av, bv = a.valid & ad, b.valid & bd
        af, bf = a.valid & ~ad, b.valid & ~bd
        if e.op == ex.LogicOp.AND:
            out = av & bv
            valid = (a.valid & b.valid) | af | bf
        else:
            out = av | bv
            valid = (a.valid & b.valid) | av | bv
        return DCol(out, valid, T.BOOLEAN)

    def _c_Not(self, e) -> DCol:
        v = self.compile(e.operand)
        return DCol(~v.data.to(torch.bool), v.valid, T.BOOLEAN)

    def _c_IsNull(self, e) -> DCol:
        v = self.compile(e.operand)
        return DCol(~v.valid, self._const(True, T.BOOLEAN).data, T.BOOLEAN)

    def _c_IsNotNull(self, e) -> DCol:
        v = self.compile(e.operand)
        return DCol(v.valid, self._const(True, T.BOOLEAN).data, T.BOOLEAN)

    def _c_Between(self, e) -> DCol:
        return self.compile(between_expr(e))

    def _c_InList(self, e) -> DCol:
        self.compile(e.value)  # an unsupported operand refuses the list
        hit = None
        for term in in_list_terms(e):
            c = self.compile(term)
            hit = c if hit is None else self._or(hit, c)
        if hit is None:
            return self._const(False, T.BOOLEAN)
        if e.negated:
            hit = DCol(~hit.data, hit.valid, T.BOOLEAN)
        return hit

    def _or(self, a: DCol, b: DCol) -> DCol:
        av = a.valid & a.data
        bv = b.valid & b.data
        return DCol(av | bv, (a.valid & b.valid) | av | bv, T.BOOLEAN)

    # -------------------------------------------------------------- struct
    def _c_Dereference(self, e) -> DCol:
        """Struct field access resolves to the flattened path column the
        layout extracted at encode (``ROOT->F.G``)."""
        root = deref_root(e)
        if isinstance(root, ex.ColumnRef):
            d = self.env.get(deref_synth_name(root.name, deref_fields(e)))
            if d is not None:
                return d
        raise DeviceUnsupported("struct dereference without a path column")

    # ---------------------------------------------------------------- cast
    def _c_Cast(self, e) -> DCol:
        v = self.compile(e.operand)
        route = cast_route(v.sql_type, e.target)
        if route == "same":
            return DCol(v.data, v.valid, e.target)
        if route == "numeric":
            dst = e.target.base
            dt = torch.float64 if dst == SqlBaseType.DECIMAL else torch_dtype(e.target)
            data = v.data
            if data.is_floating_point() and not dt.is_floating_point:
                out = float_to_int(data, dt)
            else:
                out = data.to(dt)
            valid = v.valid
            if dst == SqlBaseType.DECIMAL and e.target.scale is not None:
                # the reference's cast raises past the precision; the card nulls
                if not self.folds_literals:
                    out, within = decimal_round(out, e.target.precision, e.target.scale)
                    return DCol(out, valid & within, e.target)
                return self._decimal_round(v, out, valid, e.target)
            return DCol(out, valid, e.target, scaled=v.scaled if out is v.data else None)
        if route == "relabel":
            return DCol(v.data.to(torch_dtype(e.target)), v.valid, e.target)
        return DCol(temporal_cast(route, v.data.to(torch.int64)), v.valid, e.target)

    def _decimal_round(self, v: DCol, x: torch.Tensor, valid, target: SqlType) -> DCol:
        """:func:`decimal_round` as the reference's jitted step computes
        it: ``x * 10^s`` reassociated when ``x`` is a product by a
        constant, and the division by the constant ``10^s`` a product with
        its reciprocal, which the result carries as :attr:`DCol.scaled`."""
        f = 10.0 ** target.scale
        xf, _ = self._times(v, x, f)
        rounded = torch.where(x >= 0, torch.floor(xf + 0.5), torch.ceil(xf - 0.5))
        out, scaled = self._times(DCol(rounded, valid, target), rounded, 1.0 / f)
        if target.precision is not None:
            valid = valid & (torch.abs(out) < 10.0 ** (target.precision - target.scale))
        return DCol(out, valid, target, scaled=scaled)

    def _round_to(self, v: DCol, s: DCol, s_expr) -> DCol:
        """ROUND(v, s): ``floor(v * 10^s + 0.5) / 10^s``, whose division
        XLA's simplifier turns into a product with ``10^-s``
        (``A / pow(B, C) -> A * pow(B, -C)``) for any ``s``; for a
        constant ``s`` both powers are constants, so ``v * 10^s`` and the
        result are products by a constant (:meth:`_times`)."""
        x = v.data.to(torch.float64)
        c = self._constant(s_expr)
        if c is None:
            sd = s.data.to(torch.float64)
            out = torch.floor(x * pow10(sd) + 0.5) * pow10(-sd)
            return DCol(out, v.valid & s.valid, T.DOUBLE)
        xf, _ = self._times(v, x, float(np.power(10.0, c)))
        rounded = torch.floor(xf + 0.5)
        out, scaled = self._times(DCol(rounded, v.valid, T.DOUBLE), rounded,
                                  float(np.power(10.0, -c)))
        return DCol(out, v.valid & s.valid, T.DOUBLE, scaled=scaled)

    # --------------------------------------------------------- conditionals
    def _c_SearchedCase(self, e) -> DCol:
        results = [self.compile(w.result) for w in e.when_clauses]
        default = self.compile(e.default) if e.default is not None else None
        t = self._common_type([r.sql_type for r in results]
                              + ([default.sql_type] if default else []))
        dt = torch_dtype(t)
        if default is not None:
            out, valid = default.data.to(dt), default.valid
        else:
            out = torch.zeros(self.n, dtype=dt, device=self.device)
            valid = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        taken = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        for w, r in zip(e.when_clauses, results):
            c = self.compile(w.condition)
            fire = ~taken & c.valid & c.data.to(torch.bool)
            out = torch.where(fire, r.data.to(dt), out)
            valid = torch.where(fire, r.valid, valid)
            taken = taken | fire
        return DCol(out, valid, t)

    def _c_SimpleCase(self, e) -> DCol:
        return self._c_SearchedCase(simple_case_expr(e))

    def _common_type(self, types) -> SqlType:
        return common_type(types)

    # ------------------------------------------------------------ functions
    def _c_FunctionCall(self, e) -> DCol:
        fn = DEVICE_FUNCTIONS.get(e.name.upper())
        if fn is None:
            raise DeviceUnsupported(f"function {e.name} on device")
        args = [self.compile(a) for a in e.args]
        seen = _ROUND_TRACE.get()
        if fn is _f_round and seen is not None and not self.folding and _is_folded(e):
            seen.add(repr(e))
        if fn is _f_round and len(args) == 2:
            return self._round_to(args[0], args[1], e.args[1])
        return fn(self, args)


_DAY_MS = 86_400_000
#: the temporal casts and their routes
_TEMPORAL_ROUTES = {
    (SqlBaseType.DATE, SqlBaseType.TIMESTAMP): "days_to_ms",
    (SqlBaseType.TIMESTAMP, SqlBaseType.DATE): "ms_to_days",
    (SqlBaseType.TIMESTAMP, SqlBaseType.TIME): "ms_to_time",
}


def float_to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float CAST to an integer: Java narrowing truncates toward zero,
    saturated at the type's range."""
    return saturating_int(torch.trunc(x), dtype)


def decimal_round(x: torch.Tensor, precision, scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CAST to DECIMAL(precision, scale) of f64 ``x``: the value rounded
    HALF_UP to ``scale``, and the mask of values within the precision
    (all of them when ``precision`` is None).  It divides by ``10^s``, as
    K25's program and its twin do; a compiled step multiplies by the
    reciprocal (:meth:`TorchExprCompiler._decimal_round`)."""
    f = 10.0 ** scale
    out = torch.where(x >= 0, torch.floor(x * f + 0.5), torch.ceil(x * f - 0.5)) / f
    if precision is None:
        return out, torch.ones_like(out, dtype=torch.bool)
    return out, torch.abs(out) < 10.0 ** (precision - scale)


def temporal_cast(route: str, x: torch.Tensor) -> torch.Tensor:
    """The int64 temporal routes of :func:`cast_route`: DATE (epoch days)
    to midnight ms, or ms to epoch days or to the time of day, floored
    toward -inf for pre-epoch values."""
    if route == "days_to_ms":
        return x * _DAY_MS
    days = torch.div(x, _DAY_MS, rounding_mode="floor")
    return days if route == "ms_to_days" else x - days * _DAY_MS


def cast_route(src_t: SqlType, target: SqlType) -> str:
    """How the card casts ``src_t`` to ``target`` (the reference's
    ``_c_Cast`` rules, shared with K25's program builder): ``same`` (a
    relabel of the value), ``numeric`` (between the numerics: a float to
    an integer truncated and saturated, an integer narrowed by wrapping, a
    DECIMAL target rounded HALF_UP to its scale and NULL past its
    precision), ``relabel`` (an integer to a temporal, TIME to TIMESTAMP:
    a dtype conversion), ``days_to_ms``, ``ms_to_days``, ``ms_to_time``.
    Raises for what the card does not cast, in the reference's words."""
    src, dst = src_t.base, target.base
    nested = (SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT)
    if (src in nested or dst in nested) and src_t != target:
        # nested values are opaque codes: a schema-changing cast needs
        # element coercion
        raise DeviceUnsupported(f"CAST {src} AS {dst} on device")
    if src == dst and src == SqlBaseType.DECIMAL and src_t != target:
        # DECIMAL(p,s) re-scaling needs exact arithmetic
        raise DeviceUnsupported("DECIMAL rescale on device")
    if src == dst:
        return "same"
    if src_t.is_numeric() and target.is_numeric():
        return "numeric"
    temporal = (SqlBaseType.TIMESTAMP, SqlBaseType.TIME, SqlBaseType.DATE)
    if (dst in temporal and src in (SqlBaseType.INTEGER, SqlBaseType.BIGINT)) or (
            dst == SqlBaseType.TIMESTAMP and src == SqlBaseType.TIME):
        return "relabel"
    route = _TEMPORAL_ROUTES.get((src, dst))
    if route is None:
        raise DeviceUnsupported(f"CAST {src} AS {dst} on device")
    return route


def simple_case_expr(e: ex.SimpleCase) -> ex.SearchedCase:
    """A simple CASE as the compilers evaluate it: each WHEN ``v`` becomes
    the condition ``operand = v``."""
    whens = tuple(ex.WhenClause(ex.Comparison(ex.CompareOp.EQ, e.operand, w.condition), w.result)
                  for w in e.when_clauses)
    return ex.SearchedCase(whens, e.default)


def common_type(types) -> SqlType:
    """The type CASE and COALESCE compute in: the widest numeric (a DECIMAL
    as DOUBLE) or the one shared base; raises for mixed bases."""
    types = [t for t in types if t is not None]
    if not types:
        return T.STRING
    out = types[0]
    for t in types[1:]:
        if t.base == out.base:
            continue
        if out.base in _NUM_ORDER and t.base in _NUM_ORDER:
            nb = _NUM_ORDER[max(_NUM_ORDER.index(out.base), _NUM_ORDER.index(t.base))]
            out = T.DOUBLE if nb == SqlBaseType.DECIMAL else SqlType.of(nb)
        else:
            raise DeviceUnsupported(f"mixed CASE types {out}/{t}")
    return out


# ----------------------------------------------------- device function lib
def numpy_unary(op: str, x: torch.Tensor) -> torch.Tensor:
    """``op`` (exp, log, sqrt) over float64 ``x``: numpy's result on the
    CPU (torch's vectorized CPU float64 kernels are off by one unit in the
    last place for some inputs; numpy's sqrt is correctly rounded, as
    XLA's and CUDA's are), torch's own on the card."""
    if x.is_cuda:
        return getattr(torch, op)(x)
    with np.errstate(all="ignore"):
        return torch.from_numpy(getattr(np, op)(x.contiguous().numpy()))


def _f_abs(c, args):
    (v,) = args
    return DCol(torch.abs(v.data), v.valid, v.sql_type)


def pow10(s: torch.Tensor) -> torch.Tensor:
    """``10 ** s`` over float64 ``s``: numpy's (libm's, as XLA's CPU pow)
    on the CPU, torch's own on the card."""
    if s.is_cuda:
        return torch.pow(10.0, s)
    return torch.from_numpy(np.power(10.0, s.contiguous().numpy()))


def _f_round(c, args):
    # floor(x + 0.5): Java Math.round, -1.5 rounds UP to -1
    v = args[0]
    if len(args) == 1:
        if not v.data.is_floating_point():
            # ROUND of an integral is identity (no f64 round trip, which
            # would lose precision above 2^53)
            return DCol(v.data.to(torch.int64), v.valid, T.BIGINT)
        out = torch.floor(v.data.to(torch.float64) + 0.5)
        return DCol(saturating_int(out, torch.int64), v.valid, T.BIGINT)
    return c._round_to(v, args[1], None)


def _f_floor(c, args):
    (v,) = args
    return DCol(torch.floor(v.data.to(torch.float64)), v.valid, T.DOUBLE)


def _f_ceil(c, args):
    (v,) = args
    return DCol(torch.ceil(v.data.to(torch.float64)), v.valid, T.DOUBLE)


def _unary_f64(op: str):
    def f(c, args):
        (v,) = args
        return DCol(numpy_unary(op, v.data.to(torch.float64)), v.valid, T.DOUBLE)

    return f


def _f_sign(c, args):
    (v,) = args
    s = torch.sign(v.data)
    if s.is_floating_point():
        return DCol(saturating_int(s, torch.int32), v.valid, T.INTEGER)
    return DCol(s.to(torch.int32), v.valid, T.INTEGER)


def _extremum(combine: str):
    def f(c, args):
        from ksql_tpu_torch.ops.hash_store import xla_minmax

        out = args[0]
        for v in args[1:]:
            da, db, t = _promote(out, v)
            r = xla_minmax(da, db, combine)
            if r.is_floating_point():
                # the NaN operand itself, as XLA returns it (torch's CPU
                # kernel returns the platform's default NaN)
                r = torch.where(torch.isnan(da), da, torch.where(torch.isnan(db), db, r))
            out = DCol(r, out.valid & v.valid, t)
        return out

    return f


def _f_coalesce(c, args):
    t = common_type([a.sql_type for a in args])
    dt = torch_dtype(t)
    out = torch.zeros(c.n, dtype=dt, device=c.device)
    valid = torch.zeros(c.n, dtype=torch.bool, device=c.device)
    for v in args:
        take = ~valid & v.valid
        out = torch.where(take, v.data.to(dt), out)
        valid = valid | v.valid
    return DCol(out, valid, t)


#: the functions the card evaluates, by name (the reference's
#: ``_DEVICE_FUNCTIONS``, ``compiler/jax_expr.py:555``)
DEVICE_FUNCTIONS: Dict[str, Callable] = {
    "AS_VALUE": lambda c, args: args[0],  # key->value copy marker: identity
    "ABS": _f_abs,
    "ROUND": _f_round,
    "FLOOR": _f_floor,
    "CEIL": _f_ceil,
    "EXP": _unary_f64("exp"),
    "LN": _unary_f64("log"),
    "SQRT": _unary_f64("sqrt"),
    "SIGN": _f_sign,
    "GREATEST": _extremum("max"),
    "LEAST": _extremum("min"),
    "COALESCE": _f_coalesce,
    "IFNULL": _f_coalesce,
}
