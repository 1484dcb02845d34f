"""Columnar expression compiler: SQL expression tree → torch tensor ops.

The port of ``ksql_tpu/compiler/jax_expr.py``.  Every sub-expression
evaluates to a :class:`DCol` — ``(data, valid)`` tensors over the batch, SQL
three-valued logic riding the ``valid`` mask.  STRING/BYTES columns are
hash-encoded (``runtime/device.py``): ``data`` holds the stable 64-bit hash,
so equality and GROUP BY work on the card.

This slice covers column references, literals, comparison, arithmetic,
AND/OR/NOT, IS [NOT] NULL, BETWEEN and IN (rewritten into comparisons
and ORs, as the reference does).  Every other node raises
:class:`DeviceUnsupported`.  The tensors live on the compiler's ``device``;
the arithmetic is elementwise torch and runs eagerly on the card, as XLA
fused it on the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
        a, b = self.compile(e.left), self.compile(e.right)
        da, db, t = _promote(a, b)
        valid = a.valid & b.valid
        op = e.op
        if op == ex.ArithOp.ADD:
            out = da + db
        elif op == ex.ArithOp.SUBTRACT:
            out = da - db
        elif op == ex.ArithOp.MULTIPLY:
            out = da * db
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
                    out = (
                        torch.div(da, safe, rounding_mode="trunc")
                        if integral else da / safe
                    )
                else:
                    out = torch.fmod(da, safe)
                valid = valid & ~zero
            elif op == ex.ArithOp.DIVIDE:
                out = da / db  # IEEE: inf/nan, stays valid (Java double)
            else:
                out = torch.where(
                    db != 0,
                    torch.fmod(da, torch.where(db == 0, torch.ones_like(db), db)),
                    torch.full_like(da, float("nan")),
                )
        else:  # pragma: no cover
            raise DeviceUnsupported(f"arith op {op}")
        return DCol(out, valid, t)

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
