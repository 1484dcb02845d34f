"""SQL type system — copy of ``ksql_tpu/common/types.py``.

Analog of the reference's SQL type lattice (ksqldb-common/.../schema/ksql/
types/).  Every scalar type carries a *device dtype* (what lives in device
memory); STRING columns are dictionary/hash encoded before they reach the
device, and DECIMAL is f64 on the device (documented deviation).
"""

from __future__ import annotations

import dataclasses
import decimal as _decimal
import enum
from typing import Any, Dict, List, Optional, Tuple

# SQL DECIMAL supports precision up to 38; intermediate exact arithmetic
# (SUM over many rows, ROUND at high scale) needs more working digits than
# Python's default context (28).  DefaultContext so new threads inherit it.
_decimal.DefaultContext.prec = 77
_decimal.setcontext(_decimal.DefaultContext)

import numpy as np


class SqlBaseType(enum.Enum):
    """Base kinds, mirroring the reference's SqlBaseType enum
    (ksqldb-common/.../schema/ksql/SqlBaseType.java)."""

    BOOLEAN = "BOOLEAN"
    INTEGER = "INTEGER"
    BIGINT = "BIGINT"
    DOUBLE = "DOUBLE"
    DECIMAL = "DECIMAL"
    STRING = "STRING"
    BYTES = "BYTES"
    TIME = "TIME"
    DATE = "DATE"
    TIMESTAMP = "TIMESTAMP"
    ARRAY = "ARRAY"
    MAP = "MAP"
    STRUCT = "STRUCT"

    def is_numeric(self) -> bool:
        return self in (
            SqlBaseType.INTEGER,
            SqlBaseType.BIGINT,
            SqlBaseType.DOUBLE,
            SqlBaseType.DECIMAL,
        )



@dataclasses.dataclass(frozen=True)
class SqlType:
    """A resolved SQL type.  Immutable and JSON-serializable."""

    base: SqlBaseType
    # DECIMAL parameters
    precision: Optional[int] = None
    scale: Optional[int] = None
    # ARRAY element / MAP value type
    element: Optional["SqlType"] = None
    # MAP key type (reference restricts to STRING keys historically; we allow
    # STRING only for now as well)
    key: Optional["SqlType"] = None
    # STRUCT fields
    fields: Optional[Tuple[Tuple[str, "SqlType"], ...]] = None

    # ---------------------------------------------------------------- dunder
    def __str__(self) -> str:
        b = self.base
        if b == SqlBaseType.DECIMAL:
            return f"DECIMAL({self.precision}, {self.scale})"
        if b == SqlBaseType.ARRAY:
            return f"ARRAY<{self.element}>"
        if b == SqlBaseType.MAP:
            return f"MAP<{self.key}, {self.element}>"
        if b == SqlBaseType.STRUCT:
            inner = ", ".join(f"`{n}` {t}" for n, t in (self.fields or ()))
            return f"STRUCT<{inner}>"
        return b.value

    # ------------------------------------------------------------- factories
    @staticmethod
    def of(base: SqlBaseType) -> "SqlType":
        return _PRIMITIVES[base]

    @staticmethod
    def decimal(precision: int, scale: int) -> "SqlType":
        if precision < 1 or scale < 0 or scale > precision:
            raise ValueError(f"invalid DECIMAL({precision}, {scale})")
        return SqlType(SqlBaseType.DECIMAL, precision=precision, scale=scale)

    @staticmethod
    def array(element: "SqlType") -> "SqlType":
        return SqlType(SqlBaseType.ARRAY, element=element)

    @staticmethod
    def map(key: "SqlType", value: "SqlType") -> "SqlType":
        # non-STRING keys are representable (SqlMap allows them); the serde
        # formats that can't carry them reject at schema validation
        # (check_schema_support / _check_map_keys)
        return SqlType(SqlBaseType.MAP, key=key, element=value)

    @staticmethod
    def struct(fields: List[Tuple[str, "SqlType"]]) -> "SqlType":
        return SqlType(SqlBaseType.STRUCT, fields=tuple(fields))

    # ------------------------------------------------------------ properties
    def is_numeric(self) -> bool:
        return self.base.is_numeric()

    def device_dtype(self) -> np.dtype:
        """The dtype this column uses in HBM."""
        return _DEVICE_DTYPES[self.base]


    # ----------------------------------------------------------------- json
    def to_json(self) -> Any:
        if self.base == SqlBaseType.DECIMAL:
            return {"type": "DECIMAL", "precision": self.precision, "scale": self.scale}
        if self.base == SqlBaseType.ARRAY:
            return {"type": "ARRAY", "element": self.element.to_json()}
        if self.base == SqlBaseType.MAP:
            return {
                "type": "MAP",
                "key": self.key.to_json(),
                "value": self.element.to_json(),
            }
        if self.base == SqlBaseType.STRUCT:
            return {
                "type": "STRUCT",
                "fields": [[n, t.to_json()] for n, t in (self.fields or ())],
            }
        return self.base.value

    @staticmethod
    def from_json(obj: Any) -> "SqlType":
        if isinstance(obj, str):
            return SqlType.of(SqlBaseType(obj))
        t = obj["type"]
        if t == "DECIMAL":
            return SqlType.decimal(obj["precision"], obj["scale"])
        if t == "ARRAY":
            return SqlType.array(SqlType.from_json(obj["element"]))
        if t == "MAP":
            return SqlType.map(SqlType.from_json(obj["key"]), SqlType.from_json(obj["value"]))
        if t == "STRUCT":
            return SqlType.struct([(n, SqlType.from_json(tj)) for n, tj in obj["fields"]])
        raise ValueError(f"unknown type json: {obj!r}")


_PRIMITIVES: Dict[SqlBaseType, SqlType] = {}
for _b in SqlBaseType:
    if _b not in (SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT, SqlBaseType.DECIMAL):
        _PRIMITIVES[_b] = SqlType(_b)

BOOLEAN = _PRIMITIVES[SqlBaseType.BOOLEAN]
INTEGER = _PRIMITIVES[SqlBaseType.INTEGER]
BIGINT = _PRIMITIVES[SqlBaseType.BIGINT]
DOUBLE = _PRIMITIVES[SqlBaseType.DOUBLE]
STRING = _PRIMITIVES[SqlBaseType.STRING]
BYTES = _PRIMITIVES[SqlBaseType.BYTES]
TIME = _PRIMITIVES[SqlBaseType.TIME]
DATE = _PRIMITIVES[SqlBaseType.DATE]
TIMESTAMP = _PRIMITIVES[SqlBaseType.TIMESTAMP]


# The canonical device representation per base type.  STRING/BYTES device
# representation is the stable 64-bit hash (used for GROUP BY / joins /
# equality); batch.encode_column additionally carries int32 per-batch
# dictionary indices + the int64 hash-per-entry gather table to rebuild the
# hash or the host value for any row.  Temporal types are epoch millis/days.
_DEVICE_DTYPES: Dict[SqlBaseType, np.dtype] = {
    SqlBaseType.BOOLEAN: np.dtype(np.bool_),
    SqlBaseType.INTEGER: np.dtype(np.int32),
    SqlBaseType.BIGINT: np.dtype(np.int64),
    SqlBaseType.DOUBLE: np.dtype(np.float64),
    SqlBaseType.DECIMAL: np.dtype(np.float64),
    SqlBaseType.STRING: np.dtype(np.int64),
    SqlBaseType.BYTES: np.dtype(np.int64),
    SqlBaseType.TIME: np.dtype(np.int32),
    SqlBaseType.DATE: np.dtype(np.int32),
    SqlBaseType.TIMESTAMP: np.dtype(np.int64),
    SqlBaseType.ARRAY: np.dtype(object),
    SqlBaseType.MAP: np.dtype(object),
    SqlBaseType.STRUCT: np.dtype(object),
}
