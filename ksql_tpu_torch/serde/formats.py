"""Key/value serde formats — the KAFKA key and JSON value formats.

Trimmed copy of ``ksql_tpu/serde/formats.py``: the formats the port's plans
name (``FormatInfo`` KAFKA/JSON keys, JSON values).  Any other format raises
:class:`SerdeException` when a source or sink is built; temporal values
arrive as epoch integers (text timestamps need the row interpreter, which
the port does not have yet).
"""

from __future__ import annotations

import base64
import decimal as _decimal
import json
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

from ksql_tpu_torch.common.errors import SerdeException
from ksql_tpu_torch.common.schema import Column
from ksql_tpu_torch.common.types import SqlBaseType, SqlType

#: key formats the port (de)serializes; the in-process log carries native
#: Python values for both
KEY_FORMATS = ("KAFKA", "JSON")


class Format:
    name = "NONE"

    def serialize(self, row: Optional[Dict[str, Any]], columns: List[Column]) -> Any:
        raise NotImplementedError

    def deserialize(self, payload: Any, columns: List[Column]) -> Optional[Dict[str, Any]]:
        raise NotImplementedError


def _coerce(value: Any, t: SqlType) -> Any:
    """Coerce a JSON-decoded value into the SQL type's host representation."""
    if value is None:
        return None
    b = t.base
    if b == SqlBaseType.BOOLEAN:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() == "true"
        return bool(value)
    if b in (SqlBaseType.INTEGER, SqlBaseType.BIGINT):
        if isinstance(value, bool):
            raise SerdeException(f"cannot coerce boolean to {t}")
        if isinstance(value, float):
            # Connect's Number.intValue()/longValue(): truncate toward zero
            return int(value)
        return int(value)
    if b in (SqlBaseType.DOUBLE,):
        if isinstance(value, bool):
            raise SerdeException(f"cannot coerce boolean to {t}")
        return float(value)
    if b == SqlBaseType.DECIMAL:
        if isinstance(value, bool):
            raise SerdeException(f"cannot coerce boolean to {t}")
        try:
            d = (
                value
                if isinstance(value, _decimal.Decimal)
                else _decimal.Decimal(
                    repr(value) if isinstance(value, float) else str(value)
                )
            )
        except _decimal.InvalidOperation:
            raise SerdeException(f"cannot coerce {value!r} to {t}") from None
        quantum = _decimal.Decimal(1).scaleb(-(t.scale or 0))
        return d.quantize(quantum, rounding=_decimal.ROUND_HALF_UP)
    if b == SqlBaseType.STRING:
        if isinstance(value, bool):
            return "true" if value else "false"
        if isinstance(value, (dict, list)):
            return json.dumps(value, separators=(",", ":"))
        return str(value)
    if b == SqlBaseType.BYTES:
        if isinstance(value, bytes):
            return value
        return base64.b64decode(value)
    if b == SqlBaseType.TIMESTAMP:
        if isinstance(value, str):
            if re.fullmatch(r"-?\d+", value.strip()):
                return int(value)  # epoch-ms rendered as text (Avro/Connect)
            raise SerdeException(f"cannot coerce {value!r} to {t}")
        return int(value)
    if b == SqlBaseType.DATE:
        if isinstance(value, str):
            if re.fullmatch(r"-?\d+", value.strip()):
                return int(value)  # epoch-days rendered as text
            raise SerdeException(f"cannot coerce {value!r} to {t}")
        return int(value)
    if b == SqlBaseType.TIME:
        if isinstance(value, str):
            if re.fullmatch(r"-?\d+", value.strip()):
                return int(value)  # ms-of-day rendered as text
            raise SerdeException(f"cannot coerce {value!r} to {t}")
        return int(value)
    if b == SqlBaseType.ARRAY:
        if not isinstance(value, list):
            raise SerdeException(f"cannot coerce {type(value).__name__} to {t}")
        return [_coerce(v, t.element) for v in value]
    if b == SqlBaseType.MAP:
        if not isinstance(value, dict):
            raise SerdeException(f"cannot coerce {type(value).__name__} to {t}")
        return {k: _coerce(v, t.element) for k, v in value.items()}
    if b == SqlBaseType.STRUCT:
        if not isinstance(value, dict):
            raise SerdeException(f"cannot coerce {type(value).__name__} to {t}")
        fields = dict(t.fields or ())
        lower = {k.upper(): v for k, v in value.items()}
        return {name: _coerce(lower.get(name.upper()), ft) for name, ft in fields.items()}
    raise SerdeException(f"unsupported type {t}")


def decimal_str(v: Any, t: SqlType) -> str:
    """Plain fixed-point rendering at the column's scale (the reference
    serializes BigDecimal.toPlainString — no zero-padding of the integer
    part, e.g. DECIMAL(5,3) 1 -> "1.000")."""
    scale = t.scale or 0
    return f"{v:.{scale}f}" if scale else str(int(v))


def _jsonable(value: Any, t: Optional[SqlType] = None, decimal_as_string: bool = False) -> Any:
    if value is None:
        return None
    if isinstance(value, bytes):
        return base64.b64encode(value).decode("ascii")
    if (
        t is not None
        and t.base == SqlBaseType.DECIMAL
        and isinstance(value, _decimal.Decimal)
        and value.adjusted() + 1 > (t.precision or 38) - (t.scale or 0)
        and value != 0
    ):
        # aggregate values past the declared precision fail the query, as
        # BigDecimal.setScale/DecimalUtil.ensureFit does (sum overflow)
        raise SerdeException(
            f"Numeric field overflow: value {value} does not fit {t}"
        )
    if (
        decimal_as_string
        and t is not None
        and t.base == SqlBaseType.DECIMAL
        and isinstance(value, (int, float, _decimal.Decimal))
        and not isinstance(value, bool)
    ):
        return decimal_str(value, t)
    if isinstance(value, _decimal.Decimal):
        # plain-JSON decimals emit as numbers (double range)
        return int(value) if value == value.to_integral_value() and (t is None or (t.scale or 0) == 0) else float(value)
    if isinstance(value, float):
        # Jackson writes non-finite doubles as NaN/Infinity tokens; QTT
        # expected files carry them as strings
        if value != value:
            return "NaN"
        if value == float("inf"):
            return "Infinity"
        if value == float("-inf"):
            return "-Infinity"
        return value
    if isinstance(value, dict):
        if t is not None and t.base == SqlBaseType.STRUCT:
            fts = dict(t.fields or ())
            return {k: _jsonable(v, fts.get(k), decimal_as_string)
                    for k, v in value.items()}
        et = t.element if t is not None and t.base == SqlBaseType.MAP else None
        return {k: _jsonable(v, et, decimal_as_string) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        et = t.element if t is not None and t.base == SqlBaseType.ARRAY else None
        return [_jsonable(v, et, decimal_as_string) for v in value]
    return value


class JsonFormat(Format):
    name = "JSON"
    decimal_as_string = False  # AVRO renders decimals as padded strings

    def __init__(self, wrap: bool = True):
        # wrap=False = SerdeFeature.UNWRAP_SINGLES: a single column is
        # (de)serialized as the bare value, no envelope (SerdeUtils.java:63)
        self.wrap = wrap

    def serialize(self, row, columns):
        if row is None:
            return None
        das = self.decimal_as_string
        if not self.wrap and len(columns) == 1:
            return json.dumps(
                _jsonable(row.get(columns[0].name), columns[0].type, das),
                separators=(",", ":"),
            )
        return json.dumps(
            {c.name: _jsonable(row.get(c.name), c.type, das) for c in columns},
            separators=(",", ":"),
        )

    def deserialize(self, payload, columns):
        if payload is None:
            return None
        if isinstance(payload, (str, bytes, bytearray)):
            try:
                obj = json.loads(payload)
            except ValueError:
                if (
                    not self.wrap
                    and len(columns) == 1
                    and columns[0].type.base == SqlBaseType.STRING
                ):
                    # unwrapped single string values arrive as raw text
                    obj = payload if isinstance(payload, str) else payload.decode()
                else:
                    raise
        else:
            obj = payload
        if not self.wrap and len(columns) == 1:
            return {columns[0].name: _coerce(obj, columns[0].type)}
        if not isinstance(obj, dict):
            # single-column anonymous value
            if len(columns) == 1:
                return {columns[0].name: _coerce(obj, columns[0].type)}
            raise SerdeException(f"expected JSON object, got {type(obj).__name__}")
        upper = {k.upper(): v for k, v in obj.items()}
        return {c.name: _coerce(upper.get(c.name.upper()), c.type) for c in columns}


class KafkaFormat(Format):
    """Primitive binary format (KAFKA serde: int/bigint/double/string)."""

    name = "KAFKA"

    def serialize(self, row, columns):
        if row is None:
            return None
        if len(columns) != 1:
            # multi-column KAFKA keys serialize as a tuple of python values
            return tuple(row.get(c.name) for c in columns)
        v = row.get(columns[0].name)
        if v is None:
            return None
        b = columns[0].type.base
        # the in-process log carries native python values; the KAFKA format's
        # fixed-width binary encoding is applied only at a real wire boundary
        if b == SqlBaseType.INTEGER:
            return int(v)
        if b in (SqlBaseType.BIGINT, SqlBaseType.TIMESTAMP):
            return int(v)
        if b == SqlBaseType.DOUBLE:
            return float(v)
        if b in (SqlBaseType.STRING, SqlBaseType.BYTES):
            return v
        raise SerdeException(f"KAFKA format does not support {columns[0].type}")

    def deserialize(self, payload, columns):
        if payload is None:
            return None
        if isinstance(payload, tuple):
            return {c.name: v for c, v in zip(columns, payload)}
        if len(columns) != 1:
            raise SerdeException("KAFKA format supports single-column payloads")
        c = columns[0]
        b = c.type.base
        if isinstance(payload, (int, float, str, bool, list, dict)):
            # already-decoded (in-process producer path)
            return {c.name: _coerce(payload, c.type)}
        if b == SqlBaseType.INTEGER:
            return {c.name: struct.unpack(">i", payload)[0]}
        if b in (SqlBaseType.BIGINT, SqlBaseType.TIMESTAMP):
            return {c.name: struct.unpack(">q", payload)[0]}
        if b == SqlBaseType.DOUBLE:
            return {c.name: struct.unpack(">d", payload)[0]}
        if b == SqlBaseType.STRING:
            return {c.name: payload.decode("utf-8")}
        if b == SqlBaseType.BYTES:
            return {c.name: payload}
        raise SerdeException(f"KAFKA format does not support {c.type}")


_FORMATS = {"JSON": JsonFormat, "KAFKA": KafkaFormat}


def of(name: str, wrap_single_values: Optional[bool] = None) -> Format:
    """FormatFactory.of analog for the port's formats."""
    cls = _FORMATS.get(name.upper())
    if cls is None:
        raise SerdeException(f"format {name} is not supported by the port")
    if cls is JsonFormat and wrap_single_values is not None:
        return JsonFormat(wrap=wrap_single_values)
    return cls()


def check_key_format(key_format: str) -> None:
    if key_format.upper() not in KEY_FORMATS:
        raise SerdeException(f"key format {key_format} is not supported by the port")


def serialize_key(key_format: str, key: Tuple[Any, ...], key_columns,
                  wrapped: bool = False) -> Any:
    """Serialize a key tuple to its on-topic representation.

    Single key columns are unwrapped (SerdeFeaturesFactory.buildKeyFeatures);
    multiple key columns produce a column-name-keyed object."""
    cols = list(key_columns)
    if not cols:
        return None
    if not key:
        # source record key payload was null and passed through untouched
        # (Kafka Streams forwards the original null key bytes)
        return None
    check_key_format(key_format)
    if len(cols) == 1 and not wrapped:
        return key[0]
    return {c.name: v for c, v in zip(cols, key)}


def deserialize_key(key_format: str, payload: Any, key_columns) -> Dict[str, Any]:
    """Inverse of serialize_key: on-topic key -> column dict."""
    cols = list(key_columns)
    if not cols or payload is None:
        return {}
    check_key_format(key_format)
    if isinstance(payload, tuple):
        return {c.name: v for c, v in zip(cols, payload)}
    if isinstance(payload, dict):
        upper = {k.upper(): v for k, v in payload.items()}
        if (
            len(cols) == 1
            and cols[0].type.base == SqlBaseType.STRUCT
            and cols[0].name.upper() not in upper
        ):
            # unwrapped single struct key: the payload IS the struct value
            return {cols[0].name: _coerce(payload, cols[0].type)}
        return {c.name: _coerce(upper.get(c.name.upper()), c.type) for c in cols}
    if len(cols) == 1:
        return {cols[0].name: _coerce(payload, cols[0].type)}
    raise SerdeException(f"cannot deserialize key {payload!r} into {len(cols)} columns")
