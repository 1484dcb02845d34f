"""Host↔device columnar staging: encode HostBatch → fixed-shape arrays.

Copy of ``ksql_tpu/runtime/device.py`` (numpy only); the port uploads the
encoded arrays with ``torch.from_numpy(...).to(device)``.

The ingress analog of the reference's per-record deserialization
(GenericRowSerDe): rows are staged host-side into a :class:`HostBatch`, then
encoded to a dict of fixed-capacity numpy arrays:

* numeric/temporal columns → their device dtype, nulls masked;
* STRING/BYTES columns → the stable 64-bit hash of each value (device sees
  only hashes — variable-length data never reaches HBM).  The
  :class:`DictionaryServer` keeps the hash→value mapping host-side so sink
  emission can restore the original values (the egress analog of reading the
  key back out of RocksDB).

Array naming convention (the flat dict of arrays the query step reads):
``v_<COL>`` data, ``m_<COL>`` validity, plus ``ts`` (event-time ms),
``row_valid`` (fill mask), ``offset`` (per-row offset pseudocolumn) and
``partition``.
"""

from __future__ import annotations

import dataclasses
import decimal as _decimal
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ksql_tpu_torch.common.batch import HostBatch, encode_column, stable_hash64
from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.common.types import SqlBaseType, SqlType

_HASHED = (SqlBaseType.STRING, SqlBaseType.BYTES)
_NESTED = (SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT)
#: types the device carries as int64 dictionary codes: strings/bytes plus
#: nested values used opaquely (passthrough, equality, grouping)
DICT_ENCODED = _HASHED + _NESTED


class DictionaryServer:
    """Accumulates hash64 → original value for hash-encoded columns.

    State-store keys on device are hashes; this is the host-side reverse map
    used when decoding emitted batches.  Bounded only by distinct-key
    cardinality (same asymptotics as the reference's RocksDB key set, but
    host-RAM resident; spill-to-disk is a future tier)."""

    def __init__(self) -> None:
        self._map: Dict[int, Any] = {}

    def learn(self, hashes: np.ndarray, values: np.ndarray) -> None:
        m = self._map
        for h, v in zip(hashes.tolist(), values.tolist()):
            if h not in m:
                m[h] = v

    def learn_value(self, value: Any) -> int:
        h = stable_hash64(value)
        self._map.setdefault(h, value)
        return h

    def lookup(self, h: int) -> Any:
        return self._map.get(h)

    def __len__(self) -> int:
        return len(self._map)


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    sql_type: SqlType
    #: a struct-path column: (root column, field path) extracted at encode,
    #: so a query that only reads scalar leaves of a STRUCT never carries
    #: the struct to the card
    path: Optional[Tuple[str, Tuple[str, ...]]] = None

    @property
    def hashed(self) -> bool:
        return self.sql_type.base in DICT_ENCODED


class BatchLayout:
    """Fixed encoding layout for the columns a compiled query actually
    reads (unused columns — including nested types — are never encoded)."""

    def __init__(
        self,
        schema: LogicalSchema,
        columns: Sequence[str],
        capacity: int,
        dictionary: Optional[DictionaryServer] = None,
        struct_paths: Sequence[Tuple[str, str, Tuple[str, ...], SqlType]] = (),
    ):
        self.schema = schema
        self.capacity = capacity
        self.dictionary = dictionary if dictionary is not None else DictionaryServer()
        self.specs: List[ColumnSpec] = []
        for name in columns:
            col = schema.find_column(name)
            if col is None:
                raise KeyError(f"column {name} not in schema")
            if (
                col.type.base == SqlBaseType.DECIMAL
                and (col.type.precision or 0) > 15
            ):
                from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported

                # f64 carries <= 15 significant digits exactly
                raise DeviceUnsupported(
                    f"DECIMAL({col.type.precision}) column {name} on device"
                )
            self.specs.append(ColumnSpec(col.name, col.type))
        for synth, root, path, leaf_t in struct_paths:
            self.specs.append(ColumnSpec(synth, leaf_t, path=(root, tuple(path))))

    # ---------------------------------------------------------------- encode
    def encode(self, batch: HostBatch) -> Dict[str, np.ndarray]:
        n, cap = batch.num_rows, self.capacity
        if n > cap:
            raise ValueError(f"batch of {n} rows exceeds capacity {cap}")
        out: Dict[str, np.ndarray] = {}
        for spec in self.specs:
            if spec.path is not None:
                values, valid = _extract_path(batch, *spec.path)
            else:
                values, valid = batch.column_or_pseudo(spec.name)
            enc = encode_column(values, valid, spec.sql_type)
            if spec.hashed:
                self.dictionary.learn(enc.hashes64, enc.dictionary)
                data = enc.hashes64[enc.data]
            else:
                data = enc.data
            out[spec.name] = (data, np.asarray(valid, bool))
        return self.assemble(
            n, out, batch.timestamps,
            offsets=batch.offsets, partitions=batch.partitions,
        )

    def assemble(
        self,
        n: int,
        columns: Dict[str, Tuple[np.ndarray, np.ndarray]],
        timestamps,
        offsets=None,
        partitions=None,
    ) -> Dict[str, np.ndarray]:
        """Pad per-spec (data, valid) columns into the fixed-capacity array
        dict with the layout's dtypes."""
        cap = self.capacity
        out: Dict[str, np.ndarray] = {}
        for spec in self.specs:
            data, valid = columns[spec.name]
            dt = np.int64 if spec.hashed else spec.sql_type.device_dtype()
            dv = np.zeros(cap, dt)
            dv[:n] = data
            mv = np.zeros(cap, bool)
            mv[:n] = valid
            out[f"v_{spec.name}"] = dv
            out[f"m_{spec.name}"] = mv
        ts = np.zeros(cap, np.int64)
        ts[:n] = timestamps
        rv = np.zeros(cap, bool)
        rv[:n] = True
        off = np.zeros(cap, np.int64)
        if offsets is not None:
            off[:n] = offsets
        part = np.zeros(cap, np.int32)
        if partitions is not None:
            part[:n] = partitions
        out["ts"] = ts
        out["row_valid"] = rv
        out["offset"] = off
        out["partition"] = part
        return out



def _extract_path(batch: HostBatch, root: str, fields: Tuple[str, ...]):
    """The leaf at ``fields`` of each row's struct ``root`` (NULL where the
    struct or a field on the way is NULL or not a struct); field names
    match case-insensitively, an exact hit first."""
    n = batch.num_rows
    base_vals, base_valid = batch.column_or_pseudo(root)
    values = np.empty(n, object)
    valid = np.zeros(n, bool)
    fus = [f.upper() for f in fields]
    for i in range(n):
        cur = base_vals[i] if base_valid[i] else None
        for f, fu in zip(fields, fus):
            if not isinstance(cur, dict):
                cur = None
                break
            cur = cur.get(f) if f in cur else next(
                (v for k, v in cur.items() if k.upper() == fu), None)
        values[i] = cur
        valid[i] = cur is not None
    return values, valid


def decode_value(
    data: np.ndarray,
    valid: np.ndarray,
    sql_type: SqlType,
    dictionary: DictionaryServer,
) -> List[Any]:
    """Decode one emitted device column back to Python values."""
    base = sql_type.base
    dec_quantum = None  # loop-invariant quantize target (decimal columns)
    out: List[Any] = []
    for x, ok in zip(data.tolist(), valid.tolist()):
        if not ok:
            out.append(None)
        elif base in DICT_ENCODED:
            out.append(dictionary.lookup(int(x)))
        elif base == SqlBaseType.BOOLEAN:
            out.append(bool(x))
        elif base == SqlBaseType.DECIMAL:
            # f64 carries <=15 significant digits exactly (layout gate);
            # quantizing the shortest-repr float recovers the exact decimal
            if dec_quantum is None:
                dec_quantum = _decimal.Decimal(1).scaleb(-(sql_type.scale or 0))
            out.append(
                _decimal.Decimal(repr(float(x))).quantize(
                    dec_quantum, rounding=_decimal.ROUND_HALF_UP
                )
            )
        elif base == SqlBaseType.DOUBLE:
            out.append(float(x))
        else:
            out.append(int(x))
    return out
