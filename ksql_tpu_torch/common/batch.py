"""Columnar micro-batches — the GenericRow/GenericKey analog.

The reference processes one record at a time (GenericRow,
ksqldb-common/.../GenericRow.java:28).  On TPU the unit of work is a columnar
micro-batch: fixed-capacity arrays per column plus validity masks, padded to a
static shape so every distinct capacity compiles exactly once under jit.

Two representations:

* ``HostBatch`` — numpy object columns; full SQL fidelity (nested types,
  strings, decimals).  Used by the parity oracle, serdes, and as the staging
  buffer before device encode.
* encoded device columns — produced by :func:`encode_column`: fixed-width
  dtypes only.  STRING/BYTES become 32-bit indices into a per-batch
  dictionary plus a stable 64-bit hash per dictionary entry, so GROUP BY and
  equality ride the MXU-friendly integer path and variable-length data never
  reaches HBM.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.common.types import SqlBaseType, SqlType

# ----------------------------------------------------------------- hashing

_HASH_CACHE: Dict[Any, int] = {}
_HASH_CACHE_MAX = 1 << 20


def stable_hash64(value: Any) -> int:
    """Stable (process-independent) 64-bit hash used for key hashing and
    string dictionary encoding.  Stability matters: hashes are part of the
    durable state-store layout, so they must survive restarts (unlike
    Python's salted ``hash``)."""
    cached = _HASH_CACHE.get(value) if isinstance(value, (str, bytes)) else None
    if cached is not None:
        return cached
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, str):
        raw = b"\x00" + value.encode("utf-8")
    elif isinstance(value, bytes):
        raw = b"\x01" + value
    elif isinstance(value, bool):
        raw = b"\x02" + (b"\x01" if value else b"\x00")
    elif isinstance(value, int):
        raw = b"\x03" + value.to_bytes(16, "little", signed=True)
    elif isinstance(value, float):
        raw = b"\x04" + struct.pack("<d", value)
    elif value is None:
        raw = b"\x05"
    elif isinstance(value, (list, tuple)):
        raw = b"\x06" + b"".join(
            stable_hash64(v).to_bytes(8, "little", signed=True) for v in value
        )
    elif isinstance(value, dict):
        # canonical order by key HASH: map keys may be mixed-type or None
        # (JSON null keys), which direct sorting cannot order
        raw = b"\x07" + b"".join(
            stable_hash64(k).to_bytes(8, "little", signed=True)
            + stable_hash64(v).to_bytes(8, "little", signed=True)
            for k, v in sorted(
                value.items(), key=lambda kv: stable_hash64(kv[0])
            )
        )
    else:
        raw = repr(value).encode("utf-8")
    h = int.from_bytes(hashlib.blake2b(raw, digest_size=8).digest(), "little", signed=True)
    if isinstance(value, (str, bytes)):
        if len(_HASH_CACHE) > _HASH_CACHE_MAX:
            _HASH_CACHE.clear()
        _HASH_CACHE[value] = h
    return h


# -------------------------------------------------------------- host batch


@dataclasses.dataclass
class HostBatch:
    """Column-major batch of rows with per-column validity.

    ``columns[name]`` is a 1-D numpy array (object dtype for full fidelity),
    ``valid[name]`` a bool array.  ``timestamps`` is the per-row event-time in
    epoch ms (ROWTIME); ``partitions``/``offsets`` the provenance
    pseudocolumns.
    """

    schema: LogicalSchema
    num_rows: int
    columns: Dict[str, np.ndarray]
    valid: Dict[str, np.ndarray]
    timestamps: np.ndarray  # int64[num_rows]
    partitions: Optional[np.ndarray] = None  # int32[num_rows]
    offsets: Optional[np.ndarray] = None  # int64[num_rows]

    # ------------------------------------------------------------- factories
    @staticmethod
    def from_rows(
        schema: LogicalSchema,
        rows: Sequence[Dict[str, Any]],
        timestamps: Optional[Sequence[int]] = None,
        partitions: Optional[Sequence[int]] = None,
        offsets: Optional[Sequence[int]] = None,
    ) -> "HostBatch":
        n = len(rows)
        cols: Dict[str, np.ndarray] = {}
        valid: Dict[str, np.ndarray] = {}
        for col in schema.columns():
            arr = np.empty(n, dtype=object)
            v = np.zeros(n, dtype=bool)
            for i, r in enumerate(rows):
                val = r.get(col.name)
                if val is not None:
                    arr[i] = val
                    v[i] = True
            cols[col.name] = arr
            valid[col.name] = v
        ts = np.asarray(
            timestamps if timestamps is not None else np.zeros(n), dtype=np.int64
        )
        parts = np.asarray(partitions, dtype=np.int32) if partitions is not None else np.zeros(n, np.int32)
        offs = np.asarray(offsets, dtype=np.int64) if offsets is not None else np.arange(n, dtype=np.int64)
        return HostBatch(schema, n, cols, valid, ts, parts, offs)


    def column_or_pseudo(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """Return (values, valid) for a column, resolving pseudocolumns."""
        if name in self.columns:
            return self.columns[name], self.valid[name]
        n = self.num_rows
        if name == "ROWTIME":
            return self.timestamps, np.ones(n, bool)
        if name == "ROWPARTITION":
            p = self.partitions if self.partitions is not None else np.zeros(n, np.int32)
            return p, np.ones(n, bool)
        if name == "ROWOFFSET":
            o = self.offsets if self.offsets is not None else np.zeros(n, np.int64)
            return o, np.ones(n, bool)
        raise KeyError(name)


# ----------------------------------------------------------- device encode


@dataclasses.dataclass
class EncodedColumn:
    """A column encoded for the device.

    ``data`` is a fixed-width numpy array (device dtype).  For STRING/BYTES,
    ``data`` holds int32 indices into ``dictionary`` and ``hashes64`` holds
    the stable hash of each dictionary entry (so the device can derive the
    key-hash for any row by a gather)."""

    data: np.ndarray
    valid: np.ndarray
    dictionary: Optional[np.ndarray] = None  # object[n_unique]
    hashes64: Optional[np.ndarray] = None  # int64[n_unique]


_NUMERIC_DEFAULTS = {
    SqlBaseType.BOOLEAN: False,
    SqlBaseType.INTEGER: 0,
    SqlBaseType.BIGINT: 0,
    SqlBaseType.DOUBLE: 0.0,
    SqlBaseType.DECIMAL: 0.0,
    SqlBaseType.TIME: 0,
    SqlBaseType.DATE: 0,
    SqlBaseType.TIMESTAMP: 0,
}


def encode_column(values: np.ndarray, valid: np.ndarray, sql_type: SqlType) -> EncodedColumn:
    """Encode one host column for device transfer."""
    base = sql_type.base
    n = len(values)
    if base in (SqlBaseType.STRING, SqlBaseType.BYTES):
        # Dictionary-encode: unique values -> indices; nulls map to a
        # type-matched sentinel (masked out anyway, and np.unique cannot sort
        # mixed str/bytes).
        null_fill = "" if base == SqlBaseType.STRING else b""
        filled = np.array(
            [v if ok else null_fill for v, ok in zip(values, valid)], dtype=object
        )
        uniques, inverse = np.unique(filled, return_inverse=True)
        hashes = np.fromiter(
            (stable_hash64(u) for u in uniques), dtype=np.int64, count=len(uniques)
        )
        return EncodedColumn(
            data=inverse.astype(np.int32),
            valid=np.asarray(valid, bool),
            dictionary=uniques,
            hashes64=hashes,
        )
    if base in _NUMERIC_DEFAULTS:
        default = _NUMERIC_DEFAULTS[base]
        dtype = sql_type.device_dtype()
        valid = np.asarray(valid, bool)
        filled = np.asarray(values, dtype=object).copy()
        filled[~valid] = default
        return EncodedColumn(data=filled.astype(dtype), valid=valid)
    if base in (SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT):
        # nested values ride as opaque dictionary codes: the device sees
        # the stable hash (equality/grouping/passthrough work; anything
        # structural stays host-side).  stable_hash64 canonicalizes dict
        # ordering, so JSON key order doesn't split codes.
        valid = np.asarray(valid, bool)
        uniq: dict = {}
        idx = np.empty(n, np.int32)
        for i, (v, ok) in enumerate(zip(values, valid)):
            h = stable_hash64(v) if ok else 0
            ent = uniq.get(h)
            if ent is None:
                ent = (len(uniq), v if ok else None)
                uniq[h] = ent
            idx[i] = ent[0]
        entries = sorted(uniq.items(), key=lambda kv: kv[1][0])
        return EncodedColumn(
            data=idx,
            valid=valid,
            dictionary=np.array([v for _, (_, v) in entries], dtype=object),
            hashes64=np.fromiter(
                (h for h, _ in entries), dtype=np.int64, count=len(entries)
            ),
        )
    raise NotImplementedError(f"device encoding for {sql_type} not supported yet")
