"""Source-record decode and sink emission, shared by the port's executors.

Trimmed copies of ``SinkEmit``, ``StreamRow``, ``TableChange``,
``decode_source_record`` and ``SinkWriter`` from
``ksql_tpu/runtime/oracle.py``: stream and table sources, KAFKA/JSON keys
and JSON values (``serde/formats.py``), no header columns, no fault points,
no changelog fence.  Values are serialized one emit at a
time with the same serializer the reference's block encoder mirrors byte
for byte, so the sink topic's bytes are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

from ksql_tpu_torch.common.errors import SerdeException
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.runtime.topics import Broker, Record
from ksql_tpu_torch.serde import formats as fmt


@dataclasses.dataclass
class StreamRow:
    key: Tuple[Any, ...]
    row: Optional[Dict[str, Any]]
    ts: int
    window: Optional[Tuple[int, int]] = None
    part: Optional[int] = None  # source record partition (ROWPARTITION)
    offset: Optional[int] = None  # source record offset (ROWOFFSET)


@dataclasses.dataclass
class TableChange:
    """One changelog record of a table source: the key's previous row (None
    when the key was absent) and its new row (None = tombstone)."""

    key: Tuple[Any, ...]
    old: Optional[Dict[str, Any]]
    new: Optional[Dict[str, Any]]
    ts: int
    window: Optional[Tuple[int, int]] = None
    part: Optional[int] = None
    offset: Optional[int] = None


@dataclasses.dataclass
class SinkEmit:
    """One sink emission: key tuple, row (None = tombstone), event time and
    the window bounds of a windowed key."""

    key: Tuple[Any, ...]
    row: Optional[Dict[str, Any]]
    ts: int
    window: Optional[Tuple[int, int]] = None


def decode_source_record(
    source_step,
    record: Record,
    on_error: Callable[[str, Exception], None],
) -> Optional[Union[StreamRow, TableChange]]:
    """Deserialize one source-topic record into a StreamRow, or for a table
    source a TableChange (value serde, key serde, TIMESTAMP-column
    extraction, and the table's old/new tracking in a per-step key → row
    map).  Returns None for a record the serde rejects (reported through
    ``on_error``), whose extracted timestamp is negative, a table record
    with a null key, and a tombstone for a key the table does not hold."""
    schema = source_step.schema
    cached = source_step.__dict__.get("_decode_cache")
    if cached is None:
        value_serde = fmt.of(
            source_step.formats.value_format,
            wrap_single_values=source_step.formats.wrap_single_values,
        )
        cached = (value_serde, list(schema.value_columns))
        source_step.__dict__["_decode_cache"] = cached
    value_serde, value_columns = cached
    try:
        value_row = value_serde.deserialize(record.value, value_columns) \
            if record.value is not None else None
        key_row = {}
        if record.key is not None and schema.key_columns:
            key_row = fmt.deserialize_key(
                source_step.formats.key_format, record.key, schema.key_columns
            )
    except Exception as e:  # noqa: BLE001 — any serde failure drops the record
        on_error(f"deserialize:{source_step.topic}", e)
        return None
    ts = record.timestamp
    if source_step.timestamp_column and value_row is not None:
        tv = value_row.get(source_step.timestamp_column)
        if tv is None and source_step.timestamp_column in key_row:
            tv = key_row[source_step.timestamp_column]
        if tv is not None:
            try:
                ts = int(tv)
            except (TypeError, ValueError) as e:
                on_error("timestamp-extract", e)
                return None
            if ts < 0:
                # negative extracted timestamps drop the record
                # (reference MetadataTimestampExtractor semantics)
                return None
    is_table = isinstance(source_step, (st.TableSource, st.WindowedTableSource))
    if record.key is None and schema.key_columns:
        if is_table:
            return None  # table upsert with null key: skipped (KTable source)
        key: tuple = ()  # null key payload: stays a null key on passthrough
    else:
        key = tuple(key_row.get(c.name) for c in schema.key_columns)
        if is_table and key and all(k is None for k in key):
            return None
    if value_row is None:
        row = None
    else:
        row = dict(key_row)
        row.update(value_row)
    if is_table:
        state = source_step.__dict__.setdefault("_table_state", {})
        hkey = _hashable(key)
        old = state.get(hkey)
        if row is None:
            state.pop(hkey, None)
        else:
            state[hkey] = row
        if old is None and row is None:
            return None
        return TableChange(key, old, row, ts, record.window, record.partition, record.offset)
    return StreamRow(key, row, ts, record.window, record.partition, record.offset)


def _hashable(v: Any) -> Any:
    """A dict key for a (possibly nested) key tuple."""
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    return v


class SinkWriter:
    """Serializes SinkEmits and produces them to the sink topic (the
    SinkBuilder analog: value/key serde + sink timestamp column)."""

    def __init__(self, sink_step, broker: Broker):
        self.sink_step = sink_step
        self.broker = broker
        broker.create_topic(sink_step.topic)
        self.value_serde = fmt.of(
            sink_step.formats.value_format,
            wrap_single_values=sink_step.formats.wrap_single_values,
        )
        fmt.check_key_format(sink_step.formats.key_format)
        self.defaults = dict(getattr(sink_step, "value_defaults", ()) or ())
        if any(not isinstance(n, str) for n in self.defaults):
            raise SerdeException("nested-path sink defaults are not supported by the port")
        #: False mutes the sink (a push pipeline's ring is its only output)
        self.enabled = True

    def produce(self, e: SinkEmit) -> None:
        if not self.enabled:
            return
        schema = self.sink_step.schema
        row = e.row
        if row is not None and self.defaults:
            row = {**self.defaults, **row}
        value = (
            self.value_serde.serialize(row, list(schema.value_columns))
            if row is not None
            else None
        )
        key = fmt.serialize_key(
            self.sink_step.formats.key_format, e.key, schema.key_columns,
            wrapped=getattr(self.sink_step.formats, "key_wrapped", False),
        )
        ts = e.ts
        if self.sink_step.timestamp_column and e.row is not None:
            tv = e.row.get(self.sink_step.timestamp_column)
            if tv is not None:
                ts = int(tv)
                if ts < 0:
                    return  # negative timestamps drop the record
        topic = self.broker.topic(self.sink_step.topic)
        topic.produce(Record(key=key, value=value, timestamp=ts, partition=-1,
                             window=e.window))
