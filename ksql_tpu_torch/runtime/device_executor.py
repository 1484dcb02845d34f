"""TorchDeviceExecutor — runs a persistent query on the port's device path.

The port of ``ksql_tpu/runtime/device_executor.py``'s ``DeviceExecutor``,
stream-row, stream-table-join, stream-stream-join and table-change
branches: records
are deserialized with the shared source decoder (the Python JSON path;
the reference's native C++ ingest is not ported yet), micro-batched up
to the batch size, stepped through :class:`TorchCompiledQuery`, and the
resulting SinkEmits are written to the sink topic.  Batched mode double-buffers: a batch's
emissions are decoded when the next batch runs, or at :meth:`drain`.
Batch size 1 is the per-record mode (one change per record, the
reference's cache-off parity).  An EMIT FINAL (suppress) plan is never
pipelined: a batch's closed windows go out with the batch, and
:meth:`flush_time` closes the windows left at the end of the input (the
reference also never steps such a plan per record; its batch size is the
engine's).

A join's table topics buffer per probe.  Stream and table records keep
their arrival order across the two sides: a table record first runs the
pending stream rows, a stream row first runs the pending table batches,
and a table batch runs synchronously (it updates the table store in
place; the pipelined stream emits it may overtake are fresh tensors).

A table aggregation or table transform (a CTAS over a table source)
buffers its source's changes — each key's old row beside its new one —
and runs them through ``process_table_changes`` a batch at a time; its
emissions return at once.

A table-table join (or a foreign-key join) buffers both tables' changes in
one buffer of single-side batches: a change of the other side first runs
the pending batch, which keeps the order across the sides.  A batch runs
through ``process_tt`` (``process_fk``) and returns its emissions at
once.  A foreign-key join runs one change a step (batch size 1): a right
change fans out over the whole left store, which a batched step cannot
order, and is refused in batched mode.

A stream-stream join buffers each side's rows on its own, and keeps their
arrival order the same way: a left record runs the pending right rows
first, a right record the pending left rows.  Its batches return their
emissions at once (nothing is pipelined), and every :meth:`drain` ends
with the join's expiry, which emits the windows the tick closed.  A
self-join (one topic on both sides) needs record-interleaved sides and is
refused in batched mode.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ksql_tpu_torch.common.batch import HostBatch
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.runtime.sink import SinkEmit, SinkWriter, decode_source_record
from ksql_tpu_torch.runtime.topics import Broker, Record


class TorchDeviceExecutor:
    """Record-at-a-time executor interface over TorchCompiledQuery."""

    def __init__(
        self,
        plan: st.QueryPlan,
        broker: Broker,
        *,
        device=None,
        batch_size: int = 4096,
        store_capacity: int = 1 << 17,
        sliced: Optional[bool] = None,
        slice_ring_max: int = 512,
        table_store_capacity: int = 1 << 16,
        ss_buffer_capacity: int = 2048,
        ss_out_capacity: Optional[int] = None,
        session_slots: int = 4,
        on_error: Optional[Callable[[str, Exception], None]] = None,
        emit_callback: Optional[Callable[[SinkEmit], None]] = None,
        batch_emit_callback: Optional[Callable[[List[SinkEmit]], None]] = None,
    ):
        self.plan = plan
        self.on_error = on_error or (lambda where, e: None)
        #: called with each emission before the sink writes it, and with
        #: each dispatched batch before its emissions (the push registry's
        #: seams; ``device_executor.py:861-868`` of the reference)
        self.emit_callback = emit_callback
        self.batch_emit_callback = batch_emit_callback
        self.query = TorchCompiledQuery(
            plan, capacity=batch_size, store_capacity=store_capacity, device=device,
            sliced=sliced, slice_ring_max=slice_ring_max,
            table_store_capacity=table_store_capacity, ss_buffer_capacity=ss_buffer_capacity,
            ss_out_capacity=ss_out_capacity, session_slots=session_slots,
        )
        self.query.pipeline = batch_size > 1 and not self.query.suppress
        self.source_step = self.query.source
        #: a stream-stream join's right side
        self.right_step = self.query.right_source
        if (self.right_step is not None and self.right_step.topic == self.source_step.topic
                and batch_size > 1):
            # a self-join's parity needs record-interleaved left/right steps
            raise DeviceUnsupported("batched self-join on device")
        self.sink_writer = SinkWriter(self.query.sink, broker)
        self._rows: List[dict] = []
        self._ts: List[int] = []
        self._parts: List[int] = []
        self._offsets: List[int] = []
        self.stream_time = -(2 ** 63)
        # per-probe table-side buffers and topic -> probe routing
        self._tbuf: List[dict] = [_table_buffer() for _ in self.query.join_chain]
        self._join_topics = {js.table_source.topic: i for i, js in enumerate(self.query.join_chain)}
        # the right side's pending rows
        self._rrows: List[dict] = []
        self._rts: List[int] = []
        self._rparts: List[int] = []
        self._roffs: List[int] = []
        #: a table aggregation's or table transform's pending source changes:
        #: (key, old row, new row, ts, partition, offset)
        self._changes: List[tuple] = []
        #: a table-table or foreign-key join: each side's table source by
        #: topic and the pending single-side batch of changes, (side, key,
        #: old row, new row, ts, partition, offset)
        q = self.query
        self._side_sources = {}
        if q.tt_join is not None:
            self._side_sources = {q.tt_left_source.topic: ("l", q.tt_left_source),
                                  q.tt_right_source.topic: ("r", q.tt_right_source)}
        if q.fk_join is not None:
            if batch_size > 1:
                # a right change fans out store-wide: per-record only
                raise DeviceUnsupported("batched fk join on device")
            self._side_sources = {q.fk_left_source.topic: ("l", q.fk_left_source),
                                  q.fk_right_source.topic: ("r", q.fk_right_source)}
        self._side_buf: List[tuple] = []

    @property
    def source_topics(self) -> List[str]:
        """The topics :meth:`process` routes, sorted (the reference
        engine's subscription order): the stream source, each join table's
        changelog, a stream-stream join's right stream and both tables of a
        table-table or foreign-key join."""
        right = [self.right_step.topic] if self.right_step is not None else []
        return sorted({self.source_step.topic, *self._join_topics, *right, *self._side_sources})

    def process(self, topic: str, record: Record) -> List[SinkEmit]:
        """Buffer one record; runs the device step when the micro-batch is
        full.  Call :meth:`drain` at the end of a poll tick."""
        if topic in self._side_sources:  # before table_mode: a tt join sets it
            return self._buffer_side_change(*self._side_sources[topic], record)
        if topic in self._join_topics:
            return self._buffer_table_record(self._join_topics[topic], record)
        q = self.query
        if (q.table_agg or q.table_mode) and topic == self.source_step.topic:
            return self._buffer_change(record)
        out: List[SinkEmit] = []
        if topic == self.source_step.topic:
            out.extend(self._buffer_stream_record(record))
        if self.right_step is not None and topic == self.right_step.topic:
            out.extend(self._buffer_right_record(record))
        return out

    def _buffer_stream_record(self, record: Record) -> List[SinkEmit]:
        ev = decode_source_record(self.source_step, record, self.on_error)
        if ev is None:
            return []
        out: List[SinkEmit] = []
        q = self.query
        if ev.row is None:
            if (q.agg is None and q.join is None and q.ss_join is None
                    and not any(isinstance(op, st.StreamFilter) for op in q.pre_ops)):
                # null-value stream records pass filter-less projections
                # through unchanged (oracle SelectNode); filters and
                # aggregations drop them
                out.extend(self._run_batch() if self._rows else [])
                emit = SinkEmit(ev.key, None, ev.ts, ev.window)
                self._dispatch([emit])
                out.append(emit)
            return out
        if any(b["rows"] for b in self._tbuf):
            self._run_table_batch()
        if self._rrows:
            out.extend(self._run_right_batch())
        self.stream_time = max(self.stream_time, ev.ts)
        self._rows.append(ev.row)
        self._ts.append(ev.ts)
        self._parts.append(record.partition)
        self._offsets.append(record.offset)
        if len(self._rows) >= q.capacity:
            out.extend(self._run_batch())
        return out

    def _buffer_right_record(self, record: Record) -> List[SinkEmit]:
        """One record of a stream-stream join's right stream: the pending
        left rows run first (null-value records are dropped)."""
        ev = decode_source_record(self.right_step, record, self.on_error)
        if ev is None or ev.row is None:
            return []
        out = self._run_batch() if self._rows else []
        self.stream_time = max(self.stream_time, ev.ts)
        self._rrows.append(ev.row)
        self._rts.append(ev.ts)
        self._rparts.append(record.partition)
        self._roffs.append(record.offset)
        if len(self._rrows) >= self.query.capacity:
            out.extend(self._run_right_batch())
        return out

    def _buffer_table_record(self, idx: int, record: Record) -> List[SinkEmit]:
        """One record of probe ``idx``'s table topic: the pending stream
        rows run first; the change joins the probe's table batch."""
        step = self.query.join_chain[idx].table_source
        ev = decode_source_record(step, record, self.on_error)
        if ev is None:
            return []
        self.stream_time = max(self.stream_time, ev.ts)
        out = self._run_batch() if self._rows else []
        if ev.new is not None:
            row = ev.new
        else:  # tombstone: key columns only
            row = {c.name: None for c in step.schema.columns()}
            for c, v in zip(step.schema.key_columns, ev.key):
                row[c.name] = v
        buf = self._tbuf[idx]
        buf["rows"].append(row)
        buf["ts"].append(ev.ts)
        buf["del"].append(ev.new is None)
        buf["parts"].append(record.partition)
        buf["offs"].append(record.offset)
        if len(buf["rows"]) >= self.query.capacity:
            self._run_table_batch(idx)
        return out

    def _buffer_change(self, record: Record) -> List[SinkEmit]:
        """One record of a table aggregation's or table transform's source:
        its change (the decoder tracks each key's old row) joins the batch,
        which runs when full."""
        ev = decode_source_record(self.source_step, record, self.on_error)
        if ev is None:
            return []
        self.stream_time = max(self.stream_time, ev.ts)
        self._changes.append((ev.key, ev.old, ev.new, ev.ts, record.partition, record.offset))
        if len(self._changes) >= self.query.capacity:
            return self._run_change_batch()
        return []

    def _buffer_side_change(self, side: str, step, record: Record) -> List[SinkEmit]:
        """One change of a table-table or foreign-key join's table ``side``:
        a pending batch of the other side runs first; the batch runs when
        full (at once for a foreign-key join)."""
        ev = decode_source_record(step, record, self.on_error)
        if ev is None:
            return []
        self.stream_time = max(self.stream_time, ev.ts)
        out = self._run_side_batch() if self._side_buf and self._side_buf[0][0] != side else []
        self._side_buf.append((side, ev.key, ev.old, ev.new, ev.ts, record.partition, record.offset))
        if len(self._side_buf) >= self.query.capacity:
            out.extend(self._run_side_batch())
        return out

    def _run_side_batch(self) -> List[SinkEmit]:
        """The pending single-side changes through ``process_tt`` or
        ``process_fk`` in micro-batches, writing each one's emissions."""
        buf, self._side_buf = self._side_buf, []
        q = self.query
        step = q.process_tt if q.tt_join is not None else q.process_fk
        sources = dict(self._side_sources.values())
        out: List[SinkEmit] = []
        cap = q.capacity
        for i in range(0, len(buf), cap):
            chunk = buf[i : i + cap]
            side = chunk[0][0]
            emits = step(side, *_change_batches(sources[side].schema, [c[1:] for c in chunk]))
            self._dispatch(emits)
            out.extend(emits)
        return out

    def _run_change_batch(self) -> List[SinkEmit]:
        """The buffered changes through ``process_table_changes`` in
        micro-batches: each change's new row and old row (an absent row,
        a delete's new one included, is empty, with ``has_new`` /
        ``has_old`` False), writing each batch's emissions to the sink."""
        changes, self._changes = self._changes, []
        schema = self.source_step.schema
        out: List[SinkEmit] = []
        cap = self.query.capacity
        for i in range(0, len(changes), cap):
            chunk = changes[i : i + cap]
            keys = [c[0] for c in chunk]
            ts = [c[3] for c in chunk]
            parts = [c[4] for c in chunk]
            offs = [c[5] for c in chunk]
            has_old = np.array([c[1] is not None for c in chunk], bool)
            has_new = np.array([c[2] is not None for c in chunk], bool)
            new_hb = HostBatch.from_rows(schema, [c[2] or {} for c in chunk], timestamps=ts,
                                         partitions=parts, offsets=offs)
            old_hb = HostBatch.from_rows(schema, [c[1] or {} for c in chunk], timestamps=ts,
                                         partitions=parts, offsets=offs)
            emits = self.query.process_table_changes(new_hb, old_hb, keys, has_new, has_old, ts)
            self._dispatch(emits)
            out.extend(emits)
        return out

    def _run_table_batch(self, idx: Optional[int] = None) -> None:
        """Fold the buffered table changes (of probe ``idx``, or of every
        probe) into the table stores, synchronously."""
        cap = self.query.capacity
        for j in range(len(self._tbuf)) if idx is None else (idx,):
            buf = self._tbuf[j]
            if not buf["rows"]:
                continue
            self._tbuf[j] = _table_buffer()
            schema = self.query.join_chain[j].table_source.schema
            for i in range(0, len(buf["rows"]), cap):
                hb = HostBatch.from_rows(
                    schema, buf["rows"][i : i + cap], timestamps=buf["ts"][i : i + cap],
                    partitions=buf["parts"][i : i + cap], offsets=buf["offs"][i : i + cap],
                )
                self.query.process_table(hb, np.asarray(buf["del"][i : i + cap], bool), idx=j)

    def drain(self) -> List[SinkEmit]:
        """Flush the partial micro-batches (a table source's changes, then
        a join's table changes, first) and the pipelined emissions; a stream-stream join then expires its rings
        (the windows this tick closed emit their pads)."""
        out: List[SinkEmit] = []
        if self._side_buf:
            out.extend(self._run_side_batch())
        if self._changes:
            out.extend(self._run_change_batch())
        if any(b["rows"] for b in self._tbuf):
            self._run_table_batch()
        if self._rrows:
            out.extend(self._run_right_batch())
        if self._rows:
            out.extend(self._run_batch())
        if self.query.pipeline:
            emits = self.query.flush_pipeline()
            self._dispatch(emits)
            out.extend(emits)
        if self.right_step is not None:
            emits = self.query.ss_expire_host()
            self._dispatch(emits)
            out.extend(emits)
        return out

    def flush_time(self, stream_time: int) -> List[SinkEmit]:
        """Advance event time explicitly (end-of-input flush): drain, then
        close what the new stream time closes (a stream-stream join's
        windows, or an EMIT FINAL query's)."""
        out = self.drain()
        self.stream_time = max(self.stream_time, stream_time)
        emits = self.query.flush(self.stream_time)
        self._dispatch(emits)
        out.extend(emits)
        return out

    def _run_right_batch(self) -> List[SinkEmit]:
        rows, ts, parts, offs = self._rrows, self._rts, self._rparts, self._roffs
        self._rrows, self._rts, self._rparts, self._roffs = [], [], [], []
        return self._run_rows(self.right_step.schema, rows, ts, parts, offs,
                              lambda hb: self.query.process_ss(hb, "r"))

    def _run_batch(self) -> List[SinkEmit]:
        rows, ts, parts, offs = self._rows, self._ts, self._parts, self._offsets
        self._rows, self._ts, self._parts, self._offsets = [], [], [], []
        return self._run_rows(self.source_step.schema, rows, ts, parts, offs, self.query.process)

    def _run_rows(self, schema, rows, ts, parts, offs, step) -> List[SinkEmit]:
        """Step the buffered rows of one source through ``step`` in
        micro-batches, writing each batch's emissions to the sink."""
        out: List[SinkEmit] = []
        cap = self.query.capacity
        for i in range(0, len(rows), cap):
            hb = HostBatch.from_rows(
                schema, rows[i : i + cap], timestamps=ts[i : i + cap],
                partitions=parts[i : i + cap], offsets=offs[i : i + cap],
            )
            emits = step(hb)
            self._dispatch(emits)
            out.extend(emits)
        return out

    def _dispatch(self, emits: List[SinkEmit]) -> None:
        if not emits:
            return
        if self.batch_emit_callback is not None:
            self.batch_emit_callback(emits)
        for e in emits:
            if self.emit_callback is not None:
                self.emit_callback(e)
            self.sink_writer.produce(e)


def _change_batches(schema, changes):
    """``(new rows, old rows, deletes, has_old)`` of join changes ``(key,
    old, new, ts, partition, offset)``: a delete's new row is its key
    alone, so that every change probes with its key (the reference's
    ``_change_batches``)."""

    def as_row(key, row):
        if row is not None:
            return row
        r = {c.name: None for c in schema.columns()}
        for c, v in zip(schema.key_columns, key):
            r[c.name] = v
        return r

    ts = [c[3] for c in changes]
    parts = [c[4] for c in changes]
    offs = [c[5] for c in changes]
    new_hb = HostBatch.from_rows(schema, [as_row(c[0], c[2]) for c in changes], timestamps=ts,
                                 partitions=parts, offsets=offs)
    old_hb = HostBatch.from_rows(schema, [c[1] or {} for c in changes], timestamps=ts,
                                 partitions=parts, offsets=offs)
    deletes = np.array([c[2] is None for c in changes], np.int32)
    has_old = np.array([c[1] is not None for c in changes], bool)
    return new_hb, old_hb, deletes, has_old


def _table_buffer() -> dict:
    return {"rows": [], "ts": [], "del": [], "parts": [], "offs": []}
