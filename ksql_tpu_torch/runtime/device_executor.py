"""TorchDeviceExecutor — runs a persistent query on the port's device path.

The port of ``ksql_tpu/runtime/device_executor.py``'s ``DeviceExecutor``,
stream-row branch: records are deserialized with the shared source decoder
(the Python JSON path; the reference's native C++ ingest is not ported
yet), micro-batched up to the batch size, stepped through
:class:`TorchCompiledQuery`, and the resulting SinkEmits are written to
the sink topic.  Batched mode double-buffers: a batch's emissions are
decoded when the next batch runs, or at :meth:`drain`.  Batch size 1 is the
per-record mode (one change per record, the reference's cache-off parity).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ksql_tpu_torch.common.batch import HostBatch
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
        on_error: Optional[Callable[[str, Exception], None]] = None,
    ):
        self.plan = plan
        self.on_error = on_error or (lambda where, e: None)
        self.query = TorchCompiledQuery(
            plan, capacity=batch_size, store_capacity=store_capacity, device=device,
            sliced=sliced, slice_ring_max=slice_ring_max,
        )
        self.query.pipeline = batch_size > 1
        self.source_step = self.query.source
        self.sink_writer = SinkWriter(self.query.sink, broker)
        self._rows: List[dict] = []
        self._ts: List[int] = []
        self._parts: List[int] = []
        self._offsets: List[int] = []
        self.stream_time = -(2 ** 63)

    def process(self, topic: str, record: Record) -> List[SinkEmit]:
        """Buffer one record; runs the device step when the micro-batch is
        full.  Call :meth:`drain` at the end of a poll tick."""
        if topic != self.source_step.topic:
            return []
        ev = decode_source_record(self.source_step, record, self.on_error)
        if ev is None:
            return []
        out: List[SinkEmit] = []
        q = self.query
        if ev.row is None:
            if q.agg is None and not any(isinstance(op, st.StreamFilter) for op in q.pre_ops):
                # null-value stream records pass filter-less projections
                # through unchanged (oracle SelectNode); filters and
                # aggregations drop them
                out.extend(self._run_batch() if self._rows else [])
                emit = SinkEmit(ev.key, None, ev.ts, ev.window)
                self._dispatch([emit])
                out.append(emit)
            return out
        self.stream_time = max(self.stream_time, ev.ts)
        self._rows.append(ev.row)
        self._ts.append(ev.ts)
        self._parts.append(record.partition)
        self._offsets.append(record.offset)
        if len(self._rows) >= q.capacity:
            out.extend(self._run_batch())
        return out

    def drain(self) -> List[SinkEmit]:
        """Flush the partial micro-batch and the pipelined emissions."""
        out: List[SinkEmit] = []
        if self._rows:
            out.extend(self._run_batch())
        if self.query.pipeline:
            emits = self.query.flush_pipeline()
            self._dispatch(emits)
            out.extend(emits)
        return out

    def flush_time(self, stream_time: int) -> List[SinkEmit]:
        """Advance event time explicitly (end-of-input flush)."""
        out = self.drain()
        self.stream_time = max(self.stream_time, stream_time)
        return out

    def _run_batch(self) -> List[SinkEmit]:
        schema = self.source_step.schema
        rows, ts = self._rows, self._ts
        parts, offs = self._parts, self._offsets
        self._rows, self._ts, self._parts, self._offsets = [], [], [], []
        out: List[SinkEmit] = []
        cap = self.query.capacity
        for i in range(0, len(rows), cap):
            hb = HostBatch.from_rows(
                schema, rows[i : i + cap], timestamps=ts[i : i + cap],
                partitions=parts[i : i + cap], offsets=offs[i : i + cap],
            )
            emits = self.query.process(hb)
            self._dispatch(emits)
            out.extend(emits)
        return out

    def _dispatch(self, emits: List[SinkEmit]) -> None:
        for e in emits:
            self.sink_writer.produce(e)
