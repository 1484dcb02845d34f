"""run_plan — the port's entry point: one persistent query, end to end.

The port enters the system at the serialized physical plan (the versioned
``ExecutionStep`` IR that ``plan_to_json`` writes and ksqlDB replays from
its command topic); the SQL front end is not ported yet.  ``start_plan``
builds the executor for the plan and a consumer of every source topic of
the plan (a join reads its tables' changelog topics too), from the start;
``run_until_quiescent`` drives the records produced so far through
the device path and writes the sink topic, and may be called again after
more records are produced; ``run_plan`` is the two, once, plus the final
``drain``; ``poll_once`` is one poll tick of a started query.

``start_push_registry`` is the entry point of push queries: it returns a
:class:`~ksql_tpu_torch.server.push_registry.PushRegistry`, on which
``ksql_tpu_torch.server.push_session.PushQuerySession`` opens push
sessions as taps over shared pipelines.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor
from ksql_tpu_torch.runtime.topics import Broker, Consumer

#: records taken from the log per poll
POLL_RECORDS = 1 << 16


@dataclass
class QueryHandle:
    """A started query: its executor and the consumer of its source topics
    (the reference engine's handle, cut to these two)."""

    executor: TorchDeviceExecutor
    consumer: Consumer
    #: push subscribers of the query's emissions, and of its emission
    #: batches (``QueryHandle.push_listeners`` of the reference engine)
    push_listeners: List[Callable] = field(default_factory=list)
    push_batch_listeners: List[Callable] = field(default_factory=list)

    def subscribe(self, cb: Callable, batch_cb: Optional[Callable] = None) -> Callable[[], None]:
        """Fan the query's emissions out to ``cb(emit)``, and each emission
        batch to ``batch_cb(emits, block)`` before its emissions, where
        ``block`` holds the batch's scalar emit columns on the device (or
        is None when it is not aligned with ``emits``): the reference's
        ``engine.register_push_tap``.  Returns the unsubscribe."""
        ex = self.executor
        ex.emit_callback = self._fan_out
        ex.batch_emit_callback = self._fan_out_batch
        self.push_listeners.append(cb)
        if batch_cb is not None:
            self.push_batch_listeners.append(batch_cb)
        ex.query.collect_raw_emits = bool(self.push_batch_listeners)

        def unsubscribe():
            if cb in self.push_listeners:
                self.push_listeners.remove(cb)
            if batch_cb in self.push_batch_listeners:
                self.push_batch_listeners.remove(batch_cb)
            # the last batch listener gone: no more device gathers
            ex.query.collect_raw_emits = bool(self.push_batch_listeners)

        return unsubscribe

    def _fan_out(self, emit) -> None:
        for cb in list(self.push_listeners):
            cb(emit)

    def _fan_out_batch(self, emits) -> None:
        if not self.push_batch_listeners:
            return
        blk = self.executor.query.last_raw_block
        if blk is not None and (blk["n"] != len(emits) or blk["emits_id"] != id(emits)):
            blk = None  # another decode's block: the host path
        for bcb in list(self.push_batch_listeners):
            bcb(emits, blk)


def start_plan(plan_json: Dict[str, Any], broker: Broker, *, device=None,
               capacity: int = 4096, store_capacity: int = 1 << 17,
               sliced: Optional[bool] = None, slice_ring_max: int = 512,
               table_store_capacity: int = 1 << 16, ss_buffer_capacity: int = 2048,
               ss_out_capacity: Optional[int] = None, session_slots: int = 4) -> QueryHandle:
    """Build the executor of the query ``plan_json`` (``plan_to_json``
    output) and a consumer of its source topics in ``broker``, sorted and
    from their start (topics that do not exist yet are created).

    ``capacity`` is the micro-batch size: 1 emits one change per record,
    larger batches coalesce to one change per key per batch.  ``device``
    defaults to ``cuda`` and raises when there is no card.  A HOPPING
    aggregation runs sliced when eligible (``sliced=None``, the reference's
    ``ksql.slicing.enable``), the k-fold expansion with ``sliced=False``,
    and must slice with ``sliced=True``; ``slice_ring_max`` caps the slice
    ring (``ksql.slicing.max.ring``).  ``table_store_capacity`` is the
    first slot count of each join table's store (it grows).  A
    stream-stream join buffers each side in a ring of
    ``max(ss_buffer_capacity, capacity)`` entries and writes at most
    ``ss_out_capacity`` matches a batch (default ``max(64, 2 * capacity)``);
    both grow.  Call ``drain`` once per tick: it closes the join's windows,
    and ``flush_time`` past the last record closes the rest.  A SESSION
    aggregation tracks ``session_slots`` sessions per key at first (the
    reference's default is 4); the count doubles when a batch needs more."""
    executor = TorchDeviceExecutor(
        plan_from_json(plan_json), broker, device=device, batch_size=capacity,
        store_capacity=store_capacity, sliced=sliced,
        slice_ring_max=slice_ring_max, table_store_capacity=table_store_capacity,
        ss_buffer_capacity=ss_buffer_capacity, ss_out_capacity=ss_out_capacity,
        session_slots=session_slots,
    )
    for t in executor.source_topics:
        broker.create_topic(t)
    return QueryHandle(executor, Consumer(broker, executor.source_topics))


def run_until_quiescent(handle: QueryHandle) -> int:
    """Poll the handle's consumer until no record is left, processing each
    through its executor; returns the records taken.  Micro-batches that
    are not full stay buffered until more records come or
    :meth:`~TorchDeviceExecutor.drain`."""
    taken = 0
    while True:
        polled = handle.consumer.poll(POLL_RECORDS)
        if not polled:
            return taken
        taken += len(polled)
        for topic, record in polled:
            handle.executor.process(topic, record)


def poll_once(handle: QueryHandle, max_records: int = 4096) -> int:
    """One poll tick of a started query (the reference engine's
    ``poll_once``): at most ``max_records`` records through its executor,
    then ``drain``.  Returns the records taken."""
    polled = handle.consumer.poll(max_records)
    for topic, record in polled:
        handle.executor.process(topic, record)
    handle.executor.drain()
    return len(polled)


def start_push_registry(broker: Broker, *, device=None, **kw):
    """The push registry over ``broker`` (keyword arguments: those of
    :class:`~ksql_tpu_torch.server.push_registry.PushRegistry`, the
    reference's ``ksql.push.registry.*`` defaults).  ``device`` defaults
    to ``cuda`` and raises when there is no card."""
    from ksql_tpu_torch.server.push_registry import PushRegistry
    from ksql_tpu_torch.state import resolve_device

    return PushRegistry(broker, device=resolve_device(device), **kw)


def run_plan(plan_json: Dict[str, Any], broker: Broker, **kw) -> TorchDeviceExecutor:
    """Run the query ``plan_json`` over every record of its source topics
    in ``broker`` and write its sink topic: :func:`start_plan` (same
    keyword arguments), one :func:`run_until_quiescent`, then ``drain``.
    Returns the executor (its ``query`` holds the device state and
    counters)."""
    handle = start_plan(plan_json, broker, **kw)
    run_until_quiescent(handle)
    handle.executor.drain()
    return handle.executor
