"""run_plan — the port's entry point: one persistent query, end to end.

The port enters the system at the serialized physical plan (the versioned
``ExecutionStep`` IR that ``plan_to_json`` writes and ksqlDB replays from
its command topic); the SQL front end is not ported yet.  ``start_plan``
builds the executor for the plan and a consumer of every source topic of
the plan (a join reads its tables' changelog topics too), from the start;
``run_until_quiescent`` drives the records produced so far through
the device path and writes the sink topic, and may be called again after
more records are produced; ``run_plan`` is the two, once, plus the final
``drain``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

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
