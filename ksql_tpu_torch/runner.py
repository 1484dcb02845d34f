"""run_plan — the port's entry point: one persistent query, end to end.

The port enters the system at the serialized physical plan (the versioned
``ExecutionStep`` IR that ``plan_to_json`` writes and ksqlDB replays from
its command topic); the SQL front end is not ported yet.  ``run_plan``
builds the executor for the plan, polls the source topic from the start,
drives the micro-batches through the device path and writes the sink topic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor
from ksql_tpu_torch.runtime.topics import Broker, Consumer

#: records taken from the log per poll
POLL_RECORDS = 1 << 16


def run_plan(plan_json: Dict[str, Any], broker: Broker, *, device=None,
             capacity: int = 4096, store_capacity: int = 1 << 17,
             sliced: Optional[bool] = None, slice_ring_max: int = 512) -> TorchDeviceExecutor:
    """Run the query ``plan_json`` (``plan_to_json`` output) over every
    record of its source topic in ``broker`` and write its sink topic.

    ``capacity`` is the micro-batch size: 1 emits one change per record,
    larger batches coalesce to one change per key per batch.  ``device``
    defaults to ``cuda`` and raises when there is no card.  A HOPPING
    aggregation runs sliced when eligible (``sliced=None``, the reference's
    ``ksql.slicing.enable``), the k-fold expansion with ``sliced=False``,
    and must slice with ``sliced=True``; ``slice_ring_max`` caps the slice
    ring (``ksql.slicing.max.ring``).  Returns the executor (its ``query``
    holds the device state and counters)."""
    executor = TorchDeviceExecutor(
        plan_from_json(plan_json), broker, device=device,
        batch_size=capacity, store_capacity=store_capacity,
        sliced=sliced, slice_ring_max=slice_ring_max,
    )
    consumer = Consumer(broker, [executor.source_step.topic])
    while True:
        polled = consumer.poll(POLL_RECORDS)
        if not polled:
            break
        for topic, record in polled:
            executor.process(topic, record)
    executor.drain()
    return executor
