"""In-process partitioned log — the Kafka stand-in.

Copy of ``ksql_tpu/runtime/topics.py`` without the fault-injection hooks.
The reference's storage/transport layer is external Kafka.
This framework's ingress/egress abstraction is a partitioned, offset-addressed
record log with the same semantics (keyed partitioning, per-partition
ordering, offsets, timestamps, tombstones).  The broker here is in-process;
a networked implementation can replace it behind the same interface.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

from ksql_tpu_torch.common.batch import stable_hash64
from ksql_tpu_torch.common.errors import KsqlException


@dataclasses.dataclass
class Record:
    key: Any  # python value (tuple for multi-col keys) or None
    value: Any  # serialized payload (bytes/str) or None = tombstone
    timestamp: int
    partition: int = 0
    offset: int = -1
    # topic-global produce sequence — preserves total produce order across
    # partitions (the reference's TopologyTestDriver observes outputs in
    # produce order regardless of partition count)
    seq: int = -1
    headers: Tuple[Tuple[str, bytes], ...] = ()
    # windowed keys carry (window_start, window_end) alongside the key
    window: Optional[Tuple[int, int]] = None


class Topic:
    def __init__(self, name: str, partitions: int = 1):
        self.name = name
        self.num_partitions = partitions
        self.partitions: List[List[Record]] = [[] for _ in range(partitions)]
        self._seq = 0
        self._lock = threading.RLock()

    def partition_for(self, key: Any) -> int:
        if key is None:
            # round-robin-ish: stable on current size
            with self._lock:
                return sum(len(p) for p in self.partitions) % self.num_partitions
        return stable_hash64(key) % self.num_partitions

    def produce(self, record: Record) -> Record:
        with self._lock:
            p = record.partition if record.partition >= 0 else 0
            if record.partition < 0 or record.partition >= self.num_partitions:
                p = self.partition_for(record.key)
            part = self.partitions[p]
            # hot path: direct construction (dataclasses.replace dominates
            # the produce profile at high event rates)
            record = Record(
                record.key, record.value, record.timestamp, p, len(part),
                self._seq, record.headers, record.window,
            )
            self._seq += 1
            part.append(record)
            return record

    def read(self, partition: int, offset: int, max_records: int = 1024) -> List[Record]:
        with self._lock:
            out = self.partitions[partition][offset : offset + max_records]
        return out

    def end_offsets(self) -> List[int]:
        with self._lock:
            return [len(p) for p in self.partitions]

    def all_records(self) -> List[Record]:
        """All records in global produce order (for tests/PRINT)."""
        with self._lock:
            out = [r for p in self.partitions for r in p]
        return sorted(out, key=lambda r: r.seq)


class Broker:
    """Topic registry (KafkaTopicClient analog)."""

    def __init__(self) -> None:
        self._topics: Dict[str, Topic] = {}
        self._lock = threading.RLock()

    def create_topic(self, name: str, partitions: int = 1, if_not_exists: bool = True) -> Topic:
        with self._lock:
            t = self._topics.get(name)
            if t is not None:
                if not if_not_exists:
                    raise KsqlException(f"Topic {name} already exists")
                return t
            t = Topic(name, partitions)
            self._topics[name] = t
            return t

    def topic(self, name: str) -> Topic:
        with self._lock:
            t = self._topics.get(name)
        if t is None:
            raise KsqlException(f"Topic {name} does not exist")
        return t





class Consumer:
    """Per-query consumer over a set of topics with committed offsets."""

    def __init__(self, broker: Broker, topics: List[str], from_beginning: bool = True):
        self.broker = broker
        self.topic_names = list(topics)
        self.positions: Dict[Tuple[str, int], int] = {}
        for tn in self.topic_names:
            t = broker.topic(tn)
            for p in range(t.num_partitions):
                self.positions[(tn, p)] = 0 if from_beginning else t.end_offsets()[p]

    def poll(self, max_records: int = 4096) -> List[Tuple[str, Record]]:
        """Merge-read across subscribed topic-partitions in global produce
        (seq) order per topic, so multi-partition intermediate topics are
        consumed in the order upstream emitted them (per-partition order is
        a fortiori preserved).

        Heap-merge over per-partition cursors (each partition is already
        seq-ordered): O(taken · log P), instead of speculatively reading the
        full budget from every partition and discarding the overflow."""
        import heapq

        out: List[Tuple[str, Record]] = []
        budget = max_records
        for tn in self.topic_names:
            if budget <= 0:
                break
            t = self.broker.topic(tn)

            def part_iter(p: int, start: int):
                offset = start
                while True:
                    chunk = t.read(p, offset, 256)
                    if not chunk:
                        return
                    for r in chunk:
                        yield r.seq, p, r
                    offset += len(chunk)

            merged = heapq.merge(
                *(part_iter(p, self.positions[(tn, p)]) for p in range(t.num_partitions))
            )
            taken = 0
            for _seq, p, r in merged:
                if taken >= budget:
                    break
                self.positions[(tn, p)] += 1
                out.append((tn, r))
                taken += 1
            budget -= taken
        return out


