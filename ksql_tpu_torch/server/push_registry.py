"""Push registry: push sessions as filtered taps over shared pipelines.

The port of ``ksql_tpu/server/push_registry.py`` (ksqlDB's scalable push
queries).  Many clients subscribe to ``SELECT ... FROM <stream> WHERE ...
EMIT CHANGES``; the first session over a stream starts ONE shared pipeline
that materializes the stream into a bounded ring of sequence-stamped
emissions, and every session becomes a **tap**: a cursor into the ring and
its residual WHERE/projection chain.  A tap whose WHERE lowers joins a
predicate family of the pipeline's :class:`TapKernel` (K25 evaluates every
lane of a family over a span in one launch); the others run the chain row
by row on the host (``runtime/oracle.py``).  A tap that falls off the
ring's tail resumes at the retained tail behind a gap marker naming the
skipped span; the last tap detaching starts the linger clock, after which
``sweep`` reaps the pipeline.

Two pipeline modes:

* **listener**: a running query (a :class:`~ksql_tpu_torch.runner.QueryHandle`
  registered with :meth:`PushRegistry.register_upstream`) writes the
  source; the pipeline subscribes to its emissions, and to its emission
  batches' device columns, which K25 then reads in place of host rows.
  ``advance`` runs the handle one poll of at most 4,096 records.
* **standalone**: the pipeline runs the source's identity plan through its
  own :class:`TorchDeviceExecutor` (sink muted, per record by default:
  ``capacity=1``) over a consumer from the topic's live end.

Not ported (ROADMAP A14): the self-healing ladder and the listener's
failover, the overload clamp and shedding, fault seams, tracing and
metrics.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ksql_tpu_torch.execution import expressions as ex
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.runtime.sink import SinkEmit, StreamRow
from ksql_tpu_torch.server.tap_kernel import ResidualUnsupported, TapKernel, classify_residual

#: ring entry kinds
ROW = 0
GAP = 1

#: pseudo-columns bound to the source record's topic position: the shared
#: emit stream does not carry them, so such a residual does not share
_POSITIONAL_PSEUDO = ("ROWPARTITION", "ROWOFFSET")

#: records a listener-mode advance runs through the upstream handle
#: (``engine.run_until_quiescent(max_iters=1)`` -> ``poll_once(4096)``)
LISTENER_POLL_RECORDS = 4096


def _now_ms() -> float:
    return time.time() * 1000.0


def residual_chain(plan) -> Optional[List[Any]]:
    """The step chain ``[root-side residual steps..., StreamSource]`` of a
    shareable push plan (an optional sink over StreamSelect/StreamFilter
    steps ending in a StreamSource), else None."""
    step = plan.physical_plan
    if isinstance(step, (st.StreamSink, st.TableSink)):
        step = step.source
    chain: List[Any] = []
    while isinstance(step, (st.StreamSelect, st.StreamFilter)):
        chain.append(step)
        step = step.source
    if type(step) is not st.StreamSource:
        return None
    for s in chain:
        exprs = [s.predicate] if isinstance(s, st.StreamFilter) else [e for _, e in s.selects]
        for e0 in exprs:
            for node in ex.walk(e0):
                if isinstance(node, ex.ColumnRef) and node.name in _POSITIONAL_PSEUDO:
                    return None
    chain.append(step)
    return chain


def identity_plan(source: st.StreamSource, query_id: str) -> st.QueryPlan:
    """``SELECT * FROM <source> EMIT CHANGES`` as the reference's
    ``_build_standalone`` plans it and ``_wrap_transient_plan`` wraps it
    (a throwaway sink topic ``__transient_<query_id>``)."""
    schema = source.schema
    select = st.StreamSelect(
        source=source,
        selects=[(c.name, ex.ColumnRef(c.name)) for c in schema.value_columns],
        schema=schema,
        key_names=[c.name for c in schema.key_columns],
        ctx="Project",
    )
    sink = st.StreamSink(source=select, topic=f"__transient_{query_id}", formats=st.FormatInfo(),
                         schema=schema)
    return st.QueryPlan(query_id=query_id, sink_name=None, physical_plan=sink,
                        source_names=(source.source_name,))


class PushTap:
    """One session's subscription: a cursor into the ring and the session's
    residual filter/projection nodes, compiled once at attach."""

    def __init__(self, pipeline: "SharedPushPipeline", session, residual_steps: List[Any]):
        from ksql_tpu_torch.runtime.oracle import Compiler, FilterNode, SelectNode

        self.pipeline = pipeline
        self.session = session
        self.id = session.id
        registry = pipeline.registry
        compiler = Compiler(lambda expr, exc: registry.on_error(f"push-tap:{session.id}:{expr}", exc))
        # residual_steps is root-side first; events flow source-side first
        nodes = []
        for s in reversed(residual_steps):
            nodes.append(FilterNode(s, compiler) if isinstance(s, st.StreamFilter)
                         else SelectNode(s, compiler))
        self._nodes = nodes
        # fused delivery projects rows the mask passed (the filters are
        # decided): the chain's select nodes alone
        self._select_nodes = [n for n in nodes if isinstance(n, SelectNode)]
        self.fused = False
        self.fused_fallback: Optional[str] = None
        kernel = pipeline.ensure_kernel()
        if kernel is not None:
            try:
                spec = classify_residual(residual_steps, pipeline.out_schema)
                if spec is not None:
                    kernel.attach(session.id, spec)
                    self.fused = True
            except ResidualUnsupported as e:
                self.fused_fallback = str(e)
                reason = f"push residual stays host-side: {e}"
                registry.fallback_reasons[reason] = registry.fallback_reasons.get(reason, 0) + 1
        self.cursor = pipeline.head_seq()  # attach at the live head
        self.delivered_rows = 0
        self.evicted_rows = 0
        self.gap_markers = 0
        #: spans delivered through K25's mask, and through the host chain
        self.fused_spans = 0
        self.host_spans = 0
        self.closed = False

    def poll(self) -> None:
        """Advance the shared pipeline, then deliver the new emissions
        through this tap's residual into the session (rows via its
        ``_on_emit``, gap markers via ``_enqueue_gap``)."""
        pipe = self.pipeline
        pipe.advance()
        entries, evicted, new_cursor = pipe.read_from(self.cursor, pipe.registry.max_poll_rows)
        if not entries and evicted is None:
            self.cursor = new_cursor
            return
        fused = None
        if self.fused and entries and pipe.kernel is not None:
            # one K25 evaluation per span serves every fused tap (the span
            # cache); None (below min-taps): the host path
            fused = pipe.kernel.mask_for(self.id, new_cursor - len(entries), entries)
        if fused is not None:
            self.fused_spans += 1
        elif entries:
            self.host_spans += 1
        self._deliver(entries, evicted, fused)
        self.cursor = new_cursor

    def _deliver(self, entries, evicted, fused=None) -> int:
        """Deliver ``entries`` into the session, through the fused mask when
        given (only matching rows, and interleaved gap entries, are
        visited), else through the host residual chain row by row.
        Returns the rows delivered."""
        pipe = self.pipeline
        sess = self.session
        registry = pipe.registry
        if evicted is not None:
            # fell off the ring's tail: resume past the gap, never stall
            # the pipeline; skippedRows counts rows, not evicted markers
            skipped = evicted[2]
            marker = {
                "queryId": sess.id,
                "pipeline": pipe.id,
                "evicted": True,
                "fromSeq": evicted[0],
                "toSeq": evicted[1],
                "skippedRows": skipped,
                "error": (f"tap lagged {skipped} rows past the shared ring "
                          f"(ksql.push.registry.ring.size={pipe.ring_size}); "
                          "resuming at the retained tail"),
            }
            with registry._lock:
                self.evicted_rows += skipped
                self.gap_markers += 1
                registry.gap_markers += 1
            sess._enqueue_gap(marker)
        delivered = 0
        if fused is not None:
            positions = np.flatnonzero(fused["mask"][: len(entries)])
            limit = getattr(sess, "limit", None)
            if limit is not None:
                # LIMIT-aware gather: no visit past the remaining budget (the
                # session still enforces the cap in _on_emit)
                positions = positions[: max(int(limit) - int(sess._results), 0)]
            gap_positions = [i for i, (k, _) in enumerate(entries) if k == GAP]
            if gap_positions:
                positions = sorted(set(positions.tolist()) | set(gap_positions))
            index_iter = positions
        else:
            index_iter = range(len(entries))
        for i in index_iter:
            kind, payload = entries[i]
            if kind == GAP:
                marker = dict(payload)
                marker["queryId"] = sess.id
                with registry._lock:
                    self.gap_markers += 1
                    registry.gap_markers += 1
                sess._enqueue_gap(marker)
                continue
            key, row, ts = payload
            events: List[Any] = [StreamRow(key, row, ts, None)]
            nodes = self._select_nodes if fused is not None else self._nodes
            for node in nodes:
                events = [ev2 for ev in events for ev2 in node.receive(0, ev)]
                if not events:
                    break
            for ev in events:
                if sess._on_emit(SinkEmit(ev.key, ev.row, ev.ts, ev.window)):
                    delivered += 1
        if delivered:
            with registry._lock:
                self.delivered_rows += delivered
                registry.delivered_rows += delivered
        return delivered

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.fused and self.pipeline.kernel is not None:
            self.pipeline.kernel.detach(self.id)  # a mask update for the others
        self.pipeline.detach(self)


class SharedPushPipeline:
    """ONE pipeline serving every tap over a stream: the ring of (key,
    full row, ts) emissions, sequence-stamped.  See the module docstring
    for the modes."""

    def __init__(self, registry: "PushRegistry", source: st.StreamSource):
        self.registry = registry
        self.source = source
        self.source_name = source.source_name
        self.id = f"pushreg_{next(registry._seq)}_{self.source_name.lower()}"
        self._lock = registry._lock
        self.ring: List[Tuple[int, Any]] = []
        self.base_seq = 0
        # seqs of evicted GAP entries (bounded): subtracted from a lagging
        # tap's skipped-row span
        self._evicted_gap_seqs: List[int] = []
        self.ring_size = registry.ring_size
        self.taps: Dict[str, PushTap] = {}
        self.idle_since_ms: Optional[float] = None
        self.stopped = False
        self.mode = "standalone"
        self.upstream = None
        self._unsubscribe: Optional[Callable] = None
        self.consumer = None
        self.executor = None
        self._key_names = [c.name for c in source.schema.key_columns]
        self.out_schema = source.schema
        self.kernel: Optional[TapKernel] = None
        # listener mode: device emit blocks keyed by their ring-seq span
        self._emit_blocks: deque = deque(maxlen=8)
        # the block held between a batch callback and its last row append
        # ([start, n, blk, appended]), committed only once complete
        self._pending_block: Optional[list] = None
        upstream = registry.upstreams.get(self.source_name)
        if upstream is not None:
            self.upstream = upstream
            self._unsubscribe = upstream.subscribe(
                self._on_emit, self._on_emit_batch if registry.fused else None)
            self.mode = "listener"
        else:
            self._build_standalone()

    def _build_standalone(self) -> None:
        """The identity pipeline over the source (consume, decode, identity
        projection) from the topic's current end, sink muted."""
        from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor
        from ksql_tpu_torch.runtime.topics import Consumer

        reg = self.registry
        self.executor = TorchDeviceExecutor(
            identity_plan(self.source, self.id), reg.broker, device=reg.device,
            batch_size=reg.capacity, on_error=reg.on_error, emit_callback=self._on_emit)
        self.executor.sink_writer.enabled = False  # the ring is the only output
        reg.broker.create_topic(self.source.topic)
        self.consumer = Consumer(reg.broker, [self.source.topic], from_beginning=False)

    def ensure_kernel(self) -> Optional[TapKernel]:
        """The fused residual kernel, built on the first tap; None when
        fusing is off."""
        with self._lock:
            if self.kernel is None and self.registry.fused:
                reg = self.registry
                self.kernel = TapKernel(self, self.out_schema, self._lock,
                                        capacity_min=reg.capacity_min,
                                        capacity_max=reg.capacity_max, min_taps=reg.min_taps,
                                        device=reg.device)
            return self.kernel

    def _on_emit_batch(self, emits, blk) -> None:
        """Listener-mode batch handoff: hold the upstream's device emit
        block pending for the ring span the per-emit appends right after
        this call occupy; it commits once all its rows landed."""
        if blk is None:
            return
        with self._lock:
            if self.stopped or self.kernel is None:
                self._pending_block = None
                return  # no fused consumer: retain no device arrays
            self._pending_block = [self.base_seq + len(self.ring), len(emits), blk, 0]

    def _on_emit(self, e) -> None:
        """Stamp an emission with the next ring seq; the full row (key
        columns merged in) is what the residuals read."""
        if e.row is None:
            row = None
        else:
            row = dict(zip(self._key_names, e.key))
            row.update(e.row)
        with self._lock:
            if self.stopped:
                return
            seq = self.base_seq + len(self.ring)
            self.ring.append((ROW, (e.key, row, e.ts)))
            pend = self._pending_block
            if pend is not None:
                if seq == pend[0] + pend[3]:
                    pend[3] += 1
                    if pend[3] == pend[1]:
                        # every row of the batch landed: the block is aligned
                        # with these ring seqs
                        self._emit_blocks.append((pend[0], pend[1], pend[2]))
                        self._pending_block = None
                else:
                    self._pending_block = None  # an out-of-band append
            overflow = len(self.ring) - self.ring_size
            if overflow > 0:
                evicted_rows = 0
                for off, (k, _) in enumerate(self.ring[:overflow]):
                    if k == ROW:
                        evicted_rows += 1
                    else:
                        self._evicted_gap_seqs.append(self.base_seq + off)
                del self.ring[:overflow]
                self.base_seq += overflow
                if len(self._evicted_gap_seqs) > 256:
                    del self._evicted_gap_seqs[:-256]
                self.registry.ring_evicted += evicted_rows

    def head_seq(self) -> int:
        with self._lock:
            return self.base_seq + len(self.ring)

    def read_from(self, cursor: int, max_rows: int):
        """Ring entries from ``cursor`` (at most ``max_rows``), the evicted
        span ``(from_seq, to_seq, skipped_rows)`` when the cursor fell off
        the tail (gap entries not counted as rows), and the new cursor."""
        with self._lock:
            evicted = None
            if cursor < self.base_seq:
                gaps_in_span = sum(1 for s in self._evicted_gap_seqs if cursor <= s < self.base_seq)
                evicted = (cursor, self.base_seq, max(self.base_seq - cursor - gaps_in_span, 0))
                cursor = self.base_seq
            start = cursor - self.base_seq
            entries = list(self.ring[start:start + max_rows])
            return entries, evicted, cursor + len(entries)

    def advance(self, max_records: int = 1024) -> None:
        """Pump the pipeline (every tap poll calls it): listener mode runs
        the upstream handle one poll; standalone mode polls its consumer
        (at most ``max_records``, bounded by the ring) through its
        executor."""
        if self.stopped:
            return
        if self.mode == "listener":
            from ksql_tpu_torch.runner import poll_once

            poll_once(self.upstream, LISTENER_POLL_RECORDS)
            return
        for topic, r in self.consumer.poll(max(1, min(max_records, self.ring_size))):
            self.executor.process(topic, r)
        self.executor.drain()

    def attach(self, tap: PushTap) -> None:
        with self._lock:
            self.taps[tap.id] = tap
            self.idle_since_ms = None

    def detach(self, tap: PushTap) -> None:
        with self._lock:
            self.taps.pop(tap.id, None)
            if not self.taps:
                self.idle_since_ms = _now_ms()
        self.registry.sweep()

    def stop(self) -> None:
        """Teardown: unhook the listener, drop the consumer and executor."""
        with self._lock:
            self.stopped = True
            if self._unsubscribe is not None:
                self._unsubscribe()
                self._unsubscribe = None
            self.consumer = None
            self.executor = None
            self._emit_blocks.clear()  # release retained device arrays
            self._pending_block = None

    def healthy_row_count(self) -> int:
        with self._lock:
            return sum(1 for k, _ in self.ring if k == ROW)


class PushRegistry:
    """The shared push pipelines over one broker, by source stream (the
    ScalablePushRegistry analog).  Build it with
    :func:`ksql_tpu_torch.runner.start_push_registry`; the reference's
    configuration knobs are its keywords, with the reference's defaults."""

    def __init__(self, broker, *, device, capacity: int = 1, ring_size: int = 8192,
                 max_poll_rows: int = 4096, fused: bool = True, capacity_min: int = 8,
                 capacity_max: int = 4096, min_taps: int = 2, linger_ms: float = 5000.0):
        self.broker = broker
        self.device = device
        self.capacity = capacity
        self.ring_size = ring_size
        self.max_poll_rows = max_poll_rows
        self.fused = fused
        self.capacity_min = capacity_min
        self.capacity_max = capacity_max
        self.min_taps = min_taps
        self.linger_ms = linger_ms
        #: (where, error) of records the pipelines' decoders and the taps'
        #: expressions rejected (the reference's processing log)
        self.errors: List[Tuple[str, str]] = []
        self._lock = threading.RLock()
        self._seq = itertools.count(1)
        self.pipelines: Dict[str, SharedPushPipeline] = {}
        #: running queries by the stream they write (listener mode)
        self.upstreams: Dict[str, Any] = {}
        #: residuals kept on the host, by reason (the engine's fallback_reasons)
        self.fallback_reasons: Dict[str, int] = {}
        self.delivered_rows = 0
        self.ring_evicted = 0
        self.gap_markers = 0
        self.residual_kernel_evals = 0
        self.residual_kernel_rows = 0
        self.residual_compile_epochs = 0

    def on_error(self, where: str, e: Exception) -> None:
        self.errors.append((where, repr(e)))

    def register_upstream(self, source_name: str, handle) -> None:
        """Serve ``source_name`` from the running query ``handle`` (a
        ``runner.QueryHandle`` whose sink writes it): pipelines started
        after this run in listener mode (``engine.register_push_tap``)."""
        with self._lock:
            self.upstreams[source_name] = handle

    def try_attach(self, session, plan) -> Optional[PushTap]:
        """Attach a push session as a tap when its plan shares; None
        otherwise."""
        if len(plan.source_names) != 1:
            return None
        chain = residual_chain(plan)
        if chain is None:
            return None
        source = chain[-1]
        with self._lock:
            self.sweep()
            pipe = self.pipelines.get(source.source_name)
            if pipe is None or pipe.stopped:
                pipe = SharedPushPipeline(self, source)
                self.pipelines[source.source_name] = pipe
            tap = PushTap(pipe, session, chain[:-1])
            pipe.attach(tap)
        return tap

    def sweep(self, now_ms: Optional[float] = None) -> None:
        """Reap the pipelines idle past the linger window."""
        now_ms = _now_ms() if now_ms is None else now_ms
        with self._lock:
            for key, pipe in list(self.pipelines.items()):
                idle = pipe.idle_since_ms
                if pipe.taps or idle is None:
                    continue
                if now_ms - idle >= self.linger_ms:
                    pipe.stop()
                    self.pipelines.pop(key, None)

    def stop_all(self) -> None:
        """Tear every pipeline down regardless of taps or linger."""
        with self._lock:
            for pipe in self.pipelines.values():
                pipe.stop()
            self.pipelines.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            taps = {key: len(p.taps) for key, p in self.pipelines.items()}
            fused_taps = sum(p.kernel.fused_tap_count() for p in self.pipelines.values()
                             if p.kernel is not None)
            return {
                "pipelines": len(self.pipelines),
                "taps-total": sum(taps.values()),
                "taps": taps,
                "delivered-rows-total": self.delivered_rows,
                "ring-evicted-total": self.ring_evicted,
                "gap-markers-total": self.gap_markers,
                "residual": {
                    "fused-taps": fused_taps,
                    "host-taps": sum(taps.values()) - fused_taps,
                    "kernel-evals-total": self.residual_kernel_evals,
                    "kernel-rows-total": self.residual_kernel_rows,
                    "compile-epochs-total": self.residual_compile_epochs,
                },
            }
