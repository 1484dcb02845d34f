"""A push query session served as a tap (the tap half of
``ksql_tpu/server/rest.py``'s ``PushQuerySession``).

A session takes the push query's plan JSON (``plan_to_json`` of a
``SELECT ... FROM <stream> [WHERE ...] EMIT CHANGES``) and its LIMIT, and
attaches to the registry's shared pipeline over the stream at its live
end.  ``poll`` advances the pipeline and returns the new result rows (key
and value columns by name) and gap markers (``{"__gap__": {...}}``), in
ring order.  A plan that does not share (aggregates, joins, more than one
source) is refused with :class:`DeviceUnsupported`: dedicated sessions
are not ported (ROADMAP A14).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json


class PushQuerySession:
    def __init__(self, registry, plan_json: Dict[str, Any], limit: Optional[int] = None):
        self.id = f"transient_{uuid.uuid4().hex[:12]}"
        self.registry = registry
        self.limit = limit
        plan = plan_from_json(plan_json)
        self._key_names = [c.name for c in plan.physical_plan.schema.key_columns]
        self.rows: List[dict] = []
        self._emitted = 0
        self._results = 0  # result rows only (gap markers do not count)
        self._lock = threading.Lock()
        self.closed = False
        self.tap = registry.try_attach(self, plan)
        if self.tap is None:
            raise DeviceUnsupported(
                "push query is not a filter/projection over one stream: only shared taps are ported")

    @property
    def shared(self) -> bool:
        """True: a session is always a tap on a shared pipeline."""
        return self.tap is not None

    def _on_emit(self, e) -> bool:
        """True when the emission became a result row (within the LIMIT)."""
        with self._lock:
            if self.limit is not None and self._results >= self.limit:
                return False
            row = dict(zip(self._key_names, e.key))
            if e.row:
                row.update(e.row)
            if e.window is not None:
                row.setdefault("WINDOWSTART", e.window[0])
                row.setdefault("WINDOWEND", e.window[1])
            self.rows.append(row)
            self._results += 1
            return True

    def _enqueue_gap(self, marker: dict) -> None:
        """Queue a gap marker (a ring eviction span) onto the stream."""
        with self._lock:
            self.rows.append({"__gap__": dict(marker)})

    def poll(self) -> List[dict]:
        """Advance the shared pipeline through this tap; the new rows and
        gap markers."""
        if self.tap is not None:
            self.tap.poll()
        return self._drain_new()

    def _drain_new(self) -> List[dict]:
        with self._lock:
            new = self.rows[self._emitted:]
            self._emitted = len(self.rows)
            return new

    def done(self) -> bool:
        with self._lock:
            return self.closed or (
                self.limit is not None and self._results >= self.limit
                and self._emitted >= len(self.rows))

    def close(self) -> None:
        with self._lock:
            self.closed = True
        if self.tap is not None:
            # the last tap detaching starts the registry's linger clock
            tap, self.tap = self.tap, None
            tap.close()
