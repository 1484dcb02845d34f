"""Row-mode filter and projection nodes (trimmed copy of the node half of
``ksql_tpu/runtime/oracle.py``).

A push tap's residual WHERE chain runs through :class:`FilterNode` and
:class:`SelectNode` on the host when it is not fused (below the fusing
threshold, or a residual that does not lower), and a fused tap projects
its matched rows through the :class:`SelectNode` alone.  Stream rows only:
the push registry shares stream sources, never tables.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.schema import PSEUDOCOLUMNS, LogicalSchema
from ksql_tpu_torch.execution import expressions as ex
from ksql_tpu_torch.execution.interpreter import ExpressionCompiler, TypeResolver
from ksql_tpu_torch.runtime.sink import StreamRow

WINDOW_BOUNDS = {"WINDOWSTART": T.BIGINT, "WINDOWEND": T.BIGINT}


def _with_pseudo(row: Dict[str, Any], ts: int, window: Optional[Tuple[int, int]],
                 event: Any = None) -> Dict[str, Any]:
    out = dict(row)
    out["ROWTIME"] = ts
    if event is not None:
        out["ROWPARTITION"] = getattr(event, "part", None)
        out["ROWOFFSET"] = getattr(event, "offset", None)
    if window is not None:
        out["WINDOWSTART"], out["WINDOWEND"] = window
    return out


class Compiler:
    """Compiles a step's expressions against its source schema (with the
    pseudocolumns and window bounds resolvable)."""

    def __init__(self, on_error: Callable[[str, Exception], None]):
        self.on_error = on_error

    def expr(self, e: ex.Expression, schema: LogicalSchema):
        types = {c.name: c.type for c in schema.columns()}
        for n, t in {**PSEUDOCOLUMNS, **WINDOW_BOUNDS}.items():
            types.setdefault(n, t)
        return ExpressionCompiler(TypeResolver(types), self.on_error).compile(e)


class FilterNode:
    """A StreamFilter: passes a row whose predicate is exactly True."""

    def __init__(self, step, compiler: Compiler):
        self.step = step
        self.pred = compiler.expr(step.predicate, step.source.schema)

    def receive(self, port, event: StreamRow) -> List[StreamRow]:
        if event.row is None:
            return []
        row = _with_pseudo(event.row, event.ts, event.window, event)
        return [event] if self.pred(row) is True else []


class SelectNode:
    """A StreamSelect: carries the (renamed) key columns through and
    evaluates the projections; a null-value row passes unchanged."""

    def __init__(self, step, compiler: Compiler):
        self.step = step
        src_schema = step.source.schema
        self.selects = [(name, compiler.expr(e, src_schema)) for name, e in step.selects]
        self.key_names = [c.name for c in step.schema.key_columns]
        self.src_key_names = [c.name for c in src_schema.key_columns]

    def _project(self, row, ts, window, event=None):
        src = _with_pseudo(row, ts, window, event)
        out = {}
        for new_name, old_name in zip(self.key_names, self.src_key_names):
            out[new_name] = row.get(old_name)
        for name, f in self.selects:
            out[name] = f(src)
        return out

    def receive(self, port, event: StreamRow) -> List[StreamRow]:
        if event.row is None:
            return [event]  # stream null-value records pass through
        return [StreamRow(event.key, self._project(event.row, event.ts, event.window, event),
                          event.ts, event.window, event.part, event.offset)]
