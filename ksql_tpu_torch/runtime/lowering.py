"""TorchCompiledQuery — runs a physical plan's device step on the card.

The port of ``ksql_tpu/runtime/lowering.py``'s ``CompiledDeviceQuery`` for
the plan shapes of this slice:

    Source → Filter*/Select* → [StreamTableJoin (INNER or LEFT, n-way
    chains) → Filter*/Select*] → [GroupBy → Aggregate (unwindowed,
    TUMBLING or HOPPING) → (TableSelect | TableFilter)* → [Suppress]] →
    Sink

    Source → Filter*/Select* → GroupBy → Aggregate (SESSION, EMIT
    CHANGES) → TableSelect* → Sink

    (Source → Filter*/Select*/SelectKey*) x 2 → StreamStreamJoin (INNER,
    LEFT, RIGHT or FULL OUTER, WITHIN, with or without GRACE) →
    Filter*/Select* → Sink

    TableSource → (TableFilter | TableSelect)* → TableGroupBy →
    TableAggregate → (TableSelect | TableFilter)* → Sink

    TableSource → (TableFilter | TableSelect)+ → Sink

    (TableSource → (TableSelect | TableFilter)*) x 2 → TableTableJoin
    (INNER, LEFT, RIGHT or FULL OUTER, on the key) → (TableSelect |
    TableFilter)* → Sink

    (TableSource → (TableSelect | TableFilter)*) x 2 →
    ForeignKeyTableTableJoin (INNER or LEFT) → (TableSelect |
    TableFilter)+ → Sink

with COUNT(*), COUNT, SUM (DECIMAL too, in its 2^53 envelope), AVG, MIN and
MAX, the scalar EARLIEST/LATEST_BY_OFFSET(x[, ignoreNulls]) (ordered by the
arrival sequence ``agg_seq``, which advances by the batch capacity; their
payloads are written by K3's argset mode after its fold, or by K15's argset
mode in a session merge; a HOPPING query with them takes the expansion
route) and the vector aggregates COLLECT_LIST, COLLECT_SET,
EARLIEST/LATEST_BY_OFFSET(n), TOPK, TOPKDISTINCT, HISTOGRAM and ATTR
(``ops/device_aggs.py``; the vector state is folded by ``ops/vector.py``'s
K20-K22 after K3, on the unwindowed, TUMBLING and HOPPING-expansion
routes), plus the stateless filter/project pipelines; a struct column
read only through scalar field paths rides as its path columns.  Each table of a stream-table join
is materialized into its own keyed store on the card (``jtab``, inner
probes of a chain ``jtab<i>``): ``process_table`` folds a changelog batch
into it (K1 table mode, K2, K9 table_upsert) and every stream row probes
it in-step (K8 probe_find).  Each side of a stream-stream join buffers
its rows in a ring on the card (``ssl_*``/``ssr_*``): ``process_ss``
matches a batch of one side against the other side's ring (K10
ss_match), pads and inserts it into its own (K11 ss_insert);
``ss_expire_host`` closes, pads and evicts both rings once per tick (K12
ss_expire).  HOPPING aggregation takes the reference's two routes: stream
slicing (one slice per row into a per-key ring of slice partials, a
per-window monoid combine at emission; the default when eligible) and the
k-fold expansion (``sliced=False``, or when slicing is ineligible, with
the reference's reason in ``windowing_fallback``).  SESSION aggregation
keeps each key's sessions in slots ``(key hash, rank)``: a batch's rows
are sorted with the stored sessions of their keys and merged where they
lie within the gap (K1's session mode, K13 seg_sort, K14 session_items,
K15 session_merge, K16 session_write and K2); a batch that needs more
than ``session_slots`` sessions for a key doubles them and starts again
before it writes anything.  A table aggregation (a CTAS GROUP BY over a
table source) takes a batch of changes, each its key's old and new row
(``process_table_changes``): it undoes every old row — negated
contributions, or COLLECT_LIST's and HISTOGRAM's undo heads — at the group
K8's find-only mode finds (K23 vec_remove takes COLLECT_LIST's entries
out), emits the touched groups, then applies every new row as a stream
aggregation does and emits again.  A table transform (filters and
projections over a table source) runs the new rows through its pipeline
and the old rows through its filter, and emits a tombstone where a change
leaves the filter.  A table-table join keeps both tables in ONE store
keyed by the key (``ttab``: each side's columns and liveness); a batch of
one side's changes (``process_tt``) is placed by K1's table mode and K2,
reads the other side at its slots (K8's gather mode) before K9's side mode
writes it, and runs the post-join chain over each change's new row and
its verdict over the old one.  A foreign-key join keeps each table in a
store of its own (``fkl``, whose rows also hold their foreign key, and
``fkr``), one change a step (``process_fk``): a left change finds the right
row of its old and new foreign key (K8's live mode), a right change is
written (K9's side mode) and then fans out over every live left row of
that foreign key (K24 fk_fanout, ``ops/table_join.py``), whose emits go
out in the reference's host order.  EMIT FINAL (a TableSuppress over a TUMBLING or
HOPPING aggregation; HOPPING takes the expansion route) emits each window
once, when the running stream time reaches its close: K17 suppress_clock
keeps the running clocks, K18 suppress_close decides per slot, the closed
slots are gathered and decoded by ``_emit_slots`` before the retention
pass, and ``flush`` closes the rest; with no GRACE its grace is 0.  HAVING
over an EMIT CHANGES aggregation keeps each slot's last verdict
(``hpass``) and emits a tombstone when a slot stops passing (K19
having_verdict); under EMIT FINAL it filters at emission.  Every other
shape raises :class:`DeviceUnsupported` at construction: SESSION windows
over a join, FULL/RIGHT stream-table joins, an aggregation over a
stream-stream join, table-table and foreign-key joins over one topic,
RIGHT and FULL OUTER foreign-key joins, flat-maps,
PARTITION BY outside a join's input side, EMIT FINAL or HAVING over
SESSION windows, suppress over a table aggregation, aggregates whose state
does not invert (MIN, MAX, TOPK, COLLECT_SET, ...) over a table
aggregation, vector aggregates over SESSION windows or under EMIT FINAL,
the offsets over a table aggregation, window families, pull queries.

Where the reference traces one jitted step, the port runs eagerly: the
expression phases are torch tensor ops, and the keyed store goes through
the CUDA kernels of ``ops/hash_store.py`` (K1 row_prologue, K2
probe_insert, K3 fold_and_mark, K4 evict, K8 probe_find, K9
table_upsert), ``ops/slicing.py`` (K5 sliced_fold, K6 combine_windows,
K7 member_lanes), ``ops/ss_join.py`` (K10 ss_match, K11 ss_insert, K12
ss_expire), ``ops/session.py`` (K13 seg_sort, K14 session_items, K15
session_merge, K16 session_write), ``ops/suppress.py`` (K17
suppress_clock, K18 suppress_close, K19 having_verdict) and
``ops/vector.py`` (K20 vec_collect, K21 vec_topk, K22 vec_hist, K23
vec_remove) and ``ops/table_join.py`` (K24 fk_fanout).  The stores are
updated IN PLACE; every emitted lane is a fresh tensor (a K6, K8, K10,
K12, K16, K19 or K24 output or a batch column), never a view of a store
column, so a pipelined batch's
emits stay valid while the next batch, or a table batch, mutates the
stores (a session batch returns its emits at once: it is never
pipelined).

Semantics are the reference's, including its documented deltas from the
row oracle: EMIT CHANGES coalesces to one change per key per micro-batch,
and late-record grace is judged against the stream time at batch start
(for SESSION windows, against the running stream time in arrival order).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.batch import HostBatch
from ksql_tpu_torch.common.errors import QueryRuntimeException
from ksql_tpu_torch.common.schema import PSEUDOCOLUMNS, LogicalSchema
from ksql_tpu_torch.common.types import SqlBaseType, SqlType
from ksql_tpu_torch.compiler.torch_expr import (
    DCol,
    DeviceUnsupported,
    TorchExprCompiler,
    _HASHED,
    _repr64,
    decode_key64,
    deref_fields,
    deref_root,
    deref_synth_name,
    round_program,
    torch_dtype,
)
from ksql_tpu_torch.execution import expressions as ex
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import session as sess
from ksql_tpu_torch.ops import slicing
from ksql_tpu_torch.ops import ss_join as ssj
from ksql_tpu_torch.ops import suppress as sup
from ksql_tpu_torch.ops import table_join as tj
from ksql_tpu_torch.ops import vector as vec
from ksql_tpu_torch.ops import window as W
from ksql_tpu_torch.ops.device_aggs import DeviceAgg, compile_device_agg, resolve_udaf
from ksql_tpu_torch.parser.ast_nodes import JoinType, WindowType
from ksql_tpu_torch.runtime.device import BatchLayout, DictionaryServer, decode_value
from ksql_tpu_torch.runtime.sink import SinkEmit, _hashable
from ksql_tpu_torch.state import resolve_device, state_from_numpy, state_to_numpy

#: the reference's legacy default grace for EMIT CHANGES windows (24 h);
#: EMIT FINAL windows default to no grace
DEFAULT_GRACE_MS = 24 * 3600 * 1000
_I64_MIN = np.iinfo(np.int64).min
_I64_MAX = np.iinfo(np.int64).max
_PSEUDO = ("ROWTIME", "ROWOFFSET", "ROWPARTITION", "WINDOWSTART", "WINDOWEND")
#: HBM budget for a store's aggregate state arrays: wide state (slice
#: rings) trades initial slot count for width; the store still grows
_VEC_STATE_BUDGET_BYTES = 256 << 20
#: slice-ring combines cover exactly the monoid component kinds
_DECOMPOSABLE = ("add", "min", "max")


@dataclasses.dataclass
class _AggSpec:
    fname: str
    arg_exprs: Tuple[ex.Expression, ...]
    device: DeviceAgg
    out_name: str


@dataclasses.dataclass
class _MemberSpec:
    """The query whose window a sliced pipeline emits.  The reference
    shares one slice store among a window family (``members[1:]``); the
    port runs ``members[0]``, the query's own window, only."""

    size_ms: int
    advance_ms: int
    grace_ms: int
    agg_schema: LogicalSchema  # aggregate output schema (key column names)
    post_ops: List[st.ExecutionStep]
    sink_schema: LogicalSchema  # emitted row schema
    agg_map: List[int]  # member-local aggregate -> index in agg_specs


@dataclasses.dataclass
class _JoinSpec:
    """One stream-table probe of an n-way join chain (deepest-first)."""

    step: st.StreamTableJoin
    table_source: st.TableSource
    table_pre_ops: List[st.ExecutionStep]
    #: stream-side ops between the PREVIOUS probe (or the source) and this one
    between_ops: List[st.ExecutionStep]
    layout: Optional[BatchLayout] = None
    cols: List = dataclasses.field(default_factory=list)
    capacity: int = 0
    seen_overflow: int = 0


def _refs_of_ops(ops) -> set:
    """Source columns referenced anywhere in a step chain."""
    out: set = set()
    for s in ops:
        if hasattr(s, "predicate"):
            out.update(ex.referenced_columns(s.predicate))
        for _, e in getattr(s, "selects", ()):
            out.update(ex.referenced_columns(e))
        for e in getattr(s, "key_expressions", ()):
            out.update(ex.referenced_columns(e))
    return out


_NESTED_BASES = (SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT)


def _collect_struct_paths(exprs, schema):
    """(struct_paths, flattened_roots) for struct columns dereferenced to
    scalar leaves (the reference's ``_collect_struct_paths``): each path
    becomes a synthetic flat column ``ROOT->F.G``.  A struct whose every
    use is a path drops from the layout; one also used whole keeps its
    (dictionary-coded) column next to the path columns."""
    paths: Dict[str, Tuple[str, Tuple[str, ...], SqlType]] = {}
    bare_structs: set = set()
    struct_cols = {c.name: c.type for c in schema.columns() if c.type.base == SqlBaseType.STRUCT}

    def leaf_type(root: str, fields: Tuple[str, ...]) -> Optional[SqlType]:
        t = struct_cols.get(root)
        for f in fields:
            if t is None or t.base != SqlBaseType.STRUCT:
                return None
            t = next((ft for fn, ft in (t.fields or ()) if fn.upper() == f.upper()), None)
        if t is None or t.base in _NESTED_BASES:
            return None
        return t

    def scan(node):
        if isinstance(node, ex.Dereference):
            cur = deref_root(node)
            if isinstance(cur, ex.ColumnRef) and cur.name in struct_cols:
                fields = deref_fields(node)
                lt = leaf_type(cur.name, fields)
                if lt is None:
                    bare_structs.add(cur.name)
                else:
                    paths[deref_synth_name(cur.name, fields)] = (cur.name, fields, lt)
                return
            scan(cur)
            return
        if isinstance(node, ex.ColumnRef):
            if node.name in struct_cols:
                bare_structs.add(node.name)
            return
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, ex.Expression):
                    scan(v)
                elif isinstance(v, (list, tuple)):
                    for item in v:
                        if isinstance(item, ex.Expression):
                            scan(item)
                        elif isinstance(item, tuple) and len(item) == 2 \
                                and isinstance(item[1], ex.Expression):
                            scan(item[1])

    for e in exprs:
        scan(e)
    out = [(synth, root, fields, lt) for synth, (root, fields, lt) in sorted(paths.items())]
    roots = {root for _s, root, _f, _t in out} - bare_structs
    return out, roots


def _rebuild_keyed_store(old: Dict[str, np.ndarray], new: Dict[str, np.ndarray],
                         capacity: int) -> int:
    """Host rebuild of a keyed store (numpy arrays) into the fresh arrays
    ``new`` of ``capacity`` slots: live slots re-insert (``host_insert``),
    the other per-slot columns follow them, graves drop, scalars
    (``max_ts``, ``overflow``) carry over.  Returns the live slots."""
    live = np.nonzero(old["occ"][:-1])[0]
    if live.size:
        slots = hs.host_insert(new["occ"], new["khash"], new["wstart"], capacity,
                               old["khash"][live], old["wstart"][live])
        for name in old:
            if name not in ("occ", "khash", "wstart") and old[name].ndim:
                new[name][slots] = old[name][live]
    for name in old:
        if old[name].ndim == 0:
            new[name] = old[name]
    return int(live.size)


class TorchCompiledQuery:
    """A query lowered to the port's device path.

    Host API: ``process(HostBatch)`` / ``process_arrays(encoded arrays)``
    return the decoded ``SinkEmit``s of a micro-batch;
    ``process_table(HostBatch, deletes, idx)`` folds a table-changelog
    batch into join probe ``idx``'s store; ``process_ss(HostBatch, side)``
    runs a batch of one side of a stream-stream join, ``ss_expire_host()``
    and ``flush(stream_time)`` close its windows (``flush`` also closes an
    EMIT FINAL store's windows); ``state`` is the dict of device
    tensors (the reference's state pytree, same keys, nesting and
    dtypes).  ``device`` defaults to ``cuda`` and raises when there is no
    card; tests pass ``device="cpu"``, which runs the kernels' plain twins.
    """

    EVICT_INTERVAL = 64  # batches between retention passes
    #: when True (batched mode), emission decode lags one batch so host
    #: encode of batch i+1 overlaps device work of batch i
    pipeline = False

    def __init__(self, plan: st.QueryPlan, capacity: int = 8192,
                 store_capacity: int = 1 << 17, device=None,
                 sliced: Optional[bool] = None, slice_ring_max: int = 512,
                 table_store_capacity: int = 1 << 16, ss_buffer_capacity: int = 2048,
                 ss_out_capacity: Optional[int] = None, session_slots: int = 4):
        self.device = resolve_device(device)
        self.plan = plan
        self.capacity = capacity
        self.dictionary = DictionaryServer()
        self.sink: Optional[st.ExecutionStep] = None
        #: EMIT FINAL: windows emit once, when they close (TableSuppress)
        self.suppress = False
        #: TableSelect/TableFilter (HAVING) after the aggregate
        self.post_ops: List[st.ExecutionStep] = []
        self.agg: Optional[st.ExecutionStep] = None
        self.group: Optional[st.ExecutionStep] = None
        self.pre_ops: List[st.ExecutionStep] = []  # StreamFilter/StreamSelect
        #: stream-side ops between the outermost join and the aggregate/sink
        self.mid_ops: List[st.ExecutionStep] = []
        self.source: Optional[st.StreamSource] = None
        #: the outermost StreamTableJoin, and every probe of the chain,
        #: deepest first
        self.join: Optional[st.StreamTableJoin] = None
        self.join_chain: List[_JoinSpec] = []
        #: a stream-stream join, its right source and that side's pre-ops
        #: (``pre_ops`` are then the left side's)
        self.ss_join: Optional[st.StreamStreamJoin] = None
        self.right_source: Optional[st.StreamSource] = None
        self.right_pre_ops: List[st.ExecutionStep] = []
        #: a table aggregation over a table source (changes undo and apply:
        #: ``process_table_changes``), or a table transform (a
        #: TableFilter/TableSelect chain over a table source, ``pre_ops``)
        self.table_agg = False
        self.table_mode = False
        #: a primary-key table-table join (``table_mode`` too) or a
        #: foreign-key table-table join, each side's table source and the
        #: TableFilter/TableSelect ops between it and the join (``pre_ops``
        #: are then the post-join chain)
        self.tt_join: Optional[st.TableTableJoin] = None
        self.fk_join: Optional[st.ForeignKeyTableTableJoin] = None
        self.tt_left_source = self.tt_right_source = None
        self.tt_left_ops: List[st.ExecutionStep] = []
        self.tt_right_ops: List[st.ExecutionStep] = []
        self.fk_left_source = self.fk_right_source = None
        self.fk_left_ops: List[st.ExecutionStep] = []
        self.fk_right_ops: List[st.ExecutionStep] = []
        #: keep each decoded batch's scalar emit columns, on the device, in
        #: ``last_raw_block`` (the push registry's listener mode)
        self.collect_raw_emits = False
        self.last_raw_block: Optional[Dict[str, Any]] = None
        self._analyze(plan.physical_plan)

        self.window = getattr(self.agg, "window", None) if self.agg is not None else None
        self.size_ms = 0
        self.advance_ms = 0  # HOPPING only
        self.grace_ms = 0
        self.retention_ms: Optional[int] = None
        #: hopping windows expand each batch k-fold (the expansion route)
        self.expansion = 1
        self.session = self.window is not None and self.window.window_type == WindowType.SESSION
        if self.session and self.suppress:
            raise DeviceUnsupported("EMIT FINAL SESSION windows on device")
        if self.session and self.join is not None:
            raise DeviceUnsupported("SESSION windows over a join on device")
        if self.session:
            for op in self.post_ops:
                if not isinstance(op, st.TableSelect):
                    # the session emission lanes run TableSelects only
                    raise DeviceUnsupported(f"{type(op).__name__} over SESSION")
        #: concurrent sessions tracked per key (doubles on ``sess_ovf``), the
        #: doublings, and the inactivity gap
        self.session_slots = session_slots
        self.session_grows = 0
        self.gap_ms = self.window.gap_ms if self.session else 0
        if self.window is not None:
            wt = self.window.window_type
            if wt not in (WindowType.TUMBLING, WindowType.HOPPING, WindowType.SESSION):
                raise DeviceUnsupported(f"{wt.value} windows on device")
            grace = self.window.grace_ms
            if grace is None:
                grace = 0 if self.suppress else DEFAULT_GRACE_MS
            self.grace_ms = grace
        if self.window is not None and not self.session:
            self.size_ms = self.window.size_ms
            # windowed-store retention (KS: max(explicit retention, size+grace));
            # a session store has none (its sessions expire as they merge)
            self.retention_ms = max(self.window.retention_ms or 0, self.size_ms + self.grace_ms)
            if wt == WindowType.HOPPING:
                self.advance_ms = self.window.advance_ms
                self.expansion = W.hopping_expansion(self.size_ms, self.advance_ms)

        self.agg_specs: List[_AggSpec] = []
        self.key_types = []
        if self.agg is not None:
            self._build_agg_specs()
        self._setup_slicing(sliced, slice_ring_max)
        self._build_ingress_layout()
        self.table_store_capacity = 0
        if self.join is not None:
            self._build_table_layouts(table_store_capacity)
        self.tt_store_capacity = self.fk_store_capacity = 0
        if self.tt_join is not None or self.fk_join is not None:
            self._build_tt_layouts(table_store_capacity)
        if self.ss_join is not None:
            self._setup_ss_join(ss_buffer_capacity, ss_out_capacity)

        self.store_layout: Optional[hs.StoreLayout] = None
        #: EARLIEST/LATEST aggregates order by a global arrival sequence
        #: (``agg_seq``, advanced by the batch capacity each batch)
        self._needs_seq = False
        if self.agg is not None:
            comps = self._agg_components()
            # wide state (slice rings) shrinks the initial slot count to a
            # bounded budget; the store still grows on demand
            row_bytes = sum(np.dtype(c.dtype).itemsize * c.width for c in comps)
            budget_slots = max(1024, _VEC_STATE_BUDGET_BYTES // max(row_bytes, 1))
            while store_capacity > 1024 and store_capacity > budget_slots:
                store_capacity //= 2
            self.store_layout = hs.StoreLayout(
                capacity=store_capacity, num_keys=len(self.key_types),
                components=tuple(comps), windowed=self.window is not None,
            )
            self._needs_seq = any(c.combine == "argset" for c in comps)
        self.store_capacity = store_capacity
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self.scratch: Dict[str, torch.Tensor] = {}
        self._pending_emits: Optional[Dict[str, torch.Tensor]] = None
        self._batches = 0
        self._seen_overflow = 0
        #: host mirrors driving pre-dispatch ring sizing: a lower bound on
        #: the device stream clock (read back with the per-batch load
        #: counters) and the oldest slice index any batch could have written
        self._mirror_max_ts = -(2 ** 62)
        self._host_min_slice = 2 ** 62
        #: host-side counters of the store's maintenance (read by the chip
        #: check): retention passes, compactions, capacity doublings, ring
        #: resizes and the wall seconds of each rebuild
        self.evictions = 0
        self.compactions = 0
        self.grows = 0
        self.rebuild_seconds: List[float] = []
        self.ring_resizes = 0
        self.ring_seconds: List[float] = []
        #: join table stores' doublings and the wall seconds of each rebuild
        self.table_grows = 0
        self.table_rebuild_seconds: List[float] = []
        #: stream-stream join rings' doublings with the wall seconds of each
        #: rebuild, and the match lanes' doublings
        self.ss_grows = 0
        self.ss_rebuild_seconds: List[float] = []
        self.ss_out_grows = 0
        self.jscratch: Dict[str, Dict[str, torch.Tensor]] = {}
        self._check_compiles()

    # ------------------------------------------------------------ analysis
    def _analyze(self, step: st.ExecutionStep) -> None:
        cur = step
        if not isinstance(cur, (st.StreamSink, st.TableSink)):
            raise DeviceUnsupported("plan without sink")
        self.sink = cur
        cur = cur.source
        if isinstance(cur, st.TableSuppress):
            self.suppress = True
            cur = cur.source
        while isinstance(cur, (st.TableSelect, st.TableFilter)):
            self.post_ops.append(cur)
            cur = cur.source
        self.post_ops.reverse()
        if isinstance(cur, (st.StreamAggregate, st.StreamWindowedAggregate)):
            self.agg = cur
            cur = cur.source
            if not isinstance(cur, (st.StreamGroupBy, st.StreamGroupByKey)):
                raise DeviceUnsupported(f"aggregate over {type(cur).__name__}")
            self.group = cur
            cur = cur.source
        elif isinstance(cur, st.TableAggregate):
            # table aggregation: every source change undoes the old row's
            # contributions at its old group key and applies the new row's
            # at its new key (KudafUndoAggregator + KudafAggregator)
            if self.suppress:
                raise DeviceUnsupported("suppress over a table aggregation")
            self.agg = cur
            self.table_agg = True
            cur = cur.source
            if not isinstance(cur, st.TableGroupBy):
                raise DeviceUnsupported(f"table aggregate over {type(cur).__name__}")
            self.group = cur
            cur = cur.source
            while isinstance(cur, (st.TableFilter, st.TableSelect)):
                self.pre_ops.append(cur)
                cur = cur.source
            self.pre_ops.reverse()
            if not isinstance(cur, st.TableSource):
                raise DeviceUnsupported(f"table aggregate source {type(cur).__name__} on device")
            self.source = cur
            return
        elif self.suppress:
            raise DeviceUnsupported("suppress without aggregation")
        elif self.post_ops or isinstance(cur, st.TableTableJoin):
            # a table-to-table transform (CTAS without aggregation): the
            # TableFilter/TableSelect chain runs as a stateless pipeline
            # over each change's new row, and a verdict over its old row
            # decides the tombstones on the host; over a table-table join
            # it is the post-join chain of each side's changes
            if isinstance(cur, st.TableTableJoin):
                self._analyze_tt_join(cur)
                return
            if isinstance(cur, st.ForeignKeyTableTableJoin):
                self._analyze_fk_join(cur)
                return
            if not isinstance(cur, st.TableSource):
                raise DeviceUnsupported(
                    f"table transforms without aggregation over {type(cur).__name__}")
            self.table_mode = True
            self.pre_ops, self.post_ops = self.post_ops, []
            self.source = cur
            return
        while isinstance(cur, (st.StreamFilter, st.StreamSelect)):
            self.pre_ops.append(cur)
            cur = cur.source
        self.pre_ops.reverse()
        if isinstance(cur, st.StreamTableJoin):
            self._analyze_join(cur)
            return
        if isinstance(cur, st.StreamStreamJoin):
            self._analyze_ss_join(cur)
            return
        if not isinstance(cur, st.StreamSource) or isinstance(cur, st.WindowedStreamSource):
            raise DeviceUnsupported(f"device source {type(cur).__name__}")
        self.source = cur

    def _analyze_join(self, cur: st.StreamTableJoin) -> None:
        """A stream-table join, possibly an n-way chain A⋈B⋈C: the stream
        side keeps flowing through the row pipeline; each table side
        materializes into its own keyed store, probed in chain order."""
        self.mid_ops = self.pre_ops
        chain_rev = []  # outermost-first while walking down
        while isinstance(cur, st.StreamTableJoin):
            if cur.join_type not in (JoinType.INNER, JoinType.LEFT):
                raise DeviceUnsupported(f"{cur.join_type} stream-table join on device")
            tops: List[st.ExecutionStep] = []
            rcur = cur.right
            while isinstance(rcur, (st.TableSelect, st.TableFilter, st.TableSelectKey)):
                tops.append(rcur)
                rcur = rcur.source
            tops.reverse()
            if not isinstance(rcur, st.TableSource):
                raise DeviceUnsupported(f"join right source {type(rcur).__name__} on device")
            ops: List[st.ExecutionStep] = []
            lcur = cur.left
            while isinstance(lcur, (st.StreamFilter, st.StreamSelect, st.StreamSelectKey)):
                ops.append(lcur)
                lcur = lcur.source
            ops.reverse()
            # `ops` sit between this join and whatever feeds its left
            chain_rev.append((cur, rcur, tops, ops))
            cur = lcur
        if not isinstance(cur, st.StreamSource) or isinstance(cur, st.WindowedStreamSource):
            raise DeviceUnsupported(f"join left source {type(cur).__name__} on device")
        self.source = cur
        # deepest-first probe order; each spec's between_ops run BEFORE its
        # probe (they transform that join's left input)
        for join_step, tsrc, tops, between in reversed(chain_rev):
            self.join_chain.append(_JoinSpec(join_step, tsrc, tops, between))
        topics = [j.table_source.topic for j in self.join_chain]
        if len(set(topics)) != len(topics):
            # two probes of one changelog topic (a self-join via aliases)
            # cannot be routed topic -> probe
            raise DeviceUnsupported("same-topic stream-table join chain on device")
        deepest = self.join_chain[0]
        self.pre_ops = list(deepest.between_ops)
        deepest.between_ops = []
        self.join = self.join_chain[-1].step

    @staticmethod
    def _table_side(cur: st.ExecutionStep) -> Tuple[st.ExecutionStep, List[st.ExecutionStep]]:
        """A join side: its source below the TableSelect/TableFilter ops,
        and those ops in plan order."""
        ops: List[st.ExecutionStep] = []
        while isinstance(cur, (st.TableSelect, st.TableFilter)):
            ops.append(cur)
            cur = cur.source
        ops.reverse()
        return cur, ops

    def _analyze_tt_join(self, join: st.TableTableJoin) -> None:
        """A primary-key table-table join: both tables materialize into ONE
        two-sided store keyed by the key; each change joins against the
        resident other side and flows through the post-join chain."""
        if join.join_type not in (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT, JoinType.OUTER):
            raise DeviceUnsupported(f"{join.join_type} table-table join on device")
        self.table_mode = True
        self.tt_join = join
        self.pre_ops, self.post_ops = self.post_ops, []
        for side in ("left", "right"):
            src, ops = self._table_side(getattr(join, side))
            setattr(self, f"tt_{side}_ops", ops)
            if not isinstance(src, st.TableSource):
                raise DeviceUnsupported(
                    f"table-table join {side} source {type(src).__name__} on device")
            setattr(self, f"tt_{side}_source", src)
        if self.tt_left_source.topic == self.tt_right_source.topic:
            # a self-join's per-record side interleaving cannot be routed
            # topic -> side
            raise DeviceUnsupported("same-topic table-table join on device")
        self.source = self.tt_left_source

    def _analyze_fk_join(self, join: st.ForeignKeyTableTableJoin) -> None:
        """A foreign-key table-table join: the left table keyed by its own
        key, joined on fk(left) = key(right); a right change fans out to
        every left row with that foreign key (K24's scan of the left
        store)."""
        if join.join_type not in (JoinType.INNER, JoinType.LEFT):
            raise DeviceUnsupported(f"{join.join_type} foreign-key join on device")
        self.fk_join = join
        self.pre_ops, self.post_ops = self.post_ops, []
        for side in ("left", "right"):
            src, ops = self._table_side(getattr(join, side))
            setattr(self, f"fk_{side}_ops", ops)
            if not isinstance(src, st.TableSource):
                raise DeviceUnsupported(f"fk join {side} source {type(src).__name__} on device")
            setattr(self, f"fk_{side}_source", src)
        if self.fk_left_source.topic == self.fk_right_source.topic:
            raise DeviceUnsupported("same-topic fk join on device")
        if len(join.left.schema.key_columns) != 1:
            raise DeviceUnsupported("multi-column fk-join left key on device")
        self.source = self.fk_left_source

    def _analyze_ss_join(self, cur: st.StreamStreamJoin) -> None:
        """A stream-stream windowed join: each side runs its own pre-op
        chain into its own ring buffer on the card; each incoming batch
        matches the other side's buffer over the WITHIN window."""
        if self.agg is not None or self.post_ops or self.suppress:
            raise DeviceUnsupported("aggregation over a stream-stream join on device")
        self.ss_join = cur
        self.mid_ops = self.pre_ops
        for attr, src_attr, ops_attr in (("source", "left", "pre_ops"),
                                         ("right_source", "right", "right_pre_ops")):
            c2 = getattr(cur, src_attr)
            ops: List[st.ExecutionStep] = []
            while isinstance(c2, (st.StreamFilter, st.StreamSelect, st.StreamSelectKey)):
                ops.append(c2)
                c2 = c2.source
            ops.reverse()
            setattr(self, ops_attr, ops)
            if not isinstance(c2, st.StreamSource):
                raise DeviceUnsupported(f"join {src_attr} source {type(c2).__name__} on device")
            setattr(self, attr, c2)

    def _setup_ss_join(self, buffer_capacity: int, out_capacity: Optional[int]) -> None:
        """The right side's ingress (sharing the dictionary), the columns
        each ring buffers (those the emission reads), the window, the
        klip-36 mode and the ring and match-lane sizes."""
        ss = self.ss_join
        rsrc = self.right_source.schema
        rneeded = _refs_of_ops(self.right_pre_ops)
        rneeded.update(ex.referenced_columns(ss.right_key))
        rneeded &= {c.name for c in rsrc.columns()}
        rneeded.update(c.name for c in rsrc.key_columns)
        self.right_layout = BatchLayout(rsrc, sorted(rneeded), self.capacity, self.dictionary)
        down = _refs_of_ops(self.mid_ops)
        down.update(c.name for c in self._emit_schema().columns())
        down.update(c.name for c in ss.schema.key_columns)
        self.ss_cols = {side: [c for c in step.schema.columns() if c.name in down]
                        for side, step in (("l", ss.left), ("r", ss.right))}
        self.ss_before = ss.before_ms
        self.ss_after = ss.after_ms
        # klip-36: an explicit GRACE selects deferred (pad at close) left and
        # outer semantics; without it, the legacy eager padding
        self.ss_deferred = ss.grace_ms is not None
        self.ss_grace = ss.grace_ms if self.ss_deferred else DEFAULT_GRACE_MS
        self.ss_pad_sides = set()
        if ss.join_type in (JoinType.LEFT, JoinType.OUTER):
            self.ss_pad_sides.add("l")
        if ss.join_type in (JoinType.RIGHT, JoinType.OUTER):
            self.ss_pad_sides.add("r")
        # admission horizon against the own side's stream time: size + grace
        self.ss_retention = self.ss_before + self.ss_after + self.ss_grace
        self.ss_capacity = max(buffer_capacity, self.capacity)
        self.ss_out_cap = out_capacity or max(64, 2 * self.capacity)

    def _pre_agg_schema(self) -> LogicalSchema:
        if self.mid_ops:
            return self.mid_ops[-1].schema
        if self.join is not None:
            return self.join.schema
        return self.pre_ops[-1].schema if self.pre_ops else self.source.schema

    def _emit_schema(self) -> LogicalSchema:
        return self.sink.schema

    def _build_agg_specs(self) -> None:
        schema = self._pre_agg_schema()
        types = {c.name: c.type for c in schema.columns()}
        # struct leaves the arguments read ride as their path columns
        args = [a for call in self.agg.aggregations for a in call.args]
        types.update({synth: lt for synth, _r, _f, lt in _collect_struct_paths(args, schema)[0]})
        probe = _probe_env({**types, **PSEUDOCOLUMNS})
        for i, call in enumerate(self.agg.aggregations):
            if call.distinct:
                raise DeviceUnsupported("DISTINCT aggregation on device")
            c = TorchExprCompiler(probe, 0, "cpu")
            arg_types = [c.compile(a).sql_type for a in call.args]
            kind, result_type, n_lits = resolve_udaf(call.function, arg_types)
            # the values of the trailing literal parameters (TOPK's k,
            # EARLIEST/LATEST's n and ignoreNulls); None: not a literal
            lits: List[object] = []
            for a in call.args[len(call.args) - n_lits:] if n_lits else ():
                if isinstance(a, (ex.IntegerLiteral, ex.LongLiteral)):
                    lits.append(int(a.value))
                elif isinstance(a, ex.BooleanLiteral):
                    lits.append(bool(a.value))
                else:
                    lits.append(None)
            device = compile_device_agg(kind, arg_types, result_type, fname=call.function,
                                        literals=lits)
            if self.session and any(comp.width > 1 for comp in device.components):
                # the segment merge folds components pairwise; vector state
                # has no pairwise combine
                raise DeviceUnsupported(f"{call.function} over SESSION windows on device")
            if self.suppress and any(comp.width > 1 for comp in device.components):
                # K18 resets an evicted window's scalar components only
                raise DeviceUnsupported(f"{call.function} under EMIT FINAL on device")
            if self.table_agg and device.undo_contribs is None and any(
                    comp.combine != "add" for comp in device.components):
                # a retraction needs state that inverts: the all-'add'
                # families negate, COLLECT_LIST and HISTOGRAM have undo heads
                raise DeviceUnsupported(f"{call.function} over a table aggregation on device")
            self.agg_specs.append(_AggSpec(
                call.function, tuple(call.args), device, f"KSQL_AGG_VARIABLE_{i}",
            ))
        self.key_types = [c.type for c in self.agg.schema.key_columns]
        if len(self.key_types) > 16:
            raise DeviceUnsupported("more than 16 grouping columns on device")

    # ------------------------------------------------------- stream slicing
    def _agg_components(self) -> List[hs.AggComponent]:
        """Store component list for the aggregate state arrays.  Sliced
        stores widen every component to a per-key ring of ``slice_ring``
        slice partials; the other routes keep one cell per slot."""
        comps = [hs.AggComponent("max", "int64", _I64_MIN)]
        for spec in self.agg_specs:
            comps.extend(spec.device.components)
        if self.sliced:
            comps = [dataclasses.replace(c, width=self.slice_ring) for c in comps]
        return comps

    def _having_retract(self) -> bool:
        """Whether this query keeps per-slot HAVING verdicts (``hpass``) to
        emit retraction tombstones: an EMIT CHANGES aggregation with a
        HAVING filter (EMIT FINAL filters at emission instead, and HAVING
        over SESSION windows is refused)."""
        return (not self.suppress and not self.session
                and any(isinstance(op, st.TableFilter) for op in self.post_ops))

    def _slice_ineligibility(self, ring_max: int) -> Optional[str]:
        """Why this hopping aggregation must keep the k-fold expansion
        route (None = sliced-eligible), in the reference's words and
        order: EMIT FINAL, HAVING retraction, then the aggregates and the
        window's shape."""
        w = self.window
        if self.suppress:
            return (
                "EMIT FINAL hopping windows keep the expansion path "
                "(per-window close tracking on slices pending)"
            )
        if self._having_retract():
            return (
                "HAVING retraction over hopping windows keeps the "
                "expansion path (per-window verdict state)"
            )
        for spec in self.agg_specs:
            if any(c.combine not in _DECOMPOSABLE for c in spec.device.components):
                return (
                    f"non-decomposable aggregate {spec.fname} keeps the "
                    "expansion path (no monoid merge for its device state)"
                )
        if W.hopping_expansion(w.size_ms, w.advance_ms) < 2:
            return (
                "hopping ADVANCE equals SIZE (k=1): the expansion path is "
                "already slice-optimal"
            )
        sw = W.slice_width(w.size_ms, w.advance_ms)
        ring = self.retention_ms // sw + 2
        if ring > ring_max:
            return (
                f"hopping slice ring of {ring} slices exceeds "
                f"ksql.slicing.max.ring={ring_max} (slice width {sw}ms, "
                f"retention {self.retention_ms}ms) — set an explicit GRACE "
                "PERIOD or raise the cap; keeping the expansion path"
            )
        return None

    def _setup_slicing(self, sliced_opt: Optional[bool], ring_max: int) -> None:
        self.sliced = False
        self.slice_width = 0
        self.slice_ring = 0
        self.slice_ring_max = ring_max
        #: hopping fan-out of the window (also on the sliced route, where
        #: the batch itself no longer expands)
        self.hop_k = self.expansion
        #: why a hopping query runs the expansion route (None when sliced,
        #: or not a hopping aggregation at all)
        self.windowing_fallback: Optional[str] = None
        self.members: List[_MemberSpec] = []
        hopping = self.window is not None and self.window.window_type == WindowType.HOPPING
        if not hopping:
            if sliced_opt is True:
                raise DeviceUnsupported(
                    "sliced aggregation requires a HOPPING windowed aggregation"
                )
            return
        reason = self._slice_ineligibility(ring_max)
        if reason is None and sliced_opt is False:
            reason = "hopping runs the expansion path (slicing disabled for this executor)"
        if reason is not None:
            if sliced_opt is True:
                raise DeviceUnsupported(reason)
            self.windowing_fallback = reason
            return
        self.sliced = True
        self.expansion = 1  # no k-fold batch blow-up
        w = self.window
        self.slice_width = W.slice_width(w.size_ms, w.advance_ms)
        self.slice_ring = self.retention_ms // self.slice_width + 2
        self.members = [_MemberSpec(
            size_ms=w.size_ms, advance_ms=w.advance_ms, grace_ms=self.grace_ms,
            agg_schema=self.agg.schema,
            post_ops=list(self.post_ops), sink_schema=self._emit_schema(),
            agg_map=list(range(len(self.agg_specs))),
        )]

    def ensure_ring_for(self, ts: np.ndarray, valid: np.ndarray) -> None:
        """Pre-dispatch ring sizing: the ring must span every slice that is
        live this batch — from the admission floor (stream time − retention,
        bounded below by the host mirrors) up to the batch's
        newest slice — or two live slices would fold into one ring cell.
        Growth is capped at ``slice_ring_max``, where K1's horizon cut
        takes over."""
        if not self.sliced or ts.size == 0:
            return
        v = np.asarray(valid, bool)
        if not v.any():
            return
        tt = np.asarray(ts)[v]
        width = self.slice_width
        smin = int(tt.min()) // width
        smax = int(tt.max()) // width
        self._host_min_slice = min(self._host_min_slice, smin)
        floor = self._host_min_slice
        if self._mirror_max_ts > -(2 ** 61):
            # below clock − retention nothing reaches a ring cell, so the
            # ring need not span it
            floor = max(floor, (self._mirror_max_ts - self.retention_ms) // width)
        needed = smax - min(floor, smax) + 2
        target = min(needed, self.slice_ring_max)
        if needed > self.slice_ring and target != self.slice_ring:
            self._resize_ring(target)
        # after this batch folds, the device clock is >= the batch max
        self._mirror_max_ts = max(self._mirror_max_ts, int(tt.max()))

    def _resize_ring(self, new_ring: int) -> None:
        """Re-shape the slice ring to ``new_ring`` cells per slot (the
        slice width never changes without window families)."""
        self.slice_ring = new_ring
        self.store_layout = dataclasses.replace(
            self.store_layout,
            components=tuple(
                dataclasses.replace(c, width=new_ring) for c in self.store_layout.components
            ),
        )
        if self._state is not None and int(self._state["occ"][:-1].sum()) != 0:
            self._regrow_ring(new_ring)
        elif self._state is not None and self.join_chain:
            # an empty aggregate store re-inits at the new shapes; the join
            # table stores keep their contents
            jtabs = {k: v for k, v in self._state.items() if isinstance(v, dict)}
            self.state = {**self.init_state(tables=False), **jtabs}
        else:
            self._state = None  # lazy re-init at the new shapes

    def _regrow_ring(self, new_ring: int) -> None:
        """Host-side ring regrow: every live (slot, slice) partial moves to
        ``slice_id % new_ring`` in the widened arrays (new_ring spans every
        live slice, so no two live slices of one key collide)."""
        t0 = time.perf_counter()
        new = state_to_numpy(self.state)
        ids = new["slice_id"]
        rix, cix = np.nonzero(ids >= 0)
        npos = ids[rix, cix] % new_ring
        c1 = ids.shape[0]
        nid = np.full((c1, new_ring), -1, np.int64)
        nid[rix, npos] = ids[rix, cix]
        new["slice_id"] = nid
        for j, comp in enumerate(self.store_layout.components):
            col = new[f"a{j}"]
            ncol = np.full((c1, new_ring), comp.init, dtype=np.dtype(comp.dtype))
            ncol[rix, npos] = col[rix, cix]
            new[f"a{j}"] = ncol
        self.state = state_from_numpy(new, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ring_seconds.append(time.perf_counter() - t0)
        self.ring_resizes += 1

    def _build_ingress_layout(self) -> None:
        """The ingress BatchLayout: only the columns the pipeline reads; a
        struct column read only through scalar field paths becomes its
        path columns, extracted at encode (the struct never reaches the
        card)."""
        needed = _refs_of_ops(self.pre_ops) | _refs_of_ops(self.mid_ops)
        scope: List[ex.Expression] = []
        for s_ in [*self.pre_ops, *self.mid_ops]:
            if hasattr(s_, "predicate"):
                scope.append(s_.predicate)
            scope.extend(e_ for _n, e_ in getattr(s_, "selects", ()))
            scope.extend(getattr(s_, "key_expressions", ()))
        if self.group is not None:
            for e in getattr(self.group, "group_by_expressions", ()):
                needed.update(ex.referenced_columns(e))
                scope.append(e)
        for spec in self.agg_specs:
            for e in spec.arg_exprs:
                needed.update(ex.referenced_columns(e))
                scope.append(e)
        src_schema = self.source.schema
        if self.agg is None:
            needed.update(c.name for c in self._emit_schema().columns())
        needed &= {c.name for c in src_schema.columns()}
        needed.update(c.name for c in src_schema.key_columns)
        struct_paths, flattened_roots = _collect_struct_paths(scope, src_schema)
        needed -= flattened_roots
        self.layout = BatchLayout(src_schema, sorted(needed), self.capacity, self.dictionary,
                                  struct_paths=struct_paths)

    def _build_table_layouts(self, table_store_capacity: int) -> None:
        """Table-side ingress of each probe: the table columns its pre-ops
        and key read, into the SAME dictionary as the stream side (string
        comparisons and emit decode meet there); the store keeps only the
        right-side columns something above the probe reads."""
        down = _refs_of_ops(self.mid_ops) | _refs_of_ops(self.post_ops)
        if self.group is not None:
            for e in getattr(self.group, "group_by_expressions", ()):
                down.update(ex.referenced_columns(e))
        for spec in self.agg_specs:
            for e in spec.arg_exprs:
                down.update(ex.referenced_columns(e))
        down.update(c.name for c in self._emit_schema().columns())
        for jspec in self.join_chain:
            down.update(ex.referenced_columns(jspec.step.left_key))
            down.update(_refs_of_ops(jspec.between_ops))
            down.update(c.name for c in jspec.step.schema.key_columns)
        for jspec in self.join_chain:
            tsrc = jspec.table_source.schema
            tneeded = _refs_of_ops(jspec.table_pre_ops)
            tneeded.update(ex.referenced_columns(jspec.step.right_key))
            tneeded &= {c.name for c in tsrc.columns()}
            tneeded.update(c.name for c in tsrc.key_columns)
            jspec.layout = BatchLayout(tsrc, sorted(tneeded), self.capacity, self.dictionary)
            jspec.cols = [c for c in jspec.step.right.schema.value_columns if c.name in down]
            jspec.capacity = table_store_capacity
        self.table_store_capacity = table_store_capacity

    def _build_tt_layouts(self, table_store_capacity: int) -> None:
        """Each side's ingress of a table-table or foreign-key join (its
        ops' columns, its key, the foreign key on an fk join's left side,
        and what the post-join chain and the sink read when the side has
        no ops), sharing the dictionary, and the columns each side keeps
        in its store: those of its post-op schema the chain or the sink
        reads."""
        join = self.tt_join if self.tt_join is not None else self.fk_join
        prefix = "tt" if self.tt_join is not None else "fk"
        down = _refs_of_ops(self.pre_ops)
        down.update(c.name for c in self._emit_schema().columns())
        down.update(c.name for c in join.schema.key_columns)
        layouts, cols = {}, {}
        for side, name in (("l", "left"), ("r", "right")):
            src = getattr(self, f"{prefix}_{name}_source")
            ops = getattr(self, f"{prefix}_{name}_ops")
            needed = _refs_of_ops(ops)
            if self.tt_join is not None:
                needed.update(ex.referenced_columns(getattr(join, f"{name}_key")))
            elif side == "l":
                needed.update(ex.referenced_columns(join.foreign_key_expression))
            if not ops:
                needed.update(down)
            needed &= {c.name for c in src.schema.columns()}
            needed.update(c.name for c in src.schema.key_columns)
            layouts[side] = BatchLayout(src.schema, sorted(needed), self.capacity, self.dictionary)
            post = ops[-1].schema if ops else src.schema
            cols[side] = [c for c in post.columns() if c.name in down]
        setattr(self, f"{prefix}_layouts", layouts)
        setattr(self, f"{prefix}_cols", cols)
        setattr(self, f"{prefix}_store_capacity", table_store_capacity)

    def _check_compiles(self) -> None:
        """Compile every expression of the plan on empty CPU columns, so an
        expression the port does not lower raises DeviceUnsupported here,
        before any batch (the reference's construction-time trace)."""
        active = torch.zeros(0, dtype=torch.bool)
        ts = torch.zeros(0, dtype=torch.int64)
        if self.ss_join is not None:
            self._check_ss_compiles(active, ts)
            return
        if self.tt_join is not None:
            self._check_tt_compiles(active, ts)
            return
        if self.fk_join is not None:
            self._check_fk_compiles(active, ts)
            return
        types = {spec.name: spec.sql_type for spec in self.layout.specs}
        env = _probe_env({**types, **PSEUDOCOLUMNS})
        env, active = self._apply_ops(self.pre_ops, env, active, 0)
        if self.join is not None:
            for jspec in self.join_chain:
                tt = {spec.name: spec.sql_type for spec in jspec.layout.specs}
                tenv, _ = self._apply_ops(jspec.table_pre_ops, _probe_env({**tt, **PSEUDOCOLUMNS}),
                                          active, 0)
                TorchExprCompiler(tenv, 0, "cpu").compile(jspec.step.right_key)
                missing = [c.name for c in jspec.cols if c.name not in tenv]
                if missing:
                    raise DeviceUnsupported(f"join table columns {missing} not computed on device")
            # one-slot CPU stores: the probes of an empty batch
            jtabs = {self._jtab_key(i): self._init_table_store(i, "cpu", 1)
                     for i in range(len(self.join_chain))}
            env, active = self._apply_join(env, active, 0, jtabs)
            env, active = self._apply_ops(self.mid_ops, env, active, 0)
        if self.agg is None:
            self._pack_emits(env, active, ts)
            return
        self._key_cols(env, 0, "cpu")
        c = TorchExprCompiler(env, 0, "cpu")
        seq = torch.zeros(0, dtype=torch.int64)
        for spec in self.agg_specs:
            spec.device.contribs([c.compile(a) for a in spec.arg_exprs], active, seq)
        fin = {c2.name: c2.type for c2 in self.agg.schema.key_columns}
        fin.update({spec.out_name: spec.device.result_type for spec in self.agg_specs})
        fin["ROWTIME"] = T.BIGINT
        if self.window is not None:
            fin.update(WINDOWSTART=T.BIGINT, WINDOWEND=T.BIGINT)
        env, active = self._apply_ops(self.post_ops, _probe_env(fin), active, 0)
        self._pack_emits(env, active, ts)

    def _check_ss_compiles(self, active: torch.Tensor, ts: torch.Tensor) -> None:
        ss = self.ss_join
        for side, layout, pre, key in (("l", self.layout, self.pre_ops, ss.left_key),
                                       ("r", self.right_layout, self.right_pre_ops, ss.right_key)):
            types = {spec.name: spec.sql_type for spec in layout.specs}
            env, _ = self._apply_ops(pre, _probe_env({**types, **PSEUDOCOLUMNS}), active, 0)
            TorchExprCompiler(env, 0, "cpu").compile(key)
            missing = [c.name for c in self.ss_cols[side] if c.name not in env]
            if missing:
                raise DeviceUnsupported(f"join {side} columns {missing} not computed on device")
        out = {c.name: c.type for s in ("l", "r") for c in self.ss_cols[s]}
        out.update({c.name: c.type for c in ss.schema.key_columns}, ROWTIME=T.BIGINT)
        env, active = self._apply_ops(self.mid_ops, _probe_env(out), active, 0)
        self._pack_emits(env, active, ts)

    # --------------------------------------------------------------- state
    def init_state(self, device=None, tables: bool = True) -> Dict[str, torch.Tensor]:
        """A fresh state dict; ``tables=False`` leaves out the join table
        stores (a rebuild of the aggregate store keeps them)."""
        dev = self.device if device is None else device
        if self.store_layout is None:
            state = {"max_ts": torch.tensor(_I64_MIN, dtype=torch.int64, device=dev)}
            if self.ss_join is not None:
                state.update(self._init_ss_rings(dev))
        else:
            state = self._init_agg_state(dev)
        if tables:
            for i in range(len(self.join_chain)):
                state[self._jtab_key(i)] = self._init_table_store(i, dev)
        if self.tt_join is not None:
            state["ttab"] = self._init_tt_store(dev)
        if self.fk_join is not None:
            state["fkl"] = self._init_fk_store("l", dev)
            state["fkr"] = self._init_fk_store("r", dev)
        return state

    def _init_ss_rings(self, dev) -> Dict[str, torch.Tensor]:
        """Both sides' ring buffers, ``ss{side}_<field>`` (``ops/ss_join.py``
        ``RING_FIELDS``), ``ss{side}_v_<col>``/``_m_<col>`` per buffered
        column, each ``ss_capacity + 1`` long, and the scalars
        ``ss{side}_cursor`` (the next sequence number) and ``ss{side}_smax``
        (the side's stream time)."""
        b1 = self.ss_capacity + 1
        out: Dict[str, torch.Tensor] = {}
        for s in ("l", "r"):
            for field, t in ssj.init_ring(b1, dev).items():
                out[f"ss{s}_{field}"] = t
            for col in self.ss_cols[s]:
                out[f"ss{s}_v_{col.name}"] = torch.zeros(b1, dtype=torch_dtype(col.type), device=dev)
                out[f"ss{s}_m_{col.name}"] = torch.zeros(b1, dtype=torch.bool, device=dev)
            out[f"ss{s}_cursor"] = torch.zeros((), dtype=torch.int64, device=dev)
            out[f"ss{s}_smax"] = torch.tensor(_I64_MIN, dtype=torch.int64, device=dev)
        return out

    def _init_agg_state(self, dev) -> Dict[str, torch.Tensor]:
        state = hs.init_store(self.store_layout, dev)
        c1 = self.store_capacity + 1
        if self._needs_seq:
            # the next row's arrival sequence number
            state["agg_seq"] = torch.zeros((), dtype=torch.int64, device=dev)
        if self._having_retract():
            # each slot's last HAVING verdict: pass -> fail emits a tombstone
            state["hpass"] = torch.zeros(c1, dtype=torch.bool, device=dev)
        if self.suppress:
            # EMIT FINAL: the emission clock (stream time over every raw
            # source row), each slot's first touch in lane order (ties in
            # window end emit in creation order), the lanes seen so far, and
            # whether the slot's final result went out (a late record in
            # grace re-dirties an emitted slot, which never emits again)
            state["emit_clock"] = torch.tensor(_I64_MIN, dtype=torch.int64, device=dev)
            state["born"] = torch.full((c1,), _I64_MAX, dtype=torch.int64, device=dev)
            state["row_clock"] = torch.zeros((), dtype=torch.int64, device=dev)
            state["emitted"] = torch.zeros(c1, dtype=torch.bool, device=dev)
        if self.session:
            # each slot is one session (khash, rank): its bounds
            state["sess_start"] = torch.zeros(self.store_capacity + 1, dtype=torch.int64, device=dev)
            state["sess_end"] = torch.zeros(self.store_capacity + 1, dtype=torch.int64, device=dev)
        if self.sliced:
            c1 = self.store_capacity + 1
            # absolute slice index per ring cell (-1 = empty): a combine
            # whose expected index mismatches reads the cell as identity,
            # which is how stale cells of an earlier ring wrap drop out
            state["slice_id"] = torch.full((c1, self.slice_ring), -1, dtype=torch.int64, device=dev)
            # newest slice start folded per key slot (drives eviction)
            state["slast"] = torch.full((c1,), hs.SLAST_NONE, dtype=torch.int64, device=dev)
        return state

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        if self._state is None:
            self.state = self.init_state()
        return self._state

    @state.setter
    def state(self, value: Dict[str, torch.Tensor]) -> None:
        self._state = value
        self.jscratch = {
            self._jtab_key(i): hs.init_table_scratch(jspec.capacity, self.device)
            for i, jspec in enumerate(self.join_chain)
        }
        for key in ("ttab", "fkl", "fkr"):
            if key in value:
                self.jscratch[key] = hs.init_table_scratch(value[key]["occ"].shape[0] - 1,
                                                           self.device)
        if self.store_layout is not None:
            self.scratch = hs.init_scratch(self.store_capacity, self.device)
            if self.sliced:
                spw = W.slices_per_window(self.size_ms, self.slice_width)
                self.scratch.update(slicing.init_slice_scratch(
                    self.store_capacity, self.slice_ring, spw, self.device))

    # ---------------------------------------------------------- the step
    def _source_env(self, arrays: Dict[str, torch.Tensor],
                    layout: Optional[BatchLayout] = None) -> Dict[str, DCol]:
        env: Dict[str, DCol] = {}
        for spec in (layout or self.layout).specs:
            env[spec.name] = DCol(arrays[f"v_{spec.name}"], arrays[f"m_{spec.name}"], spec.sql_type)
        ones = torch.ones(arrays["ts"].shape[0], dtype=torch.bool, device=arrays["ts"].device)
        env["ROWTIME"] = DCol(arrays["ts"], ones, T.BIGINT)
        env["ROWOFFSET"] = DCol(arrays["offset"], ones, T.BIGINT)
        env["ROWPARTITION"] = DCol(arrays["partition"], ones, T.INTEGER)
        return env

    def _apply_ops(self, ops: Sequence[st.ExecutionStep], env: Dict[str, DCol],
                   active: torch.Tensor, n: int) -> Tuple[Dict[str, DCol], torch.Tensor]:
        for op in ops:
            c = TorchExprCompiler(env, n, active.device, self.dictionary)
            if isinstance(op, (st.StreamFilter, st.TableFilter)):
                pred = c.compile(op.predicate)
                active = active & pred.valid & pred.data.to(torch.bool)
            elif isinstance(op, (st.StreamSelectKey, st.TableSelectKey)):
                for col, e in zip(op.schema.key_columns, op.key_expressions):
                    env[col.name] = c.compile(e)
            else:  # StreamSelect, or a TableSelect (after an aggregate, or
                # on a join's table side)
                new_env: Dict[str, DCol] = {}
                src_keys = [k.name for k in op.source.schema.key_columns]
                out_keys = [k.name for k in op.schema.key_columns]
                for new_name, old_name in zip(out_keys, src_keys):
                    if old_name in env:
                        new_env[new_name] = env[old_name]
                for name, e in op.selects:
                    new_env[name] = c.compile(e)
                for p in _PSEUDO:
                    if p in env:
                        new_env[p] = env[p]
                # struct path columns (``ROOT->F``) ride along as the
                # pseudocolumns do: no select can name one
                new_env.update({k: v for k, v in env.items() if "->" in k})
                env = new_env
        return env, active

    def _key_cols(self, env: Dict[str, DCol], n: int, device) -> List[DCol]:
        group_exprs = tuple(getattr(self.group, "group_by_expressions", ()))
        if group_exprs:
            c = TorchExprCompiler(env, n, device, self.dictionary)
            return [c.compile(e) for e in group_exprs]
        # GROUP BY KEY (GroupByKey): the existing key columns
        return [env[col.name] for col in self.group.schema.key_columns]

    @round_program()
    def _step(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state = self.state
        if self.agg is None:
            env = self._source_env(arrays)
            env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], self.capacity)
            if self.join is not None:
                env, active = self._apply_join(env, active, self.capacity, state)
                env, active = self._apply_ops(self.mid_ops, env, active, self.capacity)
            ts = arrays["ts"]
            emits = self._pack_emits(env, active, ts)
            batch_max = torch.where(active, ts, torch.full_like(ts, _I64_MIN)).max()
            torch.maximum(state["max_ts"], batch_max, out=state["max_ts"])
            return emits
        if self.session:
            return self._session_step(arrays)
        emits = self.post_exchange(self.pre_exchange(arrays))
        if self._needs_seq:
            state["agg_seq"] += self.capacity
        return emits

    def pre_exchange(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-row phase: transforms, window assignment (the k-fold hopping
        expansion included), group-key hashing, aggregate contributions
        (K1 does the fixed per-row part).  Under EMIT FINAL, K1 skips its
        grace cut against the stream time at batch start: K17 cuts against
        the running stream time in lane order and also gives the emission
        clock of every raw row (``cm_emit``)."""
        n = self.capacity
        env = self._source_env(arrays)
        env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], n)
        if self.join is not None:
            env, active = self._apply_join(env, active, n, self.state)
            env, active = self._apply_ops(self.mid_ops, env, active, n)
        ts = arrays["ts"]
        key_cols = self._key_cols(env, n, ts.device)
        reprs = torch.stack([_repr64(kc) for kc in key_cols])
        valid = torch.stack([kc.valid for kc in key_cols])
        state = self.state
        wstart, knull, active, khash, base, c0 = hs.row_prologue(
            reprs, valid, ts, active, self.size_ms, self.grace_ms,
            None if self.suppress else state["max_ts"], self.store_capacity,
            advance_ms=self.advance_ms, slice_width=self.slice_width,
            slice_ring=self.slice_ring,
        )
        payload = {}
        if self.suppress:
            active, c0, payload["cm_emit"] = sup.suppress_clock(
                ts, wstart, active, arrays["row_valid"], state["max_ts"], state["emit_clock"],
                self.size_ms, self.grace_ms)
        k = self.expansion
        if k > 1:
            # the expansion route: lane h·n + i is row i's hop h
            env = {name: DCol(W.expand(c.data, k), W.expand(c.valid, k), c.sql_type)
                   for name, c in env.items()}
            reprs = reprs.repeat(1, k)
            ts = W.expand(ts, k)
        nn = n * k
        seq = None
        if self._needs_seq:
            # arrival sequence: one number a row, shared by its hopping
            # copies, so per-(key, window) order follows arrival
            seq = state["agg_seq"] + torch.arange(n, dtype=torch.int64, device=ts.device)
            if k > 1:
                seq = W.expand(seq, k)
        contribs = [c0]
        c = TorchExprCompiler(env, nn, ts.device, self.dictionary)
        for spec in self.agg_specs:
            contribs.extend(spec.device.contribs([c.compile(e) for e in spec.arg_exprs], active, seq))
        payload.update(khash=khash, wstart=wstart, knull=knull, ts=ts, active=active, base=base,
                       reprs=reprs, contribs=contribs)
        return payload

    def post_exchange(self, payload: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """State-owning phase: probe/insert (K2), fold (K3, or the sliced
        ring fold K5), emission of one change per touched key (per touched
        (key, window) on the hopping routes).  Under EMIT FINAL nothing is
        emitted here: K18 decides which windows the batch closes and
        returns them in ``suppress_emit`` (``process_arrays`` emits them)."""
        store = self.state
        active = payload["active"]
        nn = active.shape[0]
        # sliced stores key per GROUP KEY only (the slice ring hangs off the
        # key slot); the other routes key per (group key, window start)
        probe_w = torch.zeros_like(payload["wstart"]) if self.sliced else payload["wstart"]
        slots = hs.probe_insert(
            store, self.scratch, self.store_capacity, payload["base"],
            payload["khash"], probe_w, payload["reprs"], payload["knull"], active,
        )
        if self.sliced:
            slicing.sliced_fold(store, self.scratch, self.store_layout, slots,
                                payload["wstart"], payload["contribs"], active,
                                self.slice_width)
            # the emission mask reads the stream time AT BATCH START: it
            # runs before the max_ts update below
            emits = self._sliced_member_emits(slots, payload, self.members[0])
        else:
            winners = hs.fold_and_mark(
                store, self.scratch, self.store_layout, slots, payload["contribs"], active
            )
            hs.fold_argset(store, self.scratch, self.store_layout, slots, payload["contribs"])
            vec.fold_vectors(store, self.store_layout, slots, payload["contribs"])
            if self.suppress:
                emits = {"emit_mask": torch.zeros(nn, dtype=torch.bool, device=active.device),
                         "suppress_emit": sup.suppress_close(
                             store, self.store_layout, slots, active, payload["cm_emit"],
                             self.size_ms, self.grace_ms, self.retention_ms)}
            else:
                emits = self._emit_agg(slots, winners, nn)
        ts = payload["ts"]
        batch_max = torch.where(active, ts, torch.full_like(ts, _I64_MIN)).max()
        torch.maximum(store["max_ts"], batch_max, out=store["max_ts"])
        # load metrics, read host-side to trigger growth (graves hold
        # probe-chain slots until compaction, so they count)
        emits["occupancy"] = (store["occ"] | store["grave"]).sum()
        emits["graves"] = store["grave"].sum()
        emits["overflow"] = store["overflow"].clone()
        if self.sliced:
            # host mirror of the stream clock (rides the load readback)
            emits["smax_ts"] = store["max_ts"].clone()
        return emits

    # --------------------------------------------------- SESSION aggregation
    def _session_step(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One SESSION batch (the reference's ``_trace_session_step``): the
        per-row phase, then the state-owning phase, which restarts itself
        from the gather when the key's session slots run out."""
        return self.post_session_exchange(self.pre_session_exchange(arrays))

    def pre_session_exchange(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-row phase of the SESSION step (the reference's
        ``pre_session_exchange``): transforms, the group hash and null-key
        drop (K1's session mode), the late drop against the running stream
        time in arrival order (K14's prologue), the contributions
        (component 0 the ts watermark).  A multi-chip path would cut here."""
        n = self.capacity
        env = self._source_env(arrays)
        env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], n)
        ts = arrays["ts"]
        key_cols = self._key_cols(env, n, ts.device)
        reprs = torch.stack([_repr64(kc) for kc in key_cols]).contiguous()
        valid = torch.stack([kc.valid for kc in key_cols]).contiguous()
        active, khash = hs.session_prologue(reprs, valid, active.contiguous())
        active, scal = sess.session_prologue(arrays["row_valid"], ts, active, self.state["max_ts"],
                                             self.grace_ms, self.gap_ms)
        contribs = [torch.where(active, ts, torch.full_like(ts, _I64_MIN))]
        seq = None
        if self._needs_seq:
            seq = self.state["agg_seq"] + torch.arange(n, dtype=torch.int64, device=ts.device)
        c = TorchExprCompiler(env, n, ts.device, self.dictionary)
        for spec in self.agg_specs:
            contribs.extend(spec.device.contribs([c.compile(e) for e in spec.arg_exprs], active, seq))
        return {"khash": khash, "ts": ts, "active": active, "scal": scal, "reprs": reprs,
                "contribs": [x.contiguous() for x in contribs]}

    def post_session_exchange(self, payload: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """State-owning phase of the SESSION step (the reference's
        ``post_session_exchange``): the first active row per key (K13 on the
        rows, K14 first); the stored sessions of those keys gathered (K14
        items), sorted with the rows by (key, start) (K13) and merged (K15);
        then, once ``sess_ovf`` (read with one sync) is 0, the deletes
        (K16), the insert of the merged set (K2) and its write with the
        emission lanes (K16).  On ``sess_ovf > 0`` nothing has been written:
        ``session_slots`` doubles and the batch starts again from the
        gather (the probe identities ``(khash, rank)`` stay valid)."""
        store = self.state
        cap = self.store_capacity
        khash, ts, active = payload["khash"], payload["ts"], payload["active"]
        scal, reprs, contribs = payload["scal"], payload["reprs"], payload["contribs"]
        n = ts.shape[0]
        khs = torch.where(active, khash, torch.zeros_like(khash))
        order0 = sess.seg_sort(khs, torch.zeros_like(khs))
        first_occ = sess.session_first(order0, khash, active)
        comps = self.store_layout.components
        while True:
            S = self.session_slots
            items = sess.session_items(store, cap, S, khash, active, first_occ, ts, reprs,
                                       contribs, self.gap_ms, self.grace_ms, scal)
            perm = sess.seg_sort(items["kh"], items["start"])
            merged = sess.session_merge(items, perm, n, S, self.gap_ms, comps, cap)
            if self._read_sess_ovf(merged) == 0:
                break
            # more concurrent sessions per key than tracked slots
            self.session_slots *= 2
            self.session_grows += 1
        m = perm.shape[0]
        sess.session_delete(store, cap, merged)
        ins_slots = hs.probe_insert(
            store, self.scratch, cap, merged["base"], merged["kh"], merged["rank"],
            merged["ins_reprs"], torch.zeros(m, dtype=torch.int32, device=ts.device),
            merged["ins_act"],
        )
        lanes = sess.session_write(store, cap, merged, ins_slots, scal)
        if self._needs_seq:
            store["agg_seq"] += n
        mask = lanes["mask"]
        nn = 2 * m
        out_env: Dict[str, DCol] = {}
        for k, col in enumerate(self.agg.schema.key_columns):
            out_env[col.name] = DCol(decode_key64(lanes["keys"][k], torch_dtype(col.type)), mask,
                                     col.type)
        lane_comps = lanes["comps"]
        for spec, start in zip(self.agg_specs, self._spec_comp_starts()):
            data, valid = spec.device.finalize(
                [lane_comps[start + t] for t in range(len(spec.device.components))])
            out_env[spec.out_name] = DCol(data, valid & mask, spec.device.result_type)
        out_ts = lane_comps[0]
        ones = torch.ones(nn, dtype=torch.bool, device=ts.device)
        out_env["ROWTIME"] = DCol(out_ts, ones, T.BIGINT)
        out_env["WINDOWSTART"] = DCol(lanes["ws"], ones, T.BIGINT)
        out_env["WINDOWEND"] = DCol(lanes["we"], ones, T.BIGINT)
        out_env, mask = self._apply_ops(self.post_ops, out_env, mask, nn)
        emits = self._pack_emits(out_env, mask, out_ts)
        emits["tombstone"] = lanes["tombstone"]
        emits["ord_a"] = lanes["ord_a"]
        emits["ord_b"] = lanes["ord_b"]
        emits["sess_ovf"] = merged["sess_ovf"]
        emits["occupancy"] = (store["occ"] | store["grave"]).sum()
        emits["graves"] = store["grave"].sum()
        emits["overflow"] = store["overflow"].clone()
        return emits

    def _read_sess_ovf(self, merged: Dict[str, object]) -> int:
        """The one host read of a session batch: how many merged sessions
        did not fit the key's ``session_slots`` (syncs with the card)."""
        return int(merged["sess_ovf"])

    def _spec_comp_starts(self) -> List[int]:
        """Starting store-component index of each aggregate spec
        (component 0 is the per-slot ts watermark)."""
        starts: List[int] = []
        idx = 1
        for spec in self.agg_specs:
            starts.append(idx)
            idx += len(spec.device.components)
        return starts

    def _sliced_member_emits(self, slots: torch.Tensor, payload: Dict[str, torch.Tensor],
                             member: _MemberSpec) -> Dict[str, torch.Tensor]:
        """A member's per-batch emission: every still-open window covering
        a touched slice emits one coalesced change (K7 builds and dedupes
        the window lanes, K6 combines their slices)."""
        width = self.slice_width
        spw = W.slices_per_window(member.size_ms, width)
        k = W.hopping_expansion(member.size_ms, member.advance_ms)
        w_lane, slot_lane, winner = slicing.member_lanes(
            slots, payload["active"], payload["wstart"], self.state["max_ts"],
            self.store_capacity, width, spw, member.advance_ms, member.size_ms,
            member.grace_ms, k, self.scratch,
        )
        exceeded: list = []
        env, row_ts = self._combine_windows(slot_lane, w_lane, member, exceeded)
        emits = self._member_emit(env, row_ts, winner, member, slot_lane.shape[0])
        _add_dec_envelope(emits, exceeded[0])
        return emits

    def _combine_windows(self, slot_lane: torch.Tensor, w_lane: torch.Tensor,
                         member: _MemberSpec, exceeded: Optional[list] = None
                         ) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """Monoid-merge the covering slices of each (slot, window) lane (K6)
        and finalize into an expression env over the aggregate schema;
        ``exceeded`` (a list) receives the lanes' :meth:`_dec_exceeded`."""
        spw = W.slices_per_window(member.size_ms, self.slice_width)
        view = slicing.combine_windows(
            self.state, self.store_layout, len(self.key_types), slot_lane,
            w_lane, spw, self.slice_width,
        )
        if exceeded is not None:
            exceeded.append(self._dec_exceeded(view, member.agg_map))
        return self._finalized_env(view, slot_lane.shape[0], wsize_ms=member.size_ms,
                                   agg_schema=member.agg_schema, agg_map=member.agg_map)

    def _member_emit(self, env: Dict[str, DCol], row_ts: torch.Tensor, mask: torch.Tensor,
                     member: _MemberSpec, nn: int) -> Dict[str, torch.Tensor]:
        """Post-aggregation ops + emission packing for one member."""
        env, mask = self._apply_ops(member.post_ops, env, mask, nn)
        return self._pack_emits(env, mask, row_ts, schema=member.sink_schema)

    def _dec_exceeded(self, view: Dict[str, torch.Tensor],
                      agg_map: Optional[List[int]] = None) -> Optional[torch.Tensor]:
        """Per lane of ``view``, whether an accumulator with an
        ``exact_abs_bound`` (DECIMAL SUM) passed it, so its finalized value
        may have drifted; None when no aggregate has a bound."""
        out = None
        starts = self._spec_comp_starts()
        for j in agg_map if agg_map is not None else range(len(self.agg_specs)):
            bound = self.agg_specs[j].device.exact_abs_bound
            if bound is not None:
                hit = torch.abs(view[f"a{starts[j]}"]) > bound
                out = hit if out is None else out | hit
        return out

    def _finalized_env(self, view: Dict[str, torch.Tensor], nn: int,
                       wsize_ms: Optional[int] = None,
                       agg_schema: Optional[LogicalSchema] = None,
                       agg_map: Optional[List[int]] = None) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """Finalize the store state gathered per lane (``view``, from K6)
        into an env over the aggregate's output schema.  ``wsize_ms``
        overrides the window size for WINDOWEND; ``agg_map`` picks a
        member's aggregates, re-bound to its KSQL_AGG_VARIABLE_<i> names."""
        env: Dict[str, DCol] = {}
        knull = view["knull"]
        for i, col in enumerate((agg_schema or self.agg.schema).key_columns):
            data = view[f"key{i}"]
            valid = ((knull >> i) & 1) == 0
            if col.type.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL):
                data = data.view(torch.float64)
            elif col.type.base not in _HASHED:
                data = data.to(torch_dtype(col.type))
            env[col.name] = DCol(data, valid, col.type)
        row_ts = view["a0"]
        starts = self._spec_comp_starts()
        indices = agg_map if agg_map is not None else range(len(self.agg_specs))
        for i, j in enumerate(indices):
            spec = self.agg_specs[j]
            comps = [view[f"a{starts[j] + t}"] for t in range(len(spec.device.components))]
            fin = spec.device.finalize(comps)
            out_name = spec.out_name if agg_map is None else f"KSQL_AGG_VARIABLE_{i}"
            rt = spec.device.result_type
            if len(fin) == 4:  # a map: (keys [n, K], row valid, present, counts)
                data, _valid, present, counts = fin
                env[out_name] = DCol(data, present, rt, elem_valid=present, aux=counts)
            elif len(fin) == 3:  # an array: (data [n, K], present, element valid)
                data, present, ev = fin
                env[out_name] = DCol(data, present, rt, elem_valid=ev)
            else:
                env[out_name] = DCol(fin[0], fin[1], rt)
        ones = torch.ones(nn, dtype=torch.bool, device=row_ts.device)
        env["ROWTIME"] = DCol(row_ts, ones, T.BIGINT)
        if self.window is not None:
            ws = view["wstart"]
            size = wsize_ms if wsize_ms is not None else self.size_ms
            env["WINDOWSTART"] = DCol(ws, ones, T.BIGINT)
            env["WINDOWEND"] = DCol(ws + size, ones, T.BIGINT)
        return env, row_ts

    def _emit_agg(self, slots: torch.Tensor, mask: torch.Tensor, nn: int,
                  ts_override: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One change per touched slot (``mask``: K3's winners), through
        the post-aggregation ops; with HAVING retraction each filter's
        verdict goes through K19, and the slots that stop passing emit
        tombstones.  ``ts_override``: a table change's emission carries
        the change's timestamp, not the slot's watermark.  Every lane is
        a fresh tensor (K6 gathers), so the store may change after."""
        # vector state is gathered for the winners only (K6's wide mode):
        # no other lane emits
        view = slicing.combine_windows(self.state, self.store_layout, len(self.key_types), slots,
                                       mask=mask)
        env, row_ts = self._finalized_env(view, nn)
        if ts_override is not None:
            row_ts = ts_override
            env["ROWTIME"] = DCol(ts_override, torch.ones(nn, dtype=torch.bool, device=mask.device),
                                  T.BIGINT)
        tomb = None
        hpass = self.state.get("hpass")
        for op in self.post_ops:
            if hpass is not None and isinstance(op, st.TableFilter):
                pred = TorchExprCompiler(env, nn, mask.device, self.dictionary).compile(op.predicate)
                mask, tomb = sup.having_verdict(hpass, slots, mask, pred.data, pred.valid, tomb)
            else:
                env, mask = self._apply_ops([op], env, mask, nn)
        emits = self._pack_emits(env, mask, row_ts)
        if tomb is not None:
            emits["tombstone"] = tomb
        _add_dec_envelope(emits, self._dec_exceeded(view))
        return emits

    def _pack_emits(self, env: Dict[str, DCol], mask: torch.Tensor, ts: torch.Tensor,
                    schema: Optional[LogicalSchema] = None) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {"emit_mask": mask, "emit_ts": ts}
        schema = schema if schema is not None else self._emit_schema()
        for col in schema.columns():
            d = env.get(col.name)
            if d is None:
                raise DeviceUnsupported(f"sink column {col.name} not computed on device")
            out[f"v_{col.name}"] = d.data
            out[f"m_{col.name}"] = d.valid
            if d.data.dim() == 2:  # a vector column: its element null bits
                out[f"e_{col.name}"] = d.elem_valid if d.elem_valid is not None else d.valid
                if d.aux is not None:  # a map column: its per-entry counts
                    out[f"c_{col.name}"] = d.aux
        if self.window is not None and "WINDOWSTART" in env:
            out["ws"] = env["WINDOWSTART"].data
            out["we"] = env["WINDOWEND"].data
        return out

    def _evict(self) -> None:
        # sliced slots are per KEY: a slot expires only once its NEWEST
        # slice left the retention (stale ring cells recycle in place at
        # the next wrap)
        hs.evict(self.state, self.store_layout, self.retention_ms, sliced=self.sliced,
                 suppress=self.suppress)
        self.evictions += 1

    # ------------------------------------------------- table aggregation
    def _ta_side(self, arrays: Dict[str, torch.Tensor], undo: bool):
        """One side of a table-aggregation batch (the reference's
        ``_ta_side`` and its ``_emit_agg``): the pre-ops, the group hash
        (K1, unwindowed), the contributions — negated on the undo side, or
        the spec's ``undo_contribs``; the ts watermark never — then the
        undo side finds its old groups (K8's find mode: a missing group
        means the old row never aggregated, and the row folds into the dump
        slot) while the apply side inserts (K2); K3 folds the scalars and
        marks one winner per slot, the vector groups fold after it (K23's
        removal first on the undo side), and the winners emit with the
        change's timestamp.  Returns ``(emits, rows that reached a group,
        ts)``."""
        n = self.capacity
        cap = self.store_capacity
        store = self.state
        env = self._source_env(arrays)
        env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], n)
        ts = arrays["ts"]
        key_cols = self._key_cols(env, n, ts.device)
        reprs = torch.stack([_repr64(kc) for kc in key_cols]).contiguous()
        valid = torch.stack([kc.valid for kc in key_cols]).contiguous()
        _ws, knull, active, khash, base, c0 = hs.row_prologue(
            reprs, valid, ts, active.contiguous(), 0, 0, store["max_ts"], cap)
        contribs = [c0]
        c = TorchExprCompiler(env, n, ts.device, self.dictionary)
        for spec in self.agg_specs:
            args = [c.compile(e) for e in spec.arg_exprs]
            if undo and spec.device.undo_contribs is not None:
                contribs.extend(spec.device.undo_contribs(args, active))
            else:
                cs = spec.device.contribs(args, active)
                contribs.extend([-x for x in cs] if undo else cs)
        if undo:
            slots = hs.probe_find_slots(store, cap, khash, base, active)
            reached = active & (slots != cap)
        else:
            zeros64 = torch.zeros(n, dtype=torch.int64, device=ts.device)
            slots = hs.probe_insert(store, self.scratch, cap, base, khash, zeros64, reprs, knull,
                                    active)
            reached = active
        slots = torch.where(reached, slots, torch.full_like(slots, cap))
        # K3 folds every active row (a missed undo row into the dump slot, as
        # the reference's full scatter does); its winners are the reached rows'
        winners = hs.fold_and_mark(store, self.scratch, self.store_layout, slots, contribs, active)
        vec.fold_vectors(store, self.store_layout, slots, contribs, vec_undo=undo)
        return self._emit_agg(slots, winners, n, ts_override=ts), reached, ts

    @round_program()
    def _table_agg_step(self, a_new: Dict[str, torch.Tensor],
                        a_old: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One batch of table changes (the reference's
        ``_trace_table_agg_step``): undo every old row, emitting one change
        per touched group as the store stands between the two sides, then
        apply every new row and emit again; the ``2n`` lanes are the undo
        side's, then the apply side's."""
        e_old, act_old, ts_old = self._ta_side(a_old, undo=True)
        e_new, act_new, ts_new = self._ta_side(a_new, undo=False)
        emits = {k: torch.cat([e_old[k], e_new[k]]) for k in e_old}
        store = self.state
        neg = torch.full_like(ts_old, _I64_MIN)
        batch_max = torch.maximum(torch.where(act_old, ts_old, neg).max(),
                                  torch.where(act_new, ts_new, neg).max())
        torch.maximum(store["max_ts"], batch_max, out=store["max_ts"])
        emits["occupancy"] = (store["occ"] | store["grave"]).sum()
        emits["graves"] = store["grave"].sum()
        emits["overflow"] = store["overflow"].clone()
        return emits

    @round_program()
    def _verdict(self, arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The table transform's filter verdict over a batch of OLD rows
        (the reference's ``_trace_verdict``): expression ops only."""
        env = self._source_env(arrays)
        _env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], self.capacity)
        return active

    def process_table_changes(self, new_batch: HostBatch, old_batch: HostBatch,
                              keys: List[tuple], has_new: np.ndarray, has_old: np.ndarray,
                              ts: List[int]) -> List[SinkEmit]:
        """One batch of a table source's changes (``len(keys)`` of them,
        each its key's old and new row, absent where ``has_old`` /
        ``has_new`` is False).  A table aggregation undoes and applies
        them (:meth:`_table_agg_step`), checks the load and decodes the
        lanes in order.  A table transform runs its pipeline over the new
        rows and its verdict over the old ones: a change whose new row
        passes emits it; one whose new row fails, or is a delete, while
        its old row passed emits a tombstone (TableFilter's forwarding)."""
        if self.table_agg:
            a_new = self.layout.encode(new_batch)
            a_old = self.layout.encode(old_batch)
            for arrays, has in ((a_old, has_old), (a_new, has_new)):
                pad = np.zeros(self.capacity, bool)
                pad[: len(keys)] = has
                arrays["row_valid"] = pad
            emits = self._table_agg_step(self.upload(a_new), self.upload(a_old))
            self._react_to_load(emits)
            return self._decode_emits(emits, sort=False)
        emits = self._step(self.upload(self.layout.encode(new_batch)))
        old_ok = np.zeros(len(keys), bool)
        if has_old.any():
            verdict = self._verdict(self.upload(self.layout.encode(old_batch)))
            old_ok = verdict.cpu().numpy()[: len(keys)] & has_old
        emit_mask = emits["emit_mask"].cpu().numpy()
        new_mask = emit_mask[: len(keys)] & has_new
        rows = self._decode_emits(emits, sort=False)
        by_index: Dict[int, SinkEmit] = {}
        for pos, e in zip(np.nonzero(emit_mask)[0], rows):
            if pos < len(keys):
                by_index[int(pos)] = e
        out: List[SinkEmit] = []
        for i, key in enumerate(keys):
            if new_mask[i]:
                e = by_index.get(i)
                if e is not None:
                    out.append(SinkEmit(key, e.row, ts[i], e.window))
            elif old_ok[i]:
                out.append(SinkEmit(key, None, ts[i], None))
        return out

    # ------------------------------- table-table and foreign-key joins
    def _init_tt_store(self, device=None) -> Dict[str, torch.Tensor]:
        """The two-sided store of a primary-key table-table join: one slot
        per key holds BOTH tables' rows, ``{side}_v_<col>`` /
        ``{side}_m_<col>`` per kept column, and each side's liveness
        ``{side}_live`` (a deleted row keeps its slot, not live)."""
        cap = self.tt_store_capacity
        dev = self.device if device is None else device
        s = hs.init_store(hs.StoreLayout(capacity=cap, num_keys=1, components=()), dev)
        for side in ("l", "r"):
            s[f"{side}_live"] = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
            for col in self.tt_cols[side]:
                s[f"{side}_v_{col.name}"] = torch.zeros(cap + 1, dtype=torch_dtype(col.type), device=dev)
                s[f"{side}_m_{col.name}"] = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        return s

    def _init_fk_store(self, side: str, device=None) -> Dict[str, torch.Tensor]:
        """One side's store of a foreign-key join, keyed by the side's own
        key: ``live`` and its kept columns; the left side also holds each
        row's foreign key repr and valid bit (``fkrepr``, ``fkvalid``),
        which K24 scans on a right change."""
        cap = self.fk_store_capacity
        dev = self.device if device is None else device
        s = hs.init_store(hs.StoreLayout(capacity=cap, num_keys=1, components=()), dev)
        s["live"] = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        if side == "l":
            s["fkrepr"] = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
            s["fkvalid"] = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        for col in self.fk_cols[side]:
            s[f"v_{col.name}"] = torch.zeros(cap + 1, dtype=torch_dtype(col.type), device=dev)
            s[f"m_{col.name}"] = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        return s

    def _side_env(self, arrays: Dict[str, torch.Tensor], layout: BatchLayout,
                  ops: Sequence[st.ExecutionStep]) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """A join side's change rows through the side's own ops."""
        env = self._source_env(arrays, layout)
        return self._apply_ops(ops, env, arrays["row_valid"], arrays["ts"].shape[0])

    def _tt_side(self, side: str):
        """(layout, ops, key expression) of one side of the tt join."""
        if side == "l":
            return self.tt_layouts["l"], self.tt_left_ops, self.tt_join.left_key
        return self.tt_layouts["r"], self.tt_right_ops, self.tt_join.right_key

    def _tt_joined_env(self, side: str, env_s: Dict[str, DCol], present_s: torch.Tensor,
                       lanes: Dict[str, torch.Tensor], o_live: torch.Tensor,
                       n: int) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """(joined env, join-valid mask) of one side's change rows against
        the other side's ``lanes`` (K8's gather, valid bits already AND
        ``o_live``)."""
        other = "r" if side == "l" else "l"
        env: Dict[str, DCol] = {}
        for col in self.tt_cols[side]:
            d = env_s.get(col.name)
            if d is None:
                raise DeviceUnsupported(f"join column {col.name} not on device")
            env[col.name] = DCol(d.data, d.valid & present_s, col.type)
        for col in self.tt_cols[other]:
            env[col.name] = DCol(lanes[f"v_{col.name}"], lanes[f"m_{col.name}"], col.type)
        l_p, r_p = (present_s, o_live) if side == "l" else (o_live, present_s)
        jt = self.tt_join.join_type
        if jt == JoinType.INNER:
            jok = l_p & r_p
        elif jt == JoinType.LEFT:
            jok = l_p
        elif jt == JoinType.RIGHT:
            jok = r_p
        else:  # OUTER
            jok = l_p | r_p
        # the result's key column carries the key (valid even when only the
        # other side is present: the change key is always known)
        key_expr = self._tt_side(side)[2]
        kcol = TorchExprCompiler(env_s, n, present_s.device, self.dictionary).compile(key_expr)
        for out_key in self.tt_join.schema.key_columns:
            env[out_key.name] = kcol
        return env, jok

    def _check_tt_compiles(self, active: torch.Tensor, ts: torch.Tensor) -> None:
        for side, other in (("l", "r"), ("r", "l")):
            layout, ops, _key = self._tt_side(side)
            types = {spec.name: spec.sql_type for spec in layout.specs}
            env, act = self._apply_ops(ops, _probe_env({**types, **PSEUDOCOLUMNS}), active, 0)
            lanes = _probe_lanes(self.tt_cols[other])
            jenv, jok = self._tt_joined_env(side, env, act, lanes, active, 0)
            fenv, fok = self._apply_ops(self.pre_ops, jenv, jok, 0)
            self._pack_emits(fenv, fok, ts)

    @round_program()
    def _tt_step(self, side: str, a_new: Dict[str, torch.Tensor],
                 a_old: Dict[str, torch.Tensor]):
        """One batch of side ``side``'s changes (the reference's
        ``_trace_tt_step``): K1's table mode hashes the change key from the
        NEW rows (deletes are key-only new rows); K2 places every change
        with a valid key; K8's gather mode reads the OTHER side at those
        slots before the side is updated (the old and the new rows share
        it); the post-join chain runs over the new rows and its verdict
        over the old ones; K9's side mode writes the side (the last change
        per key wins; a delete clears its liveness).  Returns ``(emits,
        occupancy, overflow)``, the last two device scalars."""
        n = self.capacity
        cap = self.tt_store_capacity
        tt = self.state["ttab"]
        layout, ops, key_expr = self._tt_side(side)
        other = "r" if side == "l" else "l"
        env_new, act_new = self._side_env(a_new, layout, ops)
        env_old, act_old = self._side_env(a_old, layout, ops)
        delete = a_new["delete"] != 0
        dev = delete.device
        kcol = TorchExprCompiler(env_new, n, dev, self.dictionary).compile(key_expr)
        _krepr, touched, slots = self._place_changes("ttab", kcol, a_new["row_valid"])
        lanes, o_live = hs.probe_gather(tt, cap, slots, tt[f"{other}_live"],
                                        [c.name for c in self.tt_cols[other]], f"{other}_")
        jenv_old, jok_old = self._tt_joined_env(side, env_old, act_old & a_old["row_valid"],
                                                lanes, o_live, n)
        jenv_new, jok_new = self._tt_joined_env(side, env_new, act_new & a_new["row_valid"] & ~delete,
                                                lanes, o_live, n)
        fenv_new, fok_new = self._apply_ops(self.pre_ops, jenv_new, jok_new, n)
        _, fok_old = self._apply_ops(self.pre_ops, jenv_old, jok_old, n)
        hs.upsert_side(tt[f"{side}_live"], self.jscratch["ttab"], cap, slots, touched, delete,
                       act_new, [(tt[f"{side}_v_{c.name}"], tt[f"{side}_m_{c.name}"],
                                  env_new[c.name].data, env_new[c.name].valid, True)
                                 for c in self.tt_cols[side]])
        emits = self._pack_emits(fenv_new, fok_new | fok_old, a_new["ts"])
        emits["tombstone"] = ~fok_new
        return emits, (tt["occ"] | tt["grave"]).sum(), tt["overflow"]

    def _join_arrays(self, layout: BatchLayout, new_batch: HostBatch, old_batch: HostBatch,
                     deletes: np.ndarray, has_old: np.ndarray):
        """A batch of join changes as device arrays: the new rows (a
        delete's key-only) with the int32 ``delete`` flags, the old rows
        with ``row_valid`` = ``has_old``."""
        a_new = layout.encode(new_batch)
        pad = np.zeros(self.capacity, np.int32)
        pad[: len(deletes)] = deletes
        a_new["delete"] = pad
        a_old = layout.encode(old_batch)
        ho = np.zeros(self.capacity, bool)
        ho[: len(has_old)] = has_old
        a_old["row_valid"] = ho
        return self.upload(a_new), self.upload(a_old)

    def process_tt(self, side: str, new_batch: HostBatch, old_batch: HostBatch,
                   deletes: np.ndarray, has_old: np.ndarray) -> List[SinkEmit]:
        """Host entry for one single-side batch of table-table join
        changes: the step, the overflow check, the load check (it doubles
        the store when the next batch could pass 0.75) and the emitted
        rows and tombstones, unsorted."""
        a_new, a_old = self._join_arrays(self.tt_layouts[side], new_batch, old_batch, deletes,
                                         has_old)
        ov_before = self.state["ttab"]["overflow"].clone()
        emits, occupancy, overflow = self._tt_step(side, a_new, a_old)
        grew, occupancy = _read_load(overflow, ov_before, occupancy)
        if grew:
            raise QueryRuntimeException(
                f"device table-table join store overflowed; capacity={self.tt_store_capacity}")
        if occupancy + self.capacity > 0.75 * self.tt_store_capacity:
            self._grow_tt()
        return self._decode_emits(emits, sort=False)

    def _rebuild_join_store(self, key: str, init) -> None:
        """Host rebuild of a join store into ``init("cpu")``'s fresh arrays
        (the store's new capacity): every occupied slot re-inserts, a
        deleted key's slot (not live) included."""
        t0 = time.perf_counter()
        new = state_to_numpy(init("cpu"))
        _rebuild_keyed_store(state_to_numpy(self.state[key]), new, new["occ"].shape[0] - 1)
        self.state = {**self.state, key: state_from_numpy(new, self.device)}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.table_rebuild_seconds.append(time.perf_counter() - t0)

    def _grow_tt(self, factor: int = 2) -> None:
        """Double the two-sided store (host rebuild)."""
        self.tt_store_capacity *= factor
        self._rebuild_join_store("ttab", self._init_tt_store)
        self.table_grows += 1

    def _fk_side(self, side: str):
        """(layout, ops, key column) of one side of the fk join."""
        if side == "l":
            return self.fk_layouts["l"], self.fk_left_ops, self.fk_join.left.schema.key_columns[0]
        return self.fk_layouts["r"], self.fk_right_ops, self.fk_join.right.schema.key_columns[0]

    def _fk_joined(self, lenv: Dict[str, DCol], l_present: torch.Tensor,
                   renv: Dict[str, DCol], r_present: torch.Tensor) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """Joined env + join-valid mask: INNER needs both sides, LEFT pads
        the right side."""
        env: Dict[str, DCol] = {}
        for col in self.fk_cols["l"]:
            d = lenv[col.name]
            env[col.name] = DCol(d.data, d.valid & l_present, col.type)
        for col in self.fk_cols["r"]:
            d = renv[col.name]
            env[col.name] = DCol(d.data, d.valid & r_present, col.type)
        jok = l_present & r_present if self.fk_join.join_type == JoinType.INNER else l_present
        return env, jok

    def _check_fk_compiles(self, active: torch.Tensor, ts: torch.Tensor) -> None:
        envs = {}
        for side in ("l", "r"):
            layout, ops, _key = self._fk_side(side)
            types = {spec.name: spec.sql_type for spec in layout.specs}
            envs[side], _ = self._apply_ops(ops, _probe_env({**types, **PSEUDOCOLUMNS}), active, 0)
        TorchExprCompiler(envs["l"], 0, "cpu").compile(self.fk_join.foreign_key_expression)
        lkey = envs["l"][self._fk_side("l")[2].name]
        envs["r"][self._fk_side("r")[2].name]  # the right key reaches the right store
        stored = {side: _probe_env({c.name: c.type for c in self.fk_cols[side]}) for side in "lr"}
        for lenv, renv in ((envs["l"], stored["r"]), (stored["l"], envs["r"])):
            jenv, jok = self._fk_joined(lenv, active, renv, active)
            for out_key in self.fk_join.schema.key_columns:
                jenv[out_key.name] = lkey
            fenv, fok = self._apply_ops(self.pre_ops, jenv, jok, 0)
            self._pack_emits(fenv, fok, ts)

    def _place_changes(self, key: str, kcol: DCol, row_valid: torch.Tensor):
        """A batch of join changes' key ``kcol`` through K1's table mode and
        K2 into the join store ``key`` (window 0, null bits 0, the
        reference's arguments): ``(key repr, touched, slots)``, touched
        being the rows with a valid key."""
        n = self.capacity
        store = self.state[key]
        cap = store["occ"].shape[0] - 1
        krepr = _repr64(kcol).reshape(1, n).contiguous()
        touched, khash, base = hs.table_prologue(krepr, kcol.valid.reshape(1, n).contiguous(),
                                                 row_valid, cap)
        dev = touched.device
        slots = hs.probe_insert(store, self.jscratch[key], cap, base, khash,
                                torch.zeros(n, dtype=torch.int64, device=dev), krepr,
                                torch.zeros(n, dtype=torch.int32, device=dev), touched)
        return krepr[0], touched, slots

    def _fk_write(self, side: str, env_new: Dict[str, DCol], act_new: torch.Tensor,
                  touched: torch.Tensor, slots: torch.Tensor, delete: torch.Tensor,
                  extra: Sequence[hs.SideColumn] = ()) -> None:
        """K9's side mode into the side's store (``extra``: the left
        side's foreign key repr and valid bit, at the same targets)."""
        key = "fkl" if side == "l" else "fkr"
        store = self.state[key]
        cols = [(store[f"v_{c.name}"], store[f"m_{c.name}"], env_new[c.name].data,
                 env_new[c.name].valid, True) for c in self.fk_cols[side]]
        hs.upsert_side(store["live"], self.jscratch[key], self.fk_store_capacity, slots, touched,
                       delete, act_new, cols + list(extra))

    @round_program()
    def _fk_left(self, a_new: Dict[str, torch.Tensor], a_old: Dict[str, torch.Tensor]):
        """One batch of LEFT-table changes (the reference's
        ``_trace_fk_left``): K1 + K2 place each change in ``fkl``; K8's live
        mode finds the right row of the new and of the old foreign key in
        one launch (a deleted right row is found, not live); the chain
        runs over the joined rows; K9's side mode writes the left rows
        with their foreign keys; a left delete tombstones only through a
        chain with no TableFilter.  Returns ``(emits, occupancy,
        overflow)``."""
        n = self.capacity
        cap = self.fk_store_capacity
        fkl, fkr = self.state["fkl"], self.state["fkr"]
        layout, ops, _key = self._fk_side("l")
        env_new, act_new = self._side_env(a_new, layout, ops)
        delete = a_new["delete"] != 0
        kcol = env_new[self._fk_side("l")[2].name]
        _krepr, touched, slots = self._place_changes("fkl", kcol, a_new["row_valid"])
        dev = touched.device
        fk_expr = self.fk_join.foreign_key_expression
        fk_new = TorchExprCompiler(env_new, n, dev, self.dictionary).compile(fk_expr)
        env_old, act_old = self._side_env(a_old, layout, ops)
        has_old = a_old["row_valid"]
        fk_old = TorchExprCompiler(env_old, n, dev, self.dictionary).compile(fk_expr)
        # the right rows of the new and the old foreign key in one K8
        # launch: nothing writes fkr between the reference's two right_of
        sets = [(_repr64(fk).contiguous(), valid, valid)
                for fk, valid in ((f, f.valid.contiguous()) for f in (fk_new, fk_old))]
        (renv_new, rok_new), (renv_old, rok_old) = [
            ({c.name: DCol(lanes[f"v_{c.name}"], lanes[f"m_{c.name}"], c.type)
              for c in self.fk_cols["r"]}, found)
            for lanes, _key0, found in hs.probe_find_live_pair(
                fkr, cap, sets, [c.name for c in self.fk_cols["r"]], fkr["live"])]
        jenv_new, jok_new = self._fk_joined(env_new, act_new & a_new["row_valid"] & ~delete,
                                            renv_new, rok_new)
        for out_key in self.fk_join.schema.key_columns:
            # the result key is the left key: valid for delete rows too
            jenv_new[out_key.name] = kcol
        fenv_new, fok_new = self._apply_ops(self.pre_ops, jenv_new, jok_new, n)
        jenv_old, jok_old = self._fk_joined(env_old, act_old & has_old, renv_old, rok_old)
        for out_key in self.fk_join.schema.key_columns:
            jenv_old[out_key.name] = kcol
        emit = fok_new | self._apply_ops(self.pre_ops, jenv_old, jok_old, n)[1]
        if not any(isinstance(op, st.TableFilter) for op in self.pre_ops):
            # a left delete forwards a (null, null) change, which reaches
            # the sink as a tombstone only through a filter-free chain
            emit = emit | (a_new["row_valid"] & delete & has_old)
        self._fk_write("l", env_new, act_new, touched, slots, delete,
                       [(fkl["fkrepr"], fkl["fkvalid"], _repr64(fk_new), fk_new.valid, False)])
        emits = self._pack_emits(fenv_new, emit, a_new["ts"])
        emits["tombstone"] = ~fok_new
        return emits, (fkl["occ"] | fkl["grave"]).sum(), fkl["overflow"] + fkr["overflow"]

    @round_program()
    def _fk_right(self, a_new: Dict[str, torch.Tensor], a_old: Dict[str, torch.Tensor]):
        """One RIGHT-table change, per record (the reference's
        ``_trace_fk_right``): K1 + K2 + K9's side mode update ``fkr``; K24
        then finds every live left row whose foreign key is the change's
        key, in slot order, and gathers it; the chain runs over those
        lanes, the change's old and new right row broadcast to them; the
        left key decodes by its type.  Returns ``(emits, occupancy,
        overflow)``."""
        fkl, fkr = self.state["fkl"], self.state["fkr"]
        layout, ops, _key = self._fk_side("r")
        env_new, act_new = self._side_env(a_new, layout, ops)
        env_old, act_old = self._side_env(a_old, layout, ops)
        delete = a_new["delete"] != 0
        has_old = a_old["row_valid"]
        krepr, touched, slots = self._place_changes("fkr", env_new[self._fk_side("r")[2].name],
                                                    a_new["row_valid"])
        # the store first: the fan-out reads left rows, and the old and new
        # right values come from this change
        self._fk_write("r", env_new, act_new, touched, slots, delete)
        _lslots, llanes, lkey0 = tj.fk_fanout(fkl, self.fk_store_capacity, krepr, touched,
                                              [c.name for c in self.fk_cols["l"]])
        m = lkey0.shape[0]
        matched = torch.ones(m, dtype=torch.bool, device=lkey0.device)
        lenv = {c.name: DCol(llanes[f"v_{c.name}"], llanes[f"m_{c.name}"], c.type)
                for c in self.fk_cols["l"]}

        def bcast(env_side: Dict[str, DCol], present: torch.Tensor):
            p = present[:1].expand(m)
            return {c.name: DCol(env_side[c.name].data[:1].expand(m),
                                 env_side[c.name].valid[:1].expand(m) & p, c.type)
                    for c in self.fk_cols["r"]}, p

        renv_old, r_old = bcast(env_old, act_old & has_old)
        renv_new, r_new = bcast(env_new, act_new & a_new["row_valid"] & ~delete)
        jenv_old, jok_old = self._fk_joined(lenv, matched, renv_old, r_old)
        jenv_new, jok_new = self._fk_joined(lenv, matched, renv_new, r_new)
        lkey_t = self._fk_side("l")[2].type
        lkey = DCol(decode_key64(lkey0, torch_dtype(lkey_t)), matched, lkey_t)
        for out_key in self.fk_join.schema.key_columns:
            jenv_old[out_key.name] = lkey
            jenv_new[out_key.name] = lkey
        fenv_new, fok_new = self._apply_ops(self.pre_ops, jenv_new, jok_new, m)
        _, fok_old = self._apply_ops(self.pre_ops, jenv_old, jok_old, m)
        emits = self._pack_emits(fenv_new, fok_new | fok_old, a_new["ts"][:1].expand(m))
        emits["tombstone"] = ~fok_new
        return emits, (fkr["occ"] | fkr["grave"]).sum(), fkl["overflow"] + fkr["overflow"]

    def process_fk(self, side: str, new_batch: HostBatch, old_batch: HostBatch,
                   deletes: np.ndarray, has_old: np.ndarray) -> List[SinkEmit]:
        """Host entry for one single-side batch of foreign-key join changes
        (a right change runs alone: its fan-out is store-wide): the step,
        the overflow check, the load check of the side's store (both
        stores double together) and the emits; a right change's in the
        reference's order, by the repr of the left key."""
        a_new, a_old = self._join_arrays(self.fk_layouts[side], new_batch, old_batch, deletes,
                                         has_old)
        ov_before = self.state["fkl"]["overflow"] + self.state["fkr"]["overflow"]
        step = self._fk_left if side == "l" else self._fk_right
        emits, occupancy, overflow = step(a_new, a_old)
        grew, occupancy = _read_load(overflow, ov_before, occupancy)
        if grew:
            raise QueryRuntimeException(
                f"device fk-join store overflowed; capacity={self.fk_store_capacity}")
        if occupancy + self.capacity > 0.75 * self.fk_store_capacity:
            self._grow_fk()
        out = self._decode_emits(emits, sort=False)
        if side == "r":
            out.sort(key=lambda e: repr((_hashable(e.key[0] if len(e.key) == 1 else e.key), e.key)))
        return out

    def _grow_fk(self, factor: int = 2) -> None:
        """Double both fk stores together (host rebuilds)."""
        self.fk_store_capacity *= factor
        self._rebuild_join_store("fkl", lambda dev: self._init_fk_store("l", dev))
        self._rebuild_join_store("fkr", lambda dev: self._init_fk_store("r", dev))
        self.table_grows += 1

    # ------------------------------------------- join table stores (device)
    def _jtab_key(self, idx: int) -> str:
        """State key of probe ``idx``: the outermost store is ``jtab``, the
        inner probes of an n-way chain ``jtab<i>`` (the reference's names)."""
        if idx < 0:
            idx += len(self.join_chain)
        return "jtab" if idx == len(self.join_chain) - 1 else f"jtab{idx}"

    def _init_table_store(self, idx: int = -1, device=None,
                          capacity: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The keyed store of one probe's table: the join key's repr in
        ``key0`` and one ``v_<col>``/``m_<col>`` pair per kept column,
        overwritten last-write-wins (the materialized KTable)."""
        jspec = self.join_chain[idx]
        cap = jspec.capacity if capacity is None else capacity
        dev = self.device if device is None else device
        s = hs.init_store(hs.StoreLayout(capacity=cap, num_keys=1, components=()), dev)
        for col in jspec.cols:
            s[f"v_{col.name}"] = torch.zeros(cap + 1, dtype=torch_dtype(col.type), device=dev)
            s[f"m_{col.name}"] = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        return s

    def _apply_join(self, env: Dict[str, DCol], active: torch.Tensor, n: int,
                    jtabs: Dict[str, Dict[str, torch.Tensor]]) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """Probe each table store in chain order (K8), each probe after its
        between-ops: the table's columns for matches; INNER drops rows that
        do not match, LEFT null-pads them."""
        for idx, jspec in enumerate(self.join_chain):
            env, active = self._apply_ops(jspec.between_ops, env, active, n)
            jtab = jtabs[self._jtab_key(idx)]
            c = TorchExprCompiler(env, n, active.device, self.dictionary)
            kcol = c.compile(jspec.step.left_key)
            lanes, key, found = hs.probe_find(
                jtab, jtab["occ"].shape[0] - 1, _repr64(kcol).contiguous(),
                kcol.valid.contiguous(), active, [col.name for col in jspec.cols],
            )
            if jspec.step.join_type == JoinType.INNER:
                active = found
            for col in jspec.cols:
                env[col.name] = DCol(lanes[f"v_{col.name}"], lanes[f"m_{col.name}"], col.type)
            # the right side's primary key column (stored as its key repr)
            for kc in jspec.step.right.schema.key_columns:
                env[kc.name] = DCol(decode_key64(key, torch_dtype(kc.type)), found, kc.type)
            # the join result's key column carries the join key value
            for out_key in jspec.step.schema.key_columns:
                env[out_key.name] = kcol
        return env, active

    @round_program()
    def _table_step(self, arrays: Dict[str, torch.Tensor], idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fold one table-changelog batch into probe ``idx``'s store in
        place: K1's table mode hashes the key, K2 inserts with window 0 and
        null bits 0 for every row (the reference's arguments, whatever the
        key's validity), K9 writes the last row per key; tombstones leave
        graves.  Returns the store's (occupancy, overflow) device scalars."""
        jspec = self.join_chain[idx]
        key = self._jtab_key(idx)
        jt = self.state[key]
        n = self.capacity
        env = self._source_env(arrays, jspec.layout)
        env, active = self._apply_ops(jspec.table_pre_ops, env, arrays["row_valid"], n)
        kcol = TorchExprCompiler(env, n, active.device, self.dictionary).compile(jspec.step.right_key)
        krepr = _repr64(kcol).reshape(1, n).contiguous()
        cap_t = jspec.capacity
        act, khash, base = hs.table_prologue(
            krepr, kcol.valid.reshape(1, n).contiguous(), active, cap_t)
        zeros64 = torch.zeros(n, dtype=torch.int64, device=active.device)
        zeros32 = torch.zeros(n, dtype=torch.int32, device=active.device)
        slots = hs.probe_insert(jt, self.jscratch[key], cap_t, base, khash, zeros64, krepr,
                                zeros32, act)
        values = {col.name: (env[col.name].data, env[col.name].valid) for col in jspec.cols}
        hs.table_upsert(jt, self.jscratch[key], cap_t, slots, act, arrays["delete"], values)
        return (jt["occ"] | jt["grave"]).sum(), jt["overflow"]

    def process_table(self, batch: HostBatch, deletes: np.ndarray, idx: int = -1) -> None:
        """Host entry for one table-side micro-batch (rows + tombstone
        mask) of join probe ``idx``."""
        if idx < 0:
            idx += len(self.join_chain)
        jspec = self.join_chain[idx]
        arrays = jspec.layout.encode(batch)
        pad = np.zeros(self.capacity, bool)
        pad[: len(deletes)] = deletes
        arrays["delete"] = pad
        occupancy, overflow = self._table_step(self.upload(arrays), idx)
        overflow = int(overflow)
        if overflow > jspec.seen_overflow:
            jspec.seen_overflow = overflow
            raise QueryRuntimeException(
                f"device join-table store overflowed ({overflow} rows); "
                "growth failed to keep pace with key cardinality"
            )
        if int(occupancy) + self.capacity > 0.75 * jspec.capacity:
            self._grow_table(idx=idx)

    def _grow_table(self, factor: int = 2, idx: int = -1) -> None:
        """Double one join table store (host rebuild)."""
        if idx < 0:
            idx += len(self.join_chain)
        jspec = self.join_chain[idx]
        jspec.capacity *= factor
        if idx == len(self.join_chain) - 1:
            self.table_store_capacity = jspec.capacity
        self._rebuild_join_store(self._jtab_key(idx), lambda dev: self._init_table_store(idx, dev))
        self.table_grows += 1

    # ------------------------------------- stream-stream join (device)
    def _ss_ring(self, side: str) -> ssj.Ring:
        return {f: self.state[f"ss{side}_{f}"] for f in ssj.RING_FIELDS}

    def _ss_ring_cols(self, side: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(self.state[f"ss{side}_v_{c.name}"], self.state[f"ss{side}_m_{c.name}"])
                for c in self.ss_cols[side]]

    def _ss_prepare(self, side: str, arrays: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """The side's batch through its pre-ops and join key, K10's count
        against the other side's ring and K11's prologue against its own:
        everything before the host reads the match total and the overwrite
        loss.  Writes no state."""
        ss = self.ss_join
        n = arrays["row_valid"].shape[0]
        layout, pre, key = ((self.layout, self.pre_ops, ss.left_key) if side == "l"
                            else (self.right_layout, self.right_pre_ops, ss.right_key))
        env, active = self._apply_ops(pre, self._source_env(arrays, layout), arrays["row_valid"], n)
        kcol = TorchExprCompiler(env, n, active.device, self.dictionary).compile(key)
        kvalid = kcol.valid.contiguous()
        krepr = _repr64(kcol).contiguous()
        active = active.contiguous()
        ts = arrays["ts"]
        other = "r" if side == "l" else "l"
        count = ssj.ss_match_count(side, krepr, kvalid, active, ts, self._ss_ring(other),
                                   self.ss_before, self.ss_after)
        state = self.state
        pro = ssj.ss_insert_prologue(
            arrays["row_valid"], ts, active, count[1], self._ss_ring(side), state["max_ts"],
            state[f"ss{side}_smax"], state[f"ss{side}_cursor"], pad_side=side in self.ss_pad_sides,
            deferred=self.ss_deferred, swin=self.ss_after if side == "l" else self.ss_before,
            grace=self.ss_grace, retention=self.ss_retention,
        )
        return {"env": env, "active": active, "kcol": kcol, "kvalid": kvalid, "krepr": krepr,
                "count": count, "pro": pro}

    def _ss_write(self, side: str, arrays: Dict[str, torch.Tensor],
                  prep: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """K10's write (the match lanes, the other ring's matched bits) and
        K11's write (the admitted rows into the own ring, both clocks), then
        the step's emission: ``ss_out_cap`` match lanes, then the batch's
        own pads, through the ops above the join."""
        ss = self.ss_join
        env, kcol, kvalid, krepr = prep["env"], prep["kcol"], prep["kvalid"], prep["krepr"]
        count, pro = prep["count"], prep["pro"]
        ts = arrays["ts"]
        n = ts.shape[0]
        oc = self.ss_out_cap
        other = "r" if side == "l" else "l"
        own = [(env[c.name].data.contiguous(), env[c.name].valid.contiguous())
               for c in self.ss_cols[side]]
        lanes = ssj.ss_match(side, krepr, kvalid, prep["active"], ts, self._ss_ring(other),
                             self.ss_before, self.ss_after, count, oc,
                             own + [(kcol.data.contiguous(), kvalid)], self._ss_ring_cols(other))
        state = self.state
        ssj.ss_insert(self._ss_ring(side), self._ss_ring_cols(side), pro, ts, krepr, kvalid,
                      count[1], own, state["max_ts"], state[f"ss{side}_smax"],
                      state[f"ss{side}_cursor"])
        pad = pro["pad"]
        own_lanes, other_lanes = iter(lanes["own"]), iter(lanes["opp"])
        out_env: Dict[str, DCol] = {}
        for s2 in ("l", "r"):
            for col in self.ss_cols[s2]:
                if s2 == side:
                    md, mv = next(own_lanes)
                    d = env[col.name]
                    pdata, pvalid = d.data, d.valid & pad
                else:
                    md, mv = next(other_lanes)
                    pdata = torch.zeros(n, dtype=md.dtype, device=md.device)
                    pvalid = torch.zeros(n, dtype=torch.bool, device=md.device)
                out_env[col.name] = DCol(torch.cat([md, pdata]), torch.cat([mv, pvalid]), col.type)
        kd, kv = lanes["own"][-1]
        for out_key in ss.schema.key_columns:
            out_env[out_key.name] = DCol(torch.cat([kd, kcol.data]), torch.cat([kv, kvalid & pad]),
                                         out_key.type)
        nn = oc + n
        out_ts = torch.cat([lanes["ts"], ts])
        out_env["ROWTIME"] = DCol(out_ts, torch.ones(nn, dtype=torch.bool, device=ts.device), T.BIGINT)
        mask = torch.cat([lanes["mvalid"], pad])
        out_env, mask = self._apply_ops(self.mid_ops, out_env, mask, nn)
        emits = self._pack_emits(out_env, mask, out_ts)
        # the oracle's emission order: per incoming row its matches in
        # buffer (seq) order, then the row's own pad
        emits["ord_a"] = torch.cat([lanes["mi"].to(torch.int64),
                                    torch.arange(n, dtype=torch.int64, device=ts.device)])
        emits["ord_b"] = torch.cat([lanes["ord_b"],
                                    torch.full((n,), _I64_MAX, dtype=torch.int64, device=ts.device)])
        emits["ss_matchovf"] = (count[3] - oc).clamp(min=0)
        emits["ss_lost"] = pro["scal"][0]
        return emits

    def process_ss(self, batch: HostBatch, side: str) -> List[SinkEmit]:
        """One batch of side ``side`` (``"l"`` or ``"r"``) of a
        stream-stream join.  The reference re-runs a step on the old state
        when its matches overflow the lanes or its insert would overwrite
        live entries; the port reads both numbers (one sync) before it
        writes any state: the match lanes double until they hold every
        match, the rings double and the batch starts again on the loss."""
        layout = self.layout if side == "l" else self.right_layout
        arrays = self.upload(layout.encode(batch))
        while True:
            with round_program() as rounds:  # a retry runs the same program again
                prep = self._ss_prepare(side, arrays)
            total, lost = torch.stack([prep["count"][3], prep["pro"]["scal"][0]]).tolist()
            if lost == 0:
                break
            self._grow_ss()
        while total > self.ss_out_cap:
            self.ss_out_cap *= 2
            self.ss_out_grows += 1
        with round_program(rounds):
            lanes = self._ss_write(side, arrays, prep)
        return self._decode_emits(lanes)

    def ss_expire_host(self) -> List[SinkEmit]:
        """Close, pad and evict both rings at the current stream time
        (K12); once per tick, after the tick's batches."""
        return self._decode_emits(self._ss_expire())

    def _ss_expire(self) -> Dict[str, torch.Tensor]:
        """K12 over both rings, then the expiry's emission: every entry of
        the left ring, then of the right, through the ops above the join."""
        ss = self.ss_join
        state = self.state
        key_cols = ss.schema.key_columns
        out = ssj.ss_expire(
            {s: self._ss_ring(s) for s in ("l", "r")},
            {s: self._ss_ring_cols(s) for s in ("l", "r")}, state["max_ts"],
            {s: state[f"ss{s}_smax"] for s in ("l", "r")}, [torch_dtype(k.type) for k in key_cols],
            deferred=self.ss_deferred, pad_sides=self.ss_pad_sides, after=self.ss_after,
            before=self.ss_before, grace=self.ss_grace, retention=self.ss_retention,
        )
        out_ts = out["ts"]
        nn = out_ts.shape[0]
        out_env: Dict[str, DCol] = {}
        for s2 in ("l", "r"):
            for col, (d, v) in zip(self.ss_cols[s2], out[s2]):
                out_env[col.name] = DCol(d, v, col.type)
        for out_key, kd in zip(key_cols, out["keys"]):
            out_env[out_key.name] = DCol(kd, out["key_valid"], out_key.type)
        out_env["ROWTIME"] = DCol(out_ts, torch.ones(nn, dtype=torch.bool, device=out_ts.device),
                                  T.BIGINT)
        out_env, mask = self._apply_ops(self.mid_ops, out_env, out["mask"], nn)
        emits = self._pack_emits(out_env, mask, out_ts)
        # the oracle's on_time order: by ts, left entries before right ones
        emits["ord_a"] = out_ts
        emits["ord_b"] = out["ord_b"]
        return emits

    def _grow_ss(self) -> None:
        """Double both rings (host rebuild): each side's live entries move,
        in seq order, to entries 0..k-1 with seq renumbered 0..k-1 and the
        cursor at k, so the emission order is kept; every other entry, the
        dump entry included, starts zeroed."""
        t0 = time.perf_counter()
        self.ss_capacity *= 2
        b1 = self.ss_capacity + 1
        old = state_to_numpy(self.state)
        new = dict(old)
        for s in ("l", "r"):
            live = np.nonzero(old[f"ss{s}_live"][:-1])[0]
            live = live[np.argsort(old[f"ss{s}_seq"][live])]
            k = live.size
            for key, v in old.items():
                if key.startswith(f"ss{s}_") and v.ndim:
                    new[key] = np.zeros(b1, v.dtype)
                    new[key][:k] = v[live]
            new[f"ss{s}_seq"][:k] = np.arange(k)
            new[f"ss{s}_live"][:k] = True
            new[f"ss{s}_cursor"] = np.asarray(k, np.int64)
        self.state = state_from_numpy(new, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ss_rebuild_seconds.append(time.perf_counter() - t0)
        self.ss_grows += 1

    # ------------------------------------------------------------ host API
    def process(self, batch: HostBatch) -> List[SinkEmit]:
        if self.ss_join is not None:
            return self.process_ss(batch, "l")
        return self.process_arrays(self.layout.encode(batch))

    def flush(self, stream_time: Optional[int] = None) -> List[SinkEmit]:
        """Advance the stream time to ``stream_time`` (when given, else the
        store's ``max_ts``) and emit what closes on time alone (the
        reference's ``flush``/``ss_flush``): a stream-stream join's expiry,
        or an EMIT FINAL store's windows.  The latter is a host scan of the
        store with no horizon test: every dirty window not yet emitted whose
        close (end + grace) is at or before ``stream_time`` emits, in
        ``_emit_slots``' order, and is marked clean and emitted;
        ``emit_clock`` advances to ``stream_time`` even when nothing
        closes.  Other shapes emit nothing."""
        if self.ss_join is not None:
            if stream_time is not None:
                max_ts = self.state["max_ts"]
                torch.clamp_min(max_ts, stream_time, out=max_ts)
            return self.ss_expire_host()
        if not self.suppress:
            return []
        state = self.state
        if stream_time is None:
            stream_time = int(state["max_ts"])
        occ, dirty, emitted, ws = (state[k].cpu().numpy()
                                   for k in ("occ", "dirty", "emitted", "wstart"))
        closed = occ & dirty & ~emitted & (ws + self.size_ms + self.grace_ms <= stream_time)
        torch.clamp_min(state["emit_clock"], stream_time, out=state["emit_clock"])
        idx = np.nonzero(closed)[0]
        if idx.size == 0:
            return []
        result = self._emit_slots(idx)
        slots = torch.from_numpy(idx).to(self.device)
        state["dirty"][slots] = False
        state["emitted"][slots] = True
        return result

    def _emit_slots(self, idx: np.ndarray) -> List[SinkEmit]:
        """Emit the store slots ``idx`` (the windows an EMIT FINAL batch or
        flush closes): ordered by window start (every window has the same
        size, so by window end), then by first touch (``born``), gathered
        (K6's plain mode), finalized, through the post-aggregation ops
        (HAVING as a plain filter) and decoded in that order."""
        if idx.size == 0:
            return []
        dev_idx = torch.from_numpy(idx).to(self.device)
        ws, born = torch.stack([self.state["wstart"][dev_idx],
                                self.state["born"][dev_idx]]).cpu().numpy()
        idx = idx[np.lexsort((born, ws))]
        slots = torch.from_numpy(idx.astype(np.int32)).to(self.device)
        view = slicing.combine_windows(self.state, self.store_layout, len(self.key_types), slots)
        env, row_ts = self._finalized_env(view, idx.size)
        mask = torch.ones(idx.size, dtype=torch.bool, device=self.device)
        env, mask = self._apply_ops(self.post_ops, env, mask, idx.size)
        emits = self._pack_emits(env, mask, row_ts)
        _add_dec_envelope(emits, self._dec_exceeded(view))
        return self._decode_emits(emits, sort=False)

    def upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    def process_arrays(self, arrays: Dict[str, np.ndarray]) -> List[SinkEmit]:
        """One encoded micro-batch through the device step.  Under EMIT
        FINAL the windows the step closed are emitted before the retention
        pass and the load check, which remap or reset slots; such a batch
        is never pipelined."""
        if self.sliced:
            self.ensure_ring_for(arrays["ts"], arrays["row_valid"])
        emits = self._step(self.upload(arrays))
        result: Optional[List[SinkEmit]] = None
        if self.suppress:
            result = self._emit_slots(emits["suppress_emit"].nonzero().squeeze(1).cpu().numpy())
        if self.agg is not None:
            self._batches += 1
            if self.retention_ms is not None and self._batches % self.EVICT_INTERVAL == 0:
                self._evict()
        if result is not None:
            self._react_to_load(emits)
            return result
        if self.pipeline and not self.session:
            # a session batch's emits return at once (the reference never
            # pipelines sessions)
            emits, self._pending_emits = self._pending_emits, emits
            if emits is None:
                return []
            # sample the load check: int() syncs with the card, and the
            # 0.75-occupancy threshold leaves several batches of headroom
            if self.agg is not None and self._batches % 4 == 0:
                self._react_to_load(emits)
        elif self.agg is not None:
            self._react_to_load(emits)
        return self._decode_emits(emits)

    def flush_pipeline(self) -> List[SinkEmit]:
        """Decode the deferred batch (poll-tick boundary)."""
        emits, self._pending_emits = self._pending_emits, None
        if emits is None:
            return []
        if self.agg is not None:
            self._react_to_load(emits)
        return self._decode_emits(emits)

    def _react_to_load(self, emits: Dict[str, torch.Tensor]) -> None:
        """Grow the store before it can overflow (and fail loudly if it
        somehow did — slot exhaustion drops aggregates)."""
        if "smax_ts" in emits:
            self._mirror_max_ts = max(self._mirror_max_ts, int(emits["smax_ts"]))
        overflow = int(emits["overflow"])
        if overflow > self._seen_overflow:
            self._seen_overflow = overflow
            raise QueryRuntimeException(
                f"device state store overflowed ({overflow} rows lost); "
                f"store_capacity={self.store_capacity} is undersized for the "
                "key×window cardinality"
            )
        occupancy = int(emits["occupancy"])
        headroom = self.capacity * self.expansion
        if self.pipeline:
            headroom *= 4  # load checks are sampled every 4th batch
        if occupancy + headroom > 0.75 * self.store_capacity:
            if self.retention_ms is not None:
                # evict expired windows now, then compact the tombstones
                # away in place; grow only if still dense with LIVE entries
                self._evict()
                live = self._grow(factor=1)
                if live + headroom > 0.5 * self.store_capacity:
                    self._grow()
            else:
                self._grow()

    def _grow(self, factor: int = 2) -> int:
        """Rebuild the store on the host (numpy reinsert of live slots with
        ``host_insert``), dropping tombstones; factor=1 compacts in place,
        factor>1 also multiplies the capacity.  Returns the live slots."""
        t0 = time.perf_counter()
        # the join table stores are sized on their own: they carry over
        jtabs = {k: v for k, v in self.state.items() if isinstance(v, dict)}
        old = state_to_numpy({k: v for k, v in self.state.items() if k not in jtabs})
        self.store_capacity *= factor
        self.store_layout = dataclasses.replace(self.store_layout, capacity=self.store_capacity)
        new = state_to_numpy(self.init_state("cpu", tables=False))
        live = _rebuild_keyed_store(old, new, self.store_capacity)
        self.state = {**state_from_numpy(new, self.device), **jtabs}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rebuild_seconds.append(time.perf_counter() - t0)
        if factor == 1:
            self.compactions += 1
        else:
            self.grows += 1
        return live

    def _decode_emits(self, emits: Dict[str, torch.Tensor], sort: bool = True) -> List[SinkEmit]:
        """The emitted lanes as SinkEmits, in the reference's order: by
        ``ord_a``/``ord_b`` when present, else by (ts, window start) unless
        ``sort`` is False (the lanes are already in emission order).  A
        tombstone lane decodes with ``row = None``.  A DECIMAL SUM past
        its exactness envelope on an emitted lane raises instead."""
        if "dec_envelope" in emits:
            n_drift = int(emits["dec_envelope"].sum())
            if n_drift:
                # never emit a silently drifted decimal sum
                raise QueryRuntimeException(
                    f"DECIMAL SUM exceeded the 2^53-exact envelope on "
                    f"{n_drift} emitted aggregate(s); rerun this query on "
                    "the oracle backend (ksql.runtime.backend=oracle) for "
                    "unbounded decimal arithmetic"
                )
        idx_dev = emits["emit_mask"].nonzero().squeeze(1)
        if idx_dev.numel() == 0:
            return []
        schema = self._emit_schema()

        def host(name: str) -> np.ndarray:
            return emits[name][idx_dev].cpu().numpy()

        ordered = "ord_a" in emits
        if ordered:  # an explicit emission order (the join's match/expiry sequencing)
            order = np.lexsort((host("ord_b"), host("ord_a")))
            idx_dev = idx_dev[torch.from_numpy(order).to(idx_dev.device)]

        cols: Dict[str, list] = {}
        for col in schema.columns():
            if emits[f"v_{col.name}"].dim() == 2:
                cols[col.name] = self._decode_vectors(emits, host, col)
                continue
            cols[col.name] = decode_value(
                host(f"v_{col.name}"), host(f"m_{col.name}"), col.type, self.dictionary
            )
        ts = host("emit_ts")
        ws = host("ws") if "ws" in emits else None
        we = host("we") if "we" in emits else None
        tomb = host("tombstone") if "tombstone" in emits else None
        out: List[SinkEmit] = []
        key_names = [c.name for c in schema.key_columns]
        val_names = [c.name for c in schema.value_columns]
        collapse_null_keys = self.agg is None and self.join is None and self.ss_join is None
        for j in range(len(ts)):
            key = tuple(cols[kn][j] for kn in key_names)
            if collapse_null_keys and key and all(k is None for k in key):
                # key passthrough of a null-key record: the oracle carries
                # an empty key tuple, which the sink writes as a null key
                key = ()
            if tomb is not None and tomb[j]:
                row = None  # a session merged away, or a HAVING retraction
            else:
                row = {kn: cols[kn][j] for kn in key_names}
                row.update({vn: cols[vn][j] for vn in val_names})
            window = (int(ws[j]), int(we[j])) if ws is not None else None
            out.append(SinkEmit(key, row, int(ts[j]), window))
        if sort and not ordered:
            # ts-major, window-start-minor: the reference's emission order
            if self.collect_raw_emits:
                # keep the permutation: the raw block below stays row-aligned
                order = sorted(range(len(out)), key=lambda j: (out[j].ts, out[j].window or (0, 0)))
                out = [out[j] for j in order]
                idx_dev = idx_dev[torch.as_tensor(order, dtype=torch.int64, device=idx_dev.device)]
            else:
                out.sort(key=lambda e: (e.ts, e.window or (0, 0)))
        if self.collect_raw_emits:
            # the push registry's handoff: the batch's scalar emit columns
            # gathered on the device in final emit order (2-D columns are
            # skipped: a span that needs one is columnarized on the host)
            self.last_raw_block = {
                "cols": {c.name: (emits[f"v_{c.name}"][idx_dev], emits[f"m_{c.name}"][idx_dev])
                         for c in schema.columns() if emits[f"v_{c.name}"].dim() == 1},
                "ts": emits["emit_ts"][idx_dev],
                "row_none": np.fromiter((e.row is None for e in out), bool, count=len(out)),
                "n": len(out),
                # the emit list this block is aligned with (the dispatcher
                # checks it)
                "emits_id": id(out),
            }
        return out


    def _decode_vectors(self, emits: Dict[str, torch.Tensor], host, col) -> list:
        """An ARRAY column's emitted lanes as lists of their present
        elements, or a MAP column's (``c_<col>``) as dicts of present key →
        count, in entry order; string elements decode through the
        dictionary (the reference's ``_decode_emits``)."""
        data, present = host(f"v_{col.name}"), host(f"m_{col.name}")
        flat = present.reshape(-1)
        bounds = np.cumsum(present.sum(axis=1))[:-1]
        if f"c_{col.name}" in emits:
            keys = decode_value(data.reshape(-1)[flat], np.ones(int(flat.sum()), bool),
                                col.type.key or col.type.element, self.dictionary)
            counts = host(f"c_{col.name}").reshape(-1)[flat]
            return [dict(zip(kp, (int(x) for x in vp)))
                    for kp, vp in zip(np.split(np.asarray(keys, object), bounds),
                                      np.split(counts, bounds))]
        elems = decode_value(data.reshape(-1)[flat], host(f"e_{col.name}").reshape(-1)[flat],
                             col.type.element, self.dictionary)
        # an element-wise object array: equal-length list elements must not
        # become a 2-D array
        objs = np.empty(len(elems), object)
        for i, v in enumerate(elems):
            objs[i] = v
        return [list(part) for part in np.split(objs, bounds)]


def _add_dec_envelope(emits: Dict[str, torch.Tensor], exceeded: Optional[torch.Tensor]) -> None:
    """The emitted lanes whose DECIMAL SUM passed its exactness envelope,
    counted into ``emits["dec_envelope"]`` (a 1-element int64 tensor, so
    a table aggregation's two sides concatenate); nothing when no
    aggregate has an envelope."""
    if exceeded is not None:
        emits["dec_envelope"] = (exceeded & emits["emit_mask"]).sum().reshape(1)


def _read_load(overflow: torch.Tensor, before: torch.Tensor, occupancy: torch.Tensor) -> Tuple[bool, int]:
    """(whether ``overflow`` passed ``before``, the occupancy) of a join
    step, read back in one transfer."""
    grew, occ = torch.stack([overflow - before, occupancy]).tolist()
    return grew > 0, occ


def _probe_lanes(cols) -> Dict[str, torch.Tensor]:
    """Empty gathered lanes (``v_<col>``/``m_<col>``) of ``cols``."""
    out = {}
    for c in cols:
        out[f"v_{c.name}"] = torch.zeros(0, dtype=torch_dtype(c.type))
        out[f"m_{c.name}"] = torch.zeros(0, dtype=torch.bool)
    return out


def _probe_env(types) -> Dict[str, DCol]:
    return {
        name: DCol(torch.zeros(0, dtype=torch_dtype(t)), torch.zeros(0, dtype=torch.bool), t)
        for name, t in types.items()
    }
