"""TorchCompiledQuery — runs a physical plan's device step on the card.

The port of ``ksql_tpu/runtime/lowering.py``'s ``CompiledDeviceQuery`` for
the plan shapes of this slice:

    Source → Filter*/Select* → [GroupBy → Aggregate (unwindowed or
    TUMBLING) → TableSelect*] → Sink

with COUNT(*), COUNT, SUM, AVG, MIN and MAX (``ops/device_aggs.py``), plus
the stateless filter/project pipelines.  Every other shape raises
:class:`DeviceUnsupported` at construction: hopping and session windows,
joins, flat-maps, PARTITION BY, EMIT FINAL, HAVING, table sources and
table aggregation, vector and arg-set aggregates.

Where the reference traces one jitted step, the port runs eagerly: the
expression phases are torch tensor ops, and the keyed store goes through
the four CUDA kernels of ``ops/hash_store.py`` (row_prologue, probe_insert,
fold_and_mark, evict).  The store is updated IN PLACE; every emitted lane
is a fresh tensor (a gather or a batch column), never a view of a store
column, so a pipelined batch's emits stay valid while the next batch
mutates the store.

Semantics are the reference's, including its documented deltas from the
row oracle: EMIT CHANGES coalesces to one change per key per micro-batch,
and late-record grace is judged against the stream time at batch start.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.batch import HostBatch
from ksql_tpu_torch.common.errors import QueryRuntimeException
from ksql_tpu_torch.common.schema import PSEUDOCOLUMNS, LogicalSchema
from ksql_tpu_torch.common.types import SqlBaseType
from ksql_tpu_torch.compiler.torch_expr import (
    DCol,
    DeviceUnsupported,
    TorchExprCompiler,
    _HASHED,
    _repr64,
    torch_dtype,
)
from ksql_tpu_torch.execution import expressions as ex
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops.device_aggs import DeviceAgg, compile_device_agg, resolve_udaf
from ksql_tpu_torch.parser.ast_nodes import WindowType
from ksql_tpu_torch.runtime.device import BatchLayout, DictionaryServer, decode_value
from ksql_tpu_torch.runtime.sink import SinkEmit
from ksql_tpu_torch.state import resolve_device, state_from_numpy, state_to_numpy

#: the reference's legacy default grace for EMIT CHANGES windows (24 h)
DEFAULT_GRACE_MS = 24 * 3600 * 1000
_I64_MIN = np.iinfo(np.int64).min
_PSEUDO = ("ROWTIME", "ROWOFFSET", "ROWPARTITION", "WINDOWSTART", "WINDOWEND")


@dataclasses.dataclass
class _AggSpec:
    fname: str
    arg_exprs: Tuple[ex.Expression, ...]
    device: DeviceAgg
    out_name: str


def _refs_of_ops(ops) -> set:
    """Source columns referenced anywhere in a step chain."""
    out: set = set()
    for s in ops:
        if hasattr(s, "predicate"):
            out.update(ex.referenced_columns(s.predicate))
        for _, e in getattr(s, "selects", ()):
            out.update(ex.referenced_columns(e))
    return out


class TorchCompiledQuery:
    """A query lowered to the port's device path.

    Host API: ``process(HostBatch)`` / ``process_arrays(encoded arrays)``
    return the decoded ``SinkEmit``s of a micro-batch; ``state`` is the
    dict of device tensors (the reference's state pytree, same keys and
    dtypes).  ``device`` defaults to ``cuda`` and raises when there is no
    card; tests pass ``device="cpu"``, which runs the kernels' plain twins.
    """

    EVICT_INTERVAL = 64  # batches between retention passes
    #: when True (batched mode), emission decode lags one batch so host
    #: encode of batch i+1 overlaps device work of batch i
    pipeline = False

    def __init__(self, plan: st.QueryPlan, capacity: int = 8192,
                 store_capacity: int = 1 << 17, device=None):
        self.device = resolve_device(device)
        self.plan = plan
        self.capacity = capacity
        self.store_capacity = store_capacity
        self.dictionary = DictionaryServer()
        self.sink: Optional[st.ExecutionStep] = None
        self.post_ops: List[st.ExecutionStep] = []  # TableSelect (after the aggregate)
        self.agg: Optional[st.ExecutionStep] = None
        self.group: Optional[st.ExecutionStep] = None
        self.pre_ops: List[st.ExecutionStep] = []  # StreamFilter/StreamSelect
        self.source: Optional[st.StreamSource] = None
        self._analyze(plan.physical_plan)

        self.window = getattr(self.agg, "window", None) if self.agg is not None else None
        self.size_ms = 0
        self.grace_ms = 0
        self.retention_ms: Optional[int] = None
        if self.window is not None:
            if self.window.window_type != WindowType.TUMBLING:
                raise DeviceUnsupported(f"{self.window.window_type.value} windows on device")
            self.size_ms = self.window.size_ms
            grace = self.window.grace_ms
            self.grace_ms = grace if grace is not None else DEFAULT_GRACE_MS
            # windowed-store retention (KS: max(explicit retention, size+grace))
            self.retention_ms = max(self.window.retention_ms or 0, self.size_ms + self.grace_ms)

        self.agg_specs: List[_AggSpec] = []
        self.key_types = []
        if self.agg is not None:
            self._build_agg_specs()
        self._build_ingress_layout()

        self.store_layout: Optional[hs.StoreLayout] = None
        if self.agg is not None:
            comps = [hs.AggComponent("max", "int64", _I64_MIN)]
            for spec in self.agg_specs:
                comps.extend(spec.device.components)
            self.store_layout = hs.StoreLayout(
                capacity=store_capacity, num_keys=len(self.key_types),
                components=tuple(comps), windowed=self.window is not None,
            )
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self.scratch: Dict[str, torch.Tensor] = {}
        self._pending_emits: Optional[Dict[str, torch.Tensor]] = None
        self._batches = 0
        self._seen_overflow = 0
        #: host-side counters of the store's maintenance (read by the chip
        #: check): retention passes, compactions, capacity doublings and
        #: the wall seconds of each rebuild
        self.evictions = 0
        self.compactions = 0
        self.grows = 0
        self.rebuild_seconds: List[float] = []
        self._check_compiles()

    # ------------------------------------------------------------ analysis
    def _analyze(self, step: st.ExecutionStep) -> None:
        cur = step
        if not isinstance(cur, (st.StreamSink, st.TableSink)):
            raise DeviceUnsupported("plan without sink")
        self.sink = cur
        cur = cur.source
        if isinstance(cur, st.TableSuppress):
            raise DeviceUnsupported("EMIT FINAL on device")
        while isinstance(cur, (st.TableSelect, st.TableFilter)):
            if isinstance(cur, st.TableFilter):
                raise DeviceUnsupported("HAVING / table filter on device")
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
        elif self.post_ops:
            raise DeviceUnsupported("table transforms without aggregation on device")
        while isinstance(cur, (st.StreamFilter, st.StreamSelect)):
            self.pre_ops.append(cur)
            cur = cur.source
        self.pre_ops.reverse()
        if not isinstance(cur, st.StreamSource) or isinstance(cur, st.WindowedStreamSource):
            raise DeviceUnsupported(f"device source {type(cur).__name__}")
        self.source = cur

    def _pre_agg_schema(self) -> LogicalSchema:
        return self.pre_ops[-1].schema if self.pre_ops else self.source.schema

    def _emit_schema(self) -> LogicalSchema:
        return self.sink.schema

    def _build_agg_specs(self) -> None:
        types = {c.name: c.type for c in self._pre_agg_schema().columns()}
        probe = _probe_env({**types, **PSEUDOCOLUMNS})
        for i, call in enumerate(self.agg.aggregations):
            if call.distinct:
                raise DeviceUnsupported("DISTINCT aggregation on device")
            c = TorchExprCompiler(probe, 0, "cpu")
            arg_types = [c.compile(a).sql_type for a in call.args]
            kind, result_type = resolve_udaf(call.function, arg_types)
            self.agg_specs.append(_AggSpec(
                call.function, tuple(call.args),
                compile_device_agg(kind, arg_types, result_type),
                f"KSQL_AGG_VARIABLE_{i}",
            ))
        self.key_types = [c.type for c in self.agg.schema.key_columns]
        if len(self.key_types) > 16:
            raise DeviceUnsupported("more than 16 grouping columns on device")

    def _build_ingress_layout(self) -> None:
        """The ingress BatchLayout: only the columns the pipeline reads."""
        needed = _refs_of_ops(self.pre_ops)
        if self.group is not None:
            for e in getattr(self.group, "group_by_expressions", ()):
                needed.update(ex.referenced_columns(e))
        for spec in self.agg_specs:
            for e in spec.arg_exprs:
                needed.update(ex.referenced_columns(e))
        src_schema = self.source.schema
        if self.agg is None:
            needed.update(c.name for c in self._emit_schema().columns())
        needed &= {c.name for c in src_schema.columns()}
        needed.update(c.name for c in src_schema.key_columns)
        self.layout = BatchLayout(src_schema, sorted(needed), self.capacity, self.dictionary)

    def _check_compiles(self) -> None:
        """Compile every expression of the plan on empty CPU columns, so an
        expression the port does not lower raises DeviceUnsupported here,
        before any batch (the reference's construction-time trace)."""
        types = {spec.name: spec.sql_type for spec in self.layout.specs}
        env = _probe_env({**types, **PSEUDOCOLUMNS})
        active = torch.zeros(0, dtype=torch.bool)
        ts = torch.zeros(0, dtype=torch.int64)
        env, active = self._apply_ops(self.pre_ops, env, active, 0)
        if self.agg is None:
            self._pack_emits(env, active, ts)
            return
        self._key_cols(env, 0, "cpu")
        c = TorchExprCompiler(env, 0, "cpu")
        for spec in self.agg_specs:
            spec.device.contribs([c.compile(a) for a in spec.arg_exprs], active)
        fin = {c2.name: c2.type for c2 in self.agg.schema.key_columns}
        fin.update({spec.out_name: spec.device.result_type for spec in self.agg_specs})
        fin["ROWTIME"] = T.BIGINT
        if self.window is not None:
            fin.update(WINDOWSTART=T.BIGINT, WINDOWEND=T.BIGINT)
        env, active = self._apply_ops(self.post_ops, _probe_env(fin), active, 0)
        self._pack_emits(env, active, ts)

    # --------------------------------------------------------------- state
    def init_state(self) -> Dict[str, torch.Tensor]:
        if self.store_layout is None:
            return {"max_ts": torch.tensor(_I64_MIN, dtype=torch.int64, device=self.device)}
        return hs.init_store(self.store_layout, self.device)

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        if self._state is None:
            self.state = self.init_state()
        return self._state

    @state.setter
    def state(self, value: Dict[str, torch.Tensor]) -> None:
        self._state = value
        if self.store_layout is not None:
            self.scratch = hs.init_scratch(self.store_capacity, self.device)

    # ---------------------------------------------------------- the step
    def _source_env(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, DCol]:
        env: Dict[str, DCol] = {}
        for spec in self.layout.specs:
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
            if isinstance(op, st.StreamFilter):
                pred = c.compile(op.predicate)
                active = active & pred.valid & pred.data.to(torch.bool)
            else:  # StreamSelect, or the TableSelect after an aggregate
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
                env = new_env
        return env, active

    def _key_cols(self, env: Dict[str, DCol], n: int, device) -> List[DCol]:
        group_exprs = tuple(getattr(self.group, "group_by_expressions", ()))
        if group_exprs:
            c = TorchExprCompiler(env, n, device, self.dictionary)
            return [c.compile(e) for e in group_exprs]
        # GROUP BY KEY (GroupByKey): the existing key columns
        return [env[col.name] for col in self.group.schema.key_columns]

    def _step(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state = self.state
        if self.agg is None:
            env = self._source_env(arrays)
            env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], self.capacity)
            ts = arrays["ts"]
            emits = self._pack_emits(env, active, ts)
            batch_max = torch.where(active, ts, torch.full_like(ts, _I64_MIN)).max()
            torch.maximum(state["max_ts"], batch_max, out=state["max_ts"])
            return emits
        return self.post_exchange(self.pre_exchange(arrays))

    def pre_exchange(self, arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-row phase: transforms, window assignment, group-key hashing,
        aggregate contributions (K1 does the fixed per-row part)."""
        n = self.capacity
        env = self._source_env(arrays)
        env, active = self._apply_ops(self.pre_ops, env, arrays["row_valid"], n)
        ts = arrays["ts"]
        key_cols = self._key_cols(env, n, ts.device)
        reprs = torch.stack([_repr64(kc) for kc in key_cols])
        valid = torch.stack([kc.valid for kc in key_cols])
        wstart, knull, active, khash, base, c0 = hs.row_prologue(
            reprs, valid, ts, active, self.size_ms, self.grace_ms,
            self.state["max_ts"], self.store_capacity,
        )
        contribs = [c0]
        c = TorchExprCompiler(env, n, ts.device, self.dictionary)
        for spec in self.agg_specs:
            contribs.extend(spec.device.contribs([c.compile(e) for e in spec.arg_exprs], active))
        return {"khash": khash, "wstart": wstart, "knull": knull, "ts": ts,
                "active": active, "base": base, "reprs": reprs, "contribs": contribs}

    def post_exchange(self, payload: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """State-owning phase: probe/insert (K2), fold + winners (K3),
        emission of one change per touched key."""
        store = self.state
        active = payload["active"]
        slots = hs.probe_insert(
            store, self.scratch, self.store_capacity, payload["base"],
            payload["khash"], payload["wstart"], payload["reprs"],
            payload["knull"], active,
        )
        winners = hs.fold_and_mark(
            store, self.scratch, self.store_layout, slots, payload["contribs"], active
        )
        ts = payload["ts"]
        batch_max = torch.where(active, ts, torch.full_like(ts, _I64_MIN)).max()
        torch.maximum(store["max_ts"], batch_max, out=store["max_ts"])
        emits = self._emit_agg(slots, winners, active.shape[0])
        # load metrics, read host-side to trigger growth (graves hold
        # probe-chain slots until compaction, so they count)
        emits["occupancy"] = (store["occ"] | store["grave"]).sum()
        emits["graves"] = store["grave"].sum()
        emits["overflow"] = store["overflow"].clone()
        return emits

    def _finalized_env(self, slots: torch.Tensor, nn: int) -> Tuple[Dict[str, DCol], torch.Tensor]:
        """Gather + finalize store state at ``slots`` into an env over the
        aggregate's output schema."""
        store = self.state
        idx = slots.long()
        env: Dict[str, DCol] = {}
        knull = store["knull"][idx]
        for i, col in enumerate(self.agg.schema.key_columns):
            data = store[f"key{i}"][idx]
            valid = ((knull >> i) & 1) == 0
            if col.type.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL):
                data = data.view(torch.float64)
            elif col.type.base not in _HASHED:
                data = data.to(torch_dtype(col.type))
            env[col.name] = DCol(data, valid, col.type)
        row_ts = store["a0"][idx]
        base = 1
        for spec in self.agg_specs:
            ncomp = len(spec.device.components)
            comps = [store[f"a{base + t}"][idx] for t in range(ncomp)]
            base += ncomp
            data, valid = spec.device.finalize(comps)
            env[spec.out_name] = DCol(data, valid, spec.device.result_type)
        ones = torch.ones(nn, dtype=torch.bool, device=slots.device)
        env["ROWTIME"] = DCol(row_ts, ones, T.BIGINT)
        if self.window is not None:
            ws = store["wstart"][idx]
            env["WINDOWSTART"] = DCol(ws, ones, T.BIGINT)
            env["WINDOWEND"] = DCol(ws + self.size_ms, ones, T.BIGINT)
        return env, row_ts

    def _emit_agg(self, slots: torch.Tensor, mask: torch.Tensor, nn: int) -> Dict[str, torch.Tensor]:
        env, row_ts = self._finalized_env(slots, nn)
        env, mask = self._apply_ops(self.post_ops, env, mask, nn)
        return self._pack_emits(env, mask, row_ts)

    def _pack_emits(self, env: Dict[str, DCol], mask: torch.Tensor,
                    ts: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {"emit_mask": mask, "emit_ts": ts}
        for col in self._emit_schema().columns():
            d = env.get(col.name)
            if d is None:
                raise DeviceUnsupported(f"sink column {col.name} not computed on device")
            out[f"v_{col.name}"] = d.data
            out[f"m_{col.name}"] = d.valid
        if self.window is not None and "WINDOWSTART" in env:
            out["ws"] = env["WINDOWSTART"].data
            out["we"] = env["WINDOWEND"].data
        return out

    def _evict(self) -> None:
        hs.evict(self.state, self.store_layout, self.retention_ms)
        self.evictions += 1

    # ------------------------------------------------------------ host API
    def process(self, batch: HostBatch) -> List[SinkEmit]:
        return self.process_arrays(self.layout.encode(batch))

    def upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    def process_arrays(self, arrays: Dict[str, np.ndarray]) -> List[SinkEmit]:
        """One encoded micro-batch through the device step."""
        emits = self._step(self.upload(arrays))
        if self.agg is not None:
            self._batches += 1
            if self.retention_ms is not None and self._batches % self.EVICT_INTERVAL == 0:
                self._evict()
        if self.pipeline:
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
        overflow = int(emits["overflow"])
        if overflow > self._seen_overflow:
            self._seen_overflow = overflow
            raise QueryRuntimeException(
                f"device state store overflowed ({overflow} rows lost); "
                f"store_capacity={self.store_capacity} is undersized for the "
                "key×window cardinality"
            )
        occupancy = int(emits["occupancy"])
        headroom = self.capacity
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
        old = state_to_numpy(self.state)
        self.store_capacity *= factor
        self.store_layout = dataclasses.replace(self.store_layout, capacity=self.store_capacity)
        new = state_to_numpy(hs.init_store(self.store_layout, "cpu"))
        scalars = {k for k, v in old.items() if v.ndim == 0}
        live = np.nonzero(old["occ"][:-1])[0]
        if live.size:
            slots = hs.host_insert(
                new["occ"], new["khash"], new["wstart"], self.store_capacity,
                old["khash"][live], old["wstart"][live],
            )
            for name in old:
                if name in scalars or name in ("occ", "khash", "wstart"):
                    continue
                new[name][slots] = old[name][live]
        for name in scalars:  # max_ts, overflow
            new[name] = old[name]
        self.state = state_from_numpy(new, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rebuild_seconds.append(time.perf_counter() - t0)
        if factor == 1:
            self.compactions += 1
        else:
            self.grows += 1
        return int(live.size)

    def _decode_emits(self, emits: Dict[str, torch.Tensor]) -> List[SinkEmit]:
        idx_dev = emits["emit_mask"].nonzero().squeeze(1)
        if idx_dev.numel() == 0:
            return []
        schema = self._emit_schema()

        def host(name: str) -> np.ndarray:
            return emits[name][idx_dev].cpu().numpy()

        cols: Dict[str, list] = {}
        for col in schema.columns():
            cols[col.name] = decode_value(
                host(f"v_{col.name}"), host(f"m_{col.name}"), col.type, self.dictionary
            )
        ts = host("emit_ts")
        ws = host("ws") if "ws" in emits else None
        we = host("we") if "we" in emits else None
        out: List[SinkEmit] = []
        key_names = [c.name for c in schema.key_columns]
        val_names = [c.name for c in schema.value_columns]
        collapse_null_keys = self.agg is None
        for j in range(len(ts)):
            key = tuple(cols[kn][j] for kn in key_names)
            if collapse_null_keys and key and all(k is None for k in key):
                # key passthrough of a null-key record: the oracle carries
                # an empty key tuple, which the sink writes as a null key
                key = ()
            row = {kn: cols[kn][j] for kn in key_names}
            row.update({vn: cols[vn][j] for vn in val_names})
            window = (int(ws[j]), int(we[j])) if ws is not None else None
            out.append(SinkEmit(key, row, int(ts[j]), window))
        # ts-major, window-start-minor: the reference's emission order
        out.sort(key=lambda e: (e.ts, e.window or (0, 0)))
        return out


def _probe_env(types) -> Dict[str, DCol]:
    return {
        name: DCol(torch.zeros(0, dtype=torch_dtype(t)), torch.zeros(0, dtype=torch.bool), t)
        for name, t in types.items()
    }
