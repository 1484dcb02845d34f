"""Fused tap residuals: one K25 pass per predicate family over a span.

The port of ``ksql_tpu/server/tap_kernel.py``.  Every push tap whose
residual WHERE chain lowers joins a **predicate family**: taps whose
chains differ only in their literal values share one family, one lane
each, with the literals in per-lane parameter rows.  A family is lowered
once to K25's program (``ops/tap_residual.py``) at a power-of-two lane
capacity; attach and detach within the capacity write a parameter row and
an ``active`` bit, and an attach past it doubles the capacity and
rebuilds the program once.  Each ring span a tap reads is columnarized
once (row counts padded to powers of two from 256) and evaluated for every
family in one K25 launch each; the span's masks and LIMIT-clipped counts
are cached, so taps polling in lockstep share one evaluation.

A residual that does not lower (LIKE, string ordering, an expression the
device compiler refuses, a chain past K25's limits) keeps the host path,
tap by tap, with its reason counted in the registry's
``fallback_reasons``.  Unlike the reference, a K25 build or launch error
propagates: the pipeline never degrades to the host path on its own, so a
broken kernel cannot pass for a working one (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.batch import stable_hash64
from ksql_tpu_torch.common.types import SqlBaseType
from ksql_tpu_torch.compiler.torch_expr import _HASHED, DeviceUnsupported, torch_dtype
from ksql_tpu_torch.execution import expressions as ex
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.ops import tap_residual as tr

#: row buckets the kernel runs over: spans pad up to the next bucket
_ROW_BUCKET_MIN = 256

#: lanes with no LIMIT pass this budget (far above any poll bound)
_NO_LIMIT = 1 << 62

#: ring entry kinds (``push_registry.ROW``/``GAP``)
_ROW = 0


class ResidualUnsupported(Exception):
    """This tap's residual cannot lower to the fused kernel; the tap keeps
    the host path (the reason lands in the registry's fallback_reasons)."""


# --------------------------------------------------------------- structure
#: literal classes whose value becomes an int64 lane parameter
_INT_PARAM = (ex.BooleanLiteral, ex.IntegerLiteral, ex.LongLiteral)
#: literal classes whose value becomes a float64 lane parameter
_FLOAT_PARAM = (ex.DoubleLiteral, ex.DecimalLiteral)
#: literal classes parameterized by their stable 64-bit hash
_HASH_PARAM = (ex.StringLiteral, ex.BytesLiteral)


def _param_of(e: ex.Expression) -> Optional[Tuple[str, Any]]:
    """(kind, value) when ``e`` is a parameterizable literal, else None."""
    if isinstance(e, _INT_PARAM):
        v = getattr(e, "value", None)
        return None if v is None else ("i", int(v))
    if isinstance(e, _FLOAT_PARAM):
        if isinstance(e, ex.DecimalLiteral):
            return ("f", float(e.text))
        v = e.value
        return None if v is None else ("f", float(v))
    if isinstance(e, _HASH_PARAM):
        v = e.value
        return None if v is None else ("i", int(stable_hash64(v)))
    return None


def _collect(e: Any, sig: List[str], lits: List[Tuple[str, Any]],
             slots: Optional[Dict[int, Tuple[str, int]]]) -> None:
    """Walk an expression tree appending structure tokens to ``sig`` and
    literal parameters to ``lits`` (pre-order: trees of one structure give
    equal signatures and aligned parameter lists); ``slots`` (id(literal)
    -> (kind, index)) is filled for the family's representative tree."""
    if isinstance(e, ex.Expression):
        p = _param_of(e)
        if p is not None:
            kind, value = p
            idx = sum(1 for k, _ in lits if k == kind)
            lits.append((kind, value))
            if slots is not None:
                slots[id(e)] = (kind, idx)
            # the literal class stays in the signature: `x > 5` and
            # `x > 5.0` promote differently and must not share a program
            sig.append(f"{type(e).__name__}#{kind}")
            return
        sig.append(type(e).__name__ + "(")
        for f in dataclasses.fields(e):
            sig.append(f.name + "=")
            _collect(getattr(e, f.name), sig, lits, slots)
        sig.append(")")
    elif isinstance(e, (list, tuple)):
        sig.append("[")
        for item in e:
            _collect(item, sig, lits, slots)
        sig.append("]")
    else:
        # enums, column/field names, SqlTypes, flags: structural
        sig.append(repr(e) if not hasattr(e, "base") else str(e))


@dataclasses.dataclass
class ResidualSpec:
    """One tap's classification: the family it joins (``signature``), its
    lane parameters, and the source-side step prefix (through the last
    filter) the kernel evaluates."""

    signature: str
    params_i: np.ndarray  # (n_i,) int64
    params_f: np.ndarray  # (n_f,) float64
    mask_steps: List[Any]  # source-side first, ends at the last filter
    slots: Dict[int, Tuple[str, int]]  # id(literal) -> (kind, param index)
    col_names: Tuple[str, ...]  # schema columns the family columnarizes


def classify_residual(residual_steps: List[Any], schema) -> Optional[ResidualSpec]:
    """Classify a tap's residual chain (root side first, as the registry
    holds it).  None for a pure projection (no WHERE: delivery is already
    a plain gather); raises :class:`ResidualUnsupported` for a chain the
    kernel cannot evaluate (probed at attach, so the reason is known
    before any row flows)."""
    src_first = list(reversed(residual_steps))
    last_filter = -1
    for i, s in enumerate(src_first):
        if isinstance(s, st.StreamFilter):
            last_filter = i
    if last_filter < 0:
        return None
    mask_steps = src_first[: last_filter + 1]

    sig: List[str] = []
    lits: List[Tuple[str, Any]] = []
    slots: Dict[int, Tuple[str, int]] = {}
    for s in mask_steps:
        if isinstance(s, st.StreamFilter):
            sig.append("|F:")
            _collect(s.predicate, sig, lits, slots)
        else:
            sig.append("|S:")
            sig.append(repr(tuple(c.name for c in s.schema.key_columns)))
            sig.append(repr(tuple(c.name for c in s.source.schema.key_columns)))
            for name, e0 in s.selects:
                sig.append(name + "<-")
                _collect(e0, sig, lits, slots)

    # the columns the family needs: every ColumnRef that resolves in the
    # pipeline schema, the key columns (the select carry-through) and ROWTIME
    referenced = set()
    for s in mask_steps:
        exprs = [s.predicate] if isinstance(s, st.StreamFilter) else [e0 for _, e0 in s.selects]
        for e0 in exprs:
            for node in ex.walk(e0):
                if isinstance(node, ex.ColumnRef):
                    referenced.add(node.name)
    schema_cols = {c.name: c.type for c in schema.columns()}
    key_names = [c.name for c in schema.key_columns]
    col_names = tuple([n for n in schema_cols if n in referenced or n in key_names] + ["ROWTIME"])
    spec = ResidualSpec(
        signature="".join(sig),
        params_i=np.asarray([v for k, v in lits if k == "i"], np.int64),
        params_f=np.asarray([v for k, v in lits if k == "f"], np.float64),
        mask_steps=mask_steps,
        slots=slots,
        col_names=col_names,
    )
    try:
        _probe(spec, schema_cols)
    except DeviceUnsupported as e:
        raise ResidualUnsupported(str(e)) from e
    return spec


def _col_types(col_names, schema_cols) -> Tuple[Any, ...]:
    return tuple(T.BIGINT if name == "ROWTIME" else schema_cols[name] for name in col_names)


def _probe(spec: ResidualSpec, schema_cols: Dict[str, Any]) -> None:
    """The attach-time check: the family's K25 program builds, and the
    twin runs over a 2-row CPU dummy batch (``jax.eval_shape`` of the
    reference's lane function)."""
    for name in spec.col_names:
        if name != "ROWTIME" and name not in schema_cols:
            raise DeviceUnsupported(f"column {name} not in the shared batch")
    types = _col_types(spec.col_names, schema_cols)
    tr.build_program(spec, types)
    datas = [torch.zeros(2, dtype=torch_dtype(t)) for t in types]
    valids = [torch.ones(2, dtype=torch.bool) for _ in types]
    tr.lane_masks_plain(
        spec, types, datas, valids,
        torch.zeros((1, len(spec.params_i)), dtype=torch.int64),
        torch.zeros((1, len(spec.params_f)), dtype=torch.float64),
        torch.ones(1, dtype=torch.bool), torch.ones(2, dtype=torch.bool),
        torch.full((1,), _NO_LIMIT, dtype=torch.int64),
    )


# ------------------------------------------------------------------ family
class _LaneGroup:
    """One predicate family: taps whose residual chains share a structure
    signature, packed into the lanes of one K25 program."""

    def __init__(self, spec: ResidualSpec, col_types, capacity: int):
        self.signature = spec.signature
        self.rep = spec  # the representative tree the program is built from
        self.col_types = col_types
        self.capacity = capacity
        self.lanes: List[Optional[str]] = [None] * capacity  # tap ids
        self.lane_of: Dict[str, int] = {}
        self.P_i = np.zeros((capacity, len(spec.params_i)), np.int64)
        self.P_f = np.zeros((capacity, len(spec.params_f)), np.float64)
        self.active = np.zeros(capacity, bool)
        self._program: Optional[tr.Program] = None  # rebuilt on growth
        self.program_builds = 0
        self._dev_params = None  # (P_i, P_f, active) on the device, None when stale

    def n_active(self) -> int:
        return int(self.active.sum())

    def add(self, tap_id: str, spec: ResidualSpec) -> bool:
        """Claim a lane (a parameter write, no rebuild).  False = full."""
        for i in range(self.capacity):
            if self.lanes[i] is None:
                self.lanes[i] = tap_id
                self.lane_of[tap_id] = i
                self.P_i[i] = spec.params_i
                self.P_f[i] = spec.params_f
                self.active[i] = True
                self._dev_params = None
                return True
        return False

    def remove(self, tap_id: str) -> None:
        i = self.lane_of.pop(tap_id, None)
        if i is not None:
            self.lanes[i] = None
            self.active[i] = False  # a mask update, no rebuild
            self._dev_params = None

    def grow(self) -> None:
        """Double the lane capacity: pad the parameter and active arrays
        and drop the program, which the next evaluation rebuilds once."""
        pad = self.capacity
        self.P_i = np.concatenate([self.P_i, np.zeros((pad, self.P_i.shape[1]), np.int64)])
        self.P_f = np.concatenate([self.P_f, np.zeros((pad, self.P_f.shape[1]), np.float64)])
        self.active = np.concatenate([self.active, np.zeros(pad, bool)])
        self.lanes.extend([None] * pad)
        self.capacity *= 2
        self._program = None
        self._dev_params = None

    def program(self) -> tr.Program:
        if self._program is None:
            self._program = tr.build_program(self.rep, self.col_types)
            self.program_builds += 1
        return self._program

    def device_params(self, device):
        """The parameter rows and active bits on ``device`` (uploaded again
        after a membership change)."""
        if self._dev_params is None:
            self._dev_params = tuple(torch.from_numpy(a.copy()).to(device)
                                     for a in (self.P_i, self.P_f, self.active))
        return self._dev_params


# ------------------------------------------------------------------ kernel
def _bucket_rows(n: int) -> int:
    b = _ROW_BUCKET_MIN
    while b < n:
        b *= 2
    return b


class TapKernel:
    """Per-pipeline fused residuals: predicate families, the span cache and
    the columnarizer.  State is guarded by ``lock`` (the registry's)."""

    def __init__(self, pipeline, schema, lock, *, capacity_min: int, capacity_max: int,
                 min_taps: int, device):
        self.pipeline = pipeline
        self.schema_cols = {c.name: c.type for c in schema.columns()}
        self.lock = lock
        self.device = device
        self.capacity_min = max(1, capacity_min)
        self.capacity_max = max(self.capacity_min, capacity_max)
        self.min_taps = max(1, min_taps)
        self.groups: Dict[str, _LaneGroup] = {}
        self.group_of: Dict[str, _LaneGroup] = {}  # tap id -> group
        self.epoch = 0  # bumped on any membership change (cache key)
        self.compile_epochs = 0  # program builds at evaluation (growth tiers)
        self.block_spans = 0  # spans served from device emit blocks
        self.evaluations = 0  # spans evaluated
        # span cache: (start_seq, n_entries, epoch) -> evaluated span; taps
        # polling in lockstep share one kernel run per span
        self._spans: "OrderedDict[tuple, dict]" = OrderedDict()
        self._span_cache_max = 4

    # ---------------------------------------------------------- membership
    def attach(self, tap_id: str, spec: ResidualSpec) -> None:
        """Join the tap's family (creating it at the base capacity); an
        attach past the capacity grows it, within it is a parameter write."""
        with self.lock:
            grp = self.groups.get(spec.signature)
            if grp is None:
                cap = 1
                while cap < self.capacity_min:
                    cap *= 2
                grp = _LaneGroup(spec, _col_types(spec.col_names, self.schema_cols), cap)
                self.groups[spec.signature] = grp
            while not grp.add(tap_id, spec):
                if grp.capacity * 2 > self.capacity_max:
                    raise ResidualUnsupported(
                        f"fused lane capacity cap reached ({self.capacity_max}); "
                        "tap keeps the host path")
                grp.grow()
            self.group_of[tap_id] = grp
            self.epoch += 1

    def detach(self, tap_id: str) -> None:
        with self.lock:
            grp = self.group_of.pop(tap_id, None)
            if grp is not None:
                grp.remove(tap_id)
                if not grp.lane_of:
                    self.groups.pop(grp.signature, None)
                self.epoch += 1

    def fused_tap_count(self) -> int:
        with self.lock:
            return len(self.group_of)

    # ---------------------------------------------------------- evaluation
    def mask_for(self, tap_id: str, start_seq: int, entries) -> Optional[dict]:
        """The evaluated span for a tap's read window: ``{"mask": row mask
        over entries, "count": LIMIT-clipped matches, "max_ts": the span's
        max event time}``, or None (below min-taps, or the tap is not
        fused): the caller runs the host residual path.  ``count`` is
        advisory: spans are cached across taps and polls, so delivery
        re-derives the live LIMIT budget itself."""
        with self.lock:
            grp = self.group_of.get(tap_id)
            if grp is None or len(self.group_of) < self.min_taps:
                return None
            key = (start_seq, len(entries), self.epoch)
            span = self._spans.get(key)
            if span is None:
                span = self._evaluate_span(start_seq, entries)
                self._spans[key] = span
                while len(self._spans) > self._span_cache_max:
                    self._spans.popitem(last=False)
            lane_masks = span["groups"].get(grp.signature)
            if lane_masks is None:
                return None
            lane = grp.lane_of.get(tap_id)
            if lane is None or lane >= lane_masks["masks"].shape[0]:
                return None
            return {"mask": lane_masks["masks"][lane], "count": int(lane_masks["counts"][lane]),
                    "max_ts": span["max_ts"]}

    def _evaluate_span(self, start_seq: int, entries) -> dict:
        """Columnarize the span once and run every family's K25 over it."""
        n = len(entries)
        bucket = _bucket_rows(n)
        needed = set()
        for grp in self.groups.values():
            needed.update(grp.rep.col_names)
        cols, row_valid, max_ts = self._columnarize(start_seq, entries, needed, bucket)
        out_groups: Dict[str, dict] = {}
        for sig, grp in self.groups.items():
            if not grp.n_active():
                continue
            limits = np.full(grp.capacity, _NO_LIMIT, np.int64)
            for tid, lane in grp.lane_of.items():
                limits[lane] = self._limit_remaining(tid)
            builds = grp.program_builds
            prog = grp.program()
            if grp.program_builds > builds:
                self.compile_epochs += 1
                self.pipeline.registry.residual_compile_epochs += 1
            P_i, P_f, active = grp.device_params(self.device)
            masks, counts = tr.lane_masks(
                prog, [cols[c][0] for c in grp.rep.col_names],
                [cols[c][1] for c in grp.rep.col_names], P_i, P_f, active, row_valid,
                torch.from_numpy(limits).to(self.device))
            out_groups[sig] = {"masks": masks[:, :n].cpu().numpy(), "counts": counts.cpu().numpy()}
        self.evaluations += 1
        reg = self.pipeline.registry
        reg.residual_kernel_evals += 1
        reg.residual_kernel_rows += n
        return {"groups": out_groups, "max_ts": max_ts}

    def _limit_remaining(self, tap_id: str) -> int:
        tap = self.pipeline.taps.get(tap_id)
        sess = getattr(tap, "session", None)
        limit = getattr(sess, "limit", None)
        if limit is None:
            return _NO_LIMIT
        return max(int(limit) - int(getattr(sess, "_results", 0)), 0)

    def _columnarize(self, start_seq: int, entries, needed, bucket: int):
        """Ring entries -> padded (data, valid) tensors per needed column
        (ROWTIME included) on the kernel's device, a row-validity mask
        (False on gap entries, null rows and padding) and the span's max
        event time (null-row tombstones fold into it, as the host path's
        per-row watermark does).  A listener-mode span that device emit
        blocks tile exactly is assembled from them instead."""
        rows_meta = []  # (index, row dict, ts)
        max_ts = None
        for i, (kind, payload) in enumerate(entries):
            if kind != _ROW:
                continue
            _, row, ts0 = payload
            max_ts = ts0 if max_ts is None else max(max_ts, ts0)
            if row is None:
                continue
            rows_meta.append((i, row, ts0))
        block = self._block_cols(start_seq, entries, needed, bucket)
        if block is not None:
            self.block_spans += 1
            cols, row_valid = block
            return cols, row_valid, max_ts
        row_valid = np.zeros(bucket, bool)
        cols: Dict[str, tuple] = {}
        for name in needed:
            t = T.BIGINT if name == "ROWTIME" else self.schema_cols.get(name)
            if t is None:
                continue
            dt = t.device_dtype()
            data = np.zeros(bucket, dt)
            valid = np.zeros(bucket, bool)
            hashed = t.base in _HASHED
            for i, row, ts0 in rows_meta:
                v = ts0 if name == "ROWTIME" else row.get(name)
                if v is None:
                    continue
                try:
                    if hashed:
                        data[i] = stable_hash64(v)
                    elif t.base == SqlBaseType.BOOLEAN:
                        data[i] = bool(v)
                    elif np.issubdtype(dt, np.integer):
                        data[i] = int(v)
                    else:
                        data[i] = float(v)
                except (TypeError, ValueError, OverflowError) as e:
                    raise ResidualUnsupported(f"column {name} value {v!r} not columnarizable") from e
                valid[i] = True
            cols[name] = (torch.from_numpy(data).to(self.device),
                          torch.from_numpy(valid).to(self.device))
        for i, _row, _ts0 in rows_meta:
            row_valid[i] = True
        return cols, torch.from_numpy(row_valid).to(self.device), max_ts

    def _block_cols(self, start_seq: int, entries, needed, bucket: int):
        """The span's columns from listener-mode device emit blocks, when
        consecutive blocks tile it exactly and it holds no gap entry; else
        None and the host columnarizer runs."""
        blocks = getattr(self.pipeline, "_emit_blocks", None)
        if not blocks:
            return None
        n = len(entries)
        if any(kind != _ROW for kind, _ in entries):
            return None
        run = []
        pos = start_seq
        for bstart, bn, blk in blocks:
            if bstart + bn <= start_seq or pos >= start_seq + n:
                continue
            if bstart != pos:
                return None  # a hole or a partial overlap: host path
            run.append(blk)
            pos = bstart + bn
        if pos != start_seq + n:
            return None
        for name in needed:
            if name != "ROWTIME" and any(name not in blk["cols"] for blk in run):
                return None  # a 2-D column the block skipped
        cols: Dict[str, tuple] = {}
        for name in needed:
            if name == "ROWTIME":
                data = torch.cat([blk["ts"] for blk in run])
                valid = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
            else:
                data = torch.cat([blk["cols"][name][0] for blk in run])
                valid = torch.cat([blk["cols"][name][1] for blk in run])
            if data.shape[0] != bucket:
                pad = bucket - data.shape[0]
                data = torch.cat([data, data.new_zeros(pad)])
                valid = torch.cat([valid, valid.new_zeros(pad)])
            cols[name] = (data, valid)
        row_valid = np.zeros(bucket, bool)
        row_valid[:n] = ~np.concatenate([blk["row_none"] for blk in run])
        return cols, torch.from_numpy(row_valid).to(self.device)
