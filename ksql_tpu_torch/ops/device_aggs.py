"""Device aggregates as scatter-combined state components.

The port of ``ksql_tpu/ops/device_aggs.py`` for the scalar families of this
slice: COUNT(*), COUNT, SUM (INTEGER, BIGINT, DOUBLE), AVG, MIN and MAX.
Each decomposes into 'add'/'min'/'max' state components that
``hash_store.fold_and_mark`` folds, per-row contributions (inactive rows
contribute the identity), and a ``finalize`` from slot state to the output
column.  Every other aggregate, and any DECIMAL argument or result, raises
:class:`DeviceUnsupported`.

``resolve_udaf`` stands in for the reference's function registry lookup
(``functions/udafs.py``): it maps a call to its device kind and SQL result
type.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.types import SqlBaseType, SqlType
from ksql_tpu_torch.compiler.torch_expr import DCol, DeviceUnsupported
from ksql_tpu_torch.ops.hash_store import AggComponent

_I64_MAX = np.iinfo(np.int64).max
_I32_MAX = np.iinfo(np.int32).max
_NUMERIC = (SqlBaseType.INTEGER, SqlBaseType.BIGINT, SqlBaseType.DOUBLE)
_ORDERED = _NUMERIC + (
    SqlBaseType.BOOLEAN, SqlBaseType.TIMESTAMP, SqlBaseType.DATE, SqlBaseType.TIME,
)


@dataclasses.dataclass
class DeviceAgg:
    """A compiled device aggregate: components + per-row contributions +
    finalizer."""

    components: Tuple[AggComponent, ...]
    # (args, row_active) -> per-component contribution tensors
    contribs: Callable[[Sequence[DCol], torch.Tensor], List[torch.Tensor]]
    # component slot tensors -> (data, valid)
    finalize: Callable[[Sequence[torch.Tensor]], Tuple[torch.Tensor, torch.Tensor]]
    result_type: SqlType


def resolve_udaf(name: str, arg_types: Sequence[SqlType]) -> Tuple[str, SqlType]:
    """(device kind, result type) of an aggregate call."""
    fn = name.upper()
    if any(t.base == SqlBaseType.DECIMAL for t in arg_types):
        raise DeviceUnsupported(f"DECIMAL aggregation {fn} on device")
    if fn == "COUNT" and not arg_types:
        return "count_star", T.BIGINT
    if fn == "COUNT" and len(arg_types) == 1:
        return "count", T.BIGINT
    if fn == "SUM" and len(arg_types) == 1 and arg_types[0].base in _NUMERIC:
        return "sum", arg_types[0]  # SumKudaf: SUM(INT)->INT, SUM(BIGINT)->BIGINT
    if fn == "AVG" and len(arg_types) == 1 and arg_types[0].base in _NUMERIC:
        return "avg", T.DOUBLE
    if fn in ("MIN", "MAX") and len(arg_types) == 1 and arg_types[0].base in _ORDERED:
        return fn.lower(), arg_types[0]
    raise DeviceUnsupported(f"aggregate {fn}({', '.join(map(str, arg_types))}) on device")


def _minmax_dtype(t: SqlType):
    if t.base == SqlBaseType.DOUBLE:
        return torch.float64, float("inf")  # ±inf sentinels: data may hold ±F64_MAX
    if t.base == SqlBaseType.INTEGER:
        return torch.int32, _I32_MAX
    return torch.int64, _I64_MAX


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


def compile_device_agg(kind: str, arg_types: Sequence[SqlType],
                       result_type: SqlType) -> DeviceAgg:
    """Build the device decomposition for one aggregation call."""
    if kind == "count_star":
        return DeviceAgg(
            components=(AggComponent("add", "int64", 0),),
            contribs=lambda args, act: [act.to(torch.int64)],
            finalize=lambda comps: (comps[0], _ones(comps[0])),
            result_type=T.BIGINT,
        )
    if kind == "count":
        return DeviceAgg(
            components=(AggComponent("add", "int64", 0),),
            contribs=lambda args, act: [(act & args[0].valid).to(torch.int64)],
            finalize=lambda comps: (comps[0], _ones(comps[0])),
            result_type=T.BIGINT,
        )
    if kind == "sum":
        t = result_type
        dt = {SqlBaseType.DOUBLE: torch.float64, SqlBaseType.INTEGER: torch.int32}.get(
            t.base, torch.int64
        )
        name = str(dt).replace("torch.", "")

        def sum_contribs(args, act):
            ok = act & args[0].valid
            return [torch.where(ok, args[0].data.to(dt), torch.zeros((), dtype=dt, device=ok.device))]

        return DeviceAgg(
            components=(AggComponent("add", name, 0),),
            contribs=sum_contribs,
            # SumKudaf: 0-initialized, nulls skipped => always non-null
            finalize=lambda comps: (comps[0], _ones(comps[0])),
            result_type=t,
        )
    if kind in ("min", "max"):
        t = arg_types[0]
        dt, sentinel = _minmax_dtype(t)
        if kind == "min":
            fill = sentinel
        else:
            fill = -sentinel if dt == torch.float64 else -sentinel - 1

        def mm_contribs(args, act):
            ok = act & args[0].valid
            return [
                torch.where(ok, args[0].data.to(dt), torch.tensor(fill, dtype=dt, device=ok.device)),
                ok.to(torch.int32),
            ]

        return DeviceAgg(
            components=(
                AggComponent(kind, str(dt).replace("torch.", ""), fill),
                AggComponent("max", "int32", 0),
            ),
            contribs=mm_contribs,
            finalize=lambda comps: (comps[0], comps[1] > 0),
            result_type=t,
        )
    if kind == "avg":
        def avg_contribs(args, act):
            ok = act & args[0].valid
            zero = torch.zeros((), dtype=torch.float64, device=ok.device)
            return [torch.where(ok, args[0].data.to(torch.float64), zero), ok.to(torch.int64)]

        def avg_finalize(comps):
            n = comps[1]
            return comps[0] / torch.where(n == 0, torch.ones_like(n), n).to(torch.float64), n > 0

        return DeviceAgg(
            components=(
                AggComponent("add", "float64", 0.0),
                AggComponent("add", "int64", 0),
            ),
            contribs=avg_contribs,
            finalize=avg_finalize,
            result_type=T.DOUBLE,
        )
    raise DeviceUnsupported(f"aggregate kind {kind} on device")
