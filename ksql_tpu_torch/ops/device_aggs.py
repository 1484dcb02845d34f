"""Device aggregates as scatter-combined state components.

The port of ``ksql_tpu/ops/device_aggs.py`` for the families the port
runs: COUNT(*), COUNT, SUM (INTEGER, BIGINT, DOUBLE, and DECIMAL as an int64
accumulator of scaled units), AVG, STDDEV_SAMPLE, STDDEV_POP, CORRELATION,
MIN and MAX (a DECIMAL as float64), which decompose into 'add'/'min'/'max'
state components that ``hash_store.fold_and_mark`` folds; the scalar
EARLIEST_BY_OFFSET(x[, ignoreNulls]) and LATEST_BY_OFFSET(x[, ignoreNulls]),
an int64 min/max order over the arrival sequence followed by two 'argset'
payloads (the value and its valid bit) that ``hash_store.fold_argset``
writes from the row that won the order; and the vector families COLLECT_LIST,
COLLECT_SET, EARLIEST_BY_OFFSET(x, n[, ignoreNulls]),
LATEST_BY_OFFSET(x, n[, ignoreNulls]), TOPK, TOPKDISTINCT, HISTOGRAM and
ATTR (and the ``collect_all_valid`` kind), whose width-K groups
``ops/vector.py`` folds.  Each has per-row contributions (inactive rows
contribute the identity; the offsets' take the rows' arrival sequence
``seq`` as a third argument) and a ``finalize`` from slot state to the
output column: ``(data, valid)``, for an ARRAY ``(data [n, K], present
[n, K], element valid [n, K])`` and for a MAP ``(keys [n, K], valid,
present [n, K], counts [n, K])``.  Every other aggregate, a DECIMAL wider
than 15 digits, and a DECIMAL SUM whose sum can pass 2^53 scaled units
raise :class:`DeviceUnsupported` in the reference's words.

A table aggregation undoes a source row's old contributions before it
applies the new row's: the all-'add' families by negating their
contributions, COLLECT_LIST, HISTOGRAM and ATTR by their ``undo_contribs``
(a negative head: COLLECT_LIST's removes the first stored occurrence of
the value, ``ops/vector.py:vec_remove``; HISTOGRAM's decrements the
value's count).

``resolve_udaf`` stands in for the reference's function registry lookup
(``functions/udafs.py``): it maps a call to its device kind, SQL result
type and number of trailing literal parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.types import SqlBaseType, SqlType
from ksql_tpu_torch.compiler.torch_expr import DCol, DeviceUnsupported, numpy_unary, saturating_int
from ksql_tpu_torch.ops.hash_store import _DTYPES, AggComponent, xla_minmax

_I64_MAX = np.iinfo(np.int64).max
_I32_MAX = np.iinfo(np.int32).max
_NUMERIC = (SqlBaseType.INTEGER, SqlBaseType.BIGINT, SqlBaseType.DOUBLE, SqlBaseType.DECIMAL)
_ORDERED = _NUMERIC + (
    SqlBaseType.BOOLEAN, SqlBaseType.TIMESTAMP, SqlBaseType.DATE, SqlBaseType.TIME,
)
#: TOPK/TOPKDISTINCT's first parameter (``functions/udafs.py`` COMPARABLE)
_COMPARABLE = _ORDERED + (SqlBaseType.STRING, SqlBaseType.BYTES)
_NESTED = (SqlBaseType.ARRAY, SqlBaseType.MAP, SqlBaseType.STRUCT)
#: hard ceiling on per-key vector state width (collect/topk); wider caps
#: are refused rather than blow up device memory
MAX_VEC_WIDTH = 4096
#: COLLECT_LIST/COLLECT_SET's cap (``functions/udafs.py`` ``_COLLECT_LIMIT``,
#: ksqlDB's CollectListUdaf LIMIT default) and HISTOGRAM's entry cap
#: (HistogramUdaf); the ``ksql.functions.<name>.limit`` override is the
#: engine's, which the port does not have
COLLECT_LIMIT = 1000
HIST_LIMIT = 1000
#: DECIMAL SUM's exactness envelope: the number of max-magnitude addends a
#: per-key sum is certified to absorb before its int64 accumulator could
#: pass 2^53 scaled units (where the float64 finalize stops being exact);
#: with 10^p bounding one addend, the card takes precision <= 12
SUM_ACCUM_HEADROOM_ROWS = 1000


@dataclasses.dataclass
class DeviceAgg:
    """A compiled device aggregate: components + per-row contributions +
    finalizer."""

    components: Tuple[AggComponent, ...]
    # (args, row_active, seq) -> per-component contribution tensors; ``seq``,
    # the rows' arrival sequence, is required by the offsets' 'argset'
    # payloads and ignored by the others
    contribs: Callable[..., List[torch.Tensor]]
    # component slot tensors -> (data, valid), or the 3-/4-tuples of the
    # ARRAY and MAP results (module docstring)
    finalize: Callable[[Sequence[torch.Tensor]], Tuple[torch.Tensor, ...]]
    result_type: SqlType
    #: a table aggregation's undo contributions, where negating ``contribs``
    #: does not invert the fold (the vector families); None: negate
    undo_contribs: Optional[Callable[[Sequence[DCol], torch.Tensor], List[torch.Tensor]]] = None
    #: when set, |component 0| past this bound at emission means the
    #: finalized value no longer round-trips its float64 carrier exactly
    #: (DECIMAL SUM past 2^53 scaled units): the runtime raises instead
    exact_abs_bound: Optional[int] = None



def resolve_udaf(name: str, arg_types: Sequence[SqlType]) -> Tuple[str, SqlType, int]:
    """(device kind, result type, number of trailing literal parameters)
    of an aggregate call; a DECIMAL wider than 15 digits among the
    arguments or the result is refused, as the reference refuses it."""
    kind, result_type, n_lits = _resolve(name.upper(), arg_types)
    for t in [*arg_types, result_type]:
        if t.base == SqlBaseType.DECIMAL and (t.precision or 0) > 15:
            # float64 carries <= 15 significant digits exactly
            raise DeviceUnsupported("DECIMAL aggregation on device")
    return kind, result_type, n_lits


def _resolve(fn: str, arg_types: Sequence[SqlType]) -> Tuple[str, SqlType, int]:
    bases = [t.base for t in arg_types]
    if fn == "COUNT" and not arg_types:
        return "count_star", T.BIGINT, 0
    if fn == "COUNT" and len(arg_types) == 1:
        return "count", T.BIGINT, 0
    if fn == "SUM" and len(arg_types) == 1 and bases[0] in _NUMERIC:
        return "sum", arg_types[0], 0  # SumKudaf: SUM(INT)->INT, SUM(BIGINT)->BIGINT
    if fn == "AVG" and len(arg_types) == 1 and bases[0] in _NUMERIC:
        return "avg", T.DOUBLE, 0
    if fn in ("STDDEV_SAMPLE", "STDDEV_POP") and len(arg_types) == 1 and bases[0] in _NUMERIC:
        # STDDEV_SAMP returns the sample VARIANCE and has no device kind
        return "stddev", T.DOUBLE, 0
    if fn == "CORRELATION" and len(arg_types) == 2 and all(b in _NUMERIC for b in bases):
        return "correlation", T.DOUBLE, 0
    if fn in ("MIN", "MAX") and len(arg_types) == 1 and bases[0] in _ORDERED:
        return fn.lower(), arg_types[0], 0
    if fn in ("EARLIEST_BY_OFFSET", "LATEST_BY_OFFSET") and (
            len(arg_types) == 1 or (len(arg_types) == 2 and bases[1] == SqlBaseType.BOOLEAN)):
        # (x[, ignoreNulls]): the first/last value in arrival order
        kind = "earliest" if fn.startswith("EARLIEST") else "latest"
        return kind, arg_types[0], len(arg_types) - 1
    if fn in ("COLLECT_LIST", "COLLECT_SET") and len(arg_types) == 1:
        return "collect", SqlType.array(arg_types[0]), 0
    if fn in ("TOPK", "TOPKDISTINCT") and len(arg_types) == 2 and bases[0] in _COMPARABLE \
            and bases[1] == SqlBaseType.INTEGER:
        return "topk", SqlType.array(arg_types[0]), 1
    if fn == "TOPK" and 3 <= len(arg_types) <= 6 and bases[-1] == SqlBaseType.INTEGER:
        # TOPK(sort_col, col0..colN, k): the reference has no device kind
        raise DeviceUnsupported(f"UDAF {name} on device")
    if fn == "HISTOGRAM" and bases == [SqlBaseType.STRING]:
        return "histogram", SqlType.map(T.STRING, T.BIGINT), 0
    if fn in ("EARLIEST_BY_OFFSET", "LATEST_BY_OFFSET") and len(arg_types) in (2, 3) \
            and bases[1] == SqlBaseType.INTEGER \
            and (len(arg_types) == 2 or bases[2] == SqlBaseType.BOOLEAN):
        # (x, n[, ignoreNulls]): the first/last n values as an array
        return "collect", SqlType.array(arg_types[0]), len(arg_types) - 1
    if fn == "ATTR" and len(arg_types) == 1:
        return "attr", arg_types[0], 0
    raise DeviceUnsupported(f"aggregate {fn}({', '.join(map(str, arg_types))}) on device")


def _minmax_dtype(t: SqlType):
    if t.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL):
        return torch.float64, float("inf")  # ±inf sentinels: data may hold ±F64_MAX
    if t.base == SqlBaseType.INTEGER:
        return torch.int32, _I32_MAX
    return torch.int64, _I64_MAX


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


def _vec_dtype(t: SqlType) -> str:
    """Element storage dtype of vector state (strings, bytes and nested
    values carry their int64 dictionary codes, booleans int8)."""
    if t.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL):
        return "float64"
    if t.base == SqlBaseType.BOOLEAN:
        return "int8"
    if t.base == SqlBaseType.INTEGER:
        return "int32"
    return "int64"


def _where(cond: torch.Tensor, x: torch.Tensor, other, dtype: torch.dtype) -> torch.Tensor:
    return torch.where(cond, x.to(dtype), torch.tensor(other, dtype=dtype, device=cond.device))


def _collect_finalize(K: int, ring: bool):
    """COLLECT_LIST/SET and EARLIEST/LATEST(n): ``(data, present,
    element valid)``, the ring rotated to arrival order."""
    def finalize(comps):
        count, data, vbits = comps
        arange = torch.arange(K, dtype=torch.int32, device=count.device)
        if ring:
            start = torch.where(count > K, torch.remainder(count, K), torch.zeros_like(count))
            idx = (start.to(torch.int32)[:, None] + arange[None, :]) % K
            data = torch.gather(data, 1, idx.long())
            vbits = torch.gather(vbits, 1, idx.long())
        present = arange[None, :] < torch.clamp(count, max=K).to(torch.int32)[:, None]
        return data, present, (vbits != 0) & present

    return finalize


def _compile_vector_agg(kind: str, arg_types: Sequence[SqlType], result_type: SqlType,
                        fname: str, literals: Sequence[object]) -> DeviceAgg:
    """The vector families: ``collect``, ``topk``, ``histogram``/``attr``
    and ``collect_all_valid`` (reference ``ops/device_aggs.py:326-560``)."""
    t = arg_types[0]
    fn = fname.upper()
    if kind == "collect":
        # nested element types ride as opaque int64 dictionary codes, like
        # strings: emission decodes the elements through the dictionary
        ignore_nulls = True
        if fn in ("COLLECT_LIST", "COLLECT_SET"):
            K, collect_nulls = COLLECT_LIMIT, True
            mode = "append" if fn == "COLLECT_LIST" else "set"
        elif fn in ("EARLIEST_BY_OFFSET", "LATEST_BY_OFFSET"):
            K = literals[0] if literals else None
            mode = "append" if fn.startswith("EARLIEST") else "ring"
            collect_nulls = False
            if len(literals) > 1 and literals[1] is not None:
                ignore_nulls = bool(literals[1])
            elif len(literals) > 1:
                raise DeviceUnsupported(f"{fname} dynamic ignoreNulls on device")
        else:
            raise DeviceUnsupported(f"{fname} on device")
        if not isinstance(K, int) or K <= 0 or K > MAX_VEC_WIDTH:
            raise DeviceUnsupported(f"{fname} cap {K!r} on device")
        vdt = _vec_dtype(t)
        tdt = _DTYPES[vdt]

        def contribs(args, act, seq=None):
            v = args[0]
            cand = act if collect_nulls or not ignore_nulls else act & v.valid
            return [cand.to(torch.int64), _where(cand & v.valid, v.data, 0, tdt),
                    (cand & v.valid).to(torch.int8)]

        undo_contribs = None
        if fn == "COLLECT_LIST":
            # a negative head removes the first stored occurrence of the
            # value (CollectListUdaf.undo)
            def undo_contribs(args, act):
                v = args[0]
                return [-act.to(torch.int64), _where(act & v.valid, v.data, 0, tdt),
                        (act & v.valid).to(torch.int8)]

        return DeviceAgg(
            components=(
                AggComponent("vec_count", "int64", 0),
                AggComponent("vec_data", vdt, 0, width=K, mode=mode),
                AggComponent("vec_valid", "int8", 0, width=K),
            ),
            contribs=contribs,
            finalize=_collect_finalize(K, mode == "ring"),
            result_type=result_type,
            undo_contribs=undo_contribs,
        )
    if kind == "topk":
        # TOPK / TOPKDISTINCT over numerics and temporals: width-k sorted
        # state, the dtype floor marking an empty entry
        if t.base in (SqlBaseType.STRING, SqlBaseType.BYTES):
            raise DeviceUnsupported("string ordering on device")
        if t.base in _NESTED:
            raise DeviceUnsupported(f"{fname} over nested types on device")
        k = literals[0] if literals else None
        if not isinstance(k, int) or k <= 0 or k > 256:
            raise DeviceUnsupported(f"{fname} k {k!r} on device")
        vdt = _vec_dtype(t)
        tdt = _DTYPES[vdt]
        sentinel = float("-inf") if vdt == "float64" else int(np.iinfo(vdt).min)
        distinct = fn == "TOPKDISTINCT"

        def tk_contribs(args, act, seq=None):
            ok = act & args[0].valid
            return [ok.to(torch.int32), _where(ok, args[0].data, sentinel, tdt)]

        def tk_finalize(comps):
            count, data = comps
            if distinct:
                # the distinct count is not kept: dtype-floor values (-inf,
                # the int min) read as absent, the reference's documented edge
                present = data != torch.tensor(sentinel, dtype=data.dtype, device=data.device)
            else:
                arange = torch.arange(k, dtype=torch.int32, device=count.device)
                present = arange[None, :] < torch.clamp(count, max=k).to(torch.int32)[:, None]
            return data, present, present

        return DeviceAgg(
            components=(
                AggComponent("add", "int32", 0),
                AggComponent("topk", vdt, sentinel, width=k, mode="distinct" if distinct else ""),
            ),
            contribs=tk_contribs,
            finalize=tk_finalize,
            result_type=result_type,
        )
    if kind in ("histogram", "attr"):
        # per-slot (value code, count) pairs: distinct values append
        # set-style (capped at HIST_LIMIT), every occurrence adds its head
        # to its value's count
        is_attr = kind == "attr"
        f64_repr = t.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL)
        K = HIST_LIMIT

        def code64(v):
            if f64_repr:  # the bits keep doubles exact in the code column
                return v.data.to(torch.float64).view(torch.int64)
            return v.data.to(torch.int64)

        def h_contribs(args, act, seq=None, sign=1):
            v = args[0]
            # HISTOGRAM skips null values; ATTR counts them as an entry
            cand = act if is_attr else act & v.valid
            # the head is also each entry's count increment: signed, so a
            # table aggregation's undo decrements in place
            head = cand.to(torch.int64) * sign
            return [head, _where(cand & v.valid, code64(v), 0, torch.int64),
                    (cand & v.valid).to(torch.int8), head]

        def h_finalize(comps):
            cnt, data, vbits, nums = comps
            arange = torch.arange(K, dtype=torch.int32, device=cnt.device)
            live = (arange[None, :] < torch.clamp(cnt, max=K).to(torch.int32)[:, None]) & (nums > 0)
            if is_attr:
                # the single live entry's value; NULL with 0 or 2+ live
                # entries (Attr.java map())
                n_live = live.sum(1)
                pick = torch.argmax(live.to(torch.int8), 1)
                rows = torch.arange(cnt.shape[0], device=cnt.device)
                val = data[rows, pick]
                if f64_repr:
                    val = val.view(torch.float64)
                return val, (n_live == 1) & (vbits[rows, pick] != 0)
            return data, torch.ones(cnt.shape[0], dtype=torch.bool, device=cnt.device), live, nums

        return DeviceAgg(
            components=(
                AggComponent("vec_count", "int64", 0, mode="hist"),
                AggComponent("vec_data", "int64", 0, width=K, mode="hist"),
                AggComponent("vec_valid", "int8", 0, width=K),
                AggComponent("hist_count", "int64", 0, width=K),
            ),
            contribs=h_contribs,
            finalize=h_finalize,
            result_type=result_type,
            undo_contribs=lambda args, act: h_contribs(args, act, sign=-1),
        )
    if kind == "collect_all_valid":
        # GenericVarArgUdaf/ObjVarColArgUdaf: append the FIRST argument's
        # value when EVERY argument is non-null
        K = COLLECT_LIMIT
        vdt = _vec_dtype(t)
        tdt = _DTYPES[vdt]

        def cav_contribs(args, act, seq=None):
            cand = act
            for a in args:
                cand = cand & a.valid
            return [cand.to(torch.int64), _where(cand, args[0].data, 0, tdt), cand.to(torch.int8)]

        return DeviceAgg(
            components=(
                AggComponent("vec_count", "int64", 0),
                AggComponent("vec_data", vdt, 0, width=K, mode="append"),
                AggComponent("vec_valid", "int8", 0, width=K),
            ),
            contribs=cav_contribs,
            finalize=_collect_finalize(K, False),
            result_type=result_type,
        )
    raise DeviceUnsupported(f"aggregate kind {kind} on device")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA and CUDA take it."""
    return numpy_unary("sqrt", x)


def _stddev_agg(fname: str) -> DeviceAgg:
    """STDDEV_SAMPLE / STDDEV_POP: (sum, sum of squares, n); the result is
    the reference's ``_stddev_samp`` / ``_stddev_pop`` (``functions/udafs.py``)."""
    pop = fname.upper() == "STDDEV_POP"

    def contribs(args, act, seq=None):
        ok = act & args[0].valid
        x = _where(ok, args[0].data, 0.0, torch.float64)
        return [x, x * x, ok.to(torch.int64)]

    def finalize(comps):
        s, ss, n = comps
        nf = n.to(torch.float64)
        one = torch.ones_like(nf)
        zero = torch.zeros_like(nf)
        mean_sq = s * s / torch.where(n == 0, one, nf)
        if pop:
            var = (ss - mean_sq) / torch.where(n == 0, one, nf)
            return _sqrt(xla_minmax(var, zero, "max")), n >= 1
        var = (ss - mean_sq) / torch.where(n < 2, one, nf - 1.0)
        out = torch.where(n == 1, zero, _sqrt(xla_minmax(var, zero, "max")))
        return out, n >= 1

    return DeviceAgg(
        components=(AggComponent("add", "float64", 0.0), AggComponent("add", "float64", 0.0),
                    AggComponent("add", "int64", 0)),
        contribs=contribs,
        finalize=finalize,
        result_type=T.DOUBLE,
    )


def _correlation_agg() -> DeviceAgg:
    """CORRELATION(x, y): (n, sx, sy, sxx, syy, sxy) over the rows where both
    are non-null; NaN when either variance is 0 (the reference's)."""
    def contribs(args, act, seq=None):
        ok = act & args[0].valid & args[1].valid
        x = _where(ok, args[0].data, 0.0, torch.float64)
        y = _where(ok, args[1].data, 0.0, torch.float64)
        return [ok.to(torch.int64), x, y, x * x, y * y, x * y]

    def finalize(comps):
        n, sx, sy, sxx, syy, sxy = comps
        nf = torch.where(n == 0, torch.ones_like(sx), n.to(torch.float64))
        cov = sxy - sx * sy / nf
        vx = sxx - sx * sx / nf
        vy = syy - sy * sy / nf
        denom = _sqrt(xla_minmax(vx * vy, torch.zeros_like(vx), "max"))
        out = torch.where(denom > 0, cov / torch.where(denom == 0, torch.ones_like(denom), denom),
                          torch.full_like(cov, float("nan")))
        return out, n > 0

    return DeviceAgg(
        components=tuple(AggComponent("add", "int64" if i == 0 else "float64", 0)
                         for i in range(6)),
        contribs=contribs,
        finalize=finalize,
        result_type=T.DOUBLE,
    )


def _offset_agg(kind: str, t: SqlType) -> DeviceAgg:
    """EARLIEST/LATEST_BY_OFFSET(x[, ignoreNulls]): an int64 min (earliest)
    or max (latest) of the rows' arrival sequence, then the value and its
    valid bit as 'argset' payloads, written by the row that won the order
    (the sequence numbers are unique, so there are no ties).  A row is a
    candidate when it is active and its value is non-NULL, or NULLs are
    not ignored (ignoreNulls defaults to true)."""
    if t.base in _NESTED:
        raise DeviceUnsupported(f"{kind} over nested types on device")
    vdt = _vec_dtype(t) if t.base in (SqlBaseType.DOUBLE, SqlBaseType.DECIMAL,
                                      SqlBaseType.INTEGER) else "int64"
    tdt = _DTYPES[vdt]
    init = _I64_MAX if kind == "earliest" else -_I64_MAX - 1

    def contribs(args, act, seq=None):
        v = args[0]
        ignore_nulls = args[1].data.to(torch.bool) if len(args) > 1 else torch.ones_like(act)
        cand = act & (v.valid | ~ignore_nulls)
        return [_where(cand, seq, init, torch.int64), _where(cand, v.data, 0, tdt),
                (cand & v.valid).to(torch.int32)]

    def finalize(comps):
        return comps[1], (comps[0] != init) & (comps[2] != 0)

    return DeviceAgg(
        components=(
            AggComponent("min" if kind == "earliest" else "max", "int64", init),
            AggComponent("argset", vdt, 0),
            AggComponent("argset", "int32", 0),
        ),
        contribs=contribs,
        finalize=finalize,
        result_type=t,
    )


def _decimal_sum_agg(t: SqlType) -> DeviceAgg:
    """SUM over DECIMAL(p, s): the scaled unscaled value accumulates in
    int64 (each <= 15-digit addend recovers exactly from its float64
    carrier by rounding), so in-precision sums never drift; finalize
    rescales.  Refused where 10^p addends could carry the sum past 2^53
    scaled units within ``SUM_ACCUM_HEADROOM_ROWS`` rows; past that at run
    time, ``exact_abs_bound`` stops the emission."""
    if 10 ** int(t.precision or 0) * SUM_ACCUM_HEADROOM_ROWS > 2 ** 53:
        raise DeviceUnsupported(
            f"DECIMAL({t.precision},{t.scale}) SUM can exceed the "
            "2^53-exact device envelope (int64 accumulator decodes "
            "through float64)"
        )
    scale_f = float(10 ** (t.scale or 0))

    def contribs(args, act, seq=None):
        ok = act & args[0].valid
        scaled = torch.round(args[0].data.to(torch.float64) * scale_f)
        return [saturating_int(torch.where(ok, scaled, torch.zeros_like(scaled)), torch.int64)]

    # the reference's compiled step divides by the constant scale as a
    # multiplication by its reciprocal (XLA's algebraic simplifier): the same
    # bits here; the emission quantizes to the scale either way
    inv_scale = 1.0 / scale_f
    return DeviceAgg(
        components=(AggComponent("add", "int64", 0),),
        contribs=contribs,
        finalize=lambda comps: (comps[0].to(torch.float64) * inv_scale, _ones(comps[0])),
        result_type=t,
        exact_abs_bound=2 ** 53,
    )


VECTOR_KINDS = ("collect", "topk", "histogram", "attr", "collect_all_valid")


def compile_device_agg(kind: str, arg_types: Sequence[SqlType], result_type: SqlType,
                       fname: str = "", literals: Sequence[object] = ()) -> DeviceAgg:
    """Build the device decomposition for one aggregation call.  ``fname``
    tells families of one kind apart; ``literals`` are the values of the
    trailing literal parameters (TOPK's k, EARLIEST/LATEST's n and
    ignoreNulls; None where not a literal)."""
    if kind in VECTOR_KINDS:
        return _compile_vector_agg(kind, arg_types, result_type, fname, literals)
    if kind == "stddev":
        return _stddev_agg(fname)
    if kind == "correlation":
        return _correlation_agg()
    if kind == "count_star":
        return DeviceAgg(
            components=(AggComponent("add", "int64", 0),),
            contribs=lambda args, act, seq=None: [act.to(torch.int64)],
            finalize=lambda comps: (comps[0], _ones(comps[0])),
            result_type=T.BIGINT,
        )
    if kind == "count":
        return DeviceAgg(
            components=(AggComponent("add", "int64", 0),),
            contribs=lambda args, act, seq=None: [(act & args[0].valid).to(torch.int64)],
            finalize=lambda comps: (comps[0], _ones(comps[0])),
            result_type=T.BIGINT,
        )
    if kind in ("latest", "earliest"):
        return _offset_agg(kind, arg_types[0])
    if kind == "sum" and result_type.base == SqlBaseType.DECIMAL:
        return _decimal_sum_agg(result_type)
    if kind == "sum":
        t = result_type
        dt = {SqlBaseType.DOUBLE: torch.float64, SqlBaseType.INTEGER: torch.int32}.get(
            t.base, torch.int64
        )
        name = str(dt).replace("torch.", "")

        def sum_contribs(args, act, seq=None):
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

        def mm_contribs(args, act, seq=None):
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
        def avg_contribs(args, act, seq=None):
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
