"""Push-tap residual predicates on the card (B21).

The port of ``ksql_tpu/server/tap_kernel.py``'s ``_lane_fn`` and
``_LaneGroup.fn`` (``_trace_group``): every tap of a predicate family (taps
whose WHERE chains differ only in their literals) is one lane; the
literals are read from per-lane parameter rows ``P_i`` (int64: integers,
booleans, string hashes) and ``P_f`` (float64).  Over a span of ``rows``
ring rows the function gives ``masks[l, r] = active[l] & row_valid[r] &
(every filter of the chain is valid and true for row r under lane l's
parameters)`` and ``counts[l] = min(sum_r masks[l, r], limits[l])``.

* :func:`lane_masks_plain` is the plain torch twin: the family's step
  chain through a :class:`TorchExprCompiler` whose literals read the
  lane's parameters as ``(lanes, 1)`` tensors, so one pass over the
  ``(rows,)`` columns broadcasts to ``(lanes, rows)``.
* :func:`build_program` lowers the chain once to a flat, typed postfix
  program; a select step's outputs are inlined where later steps read
  them.  :func:`run_program` evaluates the program in torch, one opcode at
  a time, so the CPU tests hold the lowering against the twin before any
  card runs it.  :func:`lower_for_kernel` rewrites it once more into the
  form ``csrc/tap_residual.cu`` interprets (bit-keeping casts dropped,
  parameters fused into their ops, stack depths annotated), kept on the
  :class:`Program`.
* :func:`lane_masks` is K25's wrapper: for CUDA tensors it launches the
  kernel on the tensors' stream and counts the launch in
  ``lane_masks.launches``; for CPU tensors it runs the twin.

The kernel has no torch fallback on the card: a build or launch error
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.types import SqlBaseType, SqlType
from ksql_tpu_torch.compiler.torch_expr import (
    DCol,
    DeviceUnsupported,
    TorchExprCompiler,
    between_expr,
    cast_route,
    common_type,
    compare_type,
    decimal_round,
    float_to_int,
    in_list_terms,
    promoted_type,
    simple_case_expr,
    temporal_cast,
    torch_dtype,
)
from ksql_tpu_torch.execution import expressions as ex
from ksql_tpu_torch.execution import steps as st
from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import _stream

# ------------------------------------------------------------ the program
#: limits of one program (``csrc/tap_residual.cu``): a deeper or longer
#: chain stays on the host (ROADMAP C)
MAX_DEPTH = 16
MAX_INSTR = 128
MAX_COLS = 16
MAX_PARAMS = 64

#: value dtype codes
DT_I32, DT_I64, DT_F64, DT_BOOL = 0, 1, 2, 3
_DT_OF = {torch.int32: DT_I32, torch.int64: DT_I64, torch.float64: DT_F64, torch.bool: DT_BOOL}
_TORCH_OF = {v: k for k, v in _DT_OF.items()}

#: opcodes; each instruction is ``(op, a, b, dt)``.  OP_CAST is the typing
#: conversion (widening, integer narrowing that wraps, to bool); OP_SQLCAST
#: is a SQL CAST's own arithmetic (``a`` one of the SC_ kinds below);
#: OP_SELECT pops a condition, an else and a then value and pushes the then
#: value where the condition is valid and true (CASE, nested from its last
#: WHEN)
OP_COL, OP_PARAM_I, OP_PARAM_F, OP_CONST, OP_CAST = 0, 1, 2, 3, 4
OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD = 5, 6, 7, 8, 9
OP_NEG, OP_CMP, OP_AND, OP_OR, OP_NOT, OP_ISNULL, OP_FILTER = 10, 11, 12, 13, 14, 15, 16
OP_SELECT, OP_SQLCAST = 17, 18
#: K25's own (:func:`lower_for_kernel`): a parameter pushed (and cast) for
#: the binary op that takes it as its right operand, as one instruction
#: that pops and pushes the left operand: ``a`` = the op, its code, decimal
#: flag and dtype (a byte each); ``b`` = the push's opcode, dtype and the
#: cast's target (a byte each); ``dt`` = the parameter's index
OP_FUSED = 19
#: OP_SQLCAST kinds: a float to an integer (truncated, saturated, NaN 0);
#: a float to DECIMAL(p, s) (HALF_UP at scale s, NULL at or past 10^(p-s):
#: ``b = s * 64 + (p - s)``); epoch days to ms; ms to epoch days and to
#: time of day, both floored
SC_F2I, SC_DECIMAL, SC_DAYS_TO_MS, SC_MS_TO_DAYS, SC_MS_TO_TIME = 0, 1, 2, 3, 4
_SQLCAST_KINDS = {"days_to_ms": SC_DAYS_TO_MS, "ms_to_days": SC_MS_TO_DAYS, "ms_to_time": SC_MS_TO_TIME}
_SQLCAST_ROUTES = {k: r for r, k in _SQLCAST_KINDS.items()}
#: K25's DECIMAL casts take exact powers of ten only (10^0 .. 10^22)
MAX_POW10 = 22
#: stack effect (pops, pushes) of each opcode
_EFFECT = {OP_COL: (0, 1), OP_PARAM_I: (0, 1), OP_PARAM_F: (0, 1), OP_CONST: (0, 1),
           OP_CAST: (1, 1), OP_ADD: (2, 1), OP_SUB: (2, 1), OP_MUL: (2, 1), OP_DIV: (2, 1),
           OP_MOD: (2, 1), OP_NEG: (1, 1), OP_CMP: (2, 1), OP_AND: (2, 1), OP_OR: (2, 1),
           OP_NOT: (1, 1), OP_ISNULL: (1, 1), OP_FILTER: (1, 0), OP_SELECT: (3, 1),
           OP_SQLCAST: (1, 1), OP_FUSED: (1, 1)}
#: the binary opcodes a parameter fuses into
_BINARY = frozenset({OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD, OP_CMP, OP_AND, OP_OR})
_ARITH_OPS = {ex.ArithOp.ADD: OP_ADD, ex.ArithOp.SUBTRACT: OP_SUB, ex.ArithOp.MULTIPLY: OP_MUL,
              ex.ArithOp.DIVIDE: OP_DIV, ex.ArithOp.MODULUS: OP_MOD}
#: comparison codes (``a`` of OP_CMP)
_CMP_CODES = {ex.CompareOp.EQ: 0, ex.CompareOp.NEQ: 1, ex.CompareOp.LT: 2, ex.CompareOp.LTE: 3,
              ex.CompareOp.GT: 4, ex.CompareOp.GTE: 5, ex.CompareOp.IS_DISTINCT_FROM: 6,
              ex.CompareOp.IS_NOT_DISTINCT_FROM: 7}
#: the SQL type a parameterized literal evaluates as
_PARAM_TYPES = {"BooleanLiteral": T.BOOLEAN, "IntegerLiteral": T.INTEGER, "LongLiteral": T.BIGINT,
                "DoubleLiteral": T.DOUBLE, "DecimalLiteral": T.DOUBLE, "StringLiteral": T.STRING,
                "BytesLiteral": T.BYTES}


def _dt(t: SqlType) -> int:
    return _DT_OF[torch_dtype(t)]


def step_plans(spec) -> list:
    """The family's steps as ``(kind, payload, carries)``: a filter's
    predicate, or a select's expressions with the key columns it carries
    through (against the names live at that step), as ``_lane_fn``'s
    ``plans`` (``tap_kernel.py:311-327`` of the reference)."""
    plans = []
    live = set(spec.col_names)
    for s0 in spec.mask_steps:
        if isinstance(s0, st.StreamFilter):
            plans.append(("filter", s0.predicate, None))
        else:
            carries = [(nn.name, on.name)
                       for nn, on in zip(s0.schema.key_columns, s0.source.schema.key_columns)
                       if on.name in live]
            plans.append(("select", s0.selects, carries))
            live = {nn for nn, _ in carries}
            live.update(name for name, _ in s0.selects)
            live.add("ROWTIME")
    return plans


@dataclasses.dataclass
class Program:
    """A family's chain lowered for K25: ``code`` (n_instr, 4) int64 rows
    ``(op, a, b, dt)``, the stack depth it needs, and the column dtypes it
    reads (``spec.col_names`` order); ``spec`` and ``col_types`` stay for
    the twin.  ``kernel_code``, ``kernel_depth`` and ``staged`` are
    :func:`lower_for_kernel`'s form of ``code``, the one the kernel runs."""

    spec: Any
    col_types: Tuple[SqlType, ...]
    code: np.ndarray
    max_depth: int
    col_dts: Tuple[int, ...]
    kernel_code: np.ndarray
    kernel_depth: int
    staged: Tuple[int, ...]
    _host_code: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)

    @property
    def n_instr(self) -> int:
        return int(self.code.shape[0])

    def host_code(self):
        """``kernel_code`` as the ctypes int64 array K25's entry point
        takes, built once per program."""
        if self._host_code is None:
            self._host_code = cuda.host_i64(self.kernel_code.reshape(-1).tolist())
        return self._host_code


class _Builder:
    """Emits postfix code where :class:`TorchExprCompiler` emits tensor
    ops, with its typing and refusals (``promoted_type``,
    ``compare_type``) and its BETWEEN/IN rewrites (``between_expr``,
    ``in_list_terms``).  ``compile`` returns ``(code, sql_type)``; an
    environment maps a name to ``("col", index, type)`` or ``("expr",
    expression, environment, type)`` (a select's output)."""

    def __init__(self, slots):
        self.slots = slots

    def compile(self, e, env) -> Tuple[list, SqlType]:
        m = getattr(self, "_c_" + type(e).__name__, None)
        if m is None:
            if type(e).__name__ in _PARAM_TYPES:
                return self._param(e)
            raise DeviceUnsupported(f"expression {type(e).__name__}")
        return m(e, env)

    def _param(self, e):
        kind, idx = self.slots[id(e)]
        t = _PARAM_TYPES[type(e).__name__]
        return [(OP_PARAM_I if kind == "i" else OP_PARAM_F, idx, 0, _dt(t))], t

    @staticmethod
    def _cast(code, t_from: SqlType, dt_to: int) -> list:
        d = _dt(t_from)
        return code if d == dt_to else code + [(OP_CAST, d, 0, dt_to)]

    def _bool(self, code, t):
        return self._cast(code, t, DT_BOOL)

    def _c_NullLiteral(self, e, env):
        return [(OP_CONST, 0, 0, DT_I64)], T.STRING

    def _c_ColumnRef(self, e, env):
        b = env.get(e.name)
        if b is None and e.source:
            b = env.get(f"{e.source}.{e.name}")
        if b is None:
            raise DeviceUnsupported(f"column {e.name} not on device")
        if b[0] == "col":
            return [(OP_COL, b[1], 0, _dt(b[2]))], b[2]
        return self.compile(b[1], b[2])

    def _c_ArithmeticBinary(self, e, env):
        ca, ta = self.compile(e.left, env)
        cb, tb = self.compile(e.right, env)
        t = promoted_type(ta, tb)
        d = _dt(t)
        decimal_op = ta.base == SqlBaseType.DECIMAL and tb.base == SqlBaseType.DECIMAL
        code = self._cast(ca, ta, d) + self._cast(cb, tb, d)
        return code + [(_ARITH_OPS[e.op], 0, int(decimal_op), d)], t

    def _c_ArithmeticUnary(self, e, env):
        c, t = self.compile(e.operand, env)
        if not t.is_numeric():
            raise DeviceUnsupported("unary arith on non-numeric")
        return (c + [(OP_NEG, 0, 0, _dt(t))] if e.op == ex.ArithOp.SUBTRACT else c), t

    def _c_Comparison(self, e, env):
        ca, ta = self.compile(e.left, env)
        cb, tb = self.compile(e.right, env)
        d = _dt(compare_type(ta, tb, e.op))
        code = self._cast(ca, ta, d) + self._cast(cb, tb, d)
        return code + [(OP_CMP, _CMP_CODES[e.op], 0, d)], T.BOOLEAN

    def _c_LogicalBinary(self, e, env):
        ca, ta = self.compile(e.left, env)
        cb, tb = self.compile(e.right, env)
        op = OP_AND if e.op == ex.LogicOp.AND else OP_OR
        return self._bool(ca, ta) + self._bool(cb, tb) + [(op, 0, 0, DT_BOOL)], T.BOOLEAN

    def _c_Not(self, e, env):
        c, t = self.compile(e.operand, env)
        return self._bool(c, t) + [(OP_NOT, 0, 0, DT_BOOL)], T.BOOLEAN

    def _c_IsNull(self, e, env):
        c, _ = self.compile(e.operand, env)
        return c + [(OP_ISNULL, 0, 0, DT_BOOL)], T.BOOLEAN

    def _c_IsNotNull(self, e, env):
        c, _ = self.compile(e.operand, env)
        return c + [(OP_ISNULL, 1, 0, DT_BOOL)], T.BOOLEAN

    def _c_Between(self, e, env):
        return self.compile(between_expr(e), env)

    def _c_Cast(self, e, env):
        """TorchExprCompiler._c_Cast's routes (``cast_route``), as code."""
        c, t = self.compile(e.operand, env)
        target = e.target
        route = cast_route(t, target)
        if route == "same":
            return c, target
        if route == "relabel":
            return self._cast(c, t, _dt(target)), target
        if route != "numeric":
            return self._cast(c, t, DT_I64) + [(OP_SQLCAST, _SQLCAST_KINDS[route], 0, DT_I64)], target
        d = DT_F64 if target.base == SqlBaseType.DECIMAL else _dt(target)
        if _dt(t) == DT_F64 and d in (DT_I32, DT_I64):
            c = c + [(OP_SQLCAST, SC_F2I, 0, d)]
        else:
            c = self._cast(c, t, d)
        if target.base == SqlBaseType.DECIMAL and target.scale is not None:
            if target.precision is None or target.scale > MAX_POW10 \
                    or target.precision - target.scale > MAX_POW10:
                raise DeviceUnsupported(f"CAST AS {target} in a fused residual")
            whole = target.precision - target.scale
            c = c + [(OP_SQLCAST, SC_DECIMAL, target.scale * 64 + whole, DT_F64)]
        return c, target

    def _c_SearchedCase(self, e, env):
        """TorchExprCompiler._c_SearchedCase's typing; the WHENs nest from
        the last: ``c1 ? r1 : (c2 ? r2 : default)``."""
        results = [self.compile(w.result, env) for w in e.when_clauses]
        default = self.compile(e.default, env) if e.default is not None else None
        t = common_type([rt for _, rt in results] + ([default[1]] if default else []))
        d = _dt(t)
        code = self._cast(*default, d) if default else [(OP_CONST, 0, 0, d)]
        for w, (rc, rt) in reversed(list(zip(e.when_clauses, results))):
            cc, ct = self.compile(w.condition, env)
            code = self._cast(rc, rt, d) + code + self._bool(cc, ct) + [(OP_SELECT, 0, 0, d)]
        return code, t

    def _c_SimpleCase(self, e, env):
        return self._c_SearchedCase(simple_case_expr(e), env)

    def _c_InList(self, e, env):
        self.compile(e.value, env)  # an unsupported operand refuses the list
        code = None
        for term in in_list_terms(e):
            c, _ = self.compile(term, env)
            code = c if code is None else code + c + [(OP_OR, 0, 0, DT_BOOL)]
        if code is None:
            return [(OP_CONST, 0, 1, DT_BOOL)], T.BOOLEAN
        if e.negated:
            code = code + [(OP_NOT, 0, 0, DT_BOOL)]
        return code, T.BOOLEAN


def build_program(spec, col_types: Sequence[SqlType]) -> Program:
    """Lower the family's ``mask_steps`` to K25's postfix program.  Raises
    :class:`DeviceUnsupported` for what the twin refuses, and for a chain
    past K25's limits (stack depth, length, columns, parameters)."""
    b = _Builder(spec.slots)
    env = {name: ("col", i, t) for i, (name, t) in enumerate(zip(spec.col_names, col_types))}
    code: list = []
    for kind, payload, carries in step_plans(spec):
        if kind == "filter":
            c, t = b.compile(payload, env)
            code += b._bool(c, t) + [(OP_FILTER, 0, 0, DT_BOOL)]
        else:
            out = {nn: env[on] for nn, on in carries}
            for name, e0 in payload:
                _, t = b.compile(e0, env)  # typed (and refused) here, inlined where read
                out[name] = ("expr", e0, env, t)
            out["ROWTIME"] = env["ROWTIME"]
            env = out
    depth = max_depth = 0
    for op, *_ in code:
        pops, pushes = _EFFECT[op]
        depth += pushes - pops
        max_depth = max(max_depth, depth)
    if max_depth > MAX_DEPTH:
        raise DeviceUnsupported(f"residual needs a stack of {max_depth} (K25 holds {MAX_DEPTH})")
    if len(code) > MAX_INSTR:
        raise DeviceUnsupported(f"residual of {len(code)} instructions (K25 holds {MAX_INSTR})")
    if len(spec.col_names) > MAX_COLS:
        raise DeviceUnsupported(f"residual over {len(spec.col_names)} columns (K25 holds {MAX_COLS})")
    if max(len(spec.params_i), len(spec.params_f)) > MAX_PARAMS:
        raise DeviceUnsupported(f"residual with more than {MAX_PARAMS} parameters of a kind")
    arr = np.asarray(code, np.int64).reshape(-1, 4)
    return Program(spec, tuple(col_types), arr, max_depth, tuple(_dt(t) for t in col_types),
                   *lower_for_kernel(arr))


def _keeps_bits(dt_from: int, dt_to: int) -> bool:
    """A cast that leaves a value's 64 bits as K25 holds them (int32 values
    sign-extended, bools 0/1)."""
    return dt_from == dt_to or (dt_to == DT_I64 and dt_from in (DT_I32, DT_BOOL)) or (
        dt_to == DT_I32 and dt_from == DT_BOOL)


def lower_for_kernel(code: np.ndarray) -> Tuple[np.ndarray, int, Tuple[int, ...]]:
    """``code`` as ``csrc/tap_residual.cu`` runs it: the casts that keep a
    value's bits dropped; a parameter pushed (and cast) for the binary op
    right after it fused into that op (:data:`OP_FUSED`); each instruction
    with the stack depth before it; the columns numbered in the order the
    program first loads them.  Returns the ``(n, 5)`` int64 rows ``(op, a,
    b, dt, depth)``, the deepest stack, and the loaded columns (their
    indexes into ``code``'s numbering, in the kernel's order)."""
    code = [tuple(int(x) for x in row) for row in code]
    rows, staged = [], []
    depth = most = 0
    i = 0
    while i < len(code):
        op, a, b, dt = code[i]
        i += 1
        if op == OP_CAST and _keeps_bits(a, dt):
            continue
        if op in (OP_PARAM_I, OP_PARAM_F):
            j, to = i, dt
            if j < len(code) and code[j][0] == OP_CAST and code[j][1] == to:
                to = code[j][3]
                j += 1
            if j < len(code) and code[j][0] in _BINARY:
                bop, bcode, bdec, bdt = code[j]
                op, a, b, dt = (OP_FUSED, bop | bcode << 8 | bdec << 16 | bdt << 24,
                                op | dt << 8 | to << 16, a)
                i = j + 1
        if op == OP_COL:
            if a not in staged:
                staged.append(a)
            a = staged.index(a)
        rows.append((op, a, b, dt, depth))
        pops, pushes = _EFFECT[op]
        depth += pushes - pops
        most = max(most, depth)
    return np.asarray(rows, np.int64).reshape(-1, 5), most, tuple(staged)


# ----------------------------------------------------------------- the twin
class _ParamCompiler(TorchExprCompiler):
    """Literals read from the lanes' parameter rows (``_ParamCompiler`` of
    the reference): each is a ``(lanes, 1)`` column.  A parameter is no
    constant to XLA, so a division by one stays a quotient."""

    folds_literals = False

    def __init__(self, env, n, device, slots, p_i, p_f):
        super().__init__(env, n, device)
        self._slots = slots
        self._p_i = p_i
        self._p_f = p_f

    def _param_col(self, e, sql_type):
        kind, idx = self._slots[id(e)]
        vec = self._p_i if kind == "i" else self._p_f
        data = vec[:, idx:idx + 1].to(torch_dtype(sql_type))
        return DCol(data, torch.ones(data.shape, dtype=torch.bool, device=data.device), sql_type)

    def _c_BooleanLiteral(self, e):
        return self._param_col(e, T.BOOLEAN)

    def _c_IntegerLiteral(self, e):
        return self._param_col(e, T.INTEGER)

    def _c_LongLiteral(self, e):
        return self._param_col(e, T.BIGINT)

    def _c_DoubleLiteral(self, e):
        return self._param_col(e, T.DOUBLE)

    def _c_DecimalLiteral(self, e):
        return self._param_col(e, T.DOUBLE)

    def _c_StringLiteral(self, e):
        return self._param_col(e, T.STRING)

    def _c_BytesLiteral(self, e):
        return self._param_col(e, T.BYTES)


def lane_masks_plain(spec, col_types, datas, valids, P_i, P_f, active, row_valid, limits):
    """Plain twin of K25 (``_trace_group`` of the reference) — see
    :func:`lane_masks`."""
    n = datas[0].shape[0]
    dev = datas[0].device
    env = {name: DCol(d, v, t) for name, d, v, t in zip(spec.col_names, datas, valids, col_types)}
    mask = torch.ones((P_i.shape[0], n), dtype=torch.bool, device=dev)
    for kind, payload, carries in step_plans(spec):
        comp = _ParamCompiler(env, n, dev, spec.slots, P_i, P_f)
        if kind == "filter":
            p = comp.compile(payload)
            # a NULL predicate is not True: the row drops (oracle FilterNode)
            mask = mask & p.valid & p.data.to(torch.bool)
        else:
            out = {nn: env[on] for nn, on in carries}
            for name, e0 in payload:
                out[name] = comp.compile(e0)
            out["ROWTIME"] = env["ROWTIME"]
            env = out
    masks = mask & active[:, None] & row_valid[None, :]
    counts = torch.minimum(masks.sum(dim=1, dtype=torch.int64), limits)
    return masks, counts


# ----------------------------------------------------- the program in torch
def _as(x: torch.Tensor, dt: int) -> torch.Tensor:
    return x.to(_TORCH_OF[dt])


def run_program(prog: Program, datas, valids, P_i, P_f, active, row_valid, limits):
    """K25's program evaluated in torch, one opcode at a time over
    ``(lanes, rows)`` tensors: the CPU check of :func:`build_program`
    against the twin (same outputs as :func:`lane_masks`)."""
    lanes, n = P_i.shape[0], datas[0].shape[0]
    dev = datas[0].device
    ones = torch.ones((lanes, n), dtype=torch.bool, device=dev)
    stack: List[Tuple[torch.Tensor, torch.Tensor]] = []
    mask = ones
    for op, a, b, dt in prog.code.tolist():
        if op == OP_COL:
            stack.append((datas[a].expand(lanes, n), valids[a].expand(lanes, n)))
        elif op in (OP_PARAM_I, OP_PARAM_F):
            vec = P_i if op == OP_PARAM_I else P_f
            stack.append((_as(vec[:, a:a + 1], dt).expand(lanes, n), ones))
        elif op == OP_CONST:
            stack.append((torch.full((lanes, n), a, dtype=_TORCH_OF[dt], device=dev), ones & bool(b)))
        elif op == OP_CAST:
            x, v = stack.pop()
            stack.append((_as(x, dt), v))
        elif op == OP_NEG:
            x, v = stack.pop()
            stack.append((-x, v))
        elif op == OP_NOT:
            x, v = stack.pop()
            stack.append((~x, v))
        elif op == OP_ISNULL:
            _, v = stack.pop()
            stack.append((v if a else ~v, ones))
        elif op == OP_FILTER:
            x, v = stack.pop()
            mask = mask & v & x
        elif op == OP_SELECT:
            (c, vc), (y, vy), (x, vx) = stack.pop(), stack.pop(), stack.pop()
            fire = vc & c
            stack.append((torch.where(fire, x, y), torch.where(fire, vx, vy)))
        elif op == OP_SQLCAST:
            x, v = stack.pop()
            stack.append(_sql_cast(a, b, dt, x, v))
        else:
            (y, vy), (x, vx) = stack.pop(), stack.pop()
            stack.append(_binary(op, a, b, dt, x, vx, y, vy))
    masks = mask & active[:, None] & row_valid[None, :]
    return masks, torch.minimum(masks.sum(dim=1, dtype=torch.int64), limits)


def _sql_cast(kind, b, dt, x, v):
    """OP_SQLCAST in torch, through TorchExprCompiler._c_Cast's helpers."""
    if kind == SC_F2I:
        return float_to_int(x, _TORCH_OF[dt]), v
    if kind == SC_DECIMAL:
        whole, scale = b % 64, b // 64
        out, within = decimal_round(x, scale + whole, scale)
        return out, v & within
    return temporal_cast(_SQLCAST_ROUTES[kind], x), v


def _binary(op, a, b, dt, x, vx, y, vy):
    valid = vx & vy
    if op == OP_ADD:
        return x + y, valid
    if op == OP_SUB:
        return x - y, valid
    if op == OP_MUL:
        return x * y, valid
    if op in (OP_DIV, OP_MOD):
        if dt in (DT_I32, DT_I64) or b:
            zero = y == 0
            safe = torch.where(zero, torch.ones_like(y), y)
            if dt in (DT_I32, DT_I64):
                wrap = (x == torch.iinfo(x.dtype).min) & (y == -1)
                safe = torch.where(wrap, torch.ones_like(y), safe)
                out = torch.div(x, safe, rounding_mode="trunc") if op == OP_DIV else torch.fmod(x, safe)
            else:
                out = x / safe if op == OP_DIV else torch.fmod(x, safe)
            return out, valid & ~zero
        if op == OP_DIV:
            return x / y, valid
        nan = torch.full_like(x, float("nan"))
        return torch.where(y != 0, torch.fmod(x, torch.where(y == 0, torch.ones_like(y), y)), nan), valid
    if op == OP_CMP:
        if a in (0, 6, 7):
            out = x == y if a != 6 else x != y
        else:
            out = {1: x != y, 2: x < y, 3: x <= y, 4: x > y, 5: x >= y}[a]
        if a == 6:
            out = torch.where(valid, out, vx != vy)
        elif a == 7:
            out = torch.where(valid, out, vx == vy)
        else:
            out = out & valid
        return out, torch.ones_like(valid)
    av, bv = vx & x, vy & y
    if op == OP_AND:
        return av & bv, valid | (vx & ~x) | (vy & ~y)
    return av | bv, valid | av | bv


# ------------------------------------------------------------ K25: the kernel
def lane_masks(prog: Program, datas, valids, P_i, P_f, active, row_valid, limits):
    """K25 (replaces ``server/tap_kernel.py:_lane_fn`` vmapped over lanes in
    ``_LaneGroup.fn``): ``datas``/``valids`` are the span's columns in
    ``prog.spec.col_names`` order, ``rows`` long (int32, int64, float64
    or bool data; bool validity); ``P_i`` (lanes, n_i) int64 and ``P_f``
    (lanes, n_f) float64 the lanes' parameters; ``active`` (lanes,) bool;
    ``row_valid`` (rows,) bool; ``limits`` (lanes,) int64.  Returns
    ``(masks, counts)``: (lanes, rows) bool and (lanes,) int64, ``counts``
    clipped by ``limits``.  One launch: a block takes a tile of 512 rows
    and a group of lanes, stages the tile's columns and the lanes'
    parameters in shared memory, and each thread interprets the program
    over 4 rows with the top of its stack in registers; the lanes' counts
    meet in the per-device scratch (``lane_masks.scratch``: two words a
    lane, 0 between calls), where the lane's last block clips them."""
    if not datas[0].is_cuda:
        return lane_masks_plain(prog.spec, prog.col_types, datas, valids, P_i, P_f, active,
                                row_valid, limits)
    lanes, n = P_i.shape[0], datas[0].shape[0]
    dev = datas[0].device
    for d, v, dt in zip(datas, valids, prog.col_dts):
        if _DT_OF.get(d.dtype) != dt or d.shape != (n,) or not d.is_contiguous() or not d.is_cuda:
            raise ValueError(f"K25 column: expected contiguous {_TORCH_OF[dt]}[{n}] on the card, "
                             f"got {d.dtype}{list(d.shape)}")
        if v.dtype != torch.bool or v.shape != (n,) or not v.is_contiguous() or not v.is_cuda:
            raise ValueError("K25 validity: expected a contiguous bool column on the card")
    for t, dtype, shape in ((P_i, torch.int64, (lanes, P_i.shape[1])),
                            (P_f, torch.float64, (lanes, P_f.shape[1])),
                            (active, torch.bool, (lanes,)), (row_valid, torch.bool, (n,)),
                            (limits, torch.int64, (lanes,))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"K25 argument: expected contiguous {dtype}{list(shape)} on the card, "
                             f"got {t.dtype}{list(t.shape)}")
    masks = torch.empty((lanes, n), dtype=torch.bool, device=dev)
    counts = torch.empty(lanes, dtype=torch.int64, device=dev)
    if lanes == 0:
        return masks, counts
    cols = []
    for c in prog.staged:
        cols += [datas[c].data_ptr(), valids[c].data_ptr(), prog.col_dts[c]]
    scratch = lane_masks.scratch.get(dev)
    if scratch is None or scratch.shape[0] < 2 * lanes:
        scratch = lane_masks.scratch[dev] = torch.zeros(2 * lanes, dtype=torch.int64, device=dev)
    fn = cuda.lib("tap_residual")
    code = fn(
        prog.host_code(), prog.kernel_code.shape[0], prog.kernel_depth, cuda.host_i64(cols),
        len(prog.staged), P_i.data_ptr(), P_i.shape[1], P_f.data_ptr(), P_f.shape[1], active.data_ptr(),
        row_valid.data_ptr(), n, lanes, limits.data_ptr(), masks.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), _stream(dev),
    )
    if code != 0:  # the launch may not have left the scratch at 0
        del lane_masks.scratch[dev]
    cuda.check("tap_residual", code)
    lane_masks.launches += 1
    return masks, counts


lane_masks.launches = 0
#: per device, the lanes' count accumulators and tickets (int64, two words
#: a lane, grown to the widest family; 0 between calls: the kernel's last
#: block of each lane resets its words)
lane_masks.scratch = {}
# named by its kernel's source (``csrc/tap_residual.cu``), as the other
# wrappers are: the chip check's launch records key on the name
lane_masks.__name__ = "tap_residual"

KERNEL_WRAPPERS = (lane_masks,)
