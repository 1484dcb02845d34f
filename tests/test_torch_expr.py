"""TorchExprCompiler against the reference's JaxExprCompiler.

The same expression trees (built with the reference's node classes, carried
into the port through the plan JSON codec) compile over the same columns
with both compilers; every DCol's ``data`` and ``valid`` must match exactly,
null lanes included.  Nodes the port does not lower raise DeviceUnsupported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.common import types as RT
from ksql_tpu.common.batch import stable_hash64
from ksql_tpu.compiler.jax_expr import DCol as RCol
from ksql_tpu.compiler.jax_expr import JaxExprCompiler
from ksql_tpu.execution import expressions as rex
from ksql_tpu_torch.common import types as PT
from ksql_tpu_torch.compiler.torch_expr import DCol as PCol
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported, TorchExprCompiler, _decode_repr, _repr64
from ksql_tpu_torch.execution import expressions as pex

jax.config.update("jax_enable_x64", True)

N = 64
COLS = {"I": "INTEGER", "B": "BIGINT", "D": "DOUBLE", "F": "BOOLEAN", "S": "STRING", "S2": "STRING"}


def _columns():
    rng = np.random.default_rng(7)
    cols = {
        "I": rng.integers(-50, 50, N).astype(np.int32),
        "B": rng.integers(-10**12, 10**12, N),
        "D": rng.standard_normal(N) * 10,
        "F": rng.random(N) > 0.5,
        "S": np.array([stable_hash64(f"s{i % 5}") for i in range(N)], np.int64),
        "S2": np.array([stable_hash64(f"s{i % 3}") for i in range(N)], np.int64),
    }
    cols["I"][:4] = [0, np.iinfo(np.int32).min, -1, 7]
    cols["B"][:4] = [0, np.iinfo(np.int64).min, -1, 7]
    cols["D"][:3] = [0.0, -0.0, np.inf]
    valid = {k: rng.random(N) > 0.15 for k in cols}
    return cols, valid


def _envs():
    cols, valid = _columns()
    ref_env, port_env = {}, {}
    for name, t in COLS.items():
        ref_env[name] = RCol(jnp.asarray(cols[name]), jnp.asarray(valid[name]), RT.SqlType.of(RT.SqlBaseType(t)))
        port_env[name] = PCol(torch.from_numpy(cols[name]), torch.from_numpy(valid[name]),
                              PT.SqlType.of(PT.SqlBaseType(t)))
    return ref_env, port_env


def c(name):
    return rex.ColumnRef(name)


A, C, L = rex.ArithOp, rex.CompareOp, rex.LogicOp
SUPPORTED = {
    "colref": c("B"),
    "int_lit": rex.IntegerLiteral(3),
    "long_lit": rex.LongLiteral(-(2**40)),
    "double_lit": rex.DoubleLiteral(2.5),
    "decimal_lit": rex.DecimalLiteral("1.25"),
    "string_lit": rex.StringLiteral("s1"),
    "bool_lit": rex.BooleanLiteral(True),
    "null_lit": rex.NullLiteral(),
    "add_int_long": rex.ArithmeticBinary(A.ADD, c("I"), c("B")),
    "sub_double": rex.ArithmeticBinary(A.SUBTRACT, c("D"), c("I")),
    "mul_long": rex.ArithmeticBinary(A.MULTIPLY, c("B"), rex.IntegerLiteral(2)),
    "div_int": rex.ArithmeticBinary(A.DIVIDE, c("B"), c("I")),
    "div_double": rex.ArithmeticBinary(A.DIVIDE, c("D"), c("I")),
    "mod_int": rex.ArithmeticBinary(A.MODULUS, c("I"), rex.IntegerLiteral(7)),
    "mod_long_by_col": rex.ArithmeticBinary(A.MODULUS, c("B"), c("I")),
    "mod_double": rex.ArithmeticBinary(A.MODULUS, c("D"), rex.DoubleLiteral(0.0)),
    "neg": rex.ArithmeticUnary(A.SUBTRACT, c("D")),
    "gt_mixed": rex.Comparison(C.GT, c("D"), c("I")),
    "lte_long": rex.Comparison(C.LTE, c("B"), rex.LongLiteral(0)),
    "eq_string": rex.Comparison(C.EQ, c("S"), rex.StringLiteral("s2")),
    "neq_string_cols": rex.Comparison(C.NEQ, c("S"), c("S2")),
    "eq_bool": rex.Comparison(C.EQ, c("F"), rex.BooleanLiteral(False)),
    "distinct": rex.Comparison(C.IS_DISTINCT_FROM, c("S"), c("S2")),
    "not_distinct": rex.Comparison(C.IS_NOT_DISTINCT_FROM, c("I"), c("B")),
    "and_nulls": rex.LogicalBinary(L.AND, c("F"), rex.Comparison(C.GT, c("I"), rex.IntegerLiteral(0))),
    "or_nulls": rex.LogicalBinary(L.OR, c("F"), rex.Comparison(C.LT, c("D"), rex.IntegerLiteral(0))),
    "not": rex.Not(c("F")),
    "is_null": rex.IsNull(c("D")),
    "is_not_null": rex.IsNotNull(c("S")),
    "between": rex.Between(c("I"), rex.IntegerLiteral(0), rex.IntegerLiteral(5)),
    "not_between_mixed": rex.Between(c("D"), c("I"), rex.DoubleLiteral(3.5), negated=True),
    "between_cols": rex.Between(c("B"), c("I"), rex.LongLiteral(2**40)),
    "in_list": rex.InList(c("I"), (rex.IntegerLiteral(1), c("B"), rex.IntegerLiteral(7))),
    "not_in_list": rex.InList(c("D"), (rex.DoubleLiteral(0.0), c("I")), negated=True),
    "in_strings": rex.InList(c("S"), (rex.StringLiteral("s1"), c("S2"))),
    "in_empty": rex.InList(c("I"), ()),
}


def _port(e):
    """The reference node tree as the port's nodes (plan JSON codec)."""
    return pex.decode(rex.encode(e))


@pytest.mark.parametrize("name", list(SUPPORTED))
def test_supported_expression_matches_reference(name):
    ref_env, port_env = _envs()
    e = SUPPORTED[name]
    want = JaxExprCompiler(ref_env, N).compile(e)
    got = TorchExprCompiler(port_env, N, "cpu").compile(_port(e))
    assert got.sql_type.base.value == want.sql_type.base.value
    wd, gd = np.asarray(want.data), got.data.numpy()
    assert gd.dtype == wd.dtype
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if gd.dtype == np.float64:
        np.testing.assert_array_equal(gd, wd)  # NaN == NaN here
        np.testing.assert_array_equal(np.signbit(gd), np.signbit(wd))
    else:
        np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("name", ["I", "B", "D", "F", "S"])
def test_key_repr_matches_reference_and_decodes(name):
    from ksql_tpu.runtime.lowering import _decode_repr as ref_decode
    from ksql_tpu.runtime.lowering import _repr64 as ref_repr64

    ref_env, port_env = _envs()
    want = np.asarray(ref_repr64(ref_env[name]))
    got = _repr64(port_env[name]).numpy()
    np.testing.assert_array_equal(got, want)
    t = port_env[name].sql_type
    np.testing.assert_array_equal(_decode_repr(got, t), ref_decode(want, ref_env[name].sql_type))


UNSUPPORTED = {
    "cast": rex.Cast(c("I"), RT.DOUBLE),
    # BETWEEN and IN lower: over strings they need ordering, and
    # a string against a number does not compare
    "between": rex.Between(c("S"), rex.StringLiteral("a"), rex.StringLiteral("z")),
    "in_list": rex.InList(c("S"), (rex.IntegerLiteral(1),)),
    "between_null_bound": rex.Between(c("B"), rex.NullLiteral(), c("I")),
    "searched_case": rex.SearchedCase((rex.WhenClause(c("F"), c("I")),), None),
    "function": rex.FunctionCall("ABS", (c("D"),)),
    "like": rex.Like(c("S"), rex.StringLiteral("s%")),
    "string_order": rex.Comparison(C.LT, c("S"), c("S2")),
    "string_arith": rex.ArithmeticBinary(A.ADD, c("S"), c("I")),
    "missing_column": c("NOPE"),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_expression_raises(name):
    _ref_env, port_env = _envs()
    with pytest.raises(DeviceUnsupported):
        TorchExprCompiler(port_env, N, "cpu").compile(_port(UNSUPPORTED[name]))
