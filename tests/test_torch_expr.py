"""TorchExprCompiler against the reference's JaxExprCompiler.

The same expression trees (built with the reference's node classes, carried
into the port through the plan JSON codec) compile over the same columns
with both compilers (the reference's under ``jax.jit``, as its device step
runs it); every DCol's ``data`` and ``valid`` must match exactly, null
lanes included.  Nodes the port does not lower raise DeviceUnsupported,
in the reference's words.  The casts cover every numeric and temporal pair
the reference takes (saturating float-to-integer, wrapping integer
narrowing, DECIMAL rounding HALF_UP and nulling past its precision, DATE and
TIME floored for pre-epoch timestamps), CASE with and without ELSE, struct
field paths and all 13 device functions.  EXP and LN are held to one unit in
the last place: XLA's CPU exp and log are not correctly rounded (numpy's,
which the port's CPU path takes, are within it).
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
#: the casts' and functions' columns: a DECIMAL(10, 2), a double with NaN,
#: infinities and values past every integer range, the temporals (some
#: pre-epoch), and a struct leaf's flattened path column
MORE = {"DEC": RT.SqlType.decimal(10, 2), "X": RT.DOUBLE, "TS": RT.TIMESTAMP, "DT": RT.DATE,
        "TM": RT.TIME, "P": RT.DOUBLE, "ST->A": RT.INTEGER}


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


def _more_columns():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(N) * 10.0 ** rng.integers(0, 22, N)
    x[:10] = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e19, -1e19, 2.5, -2.5, -0.0]
    cols = {
        "DEC": np.round(rng.uniform(-10**6, 10**6, N), 2),
        "X": x,
        "TS": rng.integers(-10**12, 10**13, N),
        "DT": rng.integers(-20000, 20000, N).astype(np.int32),
        "TM": rng.integers(0, 86_400_000, N).astype(np.int32),
        "P": rng.integers(-3, 4, N).astype(np.float64),
        "ST->A": rng.integers(-99, 99, N).astype(np.int32),
    }
    cols["DEC"][:4] = [0.005, -0.005, 99_999_999.99, -1.125]
    cols["TS"][:3] = [-1, -86_400_000, -86_400_001]
    return cols, {k: rng.random(N) > 0.15 for k in cols}


def _envs():
    cols, valid = _columns()
    ref_env, port_env = {}, {}
    for name, t in COLS.items():
        ref_env[name] = RCol(jnp.asarray(cols[name]), jnp.asarray(valid[name]), RT.SqlType.of(RT.SqlBaseType(t)))
        port_env[name] = PCol(torch.from_numpy(cols[name]), torch.from_numpy(valid[name]),
                              PT.SqlType.of(PT.SqlBaseType(t)))
    more, mvalid = _more_columns()
    for name, t in MORE.items():
        ref_env[name] = RCol(jnp.asarray(more[name]), jnp.asarray(mvalid[name]), t)
        port_env[name] = PCol(torch.from_numpy(more[name]), torch.from_numpy(mvalid[name]),
                              PT.SqlType.from_json(t.to_json()))
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

_NUMERIC_TARGETS = {"int": RT.INTEGER, "bigint": RT.BIGINT, "double": RT.DOUBLE,
                    "dec10_2": RT.SqlType.decimal(10, 2), "dec4_1": RT.SqlType.decimal(4, 1),
                    "dec12_0": RT.SqlType.decimal(12, 0)}
for _src in ("I", "B", "D", "X", "DEC"):
    for _tn, _tt in _NUMERIC_TARGETS.items():
        if _src == "DEC" and _tt.base == RT.SqlBaseType.DECIMAL:
            continue  # a DECIMAL rescale is refused (UNSUPPORTED)
        SUPPORTED[f"cast_{_src}_{_tn}"] = rex.Cast(c(_src), _tt)
for _src in ("I", "B"):
    for _tt in (RT.TIMESTAMP, RT.DATE, RT.TIME):
        SUPPORTED[f"cast_{_src}_{_tt.base.value.lower()}"] = rex.Cast(c(_src), _tt)
SUPPORTED.update({
    "cast_time_timestamp": rex.Cast(c("TM"), RT.TIMESTAMP),
    "cast_date_timestamp": rex.Cast(c("DT"), RT.TIMESTAMP),
    "cast_timestamp_date": rex.Cast(c("TS"), RT.DATE),
    "cast_timestamp_time": rex.Cast(c("TS"), RT.TIME),
    "cast_same_decimal": rex.Cast(c("DEC"), RT.SqlType.decimal(10, 2)),
    "cast_bool_bool": rex.Cast(c("F"), RT.BOOLEAN),
    "cast_string_string": rex.Cast(c("S"), RT.STRING),
    "cast_nested": rex.Cast(rex.Cast(c("X"), RT.BIGINT), RT.INTEGER),
    "case_else": rex.SearchedCase((rex.WhenClause(rex.Comparison(C.GT, c("I"), rex.IntegerLiteral(0)),
                                                  c("B")),
                                   rex.WhenClause(c("F"), c("I"))), c("I")),
    "case_no_else": rex.SearchedCase((rex.WhenClause(c("F"), c("D")),
                                      rex.WhenClause(rex.IsNull(c("I")), c("I"))), None),
    "case_strings": rex.SearchedCase((rex.WhenClause(c("F"), c("S")),), rex.StringLiteral("zz")),
    "case_ints": rex.SearchedCase((rex.WhenClause(rex.Comparison(C.LT, c("D"), rex.IntegerLiteral(0)),
                                                  rex.IntegerLiteral(1)),), rex.IntegerLiteral(0)),
    "simple_case": rex.SimpleCase(c("I"), (rex.WhenClause(rex.IntegerLiteral(7), c("D")),
                                           rex.WhenClause(rex.IntegerLiteral(0), c("B"))),
                                  rex.DoubleLiteral(-1.0)),
    "simple_case_strings": rex.SimpleCase(c("S"), (rex.WhenClause(rex.StringLiteral("s1"), c("I")),),
                                          None),
    "deref": rex.Dereference(c("ST"), "A"),
    "deref_arith": rex.ArithmeticBinary(A.ADD, rex.Dereference(c("ST"), "A"), c("I")),
    "as_value": rex.FunctionCall("AS_VALUE", (c("S"),)),
    "abs_int": rex.FunctionCall("ABS", (c("I"),)),
    "abs_double": rex.FunctionCall("ABS", (c("X"),)),
    "round_int": rex.FunctionCall("ROUND", (c("B"),)),
    "round_double": rex.FunctionCall("ROUND", (c("X"),)),
    "round_decimal": rex.FunctionCall("ROUND", (c("DEC"),)),
    "round_places": rex.FunctionCall("ROUND", (c("D"), c("P"))),
    "floor": rex.FunctionCall("FLOOR", (c("X"),)),
    "ceil": rex.FunctionCall("CEIL", (c("I"),)),
    "sqrt": rex.FunctionCall("SQRT", (c("D"),)),
    "sign_double": rex.FunctionCall("SIGN", (c("X"),)),
    "sign_int": rex.FunctionCall("SIGN", (c("B"),)),
    "greatest": rex.FunctionCall("GREATEST", (c("I"), c("D"), c("X"))),
    "least": rex.FunctionCall("LEAST", (c("B"), c("I"))),
    "coalesce": rex.FunctionCall("COALESCE", (c("I"), c("B"), rex.LongLiteral(-1))),
    "ifnull": rex.FunctionCall("IFNULL", (c("S"), c("S2"))),
})
#: held to one unit in the last place (module docstring)
ULP_SUPPORTED = {
    "exp": rex.FunctionCall("EXP", (c("D"),)),
    "ln": rex.FunctionCall("LN", (c("DEC"),)),
}


def _port(e):
    """The reference node tree as the port's nodes (plan JSON codec)."""
    return pex.decode(rex.encode(e))


def _ref_jitted(ref_env, e):
    """The reference's DCol for ``e`` as its device step computes it: the
    compiler traced under ``jax.jit`` over the columns, so XLA's algebraic
    simplifier sees the whole expression (ROADMAP C11, C13, C14)."""
    types = {}

    @jax.jit
    def run(data, valid):
        env = {k: RCol(data[k], valid[k], ref_env[k].sql_type) for k in ref_env}
        col = JaxExprCompiler(env, N).compile(e)
        types["t"] = col.sql_type
        return col.data, col.valid

    data, valid = run({k: v.data for k, v in ref_env.items()},
                      {k: v.valid for k, v in ref_env.items()})
    return RCol(data, valid, types["t"])


@pytest.mark.parametrize("name", list(SUPPORTED))
def test_supported_expression_matches_reference(name):
    ref_env, port_env = _envs()
    e = SUPPORTED[name]
    want = _ref_jitted(ref_env, e)
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


@pytest.mark.parametrize("name", list(ULP_SUPPORTED))
def test_transcendental_function_within_one_ulp_of_reference(name):
    ref_env, port_env = _envs()
    e = ULP_SUPPORTED[name]
    want = JaxExprCompiler(ref_env, N).compile(e)
    got = TorchExprCompiler(port_env, N, "cpu").compile(_port(e))
    assert got.sql_type.base.value == want.sql_type.base.value
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    wd, gd = np.asarray(want.data), got.data.numpy()
    assert gd.dtype == wd.dtype
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(wd))
    fin = ~np.isnan(wd)
    np.testing.assert_array_max_ulp(gd[fin], wd[fin], maxulp=1)


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
    # CAST, CASE and the device functions lower: a DECIMAL rescale, CASE
    # over mixed types and a function outside the table stay refused
    "cast": rex.Cast(c("DEC"), RT.SqlType.decimal(12, 3)),
    # BETWEEN and IN lower: over strings they need ordering, and
    # a string against a number does not compare
    "between": rex.Between(c("S"), rex.StringLiteral("a"), rex.StringLiteral("z")),
    "in_list": rex.InList(c("S"), (rex.IntegerLiteral(1),)),
    "between_null_bound": rex.Between(c("B"), rex.NullLiteral(), c("I")),
    "searched_case": rex.SearchedCase((rex.WhenClause(c("F"), c("I")),), c("S")),
    "function": rex.FunctionCall("UCASE", (c("S"),)),
    "cast_nested_type": rex.Cast(c("S"), RT.SqlType.array(RT.STRING)),
    "cast_string_int": rex.Cast(c("S"), RT.INTEGER),
    "deref_without_path": rex.Dereference(c("NOPE"), "A"),
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


@pytest.mark.parametrize("name", ["cast", "searched_case", "function", "cast_nested_type",
                                  "cast_string_int", "deref_without_path"])
def test_refusal_words_are_the_references(name):
    ref_env, port_env = _envs()
    with pytest.raises(Exception) as ref_err:
        JaxExprCompiler(ref_env, N).compile(UNSUPPORTED[name])
    with pytest.raises(DeviceUnsupported) as port_err:
        TorchExprCompiler(port_env, N, "cpu").compile(_port(UNSUPPORTED[name]))
    assert str(port_err.value) == str(ref_err.value)
