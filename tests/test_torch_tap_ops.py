"""K25's twin and program (``ops/tap_residual.py``) and the port's residual
classification (``server/tap_kernel.py``) against the reference's
``classify_residual`` and ``_LaneGroup.fn()`` on the JAX CPU backend.

Each case is a predicate family: push queries over one stream, planned by
the reference engine; the port decodes the same plans (``plan_to_json``).
Both packages classify every query (signature, parameters, columns and
refusals must be equal), pack the family's lanes, and run its lane
function over the same seeded columns (5-10% NULLs, NaN, +-0.0, +-inf,
INT_MIN/INT_MAX, zero divisors, padding rows, inactive lanes, partial
LIMIT budgets).  The masks and counts of ``lane_masks_plain`` and of the
torch evaluator of ``build_program``'s program (``run_program``) must
equal the reference's exactly: they are bool and int.  The form K25 runs
(``lower_for_kernel``) must expand back to the program.  Then K25's edges
(``tests/torch_kernel_cases.py``'s TAP_EDGES) the same way, from plan
JSONs that both packages decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.analyzer.analyzer import analyze_query
from ksql_tpu.common.batch import stable_hash64
from ksql_tpu.common.config import KsqlConfig
from ksql_tpu.compiler.jax_expr import _dtype_for
from ksql_tpu.engine.engine import KsqlEngine
from ksql_tpu.execution import expressions as rex
from ksql_tpu.execution import steps as rst
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.server import tap_kernel as rtk
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.ops import tap_residual as tr
from ksql_tpu_torch.server import push_registry as preg
from ksql_tpu_torch.server import tap_kernel as ptk
from tests.torch_kernel_cases import TAP_EDGES, tap_edge_case, tap_edge_plans

jax.config.update("jax_enable_x64", True)

DDL = ("CREATE STREAM S (ID BIGINT, V BIGINT, P DOUBLE, TAG STRING, I INT, J INT, B BOOLEAN) "
       "WITH (kafka_topic='s', value_format='JSON');")
TAGS = ("t0", "t1", "t2", "t3")
I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)


def _engine():
    e = KsqlEngine(KsqlConfig({"ksql.runtime.backend": "oracle"}))
    e.execute_sql(DDL)
    return e


ENGINE = None


def _plans(sql):
    """(reference plan, port plan) of a push query."""
    global ENGINE
    if ENGINE is None:
        ENGINE = _engine()
    a = analyze_query(ENGINE.parse(sql)[0].statement, ENGINE.metastore, ENGINE.registry)
    plan = ENGINE.planner.plan(a, "transient_ops").plan
    return plan, plan_from_json(plan_to_json(plan))


def _chains(sql):
    from ksql_tpu.server.push_registry import residual_chain as rchain

    rplan, pplan = _plans(sql)
    return rchain(rplan), preg.residual_chain(pplan)


def _classify(rchain, pchain):
    """Both packages' classification, or the refusal of both."""
    try:
        rspec = rtk.classify_residual(rchain[:-1], rchain[-1].schema)
    except rtk.ResidualUnsupported:
        rspec = "refused"
    try:
        pspec = ptk.classify_residual(pchain[:-1], pchain[-1].schema)
    except ptk.ResidualUnsupported:
        pspec = "refused"
    return rspec, pspec


def _columns(rng, col_names, types, n, null_frac=0.08):
    """Seeded columns: numpy data and validity per column, with specials."""
    datas, valids = [], []
    for name, t in zip(col_names, types):
        base = str(t)
        if name == "ROWTIME":
            d = rng.integers(0, 1 << 40, n).astype(np.int64)
        elif base == "STRING":
            d = np.array([stable_hash64(TAGS[k]) for k in rng.integers(0, len(TAGS), n)], np.int64)
        elif base == "BOOLEAN":
            d = rng.random(n) < 0.5
        elif base == "DOUBLE":
            d = np.round(rng.normal(0, 20, n), 1)
            sp = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 7.5, 0.5, 1.5])
            pick = rng.random(n) < 0.2
            d[pick] = sp[rng.integers(0, len(sp), pick.sum())]
        elif base == "INTEGER":
            d = rng.integers(-50, 50, n).astype(np.int32)
            sp = np.array([I32.min, I32.max, 0, -1, 2, 1 << 20], np.int32)
            pick = rng.random(n) < 0.25
            d[pick] = sp[rng.integers(0, len(sp), pick.sum())]
        else:
            d = rng.integers(-60, 60, n).astype(np.int64)
            sp = np.array([I64.min, I64.max, 0, -1, 64, 6, 40], np.int64)
            pick = rng.random(n) < 0.15
            d[pick] = sp[rng.integers(0, len(sp), pick.sum())]
        v = rng.random(n) >= (0.0 if name == "ROWTIME" else null_frac)
        datas.append(d)
        valids.append(v)
    return datas, valids


def _run_family(queries, seed=0, n=512, limits=None, inactive=()):
    """Classify every query in both packages, pack the lanes, run both lane
    functions; returns the reference's (masks, counts), then the twin's, the
    program's and the wrapper's (on CPU tensors, the twin)."""
    specs = []
    for q in queries:
        rspec, pspec = _classify(*_chains(q))
        assert (rspec == "refused") == (pspec == "refused"), q
        assert rspec != "refused", q
        assert pspec.signature == rspec.signature, q
        assert pspec.col_names == rspec.col_names, q
        np.testing.assert_array_equal(pspec.params_i, rspec.params_i)
        np.testing.assert_array_equal(pspec.params_f, rspec.params_f)
        specs.append((rspec, pspec))
    assert len({r.signature for r, _ in specs}) == 1, "one family"
    rchain = _chains(queries[0])[0]
    schema_r = {c.name: c.type for c in rchain[-1].schema.columns()}
    rtypes = rtk._dummy_cols(specs[0][0].col_names, schema_r, 1)[2]
    cap = 1
    while cap < len(queries) + len(inactive):
        cap *= 2
    rgrp = rtk._LaneGroup(specs[0][0], rtypes, cap)
    pchain = _chains(queries[0])[1]
    ptypes = ptk._col_types(specs[0][1].col_names,
                            {c.name: c.type for c in pchain[-1].schema.columns()})
    pgrp = ptk._LaneGroup(specs[0][1], ptypes, cap)
    for k, (rspec, pspec) in enumerate(specs):
        assert rgrp.add(f"t{k}", rspec) and pgrp.add(f"t{k}", pspec)
    for k in inactive:
        rgrp.remove(f"t{k}")
        pgrp.remove(f"t{k}")
    rng = np.random.default_rng(seed)
    datas, valids = _columns(rng, specs[0][0].col_names, ptypes, n)
    row_valid = rng.random(n) < 0.9
    row_valid[-7:] = False  # padding rows
    lim = np.full(cap, 1 << 62, np.int64) if limits is None else np.asarray(limits, np.int64)
    rmasks, rcounts = rgrp.fn()(
        tuple(jnp.asarray(d.astype(_dtype_for(t))) for d, t in zip(datas, rtypes)),
        tuple(jnp.asarray(v) for v in valids), rgrp.P_i, rgrp.P_f, rgrp.active,
        jnp.asarray(row_valid), lim)
    tdatas = [torch.from_numpy(d.astype(t.device_dtype())) for d, t in zip(datas, ptypes)]
    tvalids = [torch.from_numpy(v) for v in valids]
    args = (tdatas, tvalids, torch.from_numpy(pgrp.P_i), torch.from_numpy(pgrp.P_f),
            torch.from_numpy(pgrp.active), torch.from_numpy(row_valid), torch.from_numpy(lim))
    twin = tr.lane_masks_plain(pgrp.rep, ptypes, *args)
    prog = tr.run_program(pgrp.program(), *args)
    wrapper = tr.lane_masks(pgrp.program(), *args)  # CPU tensors: the twin
    return (np.asarray(rmasks), np.asarray(rcounts)), twin, prog, wrapper


def _assert_family(queries, **kw):
    (rm, rc), *ports = _run_family(queries, **kw)
    for pm, pc in ports:
        np.testing.assert_array_equal(pm.numpy(), rm)
        np.testing.assert_array_equal(pc.numpy(), rc)
    return rm, rc


#: tests/test_tap_kernel.py:70's corpus over S (each its own family);
#: the LIKE query is refused by both
CORPUS = [
    "SELECT ID, V FROM S WHERE V % 2 = 0 EMIT CHANGES;",
    "SELECT ID FROM S WHERE V > 10 AND V <= 30 EMIT CHANGES;",
    "SELECT ID, V * 2 + 1 AS W FROM S WHERE NOT (V < 5) EMIT CHANGES;",
    "SELECT ID FROM S WHERE V IS NULL OR TAG = 't1' EMIT CHANGES;",
    "SELECT ID, P FROM S WHERE P >= 7.5 EMIT CHANGES;",
    "SELECT ID FROM S WHERE TAG <> 't0' EMIT CHANGES LIMIT 4;",
    "SELECT V + ID AS SUMMED FROM S WHERE V BETWEEN 6 AND 40 EMIT CHANGES;",
]

#: families of two or more lanes each (the literals vary, the shape not)
FAMILIES = {
    "mod64": [f"SELECT ID FROM S WHERE V % 64 = {i} EMIT CHANGES;" for i in range(64)],
    "int_overflow": [f"SELECT ID FROM S WHERE I * J + {k} > {k - 3} EMIT CHANGES;"
                     for k in (0, 2147483647, -5)],
    "int_wrap_add": [f"SELECT ID FROM S WHERE I + {k} < 0 EMIT CHANGES;" for k in (2147483647, 1, -1)],
    "int_div_mod": [f"SELECT ID FROM S WHERE I / J = {k} OR I % J = {k} EMIT CHANGES;"
                    for k in (0, 1, -1)],
    "bigint_div": [f"SELECT ID FROM S WHERE V / ID < {k} EMIT CHANGES;" for k in (0, 2, -3)],
    "neg_int": [f"SELECT ID FROM S WHERE -I > {k} EMIT CHANGES;" for k in (0, -100)],
    "string_eq": [f"SELECT ID FROM S WHERE TAG = '{t}' EMIT CHANGES;" for t in TAGS],
    "string_neq": [f"SELECT ID FROM S WHERE TAG <> '{t}' EMIT CHANGES;" for t in TAGS[:2]],
    "between": [f"SELECT ID FROM S WHERE V BETWEEN {a} AND {b} EMIT CHANGES;"
                for a, b in ((6, 40), (-10, 0), (5, 5))],
    "not_between": [f"SELECT ID FROM S WHERE V NOT BETWEEN {a} AND {b} EMIT CHANGES;"
                    for a, b in ((6, 40), (0, 0))],
    "in_list": [f"SELECT ID FROM S WHERE V IN ({a}, {b}, 40) EMIT CHANGES;" for a, b in ((1, 2), (6, 64))],
    "not_in": [f"SELECT ID FROM S WHERE V NOT IN ({a}, {b}) EMIT CHANGES;" for a, b in ((1, 2), (0, -1))],
    "in_strings": [f"SELECT ID FROM S WHERE TAG IN ('{a}', '{b}') EMIT CHANGES;"
                   for a, b in (("t1", "t2"), ("t0", "t3"))],
    "float_ieee": [f"SELECT ID FROM S WHERE P = {x} OR P / {x} > 1.0 EMIT CHANGES;"
                   for x in ("0.0", "-0.0", "1.5")],
    "float_mod": [f"SELECT ID FROM S WHERE P % {x} >= 0.0 EMIT CHANGES;" for x in ("0.0", "2.0")],
    # a division by a literal stays the quotient on the fused path: the
    # literal is a lane parameter, no constant XLA could fold (ROADMAP C11)
    "const_div": [f"SELECT ID FROM S WHERE CAST(V AS DOUBLE) / {d} = {q} EMIT CHANGES;"
                  for d, q in (("10.0", "0.3"), ("10.0", "-0.7"), ("-10.0", "0.7"))],
    "float_div_col": [f"SELECT ID FROM S WHERE P / P <> {x} EMIT CHANGES;" for x in ("1.0", "0.5")],
    "bool": [f"SELECT ID FROM S WHERE B = {b} AND NOT (V > {k}) EMIT CHANGES;"
             for b, k in (("true", 3), ("false", -3))],
    "is_not_null": [f"SELECT ID FROM S WHERE P IS NOT NULL AND ID > {k} EMIT CHANGES;" for k in (0, 5)],
    "mixed_promote": [f"SELECT ID FROM S WHERE I + V > {k} AND P < I EMIT CHANGES;" for k in (0, 10)],
    "rowtime": [f"SELECT ID FROM S WHERE ROWTIME >= {k} EMIT CHANGES;" for k in (1 << 39, 3 << 38)],
    # CAST: a double to INT (truncated, saturated, NaN 0), BIGINT narrowed
    # to INT (wraps), to DOUBLE, to DECIMAL (HALF_UP, NULL past its
    # precision), and ROWTIME as a TIMESTAMP floored to its DATE
    "cast_double_int": [f"SELECT ID FROM S WHERE CAST(P AS INT) > {k} EMIT CHANGES;" for k in (0, -3)],
    "cast_narrow": [f"SELECT ID FROM S WHERE CAST(V AS INT) + {k} < 0 EMIT CHANGES;" for k in (0, 1)],
    "cast_double": [f"SELECT ID FROM S WHERE CAST(V AS DOUBLE) * {x} >= 10.0 EMIT CHANGES;"
                    for x in ("0.5", "-1.5")],
    "cast_decimal": [f"SELECT ID FROM S WHERE CAST(P AS DECIMAL(4, 1)) > {x} EMIT CHANGES;"
                     for x in ("0.1", "-7.5")],
    "cast_date": [f"SELECT ID FROM S WHERE CAST(CAST(ROWTIME AS TIMESTAMP) AS DATE) > CAST({k} AS DATE) "
                  "EMIT CHANGES;" for k in (5_000, 9_000)],
    # CASE: with and without ELSE, mixed numeric results, a simple CASE
    "case_else": [f"SELECT ID FROM S WHERE CASE WHEN V > {a} THEN I ELSE J END > {k} EMIT CHANGES;"
                  for a, k in ((0, 0), (10, -5))],
    "case_no_else": [f"SELECT ID FROM S WHERE CASE WHEN B THEN P WHEN V < {a} THEN 1 END >= {x} "
                     "EMIT CHANGES;" for a, x in ((0, "0.5"), (20, "-2.5"))],
    "simple_case": [f"SELECT ID FROM S WHERE CASE TAG WHEN 't1' THEN V WHEN '{t}' THEN ID END = {k} "
                    "EMIT CHANGES;" for t, k in (("t2", 6), ("t3", 0))],
}


@pytest.mark.parametrize("sql", CORPUS)
def test_corpus_query_families_match_reference(sql):
    _assert_family([sql, sql], seed=3)


def test_like_is_refused_by_both():
    rspec, pspec = _classify(*_chains("SELECT ID FROM S WHERE TAG LIKE 't%' EMIT CHANGES;"))
    assert rspec == "refused" and pspec == "refused"


@pytest.mark.parametrize("sql", [
    "SELECT ID FROM S WHERE TAG > 't1' EMIT CHANGES;",  # string ordering
    "SELECT ID FROM S WHERE UCASE(TAG) = 'T1' EMIT CHANGES;",  # a function call
    # a cast the program does not take: a string parsed as a number
    "SELECT ID FROM S WHERE CAST(TAG AS INT) = 1 EMIT CHANGES;",
])
def test_refusals_match_reference(sql):
    rspec, pspec = _classify(*_chains(sql))
    assert rspec == "refused" and pspec == "refused"


def test_pure_projection_is_not_a_family():
    rspec, pspec = _classify(*_chains("SELECT ID, V FROM S EMIT CHANGES;"))
    assert rspec is None and pspec is None


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_families_match_reference_exactly(name):
    rm, _ = _assert_family(FAMILIES[name], seed=len(name))
    assert rm.any() or name in ("int_wrap_add",), "the family passes some rows"


def test_partial_limits_inactive_lanes():
    queries = FAMILIES["mod64"][:12]
    limits = [0, 1, 2, 3, 1 << 62, 5, 0, 1 << 62, 9, 1, 1, 1 << 62, 4, 4, 4, 4]
    _, rc = _assert_family(queries, seed=11, limits=limits, inactive=(3, 7))
    assert rc[0] == 0 and rc[3] == 0 and rc[7] == 0


def test_families_group_lanes_as_the_reference():
    """Structure decides the family: literal values do not, literal
    classes and column refs do."""
    qs = ["SELECT ID FROM S WHERE V > 5 EMIT CHANGES;",
          "SELECT ID FROM S WHERE V > 9 EMIT CHANGES;",
          "SELECT ID FROM S WHERE V > 5.0 EMIT CHANGES;",
          "SELECT ID FROM S WHERE ID > 5 EMIT CHANGES;"]
    rsig, psig = [], []
    for q in qs:
        r, p = _classify(*_chains(q))
        rsig.append(r.signature)
        psig.append(p.signature)
    assert rsig == psig
    assert psig[0] == psig[1] and len(set(psig)) == 3


def _select_then_filter(n_lanes=3):
    """Hand-built chains with a select inside the mask prefix: the source,
    SELECT ID AS K, V * 2 AS W, then WHERE W > k, then SELECT K."""
    rplan, _ = _plans("SELECT ID, V FROM S WHERE V > 0 EMIT CHANGES;")
    src = rplan.physical_plan.source.source
    from ksql_tpu.common.schema import LogicalSchema
    from ksql_tpu.common import types as RT

    sel_schema = LogicalSchema.builder().value_column("K", RT.BIGINT).value_column("W", RT.BIGINT).build()
    out = []
    for k in range(n_lanes):
        sel = rst.StreamSelect(
            source=src, selects=[("K", rex.ColumnRef("ID")),
                                 ("W", rex.ArithmeticBinary(rex.ArithOp.MULTIPLY, rex.ColumnRef("V"),
                                                            rex.IntegerLiteral(2)))],
            schema=sel_schema, key_names=[])
        flt = rst.StreamFilter(source=sel, predicate=rex.Comparison(
            rex.CompareOp.GT, rex.ColumnRef("W"), rex.IntegerLiteral(10 * k)), schema=sel_schema)
        top = rst.StreamSelect(source=flt, selects=[("K", rex.ColumnRef("K"))],
                               schema=LogicalSchema.builder().value_column("K", RT.BIGINT).build(),
                               key_names=[])
        plan = rst.QueryPlan(query_id="transient_sel", sink_name=None, physical_plan=top,
                             source_names=("S",))
        out.append((plan, plan_from_json(plan_to_json(plan))))
    return out


def test_select_then_filter_prefix_matches_reference():
    from ksql_tpu.server.push_registry import residual_chain as rchain

    plans = _select_then_filter()
    specs = []
    for rplan, pplan in plans:
        rc, pc = rchain(rplan), preg.residual_chain(pplan)
        rspec, pspec = _classify(rc, pc)
        assert rspec.signature == pspec.signature
        assert len(pspec.mask_steps) == 2  # the select is inside the prefix
        specs.append((rspec, pspec, rc, pc))
    schema = {c.name: c.type for c in specs[0][3][-1].schema.columns()}
    ptypes = ptk._col_types(specs[0][1].col_names, schema)
    rtypes = rtk._dummy_cols(specs[0][0].col_names,
                             {c.name: c.type for c in specs[0][2][-1].schema.columns()}, 1)[2]
    rgrp = rtk._LaneGroup(specs[0][0], rtypes, 4)
    pgrp = ptk._LaneGroup(specs[0][1], ptypes, 4)
    for k, (rspec, pspec, _, _) in enumerate(specs):
        rgrp.add(f"t{k}", rspec)
        pgrp.add(f"t{k}", pspec)
    rng = np.random.default_rng(5)
    n = 256
    datas, valids = _columns(rng, specs[0][1].col_names, ptypes, n)
    row_valid = np.ones(n, bool)
    lim = np.full(4, 1 << 62, np.int64)
    rm, rcnt = rgrp.fn()(tuple(jnp.asarray(d) for d in datas), tuple(jnp.asarray(v) for v in valids),
                         rgrp.P_i, rgrp.P_f, rgrp.active, jnp.asarray(row_valid), lim)
    args = ([torch.from_numpy(d) for d in datas], [torch.from_numpy(v) for v in valids],
            torch.from_numpy(pgrp.P_i), torch.from_numpy(pgrp.P_f), torch.from_numpy(pgrp.active),
            torch.from_numpy(row_valid), torch.from_numpy(lim))
    for pm, pc in (tr.lane_masks_plain(pgrp.rep, ptypes, *args), tr.run_program(pgrp.program(), *args)):
        np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rcnt))
    assert np.asarray(rcnt)[:3].sum() > 0


def test_program_is_flat_typed_postfix():
    """The mod family's program: one column load, two parameter loads
    (INTEGER literals cast from int64), a widening cast, MOD, CMP, FILTER."""
    _, pchain = _chains(FAMILIES["mod64"][0])
    spec = ptk.classify_residual(pchain[:-1], pchain[-1].schema)
    types = ptk._col_types(spec.col_names, {c.name: c.type for c in pchain[-1].schema.columns()})
    prog = tr.build_program(spec, types)
    ops = [int(r[0]) for r in prog.code]
    assert ops == [tr.OP_COL, tr.OP_PARAM_I, tr.OP_CAST, tr.OP_MOD, tr.OP_PARAM_I, tr.OP_CAST,
                   tr.OP_CMP, tr.OP_FILTER]
    assert prog.max_depth == 2 and prog.col_dts == (tr.DT_I64, tr.DT_I64)


def _unfused(prog):
    """``prog.kernel_code`` expanded back to ``build_program``'s encoding:
    each fused parameter as its push, its cast and its op; each column
    load by its index in ``spec.col_names``."""
    out = []
    for op, a, b, dt, _depth in prog.kernel_code.tolist():
        if op == tr.OP_FUSED:
            src, pdt, cdt = b & 0xFF, (b >> 8) & 0xFF, (b >> 16) & 0xFF
            out.append((src, dt, 0, pdt))
            if cdt != pdt:
                out.append((tr.OP_CAST, pdt, 0, cdt))
            out.append((a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF, (a >> 24) & 0xFF))
        else:
            out.append((op, prog.staged[a] if op == tr.OP_COL else a, b, dt))
    return out


def _assert_kernel_form(prog):
    """``lower_for_kernel``'s rewrite keeps the program: with the casts
    that keep a value's bits left out of both, the expanded kernel code is
    ``code``; no parameter is left unfused before a binary op; each
    instruction's depth is the stack's before it; the columns are numbered
    in the order the program first loads them."""
    def kept(code):
        return [tuple(r) for r in code if not (r[0] == tr.OP_CAST and tr._keeps_bits(r[1], r[3]))]

    assert kept(_unfused(prog)) == kept(prog.code.tolist())
    rows = prog.kernel_code.tolist()
    for r, nxt in zip(rows, rows[1:]):
        assert not (r[0] in (tr.OP_PARAM_I, tr.OP_PARAM_F) and nxt[0] in tr._BINARY)
    depth = most = 0
    for op, _a, _b, _dt, d in rows:
        pops, pushes = tr._EFFECT[op]
        assert d == depth and depth >= pops
        depth += pushes - pops
        most = max(most, depth)
    assert depth == 0 and most == prog.kernel_depth <= prog.max_depth
    loads = [int(a) for op, a, _b, _dt in prog.code.tolist() if op == tr.OP_COL]
    assert list(prog.staged) == list(dict.fromkeys(loads))


def test_kernel_form_of_the_mod_family():
    """The mod family as K25 runs it: the column load, then each INTEGER
    parameter and its widening fused into the op that takes it (MOD, then
    CMP), then FILTER; a stack one deep; one of the two columns loaded."""
    _, pchain = _chains(FAMILIES["mod64"][0])
    spec = ptk.classify_residual(pchain[:-1], pchain[-1].schema)
    types = ptk._col_types(spec.col_names, {c.name: c.type for c in pchain[-1].schema.columns()})
    prog = tr.build_program(spec, types)
    k = prog.kernel_code.tolist()
    assert [r[0] for r in k] == [tr.OP_COL, tr.OP_FUSED, tr.OP_FUSED, tr.OP_FILTER]
    assert [r[4] for r in k] == [0, 1, 1, 1] and prog.kernel_depth == 1
    assert k[1][1] == tr.OP_MOD | tr.DT_I64 << 24
    assert k[1][2] == tr.OP_PARAM_I | tr.DT_I32 << 8 | tr.DT_I64 << 16
    assert k[2][1] & 0xFF == tr.OP_CMP and (k[2][1] >> 8) & 0xFF == 0
    assert len(prog.staged) == 1 and spec.col_names[prog.staged[0]] == "V"
    _assert_kernel_form(prog)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_kernel_form_keeps_the_program(name):
    """Every family's program survives ``lower_for_kernel`` (see
    ``_assert_kernel_form``); the card tests run the rewritten form against
    the twin."""
    _, pchain = _chains(FAMILIES[name][0])
    spec = ptk.classify_residual(pchain[:-1], pchain[-1].schema)
    types = ptk._col_types(spec.col_names, {c.name: c.type for c in pchain[-1].schema.columns()})
    _assert_kernel_form(tr.build_program(spec, types))


def test_deep_tree_past_the_stack_cap_is_refused():
    """A chain needing more than MAX_DEPTH stack slots keeps the host path
    with its reason (ROADMAP C), while the reference fuses it."""
    expr = "V"
    for k in range(tr.MAX_DEPTH + 1):
        expr = f"({k} + {expr})"  # right-nested: every left operand stays stacked
    sql = f"SELECT ID FROM S WHERE {expr} > 0 EMIT CHANGES;"
    rspec, pspec = _classify(*_chains(sql))
    assert rspec != "refused" and pspec == "refused"
    _, pchain = _chains(sql)
    with pytest.raises(ptk.ResidualUnsupported, match="stack"):
        ptk.classify_residual(pchain[:-1], pchain[-1].schema)


@pytest.mark.parametrize("sql", [
    "SELECT ID FROM S WHERE ABS(V) > 3 EMIT CHANGES;",
    "SELECT ID FROM S WHERE CAST(P AS DECIMAL(30, 25)) > 1 EMIT CHANGES;",
])
def test_what_the_program_does_not_take_is_refused_with_its_reason(sql):
    """The reference fuses these; the port's program refuses a function
    call (the tap is refused at attach, before any of this) and a DECIMAL
    cast past K25's exact powers of ten, with the reason the registry puts
    in ``fallback_reasons``."""
    pchain = _chains(sql)[1]
    with pytest.raises(ptk.ResidualUnsupported) as err:
        ptk.classify_residual(pchain[:-1], pchain[-1].schema)
    assert "FunctionCall" in str(err.value) or "fused residual" in str(err.value)


@pytest.mark.parametrize("edge", list(TAP_EDGES))
def test_tap_edges_twin_equals_reference(edge):
    """K25's edges (``tests/torch_kernel_cases.py``: 1, 15, 17 and 4,097
    rows, 1 and 4,096 lanes, every row invalid, inactive lanes, LIMIT
    budgets of 0, partial and past the count, a program 16 deep, one of
    128 instructions): both packages decode the same plan JSONs, pack the
    family, and the twin, ``run_program`` and the wrapper (CPU tensors:
    the twin) equal ``_trace_group``'s masks and counts exactly."""
    from ksql_tpu.common.batch import stable_hash64 as rhash
    from ksql_tpu.execution.steps import plan_from_json as rplan_from_json
    from ksql_tpu.server.push_registry import residual_chain as rchain

    plans = tap_edge_plans(edge)
    lanes = len(plans)
    columns, row_valid, limits, inactive = tap_edge_case(edge, rhash, seed=len(edge))
    rgrp = pgrp = None
    for k, pj in enumerate(plans):
        rc, pc = rchain(rplan_from_json(pj)), preg.residual_chain(plan_from_json(pj))
        rspec, pspec = _classify(rc, pc)
        assert rspec != "refused" and pspec != "refused"
        assert rspec.signature == pspec.signature
        if rgrp is None:
            rtypes = rtk._dummy_cols(rspec.col_names, {c.name: c.type for c in rc[-1].schema.columns()}, 1)[2]
            ptypes = ptk._col_types(pspec.col_names, {c.name: c.type for c in pc[-1].schema.columns()})
            rgrp = rtk._LaneGroup(rspec, rtypes, lanes)
            pgrp = ptk._LaneGroup(pspec, ptypes, lanes)
        assert rgrp.add(f"t{k}", rspec) and pgrp.add(f"t{k}", pspec)
    for k in inactive:
        rgrp.remove(f"t{k}")
        pgrp.remove(f"t{k}")
    prog = pgrp.program()
    _assert_kernel_form(prog)
    kind = TAP_EDGES[edge][0]
    if kind == "depth16":
        assert prog.max_depth == tr.MAX_DEPTH
    if kind == "instr128":
        assert prog.n_instr == tr.MAX_INSTR
    names = pgrp.rep.col_names
    rmasks, rcounts = rgrp.fn()(tuple(jnp.asarray(columns[c][0]) for c in names),
                                tuple(jnp.asarray(columns[c][1]) for c in names), rgrp.P_i, rgrp.P_f,
                                rgrp.active, jnp.asarray(row_valid), limits)
    args = ([torch.from_numpy(columns[c][0]) for c in names], [torch.from_numpy(columns[c][1]) for c in names],
            torch.from_numpy(pgrp.P_i), torch.from_numpy(pgrp.P_f), torch.from_numpy(pgrp.active),
            torch.from_numpy(row_valid), torch.from_numpy(limits))
    for pm, pcnt in (tr.lane_masks_plain(pgrp.rep, ptypes, *args), tr.run_program(prog, *args),
                     tr.lane_masks(prog, *args)):
        np.testing.assert_array_equal(pm.numpy(), np.asarray(rmasks))
        np.testing.assert_array_equal(pcnt.numpy(), np.asarray(rcounts))
    if TAP_EDGES[edge][3] is None:
        assert np.asarray(rcounts).sum() > 0
    if edge == "limits":
        full = np.asarray(rmasks).sum(axis=1)
        assert (np.asarray(rcounts) < full).any() and (np.asarray(rcounts) == full).any()
