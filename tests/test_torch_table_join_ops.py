"""The table-table and foreign-key joins' device functions against the reference's.

Each plain twin (the CPU path, and the oracle of its CUDA kernel on the
card) meets the reference function or expression on the same numpy-seeded
inputs, bit for bit: K9's side mode (``hash_store.upsert_side_plain``)
against ``runtime/lowering.py:_upsert_side`` with the foreign-key join's
``fkrepr``/``fkvalid`` writes at its targets (keys changed several times in
a batch, deletes, untouched rows, rows K2 left in the dump slot, columns of
1, 4 and 8 bytes, -0.0 and NaN, the dump row); K8's live mode
(``probe_find_gather_plain`` with ``live``) against ``probe_find`` and the
gathers of ``_trace_fk_left``'s ``right_of`` (deleted keys that the walk
finds, graves, misses); K8's gather mode against ``_tt_joined_env``'s
gathers at K2's slots; and K24's twin (``table_join.fk_fanout_plain``)
against ``_trace_fk_right``'s ``match`` scan and lanes, taken at the
matching slots in slot order.  Tolerance: none.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.common import types as RT
from ksql_tpu.compiler.jax_expr import DCol as RDCol
from ksql_tpu.ops import hash_store as rhs
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import table_join as tj

jax.config.update("jax_enable_x64", True)

#: the stored columns of the cases: (name, numpy dtype, reference type)
COLS = (("I", np.int32, RT.INTEGER), ("L", np.int64, RT.BIGINT), ("D", np.float64, RT.DOUBLE),
        ("B", np.bool_, RT.BOOLEAN))
FVALS = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf], np.float64)


def _values(rng, dtype, n):
    if dtype == np.float64:
        return FVALS[rng.integers(0, len(FVALS), n)].copy()
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    return rng.integers(-5, 6, n).astype(dtype)


def _store(rng, capacity, prefix=""):
    """A join store's side columns, a populated dump row included."""
    c1 = capacity + 1
    st = {f"{prefix}live": rng.random(c1) < 0.5}
    for name, dt, _t in COLS:
        st[f"{prefix}v_{name}"] = _values(rng, dt, c1)
        st[f"{prefix}m_{name}"] = rng.random(c1) < 0.7
    st["fkrepr"] = rng.integers(-3, 3, c1).astype(np.int64)
    st["fkvalid"] = rng.random(c1) < 0.8
    return st


def _torch(d):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in d.items()}


def _same(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    if got.dtype.kind == "f":
        got, want = got.view(np.int64), want.view(np.int64)
    np.testing.assert_array_equal(got, want, err_msg=where)


# ---------------------------------------------------------- K9 side mode
def _side_case(seed, capacity=16, n=24):
    rng = np.random.default_rng(seed)
    store = _store(rng, capacity)
    # slots: a few hot ones (a key changed several times), some the dump
    # slot (K2 did not place the row)
    slots = rng.choice(np.r_[np.arange(4), rng.integers(0, capacity, 6), [capacity] * 2], n)
    batch = {
        "slots": slots.astype(np.int32),
        "touched": rng.random(n) < 0.85,
        "has_new": rng.random(n) < 0.7,
        "act": rng.random(n) < 0.8,
        "fkrepr": rng.integers(-3, 3, n).astype(np.int64),
        "fkvalid": rng.random(n) < 0.8,
    }
    for name, dt, _t in COLS:
        batch[f"v_{name}"] = _values(rng, dt, n)
        batch[f"m_{name}"] = rng.random(n) < 0.7
    return store, batch


def _ref_upsert_side(store, b, capacity):
    """``_upsert_side`` (unbound: it reads ``self`` only for the stored
    dtypes) and ``_trace_fk_left``'s fkrepr/fkvalid writes at its
    targets."""
    dtypes = {name: dt for name, dt, _t in COLS}
    cols = [types.SimpleNamespace(name=name) for name, _dt, _t in COLS]
    stub = types.SimpleNamespace(_table_col_dtype=lambda col: dtypes[col.name])
    env = {name: RDCol(jnp.asarray(b[f"v_{name}"]), jnp.asarray(b[f"m_{name}"]), t)
           for name, _dt, t in COLS}
    st = {k: jnp.asarray(v) for k, v in store.items()}
    tgt = CompiledDeviceQuery._upsert_side(
        stub, st, cols, env, jnp.asarray(b["touched"]), jnp.asarray(b["slots"]),
        jnp.asarray(b["has_new"]), jnp.asarray(b["act"]), capacity)
    st["fkrepr"] = st["fkrepr"].at[tgt].set(jnp.asarray(b["fkrepr"]))
    st["fkvalid"] = st["fkvalid"].at[tgt].set(jnp.asarray(b["fkvalid"]))
    return {k: np.asarray(v) for k, v in st.items()}


def _port_upsert_side(store, b, capacity):
    st = _torch(store)
    tb = _torch(b)
    cols = [(st[f"v_{name}"], st[f"m_{name}"], tb[f"v_{name}"], tb[f"m_{name}"], True)
            for name, _dt, _t in COLS]
    cols.append((st["fkrepr"], st["fkvalid"], tb["fkrepr"], tb["fkvalid"], False))
    hs.upsert_side_plain(st["live"], capacity, tb["slots"], tb["touched"], ~tb["has_new"],
                         tb["act"], cols)
    return {k: v.numpy() for k, v in st.items()}


@pytest.mark.parametrize("seed", range(6))
def test_upsert_side_matches_reference(seed):
    store, b = _side_case(seed)
    want = _ref_upsert_side(store, b, 16)
    got = _port_upsert_side(store, b, 16)
    for k in want:
        _same(got[k], want[k], f"seed {seed}: {k}")


def test_upsert_side_dump_row_takes_the_highest_non_upserting_row():
    # rows 0 and 2 upsert slots 1 and 3; row 1 deletes slot 2 (it writes the
    # dump row, and live[2] False); row 3 is untouched: the highest
    # non-upserting row, whose values stay in the dump row
    store, b = _side_case(0, n=4)
    b.update(slots=np.array([1, 2, 3, 5], np.int32), touched=np.array([True, True, True, False]),
             has_new=np.array([True, False, True, True]), act=np.ones(4, bool))
    want = _ref_upsert_side(store, b, 16)
    got = _port_upsert_side(store, b, 16)
    for k in want:
        _same(got[k], want[k], k)
    assert got["v_L"][16] == b["v_L"][3] and not got["live"][16] and not got["live"][2]


def test_upsert_side_when_every_row_upserts_leaves_the_dump_row():
    store, b = _side_case(1, n=3)
    b.update(slots=np.array([1, 2, 3], np.int32), touched=np.ones(3, bool), has_new=np.ones(3, bool))
    got = _port_upsert_side(store, b, 16)
    want = _ref_upsert_side(store, b, 16)
    for k in want:
        _same(got[k], want[k], k)
    _same(got["v_D"][16], store["v_D"][16], "dump row kept")


def _kernel_shape(shape):
    """Side-mode batches at K9's launch shapes: one row, the one-block
    limit (4,096 rows) and one past it (the cooperative grid), every row
    on one slot, a deleting winner beside upserting losers, and a batch
    whose every row upserts (the dump row keeps its values)."""
    n = {"one_row": 1, "one_block": 4096, "grid": 4097}.get(shape, 300)
    store, b = _side_case(40 + n, capacity=64, n=n)
    if shape == "one_slot":
        b.update(slots=np.full(n, 9, np.int32), touched=np.ones(n, bool))
    elif shape == "delete_winner":
        b.update(slots=np.full(n, 9, np.int32), touched=np.ones(n, bool), has_new=np.ones(n, bool))
        b["has_new"][-1] = False
    elif shape == "all_upsert":
        b.update(slots=np.arange(n, dtype=np.int32) % 64, touched=np.ones(n, bool),
                 has_new=np.ones(n, bool))
    return store, b


@pytest.mark.parametrize("shape", ["one_row", "one_block", "grid", "one_slot", "delete_winner",
                                   "all_upsert"])
def test_upsert_side_matches_reference_at_kernel_shapes(shape):
    store, b = _kernel_shape(shape)
    want = _ref_upsert_side(store, b, 64)
    got = _port_upsert_side(store, b, 64)
    for k in want:
        _same(got[k], want[k], f"{shape}: {k}")
    if shape == "delete_winner":
        assert not got["live"][9] and got["v_L"][64] == b["v_L"][-1]
    if shape == "all_upsert":
        _same(got["v_D"][64], store["v_D"][64], "dump row kept")


# ------------------------------------------------ K8 live and gather modes
def _join_store(seed, capacity=32, n_keys=20):
    """A right store of a foreign-key join built by the reference's
    probe_insert, some keys deleted (found, not live), some slots graves."""
    rng = np.random.default_rng(seed)
    st = {k: np.array(v) for k, v in rhs.init_store(rhs.StoreLayout(capacity, 1, ())).items()}
    keys = rng.integers(-50, 50, n_keys).astype(np.int64)
    kh = rhs.combine_hash([jnp.asarray(keys)])
    out, _slots = rhs.probe_insert({k: jnp.asarray(v) for k, v in st.items()}, capacity, kh,
                                   jnp.zeros(n_keys, jnp.int64), [jnp.asarray(keys)],
                                   jnp.zeros(n_keys, jnp.int32), jnp.ones(n_keys, bool))
    st = {k: np.array(v) for k, v in out.items()}
    graves = np.nonzero(st["occ"][:-1] & (rng.random(capacity) < 0.1))[0]
    st["occ"][graves] = False
    st["grave"][graves] = True
    side = _store(rng, capacity)
    st.update({k: v for k, v in side.items() if not k.startswith("fk")})
    return st, keys, rng


@pytest.mark.parametrize("seed", range(4))
def test_live_probe_matches_reference(seed):
    st, keys, rng = _join_store(seed)
    n = 40
    fk = np.where(rng.random(n) < 0.7, rng.choice(keys, n), rng.integers(-80, 80, n)).astype(np.int64)
    fkv = rng.random(n) < 0.85
    cap = 32
    # the reference's right_of: probe_find over the valid foreign keys, then
    # found = valid & slot != dump & live[slot]
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    rslots = rhs.probe_find(jst, cap, rhs.combine_hash([jnp.asarray(fk)]), jnp.zeros(n, jnp.int64),
                            jnp.asarray(fkv))
    rfound = jnp.asarray(fkv) & (rslots != cap) & jst["live"][rslots]
    tst = _torch(st)
    names = [name for name, _dt, _t in COLS]
    lanes, key0, found = hs.probe_find_gather_plain(
        tst, cap, torch.from_numpy(fk), torch.from_numpy(fkv), torch.from_numpy(fkv), names,
        live=tst["live"])
    _same(found.numpy(), np.asarray(rfound), "found")
    _same(key0.numpy(), np.asarray(jst["key0"][rslots]), "key0")
    for name in names:
        _same(lanes[f"v_{name}"].numpy(), np.asarray(jst[f"v_{name}"][rslots]), name)
        _same(lanes[f"m_{name}"].numpy(), np.asarray(jst[f"m_{name}"][rslots] & rfound), name)
    # some foreign keys walk to a deleted (not live) key's slot
    assert ((np.asarray(rslots) != cap) & fkv & ~np.asarray(rfound)).any()


@pytest.mark.parametrize("n", [1, 40, 4096])
def test_live_pair_matches_two_single_calls_and_the_reference(n):
    """K8's pair call (a left change's new and old foreign key in one
    launch) against two single live-mode calls and the reference's two
    ``right_of`` lookups, bit for bit: rows not looked up, keys not found,
    deleted (found, not live) right rows."""
    st, keys, rng = _join_store(n + 3, capacity=64, n_keys=40)
    cap = 64
    tst = _torch(st)
    names = [name for name, _dt, _t in COLS]
    sets = []
    for _ in range(2):
        fk = np.where(rng.random(n) < 0.7, rng.choice(keys, n), rng.integers(-80, 80, n))
        fkv = rng.random(n) < 0.85
        sets.append((fk.astype(np.int64), fkv))
    tsets = [(torch.from_numpy(fk), torch.from_numpy(fkv), torch.from_numpy(fkv)) for fk, fkv in sets]
    got = hs.probe_find_live_pair(tst, cap, tsets, names, tst["live"])
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    seen_deleted = seen_missing = seen_skipped = False
    for (fk, fkv), tset, (lanes, key0, found) in zip(sets, tsets, got):
        one = hs.probe_find(tst, cap, *tset, names, live=tst["live"])
        _same(found.numpy(), one[2].numpy(), "found")
        _same(key0.numpy(), one[1].numpy(), "key0")
        rslots = rhs.probe_find(jst, cap, rhs.combine_hash([jnp.asarray(fk)]),
                                jnp.zeros(n, jnp.int64), jnp.asarray(fkv))
        rfound = jnp.asarray(fkv) & (rslots != cap) & jst["live"][rslots]
        _same(found.numpy(), np.asarray(rfound), "found")
        _same(key0.numpy(), np.asarray(jst["key0"][rslots]), "key0")
        for name in names:
            _same(lanes[f"v_{name}"].numpy(), one[0][f"v_{name}"].numpy(), name)
            _same(lanes[f"m_{name}"].numpy(), one[0][f"m_{name}"].numpy(), name)
            _same(lanes[f"v_{name}"].numpy(), np.asarray(jst[f"v_{name}"][rslots]), name)
            _same(lanes[f"m_{name}"].numpy(), np.asarray(jst[f"m_{name}"][rslots] & rfound), name)
        rs = np.asarray(rslots)
        seen_deleted |= bool(((rs != cap) & fkv & ~np.asarray(rfound)).any())
        seen_missing |= bool(((rs == cap) & fkv).any())
        seen_skipped |= bool((~fkv).any())
    if n > 1:
        assert seen_deleted and seen_missing and seen_skipped


@pytest.mark.parametrize("seed", range(3))
def test_gather_mode_matches_tt_joined_env(seed):
    rng = np.random.default_rng(seed + 10)
    cap = 16
    st = _store(rng, cap, prefix="r_")
    slots = rng.integers(0, cap + 1, 30).astype(np.int32)  # the dump slot too
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    js = jnp.asarray(slots)
    o_live = jst["r_live"][js] & (js != cap)
    names = [name for name, _dt, _t in COLS]
    lanes, got_live = hs.probe_gather_plain(_torch(st), cap, torch.from_numpy(slots),
                                            torch.from_numpy(st["r_live"]), names, "r_")
    _same(got_live.numpy(), np.asarray(o_live), "o_live")
    for name in names:
        _same(lanes[f"v_{name}"].numpy(), np.asarray(jst[f"r_v_{name}"][js]), name)
        _same(lanes[f"m_{name}"].numpy(), np.asarray(jst[f"r_m_{name}"][js] & o_live), name)


# --------------------------------------------------------------- K24
#: K24's cases past one tile of its kernel (1,024 slots): a store of
#: 2,049 slots (not a multiple of the tile) with a match on the last real
#: slot, or with every slot of its second tile matching
FANOUT_TILE_CASES = ("last_slot", "tile_full")


@pytest.mark.parametrize("case", ["hot", "none", "untouched", "dump", *FANOUT_TILE_CASES])
def test_fk_fanout_matches_the_reference_scan(case):
    rng = np.random.default_rng(7)
    cap = 2048 if case in FANOUT_TILE_CASES else 64
    st = _store(rng, cap)
    st["key0"] = rng.integers(-(2 ** 40), 2 ** 40, cap + 1).astype(np.int64)
    st["fkrepr"] = rng.integers(0, 4, cap + 1).astype(np.int64)
    krepr = np.array([2, 9], np.int64)
    touched = np.array([case != "untouched", True])
    if case == "none":
        krepr[0] = 17
    if case == "last_slot":
        st["fkrepr"][st["fkrepr"] == 2] = 3
        st["fkrepr"][[5, cap - 1]], st["fkvalid"][[5, cap - 1]], st["live"][[5, cap - 1]] = 2, True, True
    if case == "tile_full":
        st["fkrepr"][1024:2048], st["fkvalid"][1024:2048], st["live"][1024:2048] = 2, True, True
    st["live"][cap] = False  # the reference's dump row is never live
    if case == "dump":
        st["fkrepr"][cap], st["fkvalid"][cap] = 2, True
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    match = np.asarray(jst["live"] & jst["fkvalid"] & (jst["fkrepr"] == krepr[0]) & touched[0])
    idx = np.nonzero(match)[0]
    names = [name for name, _dt, _t in COLS]
    slots, lanes, key0 = tj.fk_fanout_plain(_torch(st), cap, torch.from_numpy(krepr),
                                            torch.from_numpy(touched), names)
    _same(slots.numpy(), idx.astype(np.int32), "slots")
    _same(key0.numpy(), np.asarray(jst["key0"])[idx], "key0")
    for name in names:
        _same(lanes[f"v_{name}"].numpy(), np.asarray(jst[f"v_{name}"])[idx], name)
        _same(lanes[f"m_{name}"].numpy(), np.asarray(jst[f"m_{name}"] & match)[idx], name)
    assert (idx.size > 0) == (case not in ("none", "untouched")) and cap not in idx
    if case == "last_slot":
        assert idx.tolist() == [5, cap - 1]
    if case == "tile_full":
        assert set(range(1024, 2048)) <= set(idx.tolist())
