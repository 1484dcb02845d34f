"""The join path's plain twins against the reference functions, on the CPU.

``probe_find_plain`` against ``ksql_tpu.ops.hash_store.probe_find`` on a
store with graves, probe chains longer than the 32 rounds, absent keys and
inactive rows; the port's table step (K1's table-mode twin, K2's twin and
``table_upsert_plain``) against ``CompiledDeviceQuery._trace_table_step``
on batches with the traps of the last-write-wins upsert: duplicate keys,
tombstones of present and absent keys, delete + re-insert and insert +
delete in one batch, null keys and padding rows.  Whole table stores, dump
row included, are compared bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.ops import hash_store as rhs
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.test_device_join import CLICKS_DDL, LEFT_JOIN, USERS_DDL
from tests.test_torch_join import _pschema, _same_bits, plan_of

jax.config.update("jax_enable_x64", True)


def _chained_store(capacity, n_keys, seed):
    """A store whose keys crowd onto two base slots (probe chains past the
    32 rounds), inserted by linear probing, a fifth of them then graves."""
    rng = np.random.default_rng(seed)
    mask = capacity - 1
    cand = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 200_000, dtype=np.int64)
    base = hs.np_mix64(cand) & mask
    crowded = cand[(base == 3) | (base == 5)][: n_keys // 2]
    spread = cand[(base != 3) & (base != 5)][: n_keys - crowded.size]
    keys = np.concatenate([crowded, spread])
    rng.shuffle(keys)
    occ = np.zeros(capacity + 1, bool)
    kh = np.zeros(capacity + 1, np.int64)
    for k in keys:
        s = int(hs.np_mix64(np.array([k]))[0] & mask)
        while occ[s]:
            s = (s + 1) & mask
        occ[s], kh[s] = True, k
    slots = np.nonzero(occ[:-1])[0]
    graves = slots[rng.random(slots.size) < 0.2]
    store = {"occ": occ, "grave": np.zeros(capacity + 1, bool), "khash": kh,
             "wstart": np.zeros(capacity + 1, np.int64)}
    store["occ"][graves] = False
    store["grave"][graves] = True
    return store, keys, kh[graves]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_find_twin_matches_reference(seed):
    capacity = 128
    store, keys, grave_keys = _chained_store(capacity, 100, seed)
    rng = np.random.default_rng(seed + 10)
    absent = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 60, dtype=np.int64)
    khash = np.concatenate([keys, grave_keys, absent])
    active = rng.random(khash.size) > 0.1
    want = np.asarray(rhs.probe_find({k: jnp.asarray(v) for k, v in store.items()}, capacity,
                                     jnp.asarray(khash), jnp.zeros(khash.size, jnp.int64),
                                     jnp.asarray(active)))
    tstore = {k: torch.from_numpy(v) for k, v in store.items()}
    got = hs.probe_find_plain(tstore, capacity, torch.from_numpy(khash),
                              torch.zeros(khash.size, dtype=torch.int64), torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)
    # every case occurs: found, graves and absent keys not found, live keys
    # lost past the 32 rounds, inactive rows at the dump slot
    found = want != capacity
    n_live = keys.size
    assert found[:n_live].any() and not found[n_live:].any()
    live_active = active[:n_live] & np.isin(keys, store["khash"][store["occ"]])
    assert (live_active & ~found[:n_live]).any(), "a chain should outrun the 32 rounds"
    assert (want[~active] == capacity).all()


def _trap_batches():
    """(rows, deletes) per batch of a 16-row capacity; batch 2 holds the
    traps, shorter than the capacity (padding rows)."""
    first = [({"ID": k, "NAME": f"u{k}", "REGION": "eu"}, False) for k in range(10)]
    tomb = lambda k: ({"ID": k, "NAME": None, "REGION": None}, True)  # noqa: E731
    second = [
        ({"ID": 1, "NAME": "a", "REGION": "us"}, False),
        ({"ID": 1, "NAME": "b", "REGION": None}, False),
        tomb(2),                                            # present key
        tomb(50),                                           # absent key: a grave
        ({"ID": 1, "NAME": "c", "REGION": "ap"}, False),    # the last write of 1
        tomb(3),
        ({"ID": 3, "NAME": "re3", "REGION": "ap"}, False),  # delete + re-insert
        ({"ID": 4, "NAME": "x4", "REGION": "us"}, False),
        tomb(4),                                            # insert + delete
        ({"ID": None, "NAME": "nokey", "REGION": "eu"}, False),
        ({"ID": 60, "NAME": "new", "REGION": "excluded"}, False),
    ]
    third = [tomb(60), ({"ID": 50, "NAME": "back", "REGION": "eu"}, False)]
    return [first, second, third]


def test_table_step_twins_match_reference_trace_table_step():
    engine, plan = plan_of((USERS_DDL, CLICKS_DDL), LEFT_JOIN)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=16, table_store_capacity=64)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=16, device="cpu", table_store_capacity=64)
    tschema = ref_q.join_chain[0].table_source.schema
    state = ref_q.state
    for b, batch in enumerate(_trap_batches()):
        rows = [r for r, _ in batch]
        dels = np.zeros(16, bool)
        dels[: len(batch)] = [d for _, d in batch]
        ts = list(range(100 * b, 100 * b + len(rows)))
        arrays = ref_q.join_chain[0].layout.encode(RHostBatch.from_rows(tschema, rows, timestamps=ts))
        parrays = port_q.join_chain[0].layout.encode(PHostBatch.from_rows(_pschema(tschema), rows, timestamps=ts))
        arrays["delete"] = parrays["delete"] = dels
        state, metrics = ref_q._trace_table_step(state, {k: jnp.asarray(v) for k, v in arrays.items()})
        occupancy, overflow = port_q._table_step(port_q.upload(parrays), 0)
        want = {k: np.asarray(v) for k, v in jax.device_get(state["jtab"]).items()}
        got = state_to_numpy(port_q.state["jtab"])
        assert set(got) == set(want)
        for k in want:
            _same_bits(got[k], want[k], f"batch {b}: {k}")
        assert int(occupancy) == int(metrics["occupancy"])
        assert int(overflow) == int(metrics["overflow"]) == 0
    jt = state_to_numpy(port_q.state["jtab"])
    dictionary = port_q.dictionary
    live = {int(k): dictionary.lookup(int(v)) for k, v, o in zip(jt["key0"], jt["v_U_NAME"], jt["occ"]) if o}
    assert live[1] == "c" and live[3] == "re3" and live[50] == "back"
    assert 2 not in live and 4 not in live and 60 not in live
    # the absent key's tombstone claimed a slot: occupancy counts its grave
    assert int((jt["occ"] | jt["grave"]).sum()) == len(live) + int(jt["grave"].sum())
    assert not jt["occ"][-1] and not jt["grave"][-1]


@pytest.mark.parametrize("shape", ["one_row", "one_block", "grid", "one_key", "delete_winner",
                                   "all_upsert"])
def test_table_step_matches_reference_at_kernel_shapes(shape):
    """K9's launch shapes through the table step, against the reference's
    ``_trace_table_step``: one row, the one-block limit (4,096 rows) and
    one past it (the cooperative grid), every row on one key, a deleting
    winner beside upserting losers, and a batch whose every row upserts
    (the dump row keeps its values).  Whole stores, dump row included."""
    n = {"one_row": 1, "one_block": 4096, "grid": 4097}.get(shape, 64)
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 3000, n)
    dels = rng.random(n) < 0.2
    if shape in ("one_key", "delete_winner"):
        ids[:] = 7
    if shape == "delete_winner":
        dels[:] = False
        dels[-1] = True
    if shape == "all_upsert":
        ids, dels = np.arange(n), np.zeros(n, bool)
    rows = [{"ID": int(i), "NAME": f"n{j}", "REGION": None if j % 5 == 0 else "eu"}
            for j, i in enumerate(ids)]
    engine, plan = plan_of((USERS_DDL, CLICKS_DDL), LEFT_JOIN)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=n, table_store_capacity=1 << 13)
    port_q = TorchCompiledQuery(plan_from_json(json.loads(json.dumps(plan_to_json(plan)))),
                                capacity=n, device="cpu", table_store_capacity=1 << 13)
    tschema = ref_q.join_chain[0].table_source.schema
    ts = list(range(n))
    arrays = ref_q.join_chain[0].layout.encode(RHostBatch.from_rows(tschema, rows, timestamps=ts))
    parrays = port_q.join_chain[0].layout.encode(PHostBatch.from_rows(_pschema(tschema), rows,
                                                                      timestamps=ts))
    arrays["delete"] = parrays["delete"] = dels
    state, _metrics = ref_q._trace_table_step(ref_q.state, {k: jnp.asarray(v) for k, v in arrays.items()})
    port_q._table_step(port_q.upload(parrays), 0)
    want = {k: np.asarray(v) for k, v in jax.device_get(state["jtab"]).items()}
    got = state_to_numpy(port_q.state["jtab"])
    for k in want:
        _same_bits(got[k], want[k], f"{shape}: {k}")
    if shape == "delete_winner":
        assert int(got["grave"].sum()) == 1 and not got["occ"].any()


def test_table_upsert_dump_row_takes_the_highest_non_upserting_row():
    # the reference scatters every non-upserting row into the dump row, in
    # row order: here the last row is a losing duplicate, not padding
    capacity, n = 8, 4
    store = {"occ": torch.zeros(capacity + 1, dtype=torch.bool),
             "grave": torch.zeros(capacity + 1, dtype=torch.bool),
             "v_X": torch.zeros(capacity + 1, dtype=torch.int64),
             "m_X": torch.zeros(capacity + 1, dtype=torch.bool)}
    slots = torch.tensor([2, 2, 5, 2], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    delete = torch.tensor([False, False, True, False])
    data = torch.tensor([10, 11, 12, 13])
    valid = torch.tensor([True, False, True, True])
    store["occ"][[2, 5]] = True
    hs.table_upsert_plain(store, capacity, slots, active, delete, {"X": (data, valid)})
    assert int(store["v_X"][2]) == 11 and not bool(store["m_X"][2])  # the last active row of slot 2
    assert not bool(store["occ"][5]) and bool(store["grave"][5])    # its delete winner
    assert int(store["v_X"][capacity]) == 13 and bool(store["m_X"][capacity])


def test_state_round_trips_nested_table_stores():
    nested = {"max_ts": np.array(5, np.int64), "jtab": {"occ": np.array([True, False])}}
    back = state_to_numpy(state_from_numpy(nested, "cpu"))
    assert back["jtab"]["occ"].tolist() == [True, False] and int(back["max_ts"]) == 5
