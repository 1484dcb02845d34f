"""The sliced kernels' plain twins against the reference's own methods.

Each case crafts a sliced store and a batch against it with numpy
(``chip_smoke.make_sliced_case``: live, stale and empty ring cells, graves,
duplicate writers of one ring cell, rows that overflowed into the dump
slot, inactive rows), hands the same arrays to ``CompiledDeviceQuery``'s
method and to the port's twin, and compares every output bit for bit:

* K5 ``sliced_fold`` against ``_sliced_scatter`` (the whole store, the dump
  row included);
* K6 ``combine_windows`` (through ``TorchCompiledQuery._combine_windows``)
  against ``_combine_windows``, with NaN and ±0.0 cells;
* K7 ``member_lanes``' winner mask (and the whole emission) against
  ``_sliced_member_emits``, including a batch at the ring cap;
* K1's sliced and expansion modes against ``pre_exchange``'s payload;
* K4's sliced branch against ``_trace_evict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ksql_tpu.common.batch import HostBatch as RHostBatch
from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu_torch.common.batch import HostBatch as PHostBatch
from ksql_tpu_torch.common.schema import LogicalSchema
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import slicing
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.test_slicing import HOPPING_CORPUS
from tests.test_torch_lowering import DDL, PV_DDL, gen_batches, plan_for
from tests.torch_kernel_cases import SLICED_SKEWS, sliced_skew

jax.config.update("jax_enable_x64", True)

BASELINE2 = (
    "CREATE TABLE PV_STATS AS SELECT URL, SUM(USER_ID) AS S, AVG(USER_ID) AS A, "
    "MIN(USER_ID) AS MN, MAX(USER_ID) AS MX FROM PAGE_VIEWS "
    "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 15 MINUTES) GROUP BY URL EMIT CHANGES;"
)
#: (ddl, query): BASELINE #2 (ring 102) and a DOUBLE SUM/AVG/MIN/MAX
#: hopping query (ring 9)
QUERIES = {"baseline2": (PV_DDL, BASELINE2), "double": (DDL, HOPPING_CORPUS[1][0])}
CAPACITY = 256


def queries(name, capacity=CAPACITY, **kw):
    ddl, query = QUERIES[name]
    engine, plan, schema = plan_for(ddl, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=64, store_capacity=capacity, **kw)
    port_q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=64,
                                store_capacity=capacity, device="cpu", **kw)
    return ref_q, port_q, schema


def case(port_q, seed, n=400, one_slot=False):
    comps = tuple((c.combine, c.dtype, c.init) for c in port_q.store_layout.components)
    return chip_smoke.make_sliced_case(
        hs, np.random.default_rng(seed), port_q.store_capacity, port_q.slice_ring, n,
        components=comps, width=port_q.slice_width, specials=True, one_slot=one_slot)


def as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_torch(d):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in d.items()}


def assert_bits_equal(g, w, msg):
    """Equal arrays, floats bit for bit (-0.0 is not +0.0) apart from the
    NaN payload."""
    g, w = np.asarray(g), np.asarray(w)
    assert g.dtype == w.dtype and g.shape == w.shape, msg
    if g.dtype.kind == "f":
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=msg)
        g, w = g[~nan].view(np.int64), w[~nan].view(np.int64)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def assert_same_arrays(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        assert_bits_equal(got[k], want[k], f"{where}: {k}")


def assert_same_env(got, want):
    assert set(got) == set(want)
    for name in want:
        assert_bits_equal(got[name].data.numpy(), want[name].data, name)
        assert_bits_equal(got[name].valid.numpy(), want[name].valid, name)


@pytest.mark.parametrize("name", list(QUERIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_sliced_fold_twin_matches_reference(name, seed):
    ref_q, port_q, _schema = queries(name)
    layout, store, rows = case(port_q, seed)
    assert layout.components == port_q.store_layout.components
    payload = {"active": jnp.asarray(rows["active"]), "wstart": jnp.asarray(rows["wstart"])}
    want = ref_q._sliced_scatter(as_jax(store), jnp.asarray(rows["slots"]), payload,
                                 [jnp.asarray(c) for c in rows["contribs"]])
    got = as_torch(store)
    t = as_torch({k: rows[k] for k in ("slots", "wstart", "active")})
    slicing.sliced_fold(got, {}, layout, t["slots"], t["wstart"],
                        [torch.from_numpy(c) for c in rows["contribs"]], t["active"],
                        port_q.slice_width)
    assert_same_arrays(state_to_numpy(got), jax.device_get(want), "sliced_fold")
    # the case exercises what the dump row and the resets must get right
    ring = layout.components[0].width
    live = rows["active"] & (rows["slots"] != CAPACITY)
    sidx = rows["wstart"] // port_q.slice_width
    cur = store["slice_id"][rows["slots"], sidx % ring]
    assert (live & (cur >= 0) & (cur != sidx)).any()  # recycled cells
    assert (rows["active"] & ~live).any() and (~rows["active"]).any()


@pytest.mark.parametrize("name", list(QUERIES))
@pytest.mark.parametrize("kind", SLICED_SKEWS)
def test_sliced_fold_twin_matches_reference_at_the_kernels_skews(name, kind):
    """K5's twin against ``_sliced_scatter`` where the kernel's design
    leans (``SLICED_SKEWS``): one key taking most of a batch over many ring
    positions, the 32 rows of one warp on one cell with int64 extremes,
    every target cell stale and none stale, no row active, active rows
    that overflowed into the dump slot.  Tolerance: none (bits)."""
    ref_q, port_q, _schema = queries(name)
    layout, store, rows = case(port_q, 5)
    store, rows = sliced_skew(kind, store, rows, CAPACITY, layout.components[0].width,
                              port_q.slice_width, seed=5)
    payload = {"active": jnp.asarray(rows["active"]), "wstart": jnp.asarray(rows["wstart"])}
    want = ref_q._sliced_scatter(as_jax(store), jnp.asarray(rows["slots"]), payload,
                                 [jnp.asarray(c) for c in rows["contribs"]])
    got = as_torch(store)
    t = as_torch({k: rows[k] for k in ("slots", "wstart", "active")})
    slicing.sliced_fold(got, {}, layout, t["slots"], t["wstart"],
                        [torch.from_numpy(c) for c in rows["contribs"]], t["active"],
                        port_q.slice_width)
    assert_same_arrays(state_to_numpy(got), jax.device_get(want), f"sliced_fold[{kind}]")


@pytest.mark.parametrize("name", list(QUERIES))
@pytest.mark.parametrize("one_slot", [False, True])
def test_member_lanes_and_combine_twins_match_reference(name, one_slot):
    ref_q, port_q, _schema = queries(name)
    _layout, store, rows = case(port_q, 3, one_slot=one_slot)
    ring, w = port_q.slice_ring, port_q.slice_width
    spw = port_q.size_ms // w
    if one_slot:
        # a stream time early enough that every covering window is open
        rows["max_ts"] = rows["max_ts"] - (ring + spw) * w
    store["max_ts"] = rows["max_ts"]
    jstore = as_jax(store)
    payload = {"active": jnp.asarray(rows["active"]), "wstart": jnp.asarray(rows["wstart"])}
    member = ref_q.members[0]
    want = ref_q._sliced_member_emits(jstore, jnp.asarray(rows["slots"]), payload, member,
                                      jstore["max_ts"])
    port_q.state = state_from_numpy(store, "cpu")
    t = as_torch({k: rows[k] for k in ("slots", "wstart", "active")})
    got = port_q._sliced_member_emits(t["slots"], t, port_q.members[0])
    assert_same_arrays({k: v.numpy() for k, v in got.items()},
                       {k: v for k, v in jax.device_get(want).items() if k != "dec_envelope"},
                       "member emits")
    winner = got["emit_mask"]
    assert winner.any()
    # K6 alone: the combined, finalized env of every lane
    w_lane, slot_lane, _win = slicing.member_lanes_plain(
        t["slots"], t["active"], t["wstart"], port_q.state["max_ts"], CAPACITY, w, spw,
        port_q.advance_ms, port_q.size_ms, port_q.grace_ms, port_q.hop_k)
    env_p, ts_p = port_q._combine_windows(slot_lane, w_lane, port_q.members[0])
    env_r, ts_r, _exc = ref_q._combine_windows(jstore, jnp.asarray(slot_lane.numpy()),
                                               jnp.asarray(w_lane.numpy()), member)
    assert_same_env(env_p, env_r)
    np.testing.assert_array_equal(ts_p.numpy(), np.asarray(ts_r))
    if one_slot:
        # every active row hits one key, its slices spanning the whole ring:
        # the window lanes of that key span ring + spw - 2 > ring windows
        wins = w_lane[winner & (slot_lane == int(rows["slots"][0]))]
        assert int(wins.max() - wins.min()) + 1 == ring + spw - 2 > ring


@pytest.mark.parametrize("name", ["double"])
def test_combine_twin_reads_nan_and_signed_zero_like_reference(name):
    # cells of one window mixing NaN, -0.0 and +0.0 under SUM/MIN/MAX
    ref_q, port_q, _schema = queries(name)
    _layout, store, rows = case(port_q, 5)
    store["max_ts"] = rows["max_ts"]
    sid = store["slice_id"]
    live = np.nonzero(store["occ"][:-1])[0][:8]
    ring = port_q.slice_ring
    newest = int(rows["wstart"][rows["active"]].max()) // port_q.slice_width
    spw = port_q.size_ms // port_q.slice_width
    w0 = newest - spw + 1
    vals = [np.nan, -0.0, 0.0, -0.0]
    for s in live:
        for t in range(spw):
            sid[s, (w0 + t) % ring] = w0 + t
            for j, comp in enumerate(port_q.store_layout.components):
                if comp.dtype == "float64":
                    store[f"a{j}"][s, (w0 + t) % ring] = vals[(t + s) % 4]
    slot_lane = torch.from_numpy(np.repeat(live, 2).astype(np.int32))
    w_lane = torch.from_numpy(np.tile([w0, w0 + 1], live.size).astype(np.int64))
    port_q.state = state_from_numpy(store, "cpu")
    env_p, _ = port_q._combine_windows(slot_lane, w_lane, port_q.members[0])
    env_r, _, _ = ref_q._combine_windows(as_jax(store), jnp.asarray(slot_lane.numpy()),
                                         jnp.asarray(w_lane.numpy()), ref_q.members[0])
    assert_same_env(env_p, env_r)
    # MIN of {-0.0, +0.0} is -0.0, MAX is +0.0; NaN wins both
    for nm, neg in (("KSQL_AGG_VARIABLE_2", True), ("KSQL_AGG_VARIABLE_3", False)):
        data = env_p[nm].data
        assert torch.isnan(data).any()
        assert (torch.signbit(data[data == 0]) == neg).all() and (data == 0).any()


@pytest.mark.parametrize("sliced", [None, False])
def test_row_prologue_modes_match_reference_payload(sliced):
    ref_q, port_q, schema = queries("baseline2", capacity=1 << 12, sliced=sliced)
    pschema = LogicalSchema.from_json(schema.to_json())
    rows, ts = gen_batches(21, 1, 64, urls=30, ts_step=900_000, pv=True)[0]
    arrays = ref_q.layout.encode(RHostBatch.from_rows(schema, rows, timestamps=ts))
    parr = port_q.layout.encode(PHostBatch.from_rows(pschema, rows, timestamps=ts))
    # stream time in the middle of the batch: the admission, grace and (on
    # the sliced route) the in-batch horizon cuts all bite
    clock = int(np.median(ts))
    want = jax.device_get(ref_q.pre_exchange(jnp.asarray(clock), as_jax(arrays)))
    port_q.state["max_ts"].fill_(clock)
    got = port_q.pre_exchange({k: torch.from_numpy(np.asarray(v)) for k, v in parr.items()})
    n = port_q.capacity * port_q.expansion
    assert got["active"].shape == (n,)
    for k in ("khash", "wstart", "knull", "ts", "active"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got["reprs"][0].numpy(), want["repr0"])
    for j, c in enumerate(got["contribs"]):
        np.testing.assert_array_equal(c.numpy(), want[f"c{j}"], err_msg=f"c{j}")
    act = got["active"].numpy()
    assert 0 < act.sum() < np.asarray(arrays["row_valid"]).sum() * port_q.expansion


@pytest.mark.parametrize("when", ["median", "none", "all"])
def test_sliced_evict_matches_reference(when):
    # the stream time past half the keys' newest slice plus the retention
    # (median), short of every key's (none) or past every key's (all)
    ref_q, port_q, _schema = queries("baseline2")
    _layout, store, _rows = case(port_q, 7)
    live = store["slast"][store["occ"]]
    t = {"median": int(np.median(live)), "none": int(live.min()), "all": int(live.max()) + 1}[when]
    store["max_ts"] = np.array(t + port_q.retention_ms, np.int64)
    want = jax.device_get(ref_q._trace_evict(as_jax(store)))
    port_q.state = state_from_numpy(store, "cpu")
    port_q._evict()
    got = state_to_numpy(port_q.state)
    assert_same_arrays(got, want, "evict")
    expired = store["occ"] & ~got["occ"]
    assert expired.any() == (when != "none") and got["occ"].any() == (when != "all")
    assert (got["slice_id"][expired] == -1).all()
