"""The port's keyed-store primitives against ``ksql_tpu.ops.hash_store``.

Inputs are made with numpy from a seed and handed to both sides; the JAX
reference runs on the CPU.  Integer, bool, hash and slot results must be
bit-identical; float64 folds are held to rtol 1e-12 (summation order is the
only freedom).  These tests run the kernels' plain torch twins — the CUDA
kernels themselves are checked against the same twins on the card
(``test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksql_tpu.ops import hash_store as ref
from ksql_tpu.ops import window as ref_window
from ksql_tpu_torch.ops import hash_store as hs
from ksql_tpu_torch.ops import window as port_window
from ksql_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.torch_kernel_cases import FOLD_CASES as FOLD_SKEWS
from tests.torch_kernel_cases import FOLD_COMPONENTS, fold_case

jax.config.update("jax_enable_x64", True)

I64 = np.iinfo(np.int64)
EDGES = np.array([0, 1, -1, I64.min, I64.max, I64.min + 1, -8, 2**62, -(2**62)], np.int64)


def _values(seed, n=512):
    rng = np.random.default_rng(seed)
    v = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    v[: len(EDGES)] = EDGES
    return v


def test_mix64_bit_exact():
    v = _values(0)
    want = np.asarray(ref.mix64(jnp.asarray(v)))
    got = hs.mix64(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hs.np_mix64(v), want)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_combine_hash_bit_exact(k):
    parts = [_values(10 + i) for i in range(k)]
    want = np.asarray(ref.combine_hash([jnp.asarray(p) for p in parts]))
    got = hs.combine_hash([torch.from_numpy(p) for p in parts]).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ row_prologue (K1)
def _ref_prologue(reprs, valid, ts, active, size_ms, grace_ms, max_ts, capacity):
    """The reference's per-row prologue, spelled out as lowering.py's
    pre_exchange and hash_store.probe_insert compute it."""
    n = ts.shape[0]
    ts_j = jnp.asarray(ts)
    wstart = ref_window.tumbling_starts(ts_j, size_ms) if size_ms else jnp.zeros(n, jnp.int64)
    knull = jnp.zeros(n, jnp.int32)
    for i in range(reprs.shape[0]):
        knull = knull | (~jnp.asarray(valid[i])).astype(jnp.int32) << i
    act = jnp.asarray(active) & (knull == 0)
    khash = ref.combine_hash([jnp.asarray(r) for r in reprs] + [knull.astype(jnp.int64)])
    if size_ms:
        act = act & (wstart + size_ms + grace_ms > jnp.int64(max_ts))
    base = (ref.mix64(khash ^ (wstart * ref._GOLD)) & (capacity - 1)).astype(jnp.int32)
    c0 = jnp.where(act, ts_j, I64.min)
    return [np.asarray(x) for x in (wstart, knull, act, khash, base, c0)]


HOUR = 3_600_000


def _prologue_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    n, k, size, grace, max_ts = 256, 1, HOUR, 24 * HOUR, 1_700_000_000_000
    reprs = rng.integers(I64.min, I64.max, (k, n), dtype=np.int64)
    valid = np.ones((k, n), bool)
    ts = max_ts - rng.integers(0, 2 * HOUR, n)
    if name == "precedence":
        # mix64(h ^ (p + GOLD)), not mix64((h ^ p) + GOLD): reprs whose
        # low bits carry into the xor expose the grouping
        reprs[0, :16] = np.arange(16) - 8
    elif name == "logical_shift":
        # negative reprs: an arithmetic >> would smear the sign bit
        reprs[0] = -np.abs(reprs[0]) - 1
    elif name == "floor_remainder":
        # negative timestamps: floor (jnp.remainder), not C truncation
        ts = -rng.integers(1, 10 * HOUR, n)
        max_ts = -HOUR
    elif name == "knull_int32":
        # null bits built as int32 and widened to int64 for the hash
        k = 3
        reprs = rng.integers(I64.min, I64.max, (k, n), dtype=np.int64)
        valid = rng.random((k, n)) > 0.3
    elif name == "grace":
        # grace against the batch-start stream time: half the rows late, and
        # windows ending exactly at / one hour after max_ts - grace
        max_ts = 472_222 * HOUR
        ts = max_ts - rng.integers(0, 50 * HOUR, n)
        ts[:8] = max_ts - 25 * HOUR + np.array([0, 1, HOUR - 1, HOUR, HOUR + 1, -1, -HOUR, 2 * HOUR])
    elif name == "unwindowed":
        size = 0
    active = rng.random(n) > 0.1
    return reprs, valid, ts.astype(np.int64), active, size, grace, max_ts


@pytest.mark.parametrize(
    "case", ["precedence", "logical_shift", "floor_remainder", "knull_int32", "grace", "unwindowed"]
)
def test_row_prologue_twin_matches_reference(case):
    reprs, valid, ts, active, size, grace, max_ts = _prologue_case(case)
    capacity = 1 << 12
    want = _ref_prologue(reprs, valid, ts, active, size, grace, max_ts, capacity)
    got = hs.row_prologue(
        torch.from_numpy(reprs), torch.from_numpy(valid), torch.from_numpy(ts),
        torch.from_numpy(active), size, grace, torch.tensor(max_ts), capacity,
    )
    for name, g, w in zip(("wstart", "knull", "active", "khash", "base", "c0"), got, want):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case == "grace":
        assert 0 < want[2].sum() < active.sum()
    if case == "knull_int32":
        assert want[1].max() > 1


@pytest.mark.parametrize("fn,width", [("tumbling_starts", HOUR), ("slice_starts", 20 * 60_000),
                                      ("tumbling_starts", 7)])
def test_window_starts_match_reference(fn, width):
    ts = np.concatenate([_values(5, 256) // 1000, np.arange(-20, 20), [0, -1, 1]]).astype(np.int64)
    want = np.asarray(getattr(ref_window, fn)(jnp.asarray(ts), width))
    np.testing.assert_array_equal(getattr(port_window, fn)(torch.from_numpy(ts), width).numpy(), want)


@pytest.mark.parametrize("size,advance", [(HOUR, 20 * 60_000), (HOUR, HOUR), (10, 3)])
def test_hopping_expansion_matches_reference(size, advance):
    assert port_window.hopping_expansion(size, advance) == ref_window.hopping_expansion(size, advance)


# ------------------------------------------------------ probe_insert (K2)
def _store_np(capacity, num_keys=1, seed=0, fill=0, graves=0):
    layout = ref.StoreLayout(capacity, num_keys, (ref.AggComponent("add", "int64", 0),))
    st = {k: np.array(v) for k, v in jax.device_get(ref.init_store(layout)).items()}
    rng = np.random.default_rng(seed)
    if fill:
        kh = rng.integers(I64.min, I64.max, fill, dtype=np.int64)
        ws = np.zeros(fill, np.int64)
        slots = ref.host_insert(st["occ"], st["khash"], st["wstart"], capacity, kh, ws)
        st["key0"][slots] = kh
        dead = slots[:graves]
        st["occ"][dead] = False
        st["grave"][dead] = True
    return st


def _probe_inputs(st, capacity, case, seed, n=128):
    rng = np.random.default_rng(seed)
    live = np.nonzero(st["occ"][:-1] | st["grave"][:-1])[0]
    reprs = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    if case == "duplicates":
        reprs = reprs[rng.integers(0, 8, n)]
    wstart = np.zeros(n, np.int64)
    khash = np.array(ref.combine_hash([jnp.asarray(reprs), jnp.zeros(n, jnp.int64)]))
    if case in ("matching_graves", "existing") and live.size:
        pick = live[rng.integers(0, live.size, n // 2)]
        khash[: n // 2] = st["khash"][pick]
        reprs[: n // 2] = st["key0"][pick]
    active = rng.random(n) > 0.1
    if case == "one_inactive":
        active[:] = False
    knull = np.zeros(n, np.int32)
    return khash, wstart, reprs.reshape(1, n), knull, active


PROBE_CASES = {
    # name: (capacity, prefilled keys, graves among them)
    "duplicates": (1 << 10, 0, 0),
    "collisions": (1 << 8, 100, 0),
    "existing": (1 << 9, 200, 0),
    "matching_graves": (1 << 9, 200, 60),
    "nonclaimable_graves": (1 << 8, 150, 100),
    "overflow": (1 << 6, 40, 10),
    # the schedules of K2's single launch (csrc/probe_insert.cu): a row
    # found in the last of the 32 rounds behind a cluster of other keys; the
    # highest row winning its slot in round 31 exactly (the dump's khash
    # then comes from the row below it); rows overflowing a long cluster
    # beside one that wins in round 31; one inactive row; and a batch at
    # the one-block threshold (4,096 rows, which the card test
    # test_probe_insert_is_one_launch_and_matches_twin reads from the
    # kernel library) and one past it (the grid)
    "all_rounds": (1 << 9, 0, 0),
    "win_round_31": (1 << 9, 0, 0),
    "late_overflow": (1 << 9, 0, 0),
    "one_inactive": (1 << 6, 20, 5),
    "solo_threshold": (1 << 14, 3000, 300),
    "past_solo_threshold": (1 << 14, 3000, 300),
}

#: rows of each schedule case (the others have 128)
_PROBE_ROWS = {"one_inactive": 1, "solo_threshold": 4096, "past_solo_threshold": 4097}


def _keys_at(rng, capacity, base, count):
    """``count`` distinct random key hashes (window 0) whose first probe
    candidate is ``base``."""
    out = []
    while len(out) < count:
        kh = rng.integers(I64.min, I64.max, 1 << 14, dtype=np.int64)
        out.extend(kh[(hs.np_mix64(kh) & (capacity - 1)) == base].tolist())
    return np.array(out[:count], np.int64)


def _cluster_case(case, capacity, seed):
    """A store holding a run of other keys from slot ``b`` (31 long, or 40
    for ``late_overflow``) and rows probing into it; returns the store and
    the rows' (khash, wstart, reprs, knull, active)."""
    rng = np.random.default_rng(seed)
    st = _store_np(capacity)
    b = 100
    run = 40 if case == "late_overflow" else 31
    cells = np.arange(b, b + run)
    st["occ"][cells] = True
    st["khash"][cells] = rng.integers(I64.min, I64.max, run, dtype=np.int64)
    st["key0"][cells] = st["khash"][cells]
    if case == "all_rounds":
        # the rows' key sits past the run: found in round 31
        kh = _keys_at(rng, capacity, b, 1)
        st["occ"][b + run] = True
        st["khash"][b + run] = kh[0]
        st["key0"][b + run] = kh[0]
        khash = np.concatenate([np.repeat(kh, 5), _keys_at(rng, capacity, b + 5, 3)])
    elif case == "win_round_31":
        # the highest row alone reaches the free slot b + 31 in round 31
        khash = np.concatenate([_keys_at(rng, capacity, 400, 6), _keys_at(rng, capacity, b, 1)])
    else:
        # rows from b overflow; the row from b + 9 wins b + 40 in round 31
        khash = np.concatenate([_keys_at(rng, capacity, b, 4), _keys_at(rng, capacity, b + 9, 1),
                                _keys_at(rng, capacity, b, 2)])
    n = khash.size
    active = np.ones(n, bool)
    active[1] = False
    return st, (khash, np.zeros(n, np.int64), khash.reshape(1, n).copy(),
                (khash & 1).astype(np.int32), active)


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_insert_twin_matches_reference(case):
    capacity, fill, graves = PROBE_CASES[case]
    if case in ("all_rounds", "win_round_31", "late_overflow"):
        st, (khash, wstart, reprs, knull, active) = _cluster_case(case, capacity, seed=4)
    else:
        st = _store_np(capacity, fill=fill, graves=graves, seed=1)
        khash, wstart, reprs, knull, active = _probe_inputs(st, capacity, case, seed=2,
                                                            n=_PROBE_ROWS.get(case, 128))
    want_store, want_slots = ref.probe_insert(
        {k: jnp.asarray(v) for k, v in st.items()}, capacity, jnp.asarray(khash),
        jnp.asarray(wstart), [jnp.asarray(reprs[0])], jnp.asarray(knull), jnp.asarray(active),
    )
    port = state_from_numpy(st, "cpu")
    kh_t, ws_t = torch.from_numpy(khash), torch.from_numpy(wstart)
    base = hs.slot_base(kh_t, ws_t, capacity)
    slots = hs.probe_insert(port, {}, capacity, base, kh_t, ws_t,
                            torch.from_numpy(reprs), torch.from_numpy(knull),
                            torch.from_numpy(active))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(want_slots))
    got = state_to_numpy(port)
    want = {k: np.asarray(v) for k, v in jax.device_get(want_store).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_slots = np.asarray(want_slots)
    if case in ("overflow", "late_overflow"):
        assert int(want["overflow"]) > 0
    if case == "matching_graves":
        assert (st["grave"] & ~want["grave"]).any()
    if case == "all_rounds":
        assert (want_slots[active[:5].nonzero()[0]] == 100 + 31).all()
    if case == "win_round_31":
        assert want_slots[-1] == 100 + 31 and want["khash"][capacity] == khash[-2]
    if case == "late_overflow":
        assert want_slots[4] == 100 + 40 and int(want["overflow"]) == 5
        assert want["key0"][capacity] == reprs[0][-1]
    if case == "one_inactive":
        assert want_slots.tolist() == [capacity] and int(want["overflow"]) == 0


# -------------------------------------- scatter_combine + winners (K3)
FOLD_CASES = [
    ("add", "int64"), ("min", "int64"), ("max", "int64"),
    ("add", "float64"), ("min", "float64"), ("max", "float64"),
    ("add", "int32"), ("max", "int32"),
]


@pytest.mark.parametrize("combine,dtype", FOLD_CASES)
def test_fold_and_mark_twin_matches_reference(combine, dtype):
    rng = np.random.default_rng(3)
    capacity, n = 1 << 8, 512
    inits = {"add": 0, "min": np.inf if dtype == "float64" else np.iinfo(dtype).max,
             "max": -np.inf if dtype == "float64" else np.iinfo(dtype).min}
    comps = (ref.AggComponent("max", "int64", I64.min), ref.AggComponent(combine, dtype, inits[combine]))
    layout = ref.StoreLayout(capacity, 1, comps)
    st = {k: np.array(v) for k, v in jax.device_get(ref.init_store(layout)).items()}
    st["a1"][: capacity // 2] = (rng.standard_normal(capacity // 2) * 100).astype(dtype)
    active = rng.random(n) > 0.2
    slots = np.where(active, rng.integers(0, capacity, n), capacity).astype(np.int32)
    ts = rng.integers(0, 10**12, n)
    c0 = np.where(active, ts, I64.min)
    if dtype == "float64":
        x = rng.standard_normal(n) * 1e3
        x[rng.random(n) < 0.02] = np.nan
        x[rng.random(n) < 0.02] = -0.0
        x[rng.random(n) < 0.02] = 0.0
    else:
        x = rng.integers(-1000, 1000, n).astype(dtype)
    c1 = np.where(active, x, np.asarray(inits[combine], dtype)).astype(dtype)
    want_store = ref.scatter_combine(
        {k: jnp.asarray(v) for k, v in st.items()}, layout, jnp.asarray(slots),
        [jnp.asarray(c0), jnp.asarray(c1)],
    )
    want_win = np.asarray(ref.winners_per_slot(jnp.asarray(slots), jnp.asarray(active), capacity))
    port = state_from_numpy(st, "cpu")
    port_layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(c.combine, c.dtype, c.init) for c in comps))
    win = hs.fold_and_mark(port, {}, port_layout, torch.from_numpy(slots),
                           [torch.from_numpy(c0), torch.from_numpy(c1)], torch.from_numpy(active))
    np.testing.assert_array_equal(win.numpy(), want_win)
    got = state_to_numpy(port)
    want = {k: np.asarray(v) for k, v in jax.device_get(want_store).items()}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if got[k].dtype == np.float64:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
            # signed zeros and NaNs land where XLA puts them
            np.testing.assert_array_equal(np.signbit(got[k]), np.signbit(want[k]), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ host rebuild
@pytest.mark.parametrize("case", list(FOLD_SKEWS))
def test_fold_and_mark_twin_matches_reference_at_the_kernels_skews(case):
    """K3's twin against ``scatter_combine`` and ``winners_per_slot`` at
    the skews the kernel's warp combine leans on (``FOLD_CASES``): one slot
    taking most of every warp, one warp's 32 lanes on one slot with NaN,
    -0.0 and +0.0 among their min/max values, uniform slots, most rows at
    the dump; every combine and dtype, int64 sums that wrap.  Tolerance:
    float64 sums rtol 1e-12 with their signs, all else exact."""
    n, kind = FOLD_SKEWS[case]
    state, slots, active, contribs = fold_case(n, kind)
    capacity = state["dirty"].shape[0] - 1
    comps = tuple(ref.AggComponent(*c) for c in FOLD_COMPONENTS)
    layout = ref.StoreLayout(capacity, 1, comps)
    st = {k: np.array(v) for k, v in jax.device_get(ref.init_store(layout)).items()}
    st.update({k: v.copy() for k, v in state.items()})
    want_store = ref.scatter_combine({k: jnp.asarray(v) for k, v in st.items()}, layout, jnp.asarray(slots),
                                     [jnp.asarray(c) for c in contribs])
    want_win = np.asarray(ref.winners_per_slot(jnp.asarray(slots), jnp.asarray(active), capacity))
    port = state_from_numpy(st, "cpu")
    port_layout = hs.StoreLayout(capacity, 1, tuple(hs.AggComponent(*c) for c in FOLD_COMPONENTS))
    win = hs.fold_and_mark(port, {}, port_layout, torch.from_numpy(slots),
                           [torch.from_numpy(c) for c in contribs], torch.from_numpy(active))
    np.testing.assert_array_equal(win.numpy(), want_win)
    got = state_to_numpy(port)
    want = {k: np.asarray(v) for k, v in jax.device_get(want_store).items()}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if got[k].dtype == np.float64:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
            np.testing.assert_array_equal(np.signbit(got[k]), np.signbit(want[k]), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if kind == "warp":
        # the warp's slot folds NaN: the case reaches XLA's NaN rule
        assert np.isnan(want["a3"][3]) and np.isnan(want["a4"][3])


@pytest.mark.parametrize("capacity,n", [(1 << 8, 150), (1 << 12, 3000)])
def test_host_insert_matches_reference(capacity, n):
    rng = np.random.default_rng(capacity)
    kh = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    ws = rng.integers(-5, 5, n).astype(np.int64) * HOUR
    outs = []
    for fn in (ref.host_insert, hs.host_insert):
        occ = np.zeros(capacity + 1, bool)
        k2 = np.zeros(capacity + 1, np.int64)
        w2 = np.zeros(capacity + 1, np.int64)
        slots = fn(occ, k2, w2, capacity, kh, ws)
        outs.append((slots, occ, k2, w2))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
