"""Inputs of K16's write mode and K17 at the edges of their kernels'
tiles, and of K3 (fold and argset), K20 (set and hist), K23, K5, K21,
K4, K18 and K25 at the skews and edges their designs lean on, shared by the CPU parity tests (the twins against
the reference's jax) and the card tests (the kernels against the twins).
Numpy and torch only (K25's plans are JSON that both packages decode): the
card's machine has no JAX."""

import copy
import json
import os

import numpy as np
import torch

I64 = np.iinfo(np.int64)
HOUR = 3_600_000


# ------------------------------------------------- K16's write mode
#: element bytes -> the component dtype of that width
_WIDTHS = {1: np.int8, 4: np.int32, 8: np.int64}


def write_case(m, kind, sizes=(8, 8), k=1, cap=None, seed=0):
    """K16 write mode's inputs over ``m`` sorted items, as numpy arrays:
    ``store`` (dirty, sess_start, sess_end, max_ts, a<j>: one component a
    width in ``sizes``, float64 among the 8-byte ones), ``merged`` (the
    item and segment columns K15 gives; segments of 1-6 items, a
    segment's values at its first position, junk elsewhere), ``ins``
    (K2's slots) and ``scal``.  ``kind``: ``random`` (a tenth of the items
    insert), ``none`` (every item inserts at its own slot: none aims at the
    dump slot C), ``all`` (none inserts), ``last`` (only the last item aims
    at C, the rest insert), ``overflow`` (inserting items whose K2 slot is
    C aim at it too)."""
    rng = np.random.default_rng(seed)
    cap = cap or max(2 * m, 64)
    c1 = cap + 1
    bounds = np.cumsum(rng.integers(1, 7, m))
    first = np.zeros(m, np.int32)
    first[1:] = np.isin(np.arange(1, m), bounds)
    segfirst = np.maximum.accumulate(np.where(first | (np.arange(m) == 0), np.arange(m), 0)).astype(np.int32)
    ins_act = rng.random(m) < 0.1
    if kind in ("none", "last"):
        ins_act[:] = True
    if kind == "last":
        ins_act[-1] = False
    if kind == "all":
        ins_act[:] = False
    ins = rng.permutation(cap)[:m].astype(np.int32)
    if kind == "overflow":
        ins[ins_act & (rng.random(m) < 0.5)] = cap
    ins[~ins_act & (rng.random(m) < 0.5)] = cap
    dtypes = [np.float64 if s == 8 and j % 2 else _WIDTHS[s] for j, s in enumerate(sizes)]

    def vals(dt, n):
        if dt == np.float64:
            v = rng.normal(size=n) * 1e6
            v[rng.random(n) < 0.1] = -0.0
            return v
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)

    store = {"dirty": rng.random(c1) < 0.3, "sess_start": vals(np.int64, c1),
             "sess_end": vals(np.int64, c1), "max_ts": np.asarray(rng.integers(-10**6, 10**6), np.int64)}
    for j, dt in enumerate(dtypes):
        store[f"a{j}"] = vals(dt, c1)
    start = rng.integers(I64.min, I64.max, m, dtype=np.int64)
    start[rng.random(m) < 0.05] = I64.max
    merged = {
        "reprs": rng.integers(I64.min, I64.max, (k, m), dtype=np.int64),
        "seg_reprs": rng.integers(I64.min, I64.max, (k, m), dtype=np.int64),
        "comps": [vals(dt, m) for dt in dtypes], "seg_comps": [vals(dt, m) for dt in dtypes],
        "start": start, "end": start + rng.integers(0, 10**6, m), "alive": rng.random(m) < 0.8,
        "isrow": rng.random(m) < 0.5, "segfirst": segfirst, "winner": rng.random(m) < 0.3,
        "ins_act": ins_act, "seg_start": vals(np.int64, m), "seg_end": vals(np.int64, m),
        "seg_has_row": rng.random(m) < 0.7,
        "seg_minrow": np.where(rng.random(m) < 0.2, I64.max, rng.integers(0, 10**6, m)),
    }
    scal = np.array([rng.integers(0, 10**6), rng.integers(-10**6, 2 * 10**6)], np.int64)
    return store, merged, ins, scal


def write_torch(store, merged, ins, scal):
    """``write_case``'s numpy arrays as the port's tensors."""
    def t(a):
        return torch.from_numpy(np.array(a))  # a contiguous copy of any rank

    pm = {key: ([t(x) for x in v] if isinstance(v, list) else t(v)) for key, v in merged.items()}
    return {key: t(v) for key, v in store.items()}, pm, t(ins), t(scal)


# K16's write mode takes 256 items a block and keeps the highest item aimed
# at the dump slot: the edges of a block, none and every item aimed at it,
# only the last item, inserts that overflowed onto it, no component and
# the most (KSQL_MAX_COMPS), element widths 1, 4 and 8, several keys
WRITE_CASES = {
    "m1": (1, "random", (8, 8), 1), "m255": (255, "random", (8, 8), 1),
    "m256": (256, "random", (8, 8), 1), "m257": (257, "random", (8, 8), 1),
    "m2000": (2000, "random", (8, 8), 1), "none": (600, "none", (8, 8), 1),
    "all": (600, "all", (8, 8), 1), "last_in_last_block": (785, "last", (8, 8), 1),
    "overflow": (700, "overflow", (8, 8), 1), "ncomp0": (300, "random", (), 1),
    "ncomp32": (300, "random", (8, 4, 1, 8) * 8, 2), "widths_1_4_8": (513, "random", (1, 4, 8), 3),
    "keys16": (300, "all", (4,), 16),
}




# ------------------------------------------------------------ K17
def clock_case(n, k, kind, seed=0):
    """K17's inputs over ``n`` rows and ``k`` hops (lane h*n + i is row i's
    hop h): ``(ts, wstart, active, row_valid, max_ts, emit_clock, size_ms,
    grace_ms)``.  ``kind``: ``random`` (rows 17 ms apart, 5% up to 90 min
    late, 5% padding, 10% of the lanes inactive), ``inactive`` (no lane
    active, no row valid), ``late`` (the store's stream time 2 h past
    every window's close), ``extremes`` (INT64_MIN and INT64_MAX
    timestamps and window starts), ``wrap`` (half the lanes' wstart + size
    + grace wraps past INT64_MAX)."""
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000_000
    ts = t0 + np.arange(n, dtype=np.int64) * 17
    ts -= rng.integers(0, 90 * 60_000, n) * (rng.random(n) < 0.05)
    row_valid = rng.random(n) > 0.05
    active = rng.random(n * k) > 0.1
    wstart = np.tile(ts - ts % HOUR, k) - np.repeat(np.arange(k, dtype=np.int64), n) * (HOUR // k)
    max_ts, emit_clock, size, grace = t0 - 30 * 60_000, t0 - 60_000, HOUR, 10 * 60_000
    if kind == "inactive":
        active[:] = False
        row_valid[:] = False
    elif kind == "late":
        max_ts = int(ts.max()) + 2 * HOUR
    elif kind == "extremes":
        pick = rng.random(n)
        ts[pick < 0.3] = I64.min
        ts[pick > 0.7] = I64.max
        wstart = rng.choice(np.array([I64.max - HOUR, I64.min, I64.max, 0, -1]), n * k)
        max_ts = emit_clock = I64.min
    elif kind == "wrap":
        wstart[rng.random(n * k) < 0.5] = I64.max - HOUR // 2
        max_ts = int(ts.min())
    return (torch.from_numpy(ts), torch.from_numpy(np.ascontiguousarray(wstart)),
            torch.from_numpy(active), torch.from_numpy(row_valid), torch.tensor(max_ts),
            torch.tensor(emit_clock), size, grace)


# K17's tiles are 256 threads x 2, 4 or 8 items (the most that still gives
# 128 tiles; one hop's lanes a tile): one row, a tile and its edges, several
# tiles of 1-4 hops, 40 tiles (a look-back past one window of 32), tiles of
# 4 and of 8 items with a partial last tile, phase 12h's 4 hops, every lane
# inactive, every lane late, INT64_MIN/MAX timestamps, a wrapping close
CLOCK_CASES = {
    "n1": (1, 1, "random"), "n511": (511, 1, "random"), "n512_k2": (512, 2, "random"),
    "n513_k3": (513, 3, "random"), "tiles5_k4": (5 * 512 + 7, 4, "random"),
    "tiles40": (40 * 512, 1, "random"), "items4": (1 << 17, 1, "random"),
    "items8_partial": ((1 << 19) + 3, 1, "random"), "hops4": (1 << 14, 4, "random"),
    "inactive": (1536, 3, "inactive"), "late": (1536, 2, "late"),
    "extremes": (1541, 2, "extremes"), "wrap": (1024, 4, "wrap"),
}


# ------------------------------------------------------------ K3
I32 = np.iinfo(np.int32)
#: K3 fold's components, (combine, dtype, init): every combine and dtype
FOLD_COMPONENTS = (("max", "int64", I64.min), ("add", "int64", 0), ("add", "float64", 0.0),
                   ("min", "float64", np.inf), ("max", "float64", -np.inf), ("min", "int64", I64.max),
                   ("add", "int32", 0), ("max", "int32", I32.min), ("min", "int32", I32.max))
#: the doubles XLA's min/max order: NaN wins, -0.0 is below +0.0
SIGNED = np.array([-0.0, 0.0, np.nan, 1.5, -1.5, np.inf, -np.inf])


def fold_case(n, kind, capacity=256, seed=0):
    """K3 fold's inputs over ``n`` rows into ``capacity`` slots, as numpy:
    ``(state, slots, active, contribs)``, ``state`` the components'
    columns (``a<j>``, ``capacity + 1`` cells, half of them folded before)
    and ``dirty``, ``contribs`` one column a component of
    ``FOLD_COMPONENTS`` (the identity on inactive rows; int64 adds near
    2^62, so sums wrap).  ``kind``: ``hot`` (one slot takes 90% of the
    rows: most of every warp), ``warp`` (rows 32-63, one warp's lanes, on
    one slot, their float min/max values from ``SIGNED``: NaN, -0.0 and
    +0.0 among them), ``spread`` (uniform slots) or ``dump`` (80% of the
    rows active at the dump slot, overflowed)."""
    rng = np.random.default_rng(seed)
    c1 = capacity + 1
    state = {"dirty": rng.random(c1) < 0.2}
    for j, (combine, dtype, init) in enumerate(FOLD_COMPONENTS):
        col = np.full(c1, init, dtype)
        held = rng.random(c1) < 0.5
        if dtype == "float64":
            col[held] = SIGNED[rng.integers(0, SIGNED.size, int(held.sum()))] if combine != "add" \
                else rng.normal(0, 100, int(held.sum()))
        else:
            col[held] = rng.integers(-1000, 1000, int(held.sum()))
        state[f"a{j}"] = col
    slots = rng.integers(0, capacity, n)
    if kind == "hot":
        slots[rng.random(n) < 0.9] = 7 % capacity
    elif kind == "warp":
        slots[32:64] = 3 % capacity
    elif kind == "dump":
        slots[rng.random(n) < 0.8] = capacity
    active = rng.random(n) > 0.1
    slots[~active] = capacity
    contribs = []
    for combine, dtype, init in FOLD_COMPONENTS:
        if dtype == "float64" and combine != "add":
            v = SIGNED[rng.integers(0, SIGNED.size, n)]
        elif dtype == "float64":
            v = rng.normal(0, 1e3, n)
            v[rng.random(n) < 0.01] = np.nan
        elif combine == "add" and dtype == "int64":
            v = rng.integers(-(2 ** 62), 2 ** 62, n)
        else:
            v = rng.integers(-100, 100, n)
        contribs.append(np.where(active, v, np.asarray(init, dtype)).astype(dtype))
    return state, slots.astype(np.int32), active, contribs


#: K3 fold's skews: a hot slot across every warp, one warp on one slot,
#: uniform slots, most rows at the dump; with more rows than one block
#: (256) and a grid-stride loop's worth (the cooperative grid caps its blocks)
FOLD_CASES = {
    "hot": (4096, "hot"), "warp": (96, "warp"), "spread": (3000, "spread"), "dump": (1000, "dump"),
    "hot_large": (1 << 18, "hot"),
}

#: K3 argset's components (ops/device_aggs.py): the ts watermark, EARLIEST
#: over a DOUBLE (min order, value, valid bit), LATEST over a BIGINT (max
#: order, value, valid bit)
ARGSET_COMPONENTS = (("max", "int64", I64.min), ("min", "int64", I64.max), ("argset", "float64", 0),
                     ("argset", "int32", 0), ("max", "int64", I64.min), ("argset", "int64", 0),
                     ("argset", "int32", 0))


def argset_case(n, kind, capacity=1 << 12, seed=0):
    """K3 argset's inputs before the fold: ``(state, slots, active,
    contribs)`` as numpy (``state`` the components' columns), rows with
    unique sequence numbers above every stored order.  ``kind``:
    ``top_block_wins`` (the last 256 rows, the kernel's last block, are
    each the only candidate of a slot of their own, so all of them win and
    the dump takes the highest row of an earlier block), ``none_wins``
    (every row active at the dump slot, overflowed: the dump takes row n
    - 1) or ``random`` (zipf slots, 5% inactive, 10% NULL values)."""
    rng = np.random.default_rng(seed)
    c1 = capacity + 1
    state = {}
    for j, (combine, dtype, init) in enumerate(ARGSET_COMPONENTS):
        state[f"a{j}"] = np.full(c1, init, dtype)
    held = rng.choice(capacity, capacity // 2, replace=False)
    old = rng.choice(1 << 30, 2 * held.size, replace=False).astype(np.int64)
    state["a1"][held], state["a4"][held] = old[:held.size], old[held.size:]
    state["a2"][held] = rng.normal(0, 100, held.size)
    state["a5"][held] = rng.integers(-10 ** 9, 10 ** 9, held.size)
    state["a3"][held] = state["a6"][held] = 1
    slots = held[(rng.zipf(1.3, n) - 1) % held.size].astype(np.int32)
    active = rng.random(n) >= 0.05
    valid = rng.random(n) >= 0.1
    if kind == "top_block_wins":
        top = np.arange(max(n - 256, 0), n)
        free = np.setdiff1d(np.arange(capacity), held)
        slots[top] = free[:top.size]
        active[top] = valid[top] = True
    elif kind == "none_wins":
        slots[:] = capacity
        active[:] = True
    slots[~active] = capacity
    seq = (1 << 40) + np.arange(n, dtype=np.int64)
    e_cand = active & valid
    x = rng.normal(0, 100, n)
    x[rng.random(n) < 0.1] = -0.0
    x[rng.random(n) < 0.05] = np.nan
    contribs = [np.where(active, rng.integers(0, 10 ** 12, n), I64.min).astype(np.int64),
                np.where(e_cand, seq, I64.max), np.where(e_cand, x, 0.0),
                e_cand.astype(np.int32), np.where(active, seq, I64.min),
                np.where(active, rng.integers(-10 ** 9, 10 ** 9, n), 0).astype(np.int64),
                (active & valid).astype(np.int32)]
    return state, slots, active, contribs


ARGSET_CASES = {
    "top_block_wins": (1024, "top_block_wins"), "none_wins": (700, "none_wins"),
    "random": (5000, "random"),
}


# ------------------------------------------------------------ K20
#: doubles of a set's values: both zeros and NaN among them
SET_DOUBLES = np.array([-0.0, 0.0, np.nan, 1.5, -2.0, 7.25, -np.inf, 3.0, 4.5])


def collect_case(kind, mode, dtype="int64", capacity=64, K=40, n=600, seed=0):
    """K20's set or hist inputs: ``(components, state, contribs, slots)``,
    ``components`` the group's ``(combine, dtype, init, width, mode)`` at
    component 1 after an int64 max at 0, ``state`` numpy columns
    ``a1``-``a3`` (``a4``: hist's counts), ``contribs`` ``[None, head,
    values, bits]`` (hist: ``+ [head]``).  ``kind``: ``full_prefix``
    (every touched slot's stored prefix holds K entries; the batch's values
    partly among them), ``one_slot`` (every row on one slot, values
    repeated, NULL bits mixed in, NaNs among the doubles) or ``hot_run``
    (one slot takes 70% of the rows with many distinct values: a run
    longer than a block)."""
    rng = np.random.default_rng(seed)
    hist = mode == "hist"
    ddt = "int64" if hist else dtype
    comps = [("max", "int64", 0, 1, ""), ("vec_count", "int64", 0, 1, "hist" if hist else ""),
             ("vec_data", ddt, 0, K, mode), ("vec_valid", "int8", 0, K, "")]
    if hist:
        comps.append(("hist_count", "int64", 0, K, ""))
    c1 = capacity + 1
    span = 3 * K if kind == "hot_run" else K + K // 2

    def vals(m):
        if ddt == "float64":
            return SET_DOUBLES[rng.integers(0, SET_DOUBLES.size, m)].copy() if kind == "one_slot" \
                else rng.integers(0, span, m).astype(np.float64) / 4
        return rng.integers(0, span, m).astype(ddt)

    cnt = rng.integers(0, K + 1, c1).astype(np.int64)
    if kind == "full_prefix":
        cnt[:] = K + rng.integers(0, 3, c1) * (not hist)
    else:
        cnt[5] = K - 3  # the hot slot's prefix: most of K
    cnt[capacity] = 0
    data = np.stack([rng.permutation(span)[:K] for _ in range(c1)]).astype(ddt)
    if ddt == "float64":
        data /= 4
    state = {"a1": cnt, "a2": data, "a3": (rng.random((c1, K)) < 0.9).astype(np.int8)}
    if hist:
        state["a4"] = rng.integers(1, 5, (c1, K)).astype(np.int64)
    slots = rng.integers(0, capacity, n).astype(np.int32)
    if kind == "one_slot":
        slots[:] = 5
    elif kind == "hot_run":
        slots[rng.random(n) < 0.7] = 5
    slots[rng.random(n) < 0.03] = capacity
    head = np.where(rng.random(n) < 0.9, 1, 0 if not hist else -1).astype(np.int64)
    vbits = (rng.random(n) < 0.85).astype(np.int8)
    v = np.where(vbits != 0, vals(n), 0).astype(ddt)
    contribs = [None, head, v, vbits] + ([head] if hist else [])
    return comps, state, contribs, slots


COLLECT_CASES = {
    "set_full_prefix": ("full_prefix", "set", "int64"), "set_full_prefix_doubles": ("full_prefix", "set", "float64"),
    "set_one_slot": ("one_slot", "set", "int64"), "set_one_slot_doubles": ("one_slot", "set", "float64"),
    "set_hot_run": ("hot_run", "set", "int64"), "hist_full_prefix": ("full_prefix", "hist", "int64"),
    "hist_one_slot": ("one_slot", "hist", "int64"), "hist_hot_run": ("hot_run", "hist", "int64"),
}


# ------------------------------------------------------------ K23
#: doubles of an undo batch: both zeros and NaN among them
REMOVE_DOUBLES = np.array([-0.0, 0.0, np.nan, 1.5, -2.0, 7.25, np.inf])


def remove_case(kind, capacity=64, K=40, n=600, seed=0):
    """K23's inputs: ``(components, state, contribs, slots)``, the
    COLLECT_LIST group at component 1 after an int64 max at 0
    (``components`` as ``collect_case``'s), ``state`` numpy columns
    ``a1``-``a3`` (the dump row's cells past its count not zero),
    ``contribs`` ``[None, head, values, bits]``.  ``kind``: ``hot_slot``
    (one slot takes 80% of the undo rows, its list past the cap),
    ``repeats`` (K = 1,100: one value stored at 70 positions of a full
    list, some past the 1,024th, and 40 undo rows of it, past the 32nd
    occurrence; another stored 70 times with 5 undo rows), ``signed``
    (doubles: NaN, -0.0 and +0.0 stored and undone in one slot's run),
    ``all_win`` (each removing row alone on its slot: the dump row stays)
    or ``no_match`` (undo values no slot holds)."""
    rng = np.random.default_rng(seed)
    if kind == "repeats":
        K = 1100
    ddt = "float64" if kind == "signed" else "int64"
    comps = [("max", "int64", 0, 1, ""), ("vec_count", "int64", 0, 1, ""),
             ("vec_data", ddt, 0, K, "append"), ("vec_valid", "int8", 0, K, "")]
    c1 = capacity + 1
    cnt = rng.choice([0, 1, 5, K - 1, K, K + 7], c1).astype(np.int64)
    cnt[capacity] = 3
    if ddt == "float64":
        data = REMOVE_DOUBLES[rng.integers(0, REMOVE_DOUBLES.size, (c1, K))]
    else:
        data = rng.integers(0, 1 << 40, (c1, K))
    vbit = (rng.random((c1, K)) < 0.9).astype(np.int8)
    held = np.arange(K)[None, :] < np.minimum(cnt, K)[:, None]
    held[capacity] = True  # the dump row: cells past its count left as they are
    data = np.where(held, data, 0).astype(ddt)
    vbit = np.where(held, vbit, 0).astype(np.int8)
    slots = rng.integers(0, capacity, n)
    if kind == "hot_slot":
        cnt[7] = K + 7
        slots[rng.random(n) < 0.8] = 7
    pos = (rng.random(n) * np.maximum(np.minimum(cnt[slots], K), 1)).astype(np.int64)
    v = data[slots, pos].copy()
    b = vbit[slots, pos].copy()
    if kind == "no_match":
        v = rng.integers(1 << 41, 1 << 42, n)
    if kind == "signed":
        slots[: n // 2] = 9
        cnt[9] = K
        data[9] = REMOVE_DOUBLES[rng.integers(0, REMOVE_DOUBLES.size, K)]
        vbit[9] = 1
        v[: n // 2] = REMOVE_DOUBLES[rng.integers(0, REMOVE_DOUBLES.size, n // 2)]
        b[: n // 2] = 1
    head = np.where(rng.random(n) < 0.9, -1, rng.integers(0, 2, n)).astype(np.int64)
    slots[rng.random(n) < 0.03] = capacity
    if kind == "repeats":
        cnt[3] = cnt[4] = K
        for slot, at, undo in ((3, rng.choice(K, 70, replace=False), 40), (4, np.arange(0, K, K // 70)[:70], 5)):
            data[slot, at] = 1234567 + slot
            vbit[slot, at] = 1
            rows = rng.choice(n, undo, replace=False)
            slots[rows], v[rows], b[rows], head[rows] = slot, 1234567 + slot, 1, -1
        assert (np.nonzero(data[3] == 1234570)[0] >= 1024).any()
    if kind == "all_win":
        n = min(n, capacity)
        slots, v, b = rng.permutation(capacity)[:n], v[:n], b[:n]
        head = -np.ones(n, np.int64)
    state = {"a1": cnt, "a2": data, "a3": vbit}
    contribs = [None, head, v.astype(ddt), b.astype(np.int8)]
    return comps, state, contribs, slots.astype(np.int32)


REMOVE_CASES = ("hot_slot", "repeats", "signed", "all_win", "no_match")


# ------------------------------------------------------------ K5
def sliced_skew(kind, store, rows, capacity, ring, width, seed=0):
    """``make_sliced_case``'s store and rows (numpy) reshaped to one of
    K5's skews, as new arrays: ``hot_key`` (80% of the rows on one stored
    key over many ring positions), ``warp_cell`` (the first 32 rows, one
    warp, on one live cell, int64 contributions at their extremes so that
    adds wrap), ``all_stale`` (every live row's cell holds an earlier
    wrap's slice), ``none_stale`` (every live row's cell holds its slice),
    ``inactive`` (no row active) or ``overflow`` (a third of the active
    rows overflowed into the dump slot)."""
    rng = np.random.default_rng(seed)
    st = {k: np.array(v, copy=True) for k, v in store.items()}
    rw = {k: ([c.copy() for c in v] if k == "contribs" else np.array(v, copy=True)) for k, v in rows.items()}
    occupied = np.nonzero(st["occ"][:-1])[0]
    act = rw["active"]
    sidx = rw["wstart"] // width
    newest = int(sidx[act].max())
    if kind == "hot_key":
        hot = rng.random(act.size) < 0.8
        rw["slots"][hot] = occupied[0]
        act[hot] = True
        sidx[hot] = newest - rng.integers(0, ring - 1, int(hot.sum()))
    elif kind == "warp_cell":
        rw["slots"][:32] = occupied[1]
        act[:32] = True
        sidx[:32] = newest
        for j, c in enumerate(rw["contribs"]):
            if j > 0 and c.dtype == np.int64:
                c[:32] = np.where(np.arange(32) % 2 == 0, I64.max, I64.min + 1)
    elif kind == "inactive":
        act[:] = False
        rw["slots"][:] = capacity
    elif kind == "overflow":
        rw["slots"][act & (rng.random(act.size) < 0.33)] = capacity
    rw["wstart"] = sidx * width
    live = act & (rw["slots"] != capacity)
    cells = (rw["slots"][live], sidx[live] % ring)
    if kind == "all_stale":
        st["slice_id"][cells] = sidx[live] - ring
    elif kind == "none_stale":
        st["slice_id"][cells] = sidx[live]
    rw["active"] = act
    if kind == "inactive":
        ident = int(np.nonzero(~rows["active"])[0][0])  # an inactive row carries the identities
        for c in rw["contribs"]:
            c[:] = c[ident]
    return st, rw


SLICED_SKEWS = ("hot_key", "warp_cell", "all_stale", "none_stale", "inactive", "overflow")


# ------------------------------------------------------------ K21
#: doubles with the top-K traps: both zeros, NaN, the floor (-inf)
TOPK_DOUBLES = np.array([-0.0, 0.0, np.nan, 1.5, -2.0, 7.25, -np.inf, 3.0])
#: K21's batches: ``random`` (zipf slots, 3% at the dump slot, 5% holding
#: the sentinel), ``no_dump`` (none at the dump slot or the sentinel: the
#: dump row's merge reads a real slot), ``all_dump`` (every row at the dump
#: slot), ``alone`` (every row alone in its slot: the dump row untouched),
#: ``hot`` (half the rows on one slot, more than a block's group), ``runs``
#: (three slots of repeated values: ±0.0 and NaN for doubles), ``k1`` and
#: ``k256`` (the widths' edges), ``large`` (65,536 rows into 2^14 slots:
#: more rows than the kernel's grid has threads)
TOPK_KINDS = ("random", "no_dump", "all_dump", "alone", "hot", "runs", "k1", "k256", "large")


def topk_case(kind, dtype="int64", distinct=False, capacity=1 << 10, n=2048, seed=0):
    """A top-K column (component 1 of ``comps``, component 0 its count) and
    a batch of one of TOPK_KINDS, as numpy: ``(comps, state, vals,
    slots)``; ``comps`` rows are (combine, dtype, init, width, mode)."""
    rng = np.random.default_rng(seed)
    K = {"k1": 1, "k256": 256}.get(kind, 3)
    if kind == "k256":
        capacity, n = min(capacity, 64), min(n, 1024)
    elif kind == "large":
        capacity, n = max(capacity, 1 << 14), max(n, 1 << 16)
    sent = float("-inf") if dtype == "float64" else int(np.iinfo(dtype).min)
    comps = [("add", "int32", 0, 1, ""), ("topk", dtype, sent, K, "distinct" if distinct else "")]
    c1 = capacity + 1

    def draw(m):
        if dtype == "float64":
            return TOPK_DOUBLES[rng.integers(0, TOPK_DOUBLES.size, m)]
        hi = 100 if dtype == "int8" else 1000
        return rng.integers(-hi, hi, m).astype(dtype)

    col = np.sort(draw(c1 * K).reshape(c1, K), axis=1)[:, ::-1].copy()
    col[np.arange(K)[None, :] >= rng.integers(0, K + 1, c1)[:, None]] = sent
    slots = (rng.zipf(1.3, n) % capacity).astype(np.int32)
    vals = draw(n)
    if kind in ("random", "k1", "k256", "large"):
        slots[rng.random(n) < 0.03] = capacity
        vals[rng.random(n) < 0.05] = sent
    elif kind == "no_dump":
        vals[vals == sent] = 1
    elif kind == "all_dump":
        slots[:] = capacity
    elif kind == "alone":
        n = min(n, capacity)
        slots, vals = rng.permutation(capacity)[:n].astype(np.int32), vals[:n]
        vals[vals == sent] = 1
    elif kind == "hot":
        slots[rng.random(n) < 0.5] = slots[0]
    elif kind == "runs":
        pool = np.array([-0.0, 0.0, np.nan, 1.5]) if dtype == "float64" else np.array([0, 1, 2])
        vals = pool[rng.integers(0, pool.size, n)]
        slots = rng.integers(0, 3, n).astype(np.int32)
    return comps, {"a1": col.astype(dtype)}, vals.astype(dtype), slots


# ------------------------------------------------------------ K4
#: K4's edges: (component widths, which occupied slots expire, mode): every
#: one, none, one (slot 37: one lane of one warp), half at random, runs of
#: 1-40 consecutive slots; widths 1, 3 (rows shorter than 16 bytes), the
#: slice ring's 102 and a vector's 1,000
EVICT_CASES = {
    "width1_all": ((1,), "all", "tumbling"),
    "width1_one": ((1,), "one", "tumbling"),
    "width3_runs": ((3, 1), "runs", "tumbling"),
    "ring102_half": ((102,), "half", "sliced"),
    "ring102_all": ((102,), "all", "sliced"),
    "ring102_none": ((102,), "none", "sliced"),
    "width1000_one": ((1000, 1), "one", "tumbling"),
    "width1000_all": ((1000, 1), "all", "tumbling"),
    "width1000_runs": ((1000, 1), "runs", "tumbling"),
    "suppress_half": ((1, 3), "half", "suppress"),
}
#: each width's components: one of each element type
_EVICT_TYPES = (("max", "int64", int(I64.min)), ("add", "float64", 0.0), ("min", "int32", 2**31 - 1),
                ("add", "int8", -5))


def evict_case(name, capacity=1 << 10, seed=0):
    """A windowed store (HAVING verdicts, and born/emitted under suppress)
    and the retention at one of EVICT_CASES' edges, as numpy: ``(comps,
    state, retention, sliced, suppress)``; ``comps`` rows are (combine,
    dtype, init, width).  An expiring slot starts at 0, a kept one at 9.5
    h, the stream time is 10 h and the retention 1 h."""
    widths, pattern, mode = EVICT_CASES[name]
    rng = np.random.default_rng(seed)
    c1 = capacity + 1
    sliced = mode == "sliced"
    comps = [(cb, dt, init, w) for w in widths for cb, dt, init in _EVICT_TYPES]
    occ = rng.random(c1) < 0.8
    occ[-1] = False
    if pattern == "all":
        exp = np.ones(c1, bool)
    elif pattern == "none":
        exp = np.zeros(c1, bool)
    elif pattern == "one":
        exp = np.arange(c1) == 37
        occ[37] = True
    elif pattern == "half":
        exp = rng.random(c1) < 0.5
    else:  # runs of 1-40 slots, expiring or not in turn
        exp = np.repeat(np.arange(c1) % 2 == 0, rng.integers(1, 41, c1))[:c1]
    start = np.where(exp, 0, 9 * HOUR + HOUR // 2).astype(np.int64)
    st = {"occ": occ, "grave": ~occ & (rng.random(c1) < 0.1), "dirty": occ & (rng.random(c1) < 0.3),
          "wstart": np.zeros(c1, np.int64) if sliced else start, "max_ts": np.array(10 * HOUR, np.int64),
          "hpass": rng.random(c1) < 0.5}
    if sliced:
        ring = widths[0]
        st["slast"] = start
        st["slice_id"] = rng.integers(-1, 1000, (c1, ring)).astype(np.int64)
    if mode == "suppress":
        st["born"] = rng.integers(0, 1 << 40, c1).astype(np.int64)
        st["emitted"] = rng.random(c1) < 0.2
    for j, (_cb, dt, _init, w) in enumerate(comps):
        shape = (c1,) if w == 1 else (c1, w)
        st[f"a{j}"] = (rng.random(shape) * 100).astype(dt) if dt == "float64" else \
            rng.integers(-100, 100, shape).astype(dt)
    return comps, st, HOUR, sliced, mode == "suppress"


# ------------------------------------------------------------ K18
MIN = 60_000
#: K18's cases: (lanes, capacity, kind).  One lane; no candidate; every
#: candidate emitting; every one evicted; closes exactly on cm_emit values
#: and first times exactly on (and one ms either side of) a horizon; a hot
#: slot holding a quarter of the lanes; every lane at the dump slot; many
#: overflowed lanes; mostly inactive lanes; int32, int64 and float64
#: components; 17 and 9 slots (capacity + 1 is never a multiple of the
#: kernel's 16-slot vectors: a whole vector and a tail, a tail alone) with
#: candidates crowding both ends; orders that wrap past INT64_MAX within a
#: warp; 2^20 lanes (phase 12g's batch)
CLOSE_CASES = {
    "n1": (1, 1 << 10, "random"),
    "no_candidate": (3000, 1 << 12, "no_candidate"),
    "all_emit": (3000, 1 << 12, "all_emit"),
    "all_evict": (3000, 1 << 12, "all_evict"),
    "close_on_cm": (3000, 1 << 12, "close_on_cm"),
    "on_horizon": (3000, 1 << 12, "on_horizon"),
    "hot_quarter": (5000, 1 << 12, "hot_quarter"),
    "all_dump": (3000, 1 << 12, "all_dump"),
    "overflowed": (3000, 1 << 12, "overflowed"),
    "inactive": (3000, 1 << 12, "inactive"),
    "dtypes": (3000, 1 << 12, "dtypes"),
    "edges17": (2000, 16, "edges"),
    "edges9": (700, 8, "edges"),
    "order_wrap": (3000, 1 << 12, "order_wrap"),
    "lanes_2_20": (1 << 20, 1 << 20, "random"),
}
_CLOSE_TYPES = (("max", "int64", int(I64.min)), ("add", "int64", 0))
_CLOSE_DTYPES = (("add", "int32", 0), ("max", "int64", int(I64.min)), ("add", "float64", 0.0),
                 ("min", "float64", float("inf")))


def close_case(name, small=False, seed=0):
    """K18's inputs at one of CLOSE_CASES, as numpy: ``(comps, state,
    slots, active, cm_emit, size_ms, grace_ms, retention_ms)``; ``comps``
    rows are (combine, dtype, init); ``state`` holds an EMIT FINAL store's
    flags, ``wstart``, ``born``, the components and the two clocks.  1 h
    windows, a 10 min grace and a 3 h horizon (phase 2f's); the batch's
    stream times span 2 h from an hour boundary; 70% of the slots occupied,
    40% of those dirty and 10% emitted; born below row_clock for about half
    of them (the read first is final there); 10% of the lanes inactive and
    10% of the rest at the dump slot.  ``small`` cuts 2^20 lanes and slots
    to 2^12."""
    n, capacity, kind = CLOSE_CASES[name]
    if small:
        n, capacity = min(n, 1 << 12), min(capacity, 1 << 12)
    rng = np.random.default_rng(seed)
    size, grace, retention = HOUR, 10 * MIN, 3 * HOUR
    c1 = capacity + 1
    t0 = 1_700_000_000_000 - 1_700_000_000_000 % HOUR + 5 * HOUR
    cm = np.sort(t0 + rng.integers(0, 2 * HOUR, n))
    occ = rng.random(c1) < 0.7
    occ[-1] = False
    dirty = occ & (rng.random(c1) < 0.4)
    emitted = occ & (rng.random(c1) < 0.1)
    wstart = t0 + rng.integers(-5, 3, c1) * HOUR
    row_clock = 1 << 30
    if kind == "no_candidate":
        dirty[:] = False
    elif kind == "all_emit":
        wstart[:] = t0 - HOUR  # close t0 + 10 min, horizon t0 + 2 h: inside the batch
    elif kind == "all_evict":
        wstart[:] = t0 - 5 * HOUR  # closed and past its horizon before the batch
    elif kind == "close_on_cm":
        # closes exactly on emission times (inclusive), one ms after some
        ws = t0 + rng.integers(-2, 1, c1) * HOUR
        wstart = ws + rng.choice(np.array([0, 1, -1]), c1)
        cm[::7] = ws[rng.integers(0, c1, cm[::7].size)] + size + grace
        cm = np.sort(cm)
    elif kind == "on_horizon":
        # close t0 - 50 min; the first time at or past it is t0 + 1 h, the
        # horizon of start t0 - 2 h (inclusive), one ms either side of it
        wstart = t0 - 2 * HOUR + rng.choice(np.array([0, 1, -1]), c1)
        cm = np.concatenate([np.full(n // 3, t0 - 2 * HOUR), np.full(n - n // 3, t0 + HOUR)])
        cm[-1] += HOUR
    elif kind == "edges":
        occ[:-1] = dirty[:] = True
        emitted[:] = False
    elif kind == "order_wrap":
        row_clock = int(I64.max) - 40  # lanes 41 on wrap to INT64_MIN
    born = np.where(occ, rng.integers(0, 1 << 31, c1), I64.max).astype(np.int64)
    comps = _CLOSE_DTYPES if kind == "dtypes" else _CLOSE_TYPES
    live = np.nonzero(occ)[0]
    slots = rng.choice(live, n).astype(np.int32)
    active = rng.random(n) > 0.1
    if kind == "hot_quarter":
        hot = live[0]
        born[hot] = I64.max
        slots[rng.random(n) < 0.25] = hot
    elif kind == "all_dump":
        slots[:] = capacity
        active[:] = True
    elif kind == "overflowed":
        slots[active & (rng.random(n) < 0.4)] = capacity
    elif kind == "inactive":
        active = rng.random(n) < 0.1
    else:
        slots[rng.random(n) < 0.1] = capacity
    st = {"occ": occ, "grave": ~occ & (rng.random(c1) < 0.05), "dirty": dirty, "emitted": emitted,
          "wstart": wstart.astype(np.int64), "born": born,
          "emit_clock": np.array(t0 - MIN, np.int64), "row_clock": np.array(row_clock, np.int64)}
    for j, (_cb, dt, init) in enumerate(comps):
        vals = (rng.normal(size=c1) * 1e3).astype(dt) if dt == "float64" else \
            rng.integers(-1000, 1000, c1).astype(dt)
        st[f"a{j}"] = np.where(occ, vals, np.array(init, dt)).astype(dt)
    return comps, st, slots, active, cm.astype(np.int64), size, grace, retention


# ------------------------------------------------------------ K25
_TAP_TEMPLATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "ksql_tpu_torch",
                             "plans", "tap_mod_page_views.json")
TAP_NULLS = 0.05
TAP_T0 = 1_700_000_000_000


def _lit(v):
    if isinstance(v, str):
        return {"node": "StringLiteral", "fields": {"value": v}}
    node = "IntegerLiteral" if -(1 << 31) <= v < (1 << 31) else "LongLiteral"
    return {"node": node, "fields": {"value": int(v)}}


def _long(v):
    return {"node": "LongLiteral", "fields": {"value": int(v)}}


def _col(name):
    return {"node": "ColumnRef", "fields": {"name": name, "source": None}}


def _bin(node, enum, op, left, right):
    return {"node": node, "fields": {"op": {"enum": f"{enum}.{op}"}, "left": left, "right": right}}


def _tap_predicate(kind, i):
    """Lane ``i``'s predicate of program ``kind`` over PAGE_VIEWS, as JSON:
    ``mod`` (``USER_ID % m = r``, 8 instructions), ``not_and`` (``NOT
    ((CASE WHEN USER_ID > a THEN TRUE END AND VIEWTIME > t) OR URL = u)``:
    three-valued AND and OR over a NULL under a NOT, where NULL and FALSE
    differ), ``depth16`` (15 literals
    right-nested over USER_ID by +, then compared: a stack 16 deep) or
    ``instr128`` (32 comparisons of a column with a BIGINT literal, joined
    left-deep by alternating AND and OR: 128 instructions)."""
    if kind == "mod":
        m = 2 + i % 61
        return _bin("Comparison", "CompareOp", "EQ",
                    _bin("ArithmeticBinary", "ArithOp", "MODULUS", _col("USER_ID"), _lit(m)), _lit(i % m % 5))
    if kind == "not_and":
        # a comparison is never NULL on this path: a CASE without ELSE is
        maybe = {"node": "SearchedCase", "fields": {"when_clauses": [{"node": "WhenClause", "fields": {
            "condition": _bin("Comparison", "CompareOp", "GT", _col("USER_ID"), _lit(300 + 50 * i)),
            "result": {"node": "BooleanLiteral", "fields": {"value": True}}}}], "default": None}}
        both = _bin("LogicalBinary", "LogicOp", "AND", maybe,
                    _bin("Comparison", "CompareOp", "GT", _col("VIEWTIME"), _long(TAP_T0 + 17 * 40 * i)))
        either = _bin("LogicalBinary", "LogicOp", "OR", both, _bin("Comparison", "CompareOp", "EQ", _col("URL"),
                                                                   _lit(f"/page/{i}")))
        return {"node": "Not", "fields": {"operand": either}}
    if kind == "depth16":
        e = _col("USER_ID")
        for k in range(15):
            e = _bin("ArithmeticBinary", "ArithOp", "ADD", _lit(k + i), e)
        return _bin("Comparison", "CompareOp", "GT", e, _lit(600 + 7 * i))
    terms = []
    for k in range(32):
        col, op, v = (("USER_ID", "GT", 31 * k + i), ("VIEWTIME", "LTE", TAP_T0 + 17 * (97 * k + 13 * i)),
                      ("URL", "NEQ", None), ("USER_ID", "NEQ", k + i))[k % 4]
        lit = {"node": "StringLiteral", "fields": {"value": f"/page/{(k + i) % 9}"}} if v is None else _long(v)
        terms.append(_bin("Comparison", "CompareOp", op, _col(col), lit))
    e = terms[0]
    for k, t in enumerate(terms[1:]):
        e = _bin("LogicalBinary", "LogicOp", "AND" if k % 2 else "OR", e, t)
    return e


#: K25's edges: (program, lanes, rows, variant).  One row; 15 and 17 rows
#: (off the 4 rows a thread and the 32 of a warp's stride); 4,097 rows
#: (past eight 512-row tiles: the lanes' counts cross blocks); one lane;
#: 4,096 lanes; every row invalid; half the lanes inactive; LIMIT budgets
#: of 0, partial and past the count; NULLs through AND and OR under a
#: NOT; a program 16 deep; one of 128 instructions
TAP_EDGES = {
    "rows_1": ("mod", 8, 1, None),
    "rows_15": ("mod", 8, 15, None),
    "rows_17": ("mod", 8, 17, None),
    "rows_4097": ("mod", 8, 4097, None),
    "lanes_1": ("mod", 1, 1000, None),
    "lanes_4096": ("mod", 4096, 300, None),
    "rows_invalid": ("mod", 8, 600, "rows_invalid"),
    "inactive": ("mod", 16, 700, "inactive"),
    "limits": ("mod", 12, 2000, "limits"),
    "not_and": ("not_and", 8, 700, None),
    "depth16": ("depth16", 6, 700, None),
    "instr128": ("instr128", 5, 700, None),
}


def tap_edge_plans(name):
    """The edge's lanes as plan JSONs (the committed ``tap_mod_page_views``
    template with each lane's predicate), for both packages'
    ``plan_from_json``."""
    kind, lanes, _rows, _v = TAP_EDGES[name]
    with open(_TAP_TEMPLATE) as f:
        template = json.load(f)
    out = []
    for i in range(lanes):
        p = copy.deepcopy(template)
        p["plan"]["fields"]["physical_plan"]["fields"]["source"]["fields"]["predicate"] = _tap_predicate(kind, i)
        out.append(p)
    return out


def tap_edge_case(name, hash64, seed=0):
    """The edge's span as numpy: ``(columns, row_valid, limits, inactive)``;
    ``columns`` maps each PAGE_VIEWS column and ROWTIME to (data,
    validity): zipf(1.3) URLs of 50,000 (hashed by ``hash64``, the
    packages' ``stable_hash64``), USER_IDs 0-999, VIEWTIMEs 17 ms apart,
    each NULL 5% of the time; 2% of the rows invalid; ``inactive`` the
    lanes removed after packing; ``limits`` the lanes' LIMIT budgets
    (none: 2^62)."""
    _kind, lanes, rows, variant = TAP_EDGES[name]
    rng = np.random.default_rng(seed)
    urls = rng.zipf(1.3, rows) % 50_000
    cols = {
        "URL": np.array([hash64(f"/page/{u}") for u in urls], np.int64),
        "USER_ID": rng.integers(0, 1000, rows).astype(np.int64),
        "VIEWTIME": TAP_T0 + 17 * np.arange(rows, dtype=np.int64),
        "ROWTIME": TAP_T0 + 17 * np.arange(rows, dtype=np.int64),
    }
    columns = {}
    for c, d in cols.items():
        valid = np.ones(rows, bool) if c == "ROWTIME" else rng.random(rows) >= TAP_NULLS
        columns[c] = (np.where(valid, d, 0).astype(np.int64), valid)
    row_valid = rng.random(rows) >= 0.02
    limits = np.full(lanes, 1 << 62, np.int64)
    inactive = []
    if variant == "rows_invalid":
        row_valid[:] = False
    elif variant == "inactive":
        inactive = list(range(0, lanes, 2))
    elif variant == "limits":
        limits[:] = [0, 1, 3, 0, 50, 1 << 62, 7, 2, 1 << 40, 10**6, 0, 5][:lanes]
    return columns, row_valid, limits, inactive
