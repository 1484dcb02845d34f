"""Inputs of K16's write mode and K17 at the edges of their kernels'
tiles, shared by the CPU parity tests (the twins against the reference's
jax) and the card tests (the kernels against the twins).  Numpy and torch
only: the card's machine has no JAX."""

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
