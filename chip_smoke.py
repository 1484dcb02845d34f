#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``ksql_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result:

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the main path built from ``ksql_tpu_torch/csrc`` by its own
   ``nvcc`` (all started together), with each build's seconds and its
   ``-Xptxas -v`` report.
2. Each kernel against its plain torch twin on the card, at the main path's
   shapes (65,536-row batches, a 2^20-slot store that is 70% full with
   graves, zipf(1.3) keys): exact for every int and bool column, rtol 1e-12
   for float64 sums (atomic order is not fixed).  Per kernel: its device
   time per call from torch.profiler (``ms``), the median CUDA-event time
   of one wrapper call over 50 calls after warm-up (``call_ms``, host
   launch cost included), the twin's time, the least time the card could
   take (bytes over 3.35 TB/s, ops over 67 TOP/s) and a PyTorch library
   yardstick where one exists.
3. End to end: ``run_plan`` on the flagship plan
   (``ksql_tpu_torch/plans/pv_counts_tumbling.json``, tumbling COUNT(*)
   GROUP BY URL) over 16 x 65,536 JSON records of 50,000 zipf(1.3) URLs.
   The sink must equal the port's own ``device="cpu"`` run record for
   record, the last count per (URL, window) must equal a dict count of the
   records, and the store must not overflow.  Prints events/s, p50/p99
   batch time and peak device memory.
4. Growth: 20 x 131,072 records over 48 h of event time, ~330,000
   (URL, window) keys, from a 2^20-slot store: the load trigger must run the
   retention pass (K4), which frees the windows past retention, and grow
   the store to 2^21 slots with zero overflow and exact counts.
5. Launch counters: every kernel launched during phases 3-4 (the counts are
   reset just before phase 3 and read just after phase 4).  Then a short
   profiled re-run of 4 e2e batches splits a batch's time into host stages
   and the card's busy share.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel JSON record, and the line before that the card's name and
power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
N_ROWS = 1 << 16
STORE = 1 << 20
N_BATCHES = 16
N_URLS = 50_000
GROWTH_ROWS = 1 << 17
GROWTH_BATCHES = 20
GROWTH_REPEATS = 8
DEVICE = "cuda"
TS0 = 1_700_000_000_000
HOUR_MS = 3_600_000
REPS = 50


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ timing
def time_events(torch, fn, reset=None, reps=REPS, warmup=3) -> float:
    """Median ms of ``fn()`` between CUDA events; ``reset()`` runs before
    each launch, outside the timed span (in-place kernels start from the
    same state every time)."""
    for _ in range(warmup):
        if reset is not None:
            reset()
        fn()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


#: CUDA function names of each kernel wrapper's launches
KERNEL_FUNCS = {
    "row_prologue": ("row_prologue_kernel",),
    "probe_insert": ("init_kernel", "round_a_kernel", "round_b_kernel", "write_kernel", "fixup_kernel"),
    "fold_and_mark": ("fold_kernel", "winners_kernel"),
    "evict": ("evict_kernel",),
}


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def kernel_device_ms(torch, name, fn, reset=None, reps=REPS) -> float:
    """Mean device time (ms) of kernel ``name``'s CUDA functions per call of
    ``fn``, from torch.profiler over ``reps`` calls (the copies that
    ``reset`` launches are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        if reset is not None:
            reset()
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if reset is not None:
                reset()
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages()
                if any(f in e.key for f in KERNEL_FUNCS[name]))
    require(total > 0, f"{name}: the profiler saw no device time for its kernels")
    return total / reps / 1e3


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phase 1
def phase_device_and_build(torch):
    from ksql_tpu_torch.ops import cuda

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    builds = cuda.build()
    print(f"[1] built {len(builds)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for k, info in builds.items():
        print(f"[1] {k}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line or "spill" in line):
                print(f"      {line.strip()}")
    return name, smi


# ------------------------------------------------------------- phase 2
def _urls(n):
    return np.array([f"/page/{i}" for i in range(n)], dtype=object)


def fill_store(hs, occ, kh, ws, capacity, khash, wstart):
    """Linear-probing insert of distinct keys with no probe limit (the
    host rebuild stops at 128 probes, which a 70%-full table exceeds):
    each round the lowest row wins each free candidate, and every other
    row moves one slot on."""
    mask = capacity - 1
    wmul = (wstart.astype(np.int64).view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)).view(np.int64)
    cand = (hs.np_mix64(khash ^ wmul) & mask).astype(np.int64)
    slots = np.empty(len(khash), np.int64)
    todo = np.arange(len(khash))
    while todo.size:
        c = cand[todo]
        free = np.nonzero(~occ[c])[0]
        won_slots, first = np.unique(c[free], return_index=True)
        winners = todo[free[first]]
        occ[won_slots] = True
        kh[won_slots] = khash[winners]
        ws[won_slots] = wstart[winners]
        slots[winners] = won_slots
        keep = np.ones(todo.size, bool)
        keep[free[first]] = False
        todo = todo[keep]
        cand[todo] = (cand[todo] + 1) & mask
    return slots


def make_store(torch, hs, capacity, n_keys_fill, rng, url_hashes, device):
    """A store that is ``n_keys_fill / capacity`` full of (URL, window)
    keys, 5% of them graves, built with the host rebuild path."""
    from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", np.iinfo(np.int64).min),
        hs.AggComponent("add", "int64", 0),
    ), windowed=True)
    store = state_to_numpy(hs.init_store(layout, "cpu"))
    n_win = -(-n_keys_fill // len(url_hashes))
    uid = np.arange(n_keys_fill) % len(url_hashes)
    win = np.arange(n_keys_fill) // len(url_hashes)
    wstart = TS0 - (n_win - 1 - win) * HOUR_MS - (TS0 % HOUR_MS)
    reprs = url_hashes[uid]
    khash = hs.combine_hash([torch.from_numpy(reprs), torch.zeros(len(reprs), dtype=torch.int64)]).numpy()
    slots = fill_store(hs, store["occ"], store["khash"], store["wstart"], capacity, khash, wstart)
    store["key0"][slots] = reprs
    store["a0"][slots] = wstart + rng.integers(0, HOUR_MS, len(slots))
    store["a1"][slots] = rng.integers(1, 1000, len(slots))
    graves = slots[rng.random(len(slots)) < 0.05]
    store["occ"][graves] = False
    store["grave"][graves] = True
    store["a0"][graves] = np.iinfo(np.int64).min
    store["a1"][graves] = 0
    store["max_ts"] = np.array(TS0 + HOUR_MS // 2, np.int64)
    return layout, state_from_numpy(store, device)


def _clone(d):
    return {k: v.clone() for k, v in d.items()}


def _restore(dst, src):
    for k, v in src.items():
        dst[k].copy_(v)


def _assert_equal(torch, name, a, b, rtol=0.0):
    """Exact (or rtol, NaN-equal) comparison; returns the max abs error."""
    a = a.detach().cpu()
    b = b.detach().cpu()
    require(a.dtype == b.dtype and a.shape == b.shape, f"{name}: {a.dtype}{list(a.shape)} vs {b.dtype}{list(b.shape)}")
    if a.is_floating_point():
        ok = torch.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True)
        require(bool(ok.all()), f"{name}: {int((~ok).sum())} cells differ beyond rtol {rtol}")
        fin = torch.isfinite(a) & torch.isfinite(b)
        return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    eq = a == b
    require(bool(eq.all()), f"{name}: {int((~eq).sum())} cells differ")
    return 0.0


def phase_kernels(torch, seed, n=N_ROWS, capacity=STORE):
    """Every kernel against its plain twin on the card; returns the
    per-kernel records (without launch counts)."""
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    url_hashes = np.fromiter((stable_hash64(u) for u in _urls(N_URLS)), np.int64, N_URLS)
    recs = {}

    # ---- K1 row_prologue: flagship key (URL), tumbling 1 h, 24 h grace
    uid = rng.zipf(1.3, n).astype(np.int64) % N_URLS
    reprs = torch.from_numpy(url_hashes[uid].reshape(1, n)).to(dev)
    valid = torch.from_numpy((rng.random((1, n)) > 0.01)).to(dev)
    ts_np = TS0 - 30 * HOUR_MS + np.sort(rng.integers(0, 31 * HOUR_MS, n))
    # rows in the window that ends exactly at the grace cut (dropped), one
    # millisecond either side of it, and a negative timestamp (floor)
    cut = TS0 - TS0 % HOUR_MS - 24 * HOUR_MS
    ts_np[:5] = [cut - HOUR_MS, cut - 1, cut, cut + 1, -1]
    ts = torch.from_numpy(ts_np).to(dev)
    active = torch.from_numpy(np.arange(n) < n - 17).to(dev)
    max_ts = torch.tensor(TS0 - TS0 % HOUR_MS, dtype=torch.int64, device=dev)
    args = (reprs, valid, ts, active, HOUR_MS, 24 * HOUR_MS, max_ts, capacity)
    got = hs.row_prologue(*args)
    want = hs.row_prologue_plain(*args)
    names = ("wstart", "knull", "active", "khash", "base", "c0")
    err = max(_assert_equal(torch, f"row_prologue.{nm}", g, w) for nm, g, w in zip(names, got, want))
    require(0 < int(got[2].sum()) < n, "row_prologue: grace cut should drop some rows and keep others")
    k = reprs.shape[0]
    ms = kernel_device_ms(torch, "row_prologue", lambda: hs.row_prologue(*args))
    call = time_events(torch, lambda: hs.row_prologue(*args))
    plain = time_events(torch, lambda: hs.row_prologue_plain(*args))
    b, by = bound(n * (9 * k + 9 + 33), n * (30 * (k + 1) + 20))
    recs["row_prologue"] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b, bound_by=by,
                                library_ms=None, max_abs_err=err)
    print(f"[2] row_prologue: exact; device {ms:.4f} ms, call {call:.4f} ms "
          f"(plain {plain:.4f} ms, bound {b:.4f} ms)")

    # ---- K2 probe_insert: 70%-full store with graves, zipf keys
    layout, store0 = make_store(torch, hs, capacity, int(0.7 * capacity), rng, url_hashes, dev)
    wstart, knull, act, khash, base, c0 = got
    # rows land in the store's recent windows: mostly matches, some new keys
    pin = (wstart, knull, act, khash, base)
    store_k, store_p = _clone(store0), _clone(store0)
    scratch = hs.init_scratch(capacity, dev)
    slots_k = hs.probe_insert(store_k, scratch, capacity, base, khash, wstart, reprs, knull, act)
    slots_p = hs.probe_insert_plain(store_p, capacity, base, khash, wstart, reprs, knull, act)
    _assert_equal(torch, "probe_insert.slots", slots_k, slots_p)
    for key in store0:
        _assert_equal(torch, f"probe_insert.{key}", store_k[key], store_p[key])
    require(bool((scratch["claim"] == hs.INT32_MAX).all()), "probe_insert: claim cells not clean")
    new_keys = int(store_k["occ"].sum() - store0["occ"].sum())
    reclaimed = int((store0["grave"] & ~store_k["grave"]).sum())
    matched = int(act.sum()) - new_keys
    print(f"[2] probe_insert: exact; {new_keys} new keys, {reclaimed} graves reclaimed, "
          f"overflow {int(store_k['overflow'])}")
    require(reclaimed > 0 and new_keys > 0, "probe_insert: data should exercise claims and graves")
    work = _clone(store0)

    def reset_k2():
        _restore(work, store0)

    def k2():
        hs.probe_insert(work, scratch, capacity, base, khash, wstart, reprs, knull, act)

    ms = kernel_device_ms(torch, "probe_insert", k2, reset_k2)
    call = time_events(torch, k2, reset_k2)
    plain = time_events(torch, lambda: hs.probe_insert_plain(work, capacity, base, khash, wstart, reprs, knull, act), reset_k2, reps=10, warmup=1)
    n_act = int(act.sum())
    b2, by2 = bound(
        n * (4 + 8 + 8 + 8 * k + 4 + 1) + n * 4 + n_act * 18 + new_keys * (1 + 1 + 8 + 8 + 8 * k + 4),
        n * 40,
    )
    recs["probe_insert"] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b2, bound_by=by2,
                                library_ms=None, max_abs_err=0.0)
    print(f"[2] probe_insert: device {ms:.4f} ms, call {call:.4f} ms (plain {plain:.4f} ms, "
          f"bound {b2:.4f} ms); {matched} rows matched")

    # ---- K3 fold_and_mark: the flagship's components at its shapes, then
    # every combine x dtype (float64 sums to rtol 1e-12, NaNs included)
    slots = slots_k
    ones = act.to(torch.int64)
    flag_contribs = [c0, ones]
    err3 = 0.0
    variants = [(layout, flag_contribs)]
    wide = hs.StoreLayout(capacity, 1, layout.components + (
        hs.AggComponent("add", "float64", 0.0),
        hs.AggComponent("min", "float64", float("inf")),
        hs.AggComponent("max", "float64", float("-inf")),
        hs.AggComponent("min", "int64", np.iinfo(np.int64).max),
        hs.AggComponent("add", "int32", 0),
        hs.AggComponent("max", "int32", 0),
    ), windowed=True)
    x = rng.standard_normal(n) * 1e3
    x[rng.random(n) < 0.001] = np.nan
    xd = torch.from_numpy(x).to(dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    wide_contribs = flag_contribs + [
        torch.where(act, torch.nan_to_num(xd), zero),
        torch.where(act, xd, torch.full_like(xd, float("inf"))),
        torch.where(act, xd, torch.full_like(xd, float("-inf"))),
        torch.where(act, ts, torch.full_like(ts, np.iinfo(np.int64).max)),
        act.to(torch.int32),
        act.to(torch.int32),
    ]
    variants.append((wide, wide_contribs))
    for lay, contribs in variants:
        base_store = _clone(store_k)
        for j, comp in enumerate(lay.components[2:], start=2):
            base_store[f"a{j}"] = torch.full((capacity + 1,), comp.init, dtype=hs._DTYPES[comp.dtype], device=dev)
        sk, sp = _clone(base_store), _clone(base_store)
        win_k = hs.fold_and_mark(sk, scratch, lay, slots, contribs, act)
        win_p = hs.fold_and_mark_plain(sp, lay, slots, contribs, act)
        _assert_equal(torch, "fold_and_mark.winners", win_k, win_p)
        require(bool((scratch["first"] == hs.INT32_MAX).all()), "fold_and_mark: first cells not clean")
        for key in base_store:
            comp = lay.components[int(key[1:])] if key.startswith("a") else None
            rtol = 1e-12 if comp is not None and comp.combine == "add" and comp.dtype == "float64" else 0.0
            err3 = max(err3, _assert_equal(torch, f"fold_and_mark.{key}", sk[key], sp[key], rtol))
    work = _clone(store_k)

    def reset_k3():
        _restore(work, store_k)

    def k3():
        hs.fold_and_mark(work, scratch, layout, slots, flag_contribs, act)

    ms = kernel_device_ms(torch, "fold_and_mark", k3, reset_k3)
    call = time_events(torch, k3, reset_k3)
    plain = time_events(torch, lambda: hs.fold_and_mark_plain(work, layout, slots, flag_contribs, act), reset_k3, reps=10, warmup=1)
    sl = slots.long()
    lib = time_events(torch, lambda: (work["a0"].index_reduce_(0, sl, c0, "amax"), work["a1"].index_add_(0, sl, ones)), reset_k3)
    touched = int(torch.unique(slots[act]).numel())
    b3, by3 = bound(n * (4 + 1 + 16) + touched * (2 * 16 + 1) + n, n * 6)
    recs["fold_and_mark"] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b3, bound_by=by3,
                                 library_ms=lib, max_abs_err=err3)
    print(f"[2] fold_and_mark: exact ints, float64 sums max abs err {err3:.3g}; device {ms:.4f} ms, "
          f"call {call:.4f} ms (plain {plain:.4f} ms, index_reduce_+index_add_ {lib:.4f} ms, "
          f"bound {b3:.4f} ms)")

    # ---- K4 evict: the same store, stream time past the oldest windows
    ev0 = _clone(store_k)
    ev0["max_ts"].fill_(int(store_k["wstart"][store_k["occ"]].min()) + 25 * HOUR_MS + 4 * HOUR_MS)
    ek, ep = _clone(ev0), _clone(ev0)
    retention = 25 * HOUR_MS
    hs.evict(ek, layout, retention)
    hs.evict_plain(ep, layout, retention)
    for key in ev0:
        _assert_equal(torch, f"evict.{key}", ek[key], ep[key])
    expired = int((ev0["occ"] & ~ek["occ"]).sum())
    require(expired > 0, "evict: data should expire some slots")
    work = _clone(ev0)

    def reset_k4():
        _restore(work, ev0)

    def k4():
        hs.evict(work, layout, retention)

    ms = kernel_device_ms(torch, "evict", k4, reset_k4)
    call = time_events(torch, k4, reset_k4)
    plain = time_events(torch, lambda: hs.evict_plain(work, layout, retention), reset_k4)
    b4, by4 = bound((capacity + 1) * 9 + expired * (3 + 16), (capacity + 1) * 4)
    recs["evict"] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b4, bound_by=by4,
                         library_ms=None, max_abs_err=0.0)
    print(f"[2] evict: exact; {expired} slots expired; device {ms:.4f} ms, call {call:.4f} ms "
          f"(plain {plain:.4f} ms, bound {b4:.4f} ms)")
    return recs


# ------------------------------------------------------------- phase 3/4
def produce_pageviews(broker, url_idx, ts):
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("page_views")
    for u, t in zip(url_idx.tolist(), ts.tolist()):
        value = f'{{"URL":"/page/{u}","USER_ID":{u % 1000},"VIEWTIME":{t}}}'
        topic.produce(Record(key=None, value=value, timestamp=t))


def sink_records(broker):
    return [(r.key, r.value, r.timestamp, r.window) for r in broker.topic("PV_COUNTS").all_records()]


def check_counts(broker, url_idx, ts, label):
    expected = {}
    for u, t in zip(url_idx.tolist(), ts.tolist()):
        k = (f"/page/{u}", t - t % HOUR_MS)
        expected[k] = expected.get(k, 0) + 1
    last = {}
    for key, value, _ts, window in sink_records(broker):
        last[(key, window[0])] = json.loads(value)["CNT"]
    require(last == expected, f"{label}: final counts differ from the dict reference "
            f"({len(last)} sink keys vs {len(expected)} expected)")
    return len(expected)


def run_main_path(torch, plan_json, url_idx, ts, device, store, batch_seconds=None, rows=None):
    """``run_plan`` over freshly produced page-view records.  With a
    ``batch_seconds`` list, each micro-batch (assembly, encode, device
    step, emit decode, produce) is timed on the host clock up to a
    ``torch.cuda.synchronize()``."""
    from ksql_tpu_torch.runner import run_plan
    from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor
    from ksql_tpu_torch.runtime.topics import Broker

    broker = Broker()
    produce_pageviews(broker, url_idx, ts)
    run_batch = TorchDeviceExecutor._run_batch
    if batch_seconds is not None:
        def timed_batch(self):
            t0 = time.perf_counter()
            out = run_batch(self)
            if device != "cpu":
                torch.cuda.synchronize()
            batch_seconds.append(time.perf_counter() - t0)
            return out

        TorchDeviceExecutor._run_batch = timed_batch
    try:
        t0 = time.perf_counter()
        ex = run_plan(plan_json, broker, device=device, capacity=rows or N_ROWS, store_capacity=store)
        if device != "cpu":
            torch.cuda.synchronize()
        return broker, ex, time.perf_counter() - t0
    finally:
        TorchDeviceExecutor._run_batch = run_batch


def phase_e2e(torch, plan_json, seed):
    rng = np.random.default_rng(seed + 1)
    n = N_BATCHES * N_ROWS
    url_idx = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    ts = TS0 + np.arange(n, dtype=np.int64) * 17
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE, batch_s)
    peak = torch.cuda.max_memory_allocated()
    require(int(ex.query.state["overflow"]) == 0, "e2e: store overflowed")
    keys = check_counts(broker, url_idx, ts, "e2e")
    cpu_broker, _ex, cpu_secs = run_main_path(torch, plan_json, url_idx, ts, "cpu", STORE)
    require(sink_records(broker) == sink_records(cpu_broker), "e2e: card sink differs from the CPU run")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    print(f"[3] e2e flagship: {n} events, {keys} (URL, window) keys, {len(sink_records(broker))} sink records; "
          f"card run {secs:.3f} s = {n / secs:.1f} events/s; batch p50 {p50:.3f} ms p99 {p99:.3f} ms "
          f"over {len(batch_s)} batches; peak device memory {peak} B; CPU twin run {cpu_secs:.3f} s; "
          "sink equals CPU run, counts equal dict reference, overflow 0")
    return dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, peak_bytes=peak)


def phase_breakdown(torch, plan_json, seed, n_batches=4):
    """Where an e2e batch's time goes, over the first ``n_batches`` of the
    e2e traffic: host stages timed by wrapping the port's functions (each
    device step synchronized, so its device work is charged to it — the
    pipelined overlap is off here), and the card's busy time from
    torch.profiler (kernels and copies) against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from ksql_tpu_torch.common.batch import HostBatch
    from ksql_tpu_torch.runtime import device_executor
    from ksql_tpu_torch.runtime.device import BatchLayout
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
    from ksql_tpu_torch.runtime.sink import SinkWriter

    rng = np.random.default_rng(seed + 1)
    n = N_BATCHES * N_ROWS
    url_idx = (rng.zipf(1.3, size=n).astype(np.int64) % N_URLS)[: n_batches * N_ROWS]
    ts = TS0 + np.arange(url_idx.size, dtype=np.int64) * 17
    acc: dict = {}

    def timed(stage, fn, sync=False):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            acc[stage] = acc.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    patches = [
        (device_executor, "decode_source_record", "json decode", False),
        (BatchLayout, "encode", "encode", False),
        (TorchCompiledQuery, "upload", "upload", True),
        (TorchCompiledQuery, "_step", "device step", True),
        (TorchCompiledQuery, "_react_to_load", "load check", False),
        (TorchCompiledQuery, "_decode_emits", "emit decode", False),
        (SinkWriter, "produce", "sink produce", False),
    ]
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _s, _y in patches]
    saved.append((HostBatch, "from_rows", HostBatch.__dict__["from_rows"]))
    try:
        for obj, name, stage, sync in patches:
            setattr(obj, name, timed(stage, getattr(obj, name), sync))
        HostBatch.from_rows = staticmethod(timed("batch assembly", HostBatch.from_rows))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _broker, _ex, wall = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE)
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)
    busy = sum(_device_us(e) for e in prof.key_averages()) / 1e6
    per = {k: v / n_batches * 1e3 for k, v in sorted(acc.items(), key=lambda kv: -kv[1])}
    per["other host"] = wall / n_batches * 1e3 - sum(per.values())
    print(f"[3b] breakdown over {n_batches} batches of {N_ROWS} (ms per batch): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
          + f"; card busy {busy / wall * 100:.2f}% of {wall:.3f} s wall (idle {100 - busy / wall * 100:.2f}%)")
    return {"ms_per_batch": per, "device_busy_share": busy / wall}


def phase_growth(torch, plan_json, seed):
    """High-cardinality growth through the load trigger.  Batches of
    GROWTH_ROWS rows give the pipelined trigger (occupancy + 4 batches of
    headroom > 0.75 x capacity) room to fire while the 2^20-slot store is
    about 0.3 full: the reference's 32-probe limit loses rows from about
    0.47 load at 65,536-row batches (see PERF.md), so the store must grow
    before that.  Each hour of event time has its own pool of URLs, each
    viewed GROWTH_REPEATS times on average, so a batch adds ~1.6% of the
    store in new (URL, window) keys."""
    rng = np.random.default_rng(seed + 2)
    n = GROWTH_BATCHES * GROWTH_ROWS
    ts = TS0 - TS0 % HOUR_MS + (np.arange(n, dtype=np.int64) * (48 * HOUR_MS)) // n
    hour = (ts - ts[0]) // HOUR_MS
    pool = max(1, n // 48 // GROWTH_REPEATS)
    url_idx = hour * pool + rng.integers(0, pool, n)
    torch.cuda.reset_peak_memory_stats()
    broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE, rows=GROWTH_ROWS)
    q = ex.query
    require(q.evictions >= 1, "growth: the retention pass never ran")
    require(q.grows >= 1 and q.store_capacity == 2 * STORE, f"growth: store at {q.store_capacity} slots")
    require(int(q.state["overflow"]) == 0, "growth: store overflowed")
    keys = check_counts(broker, url_idx, ts, "growth")
    print(f"[4] growth: {n} events in batches of {GROWTH_ROWS}, {len(np.unique(url_idx))} URLs, "
          f"{keys} keys in {secs:.3f} s; {q.evictions} retention passes, {q.compactions} compactions, "
          f"{q.grows} grows -> {q.store_capacity} slots; host rebuild seconds "
          f"{[round(x, 4) for x in q.rebuild_seconds]} (the last one is the grow); peak device memory "
          f"{torch.cuda.max_memory_allocated()} B; counts equal dict reference, overflow 0")


# ------------------------------------------------------------------ main
REPLACES = {
    "row_prologue": "ksql_tpu/ops/hash_store.py:48 (mix64), :58 (combine_hash); ksql_tpu/runtime/lowering.py:3802 (pre_exchange)",
    "probe_insert": "ksql_tpu/ops/hash_store.py:126 (probe_insert)",
    "fold_and_mark": "ksql_tpu/ops/hash_store.py:502 (scatter_combine), :567 (winners_per_slot)",
    "evict": "ksql_tpu/runtime/lowering.py:4239 (_trace_evict)",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on the card")
    try:
        from ksql_tpu_torch.ops import hash_store as hs
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")
    kind, smi = phase_device_and_build(torch)
    recs = phase_kernels(torch, args.seed)
    with open("ksql_tpu_torch/plans/pv_counts_tumbling.json") as f:
        plan_json = json.load(f)
    hs.reset_launch_counts()
    e2e = phase_e2e(torch, plan_json, args.seed)
    phase_growth(torch, plan_json, args.seed)
    launches = {w.__name__: w.launches for w in hs.KERNEL_WRAPPERS}
    print(f"[5] launches on the main path: {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    e2e["breakdown"] = phase_breakdown(torch, plan_json, args.seed)
    kernels = [
        {"name": name, "route": "cuda", "source": f"ksql_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name], **recs[name]}
        for name in ("row_prologue", "probe_insert", "fold_and_mark", "evict")
    ]
    print(f"e2e: {json.dumps(e2e)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
