"""Time a slice's kernels at their main shapes, for a checkout.

Runs the shape groups below on this checkout's ``chip_smoke`` cases
against the ``ksql_tpu_torch`` package of the checkout at ROOT (this one
by default), so that one call on the card times an earlier commit's
kernels at the same shapes as this tree's:

    git archive <commit> | tar -x -C build/parent
    python scripts/torch_slice_times.py build/parent
    python scripts/torch_slice_times.py

Groups (``--groups``, all by default):

* ``k10``: K10's count and write at phase 2s's case (1,913 looked-up rows
  of 2,048 against a 16,385-entry ring, 6,144 live), then on rings of
  2^12, 2^14 and 2^16 entries (+1, the dump entry) whose live share is
  10%, 37% or 100%: whether the time follows the ring's length or its
  live matches.
* ``k13``: K13 on 4,096 vector-order rows, 8,192 session rows and
  270,336 session items (synthetic keys in the mix phases 2v and 2w give
  it), the whole call and each of its CUDA functions apart.
* ``k8k24``: K8's live mode at 65,536 foreign keys over 2^18 slots, alone
  and as a left change's pair of key sets (an earlier tree's two single
  calls), K24 over a 2^18 + 1-slot orders store for the hottest customer
  and for one with none, then K1's table mode, K8's pair, K9's side mode
  and K24 at one change a step.
* ``k17``: K17 at phase 2f's 65,536 tumbling and 196,608 k = 3 lanes,
  12h's 65,536 k = 4 lanes and 12g's 2^20 rows, with the two
  ``torch.cummax`` calls as its yardstick.
* ``k16``: K16's write mode at phase 2w's 270,336 items (its inputs made
  by the twins, ``chip_smoke.session_write_case``).
* ``k3``: K3's fold at phase 2's 65,536 rows into 2^20 + 1 slots (zipf
  URLs over 31 hours, uniform URLs, and the flagship's own timestamps,
  which put a quarter of the rows on one slot) and at phase 2t's undo
  shape (65,536 rows into 50 slots, 8 components), its argset mode at
  phase 2a's with the wrapper's host time a call.
* ``k20``: K20's set and hist modes at phase 2v's cases, again with every
  stored prefix emptied, hist on phase 2t's undo side, append and ring
  at 2v's.
* ``k23``: K23 at phase 2t's shape (4,096 undo rows of COLLECT_LIST(ID),
  K = 1,000), then with every undo row on slots below the cap and with
  every undo row on slots at or past it, with the wrapper's host time a
  call.
* ``k5``: K5 at phase 2h's shape (16,384 zipf rows, a 102-cell ring, 8
  components), with uniform slots, with every row live and no cell
  stale, and at phase 7's 8,192-row batch, with the ``index_add_`` /
  ``index_reduce_`` yardstick.

* ``k21``: K21 in each mode at phase 2v's batch (4,096 rows of phase
  14's traffic into a half-full 2^16-slot store, K = 3) and at
  ``chip_smoke.TOPK_SKEWS``' other batches: no row at the dump slot or the
  sentinel, the hottest slot holding a quarter of the batch, every row
  alone in its slot; the call's kernels with any K13 sort timed together,
  and the wrapper's host time a call.
* ``k4``: K4's sliced mode at phase 2h's store (2^16 + 1 slots, a 102-cell
  ring, 8 components, half the keys past the retention) and on the same
  store with none past it, its tumbling mode at phase 2's flagship store
  (2^20 + 1 slots, before K2's inserts) and over phase 2v's vector store
  (a quarter of its filled slots expired, ~18 KB of width-K rows a slot),
  its suppress mode at phase 2f's store.
* ``k25``: K25 at phase 2p's 256 lanes x 4,096 rows and 4,096 x 8,192 of
  the ``USER_ID % N = i`` family and at its cast (20 instructions) and
  case (27) corpus families (64 x 4,096), with an earlier tree's
  ``torch.zeros`` of the counts and the wrapper's host time a call.
* ``k18``: K18 at phase 2f's three shapes: phase 12's 65,536 lanes over
  2^20 + 1 slots, 12h's 65,536 k = 4 lanes and 12g's 2^20 lanes, with the
  wrapper's host time a call.

The ``k3``, ``k20``, ``k23``, ``k5``, ``k21``, ``k25`` and ``k18`` groups also time each
CUDA function of a call apart (K20's, K21's and K23's with the K13 sorts
they make).

Each kernel is held against its twin first (exact), then timed as
chip_smoke times it (device ms from torch.profiler, its records counted,
call ms from CUDA events).  Prints the card's name and power limit, then
one JSON line of ``{"root", "records": [{"kernel", "shape", "what",
...}]}``.  Needs a CUDA device; exits 1 without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the kernel functions of K3's, K5's, K10's, K13's, K16's, K18's, K20's,
#: K21's, K23's, K24's and K25's earlier designs beside this tree's, so that the profiler finds an
#: earlier tree's
EARLIER_FUNCS = {
    "fold_and_mark": ("fold_mark_kernel", "argset_kernel", "fold_kernel", "winners_kernel", "argset_dump_kernel"),
    "vec_collect": ("collect_keys_kernel", "collect_member_kernel", "collect_place_kernel",
                    "collect_prologue_kernel", "collect_first_kernel", "collect_finish_kernel"),
    "fk_fanout": ("fanout_kernel", "fanout_count_kernel", "fanout_scan_kernel", "fanout_write_kernel"),
    "ss_match": ("tile_count_kernel", "tile_write_kernel", "match_count_kernel", "match_scan_kernel",
                 "match_write_kernel"),
    "seg_sort": ("block_sort_kernel", "tile_sort_kernel", "merge_pass_kernel"),
    "session_write": ("delete_kernel", "write_kernel", "dump_kernel"),
    "sliced_fold": ("sliced_fold_kernel", "slice_reset_kernel", "slice_fold_kernel"),
    "vec_remove": ("remove_kernel", "remove_keys_kernel", "remove_claim_kernel", "remove_compact_kernel",
                   "remove_dump_kernel"),
    "evict": ("evict_kernel", "evict_rows_kernel"),
    "vec_topk": ("topk_kernel", "topk_keys_kernel", "topk_dedup_kernel", "topk_gather_kernel",
                 "topk_pstar_kernel", "topk_top_kernel", "topk_dump_kernel"),
    "suppress_close": ("close_slots_kernel", "born_kernel", "close_kernel"),
    "tap_residual": ("tap_tile_kernel", "lanes_kernel", "clip_kernel"),
}
#: K10's sweep: (ring entries before the dump entry, live share; None:
#: the case's own)
K10_RINGS = [(1 << 14, None)] + [(b, p) for b in (1 << 12, 1 << 14, 1 << 16) for p in (0.10, 0.37, 1.0)]


def k8_k24_shapes(cs, torch, seed):
    """The shapes at which one tree's K8 live mode and K24 are held
    against another's in one call, from chip_smoke ``cs``'s phase 2x
    cases; then ``cs.per_record_kernels``.  Each against its twin first.
    Returns ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import table_join as tj

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 61)
    out = []
    # ---- K8 live mode at phase 2x's shape, one key set and a pair
    c = cs.make_fkr_case(torch, rng, dev, cs.TT_ROWS, cs.TT_STORE, cs.TT_USERS)
    st, cap, fk, valid = c["store"], cs.TT_STORE, c["fk"], c["valid"]
    cols = [col.name for col in c["query"].fk_cols["r"]]
    for shape, sets in (("live", [(fk, valid, valid)]), ("live_pair", cs.live_pair_sets(torch, fk, valid))):
        if shape == "live":
            got = hs.probe_find(st, cap, fk, valid, valid, cols, live=st["live"])
            want = hs.probe_find_gather_plain(st, cap, fk, valid, valid, cols, live=st["live"])
            for name in want[0]:
                cs._assert_equal(torch, f"probe_find[live].{name}", got[0][name], want[0][name])
            cs._assert_equal(torch, "probe_find[live].key0", got[1], want[1])
            cs._assert_equal(torch, "probe_find[live].found", got[2], want[2])
            reads = cs.find_walk_keys(torch, hs, c["st"], cap, fk.cpu().numpy(), valid.cpu().numpy())
            n = fk.shape[0]
            rec = cs.measure(torch, "probe_find", lambda: hs.probe_find(st, cap, fk, valid, valid, cols,
                                                                         live=st["live"]),
                             lambda: hs.probe_find_gather_plain(st, cap, fk, valid, valid, cols,
                                                                live=st["live"]),
                             n * (8 + 1 + 1) + n * (8 + 1 + 9 * len(cols)) + reads * 18, reads * 6,
                             plain_reps=10, per_call=1)
            what = f"{n} foreign keys over {cap} slots"
        else:
            rec, what = cs.time_live_pair(torch, hs, st, cap, c["st"], sets, cols)
        out.append(("probe_find", shape, rec, what))
    del c, st
    # ---- K24 at phase 2x's shape
    c = cs.make_fanout_case(torch, rng, dev, cs.FAN_STORE, cs.FAN_ORDERS)
    st = c["store"]
    lcols = [col.name for col in c["query"].fk_cols["l"]]
    touched = torch.ones(1, dtype=torch.bool, device=dev)
    for shape, cust in (("fanout", c["hot"]), ("fanout_none", cs.ORDER_CUSTOMERS + 7)):
        krepr = torch.tensor([cust], dtype=torch.int64, device=dev)
        got = tj.fk_fanout(st, cs.FAN_STORE, krepr, touched, lcols)
        want = tj.fk_fanout_plain(st, cs.FAN_STORE, krepr, touched, lcols)
        cs._assert_equal(torch, f"fk_fanout[{shape}].slots", got[0], want[0])
        cs._assert_equal(torch, f"fk_fanout[{shape}].key0", got[2], want[2])
        for name in want[1]:
            cs._assert_equal(torch, f"fk_fanout[{shape}].{name}", got[1][name], want[1][name])
        fbytes, m = cs.fanout_bytes(c["st"], cs.FAN_STORE, cust, lcols)
        out.append(("fk_fanout", shape, cs.measure(
            torch, "fk_fanout", lambda krepr=krepr: tj.fk_fanout(st, cs.FAN_STORE, krepr, touched, lcols),
            lambda krepr=krepr: tj.fk_fanout_plain(st, cs.FAN_STORE, krepr, touched, lcols), fbytes, 0,
            per_call=cs.fanout_records(tj)), f"{cs.FAN_ORDERS} orders over {cs.FAN_STORE + 1} slots, {m} matches"))
    return out + cs.per_record_kernels(torch, seed)


def k10_shapes(cs, torch, seed):
    """K10's count and write at phase 2s's case and K10_RINGS' rings (the
    same 2,048-row batch of bench.py's traffic; a live share p makes a
    random p of the ring's entries live).  Returns ``[(kernel, shape,
    record, what)]``."""
    dev = torch.device(cs.DEVICE)
    out = []
    for ring, share in K10_RINGS:
        rng = np.random.default_rng(seed + 30)
        case = cs.make_ss_case(rng, ring, cs.SS_ROWS)
        if share is not None:
            live = rng.random(ring + 1) < share
            live[ring] = False  # the dump entry is never live
            case["ring_r"]["live"] = live
        base = cs.ss_case_tensors(torch, case, dev)
        kc, pc = cs._clone_case(base), cs._clone_case(base)
        _got, _want, recs, info = cs.check_ss_match(torch, kc, pc, 8 * cs.SS_ROWS)
        tag = "2s" if share is None else f"{ring + 1}@{share:.2f}"
        what = (f"{info['look']} rows x {ring + 1} entries, {info['live']} live, {info['total']} matches, "
                f"{info['rows_hit']} rows matched")
        out += [("ss_match", f"{mode} {tag}", recs[mode], what) for mode in ("count", "write")]
    return out


def k13_keys(torch, rng, dev, shape):
    """K13's inputs at one main-path shape, synthetic keys in the mix that
    phases 2v and 2w give it: ``vector`` (4,096 rows, k1 = 2 slot + bit over 814 of 2^14
    slots, k2 a member id), ``rows`` (8,192 rows: the key hash of 1,369
    zipf keys, 0 where a row is dropped; k2 = 0) and ``items`` (270,336 =
    8,192 x 33 items: the rows as (key hash, ts), 4,125 stored sessions
    (key hash, start) and the dead items' 2^62 + index sentinels)."""
    if shape == "vector":
        n = 4096
        slot = rng.choice(1 << 14, 814, replace=False)[rng.zipf(1.3, n) % 814]
        k1 = slot * 2 + rng.integers(0, 2, n)
        k2 = rng.integers(0, 999, n)
    else:
        n = 8192
        keys = rng.integers(-(1 << 63), (1 << 63) - 1, 1369, dtype=np.int64)
        kh = keys[rng.zipf(1.3, n) % keys.size]
        kh[rng.random(n) < 0.01] = 0
        ts = 1_700_000_000_000 + np.arange(n) * 17
        if shape == "rows":
            k1, k2 = kh, np.zeros(n, np.int64)
        else:
            m = n * 33
            k1 = (1 << 62) + np.arange(m, dtype=np.int64)
            k2 = np.zeros(m, np.int64)
            k1[:n], k2[:n] = kh, ts
            stored = n + rng.choice(m - n, 4125, replace=False)
            k1[stored] = keys[rng.integers(0, keys.size, stored.size)]
            k2[stored] = ts[0] - rng.integers(0, 3_600_000, stored.size)
    return (torch.from_numpy(np.ascontiguousarray(k1, np.int64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(k2, np.int64)).to(dev))


def _function_names(torch, fn, pats):
    """The CUDA functions, of those ``pats`` match, that one call of ``fn``
    launches (a fenced profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    return sorted({p.pattern.split(")")[-1] for e in prof.events() for p in pats if p.search(e.name)})


def k13_shapes(cs, torch, seed):
    """K13 at k13_keys' three shapes: the call against its twin and each
    of its CUDA functions' device time apart.  Returns ``[(kernel, shape,
    record, what)]``."""
    import re

    from ksql_tpu_torch.ops import session as sess

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 17)
    pats = [re.compile(rf"(?<![A-Za-z_]){f}") for f in cs.KERNEL_FUNCS["seg_sort"]]
    out = []
    for shape in ("vector", "rows", "items"):
        k1, k2 = k13_keys(torch, rng, dev, shape)
        n = k1.shape[0]
        cs._assert_equal(torch, f"seg_sort[{shape}]", sess.seg_sort(k1, k2), sess.seg_sort_plain(k1, k2))
        rec = cs.measure(torch, "seg_sort", lambda: sess.seg_sort(k1, k2), lambda: sess.seg_sort_plain(k1, k2),
                         n * 20, n * int(np.ceil(np.log2(n))) * 5,
                         library=lambda: cs._argsort_lsd(torch, k1, k2))
        funcs = _function_names(torch, lambda: sess.seg_sort(k1, k2), pats)
        for f in funcs:
            cs.KERNEL_FUNCS[f"seg_sort:{f}"] = (f,)
        parts = {f: cs.kernel_device_ms(torch, f"seg_sort:{f}", lambda: sess.seg_sort(k1, k2)) for f in funcs}
        what = f"{n} items; " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in parts.items())
        out.append(("seg_sort", shape, dict(rec, parts=parts), what))
    return out


def k17_shapes(cs, torch, seed):
    """K17 at the shapes its phases give it, on chip_smoke's suppress
    cases (``make_suppress_case``): phase 2f's 65,536 tumbling lanes and
    196,608 k = 3 expansion lanes, 12h's 16,384 rows as 65,536 k = 4
    lanes and 12g's 2^20 tumbling rows; each against its twin, with the
    two-``torch.cummax`` yardstick.  Returns ``[(kernel, shape, record,
    what)]``."""
    dev = torch.device(cs.DEVICE)
    out = []
    base = cs.make_suppress_case(torch, np.random.default_rng(seed + 11), dev, cs.N_ROWS, cs.STORE)
    for mode in ("tumbling", "expansion"):
        _got, rec, what = cs._check_suppress_clock(torch, base, mode, cs.FINAL_GRACE_MS)
        out.append(("suppress_clock", f"2f {mode}", rec, what))
    del base
    for tag, rows, mode in (("12h", cs.HOP_ROWS, "expansion"), ("12g", cs.FINAL_GROW_ROWS, "tumbling")):
        c = cs.make_suppress_case(torch, np.random.default_rng(seed + 12), dev, rows, cs.STORE,
                                  advance=cs.HOP_ADVANCE_MS)
        _got, rec, what = cs._check_suppress_clock(torch, c, mode, cs.FINAL_GRACE_MS)
        out.append(("suppress_clock", f"{tag} {mode}", rec, what))
        del c
    return out


def k16_shapes(cs, torch, seed):
    """K16's write mode at phase 2w's shapes (``cs.session_write_case``:
    270,336 items of BASELINE #5's query, S = 32), against its twin on a
    copy of the store (lanes and the whole store exact).  Returns
    ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import session as sess

    with open(os.path.join(HERE, "ksql_tpu_torch", "plans", "pv_sessions.json")) as f:
        plan = json.load(f)
    dev = torch.device(cs.DEVICE)
    w = cs.session_write_case(torch, plan, seed, dev)
    cap, merged, ins, scal = w["cap"], w["merged"], w["ins"], w["scal"]
    sk, sp = cs._clone(w["store"]), cs._clone(w["store"])
    lanes_k = sess.session_write(sk, cap, merged, ins, scal)
    lanes_p = sess.session_write_plain(sp, cap, merged, ins, scal)
    cs._assert_tree(torch, "session_write[write] lanes", lanes_k, lanes_p)
    cs._assert_tree(torch, "session_write[write] store", sk, sp)

    def reset():
        for s in (sk, sp):
            cs._restore(s, w["store"])

    m = w["m"]
    rec = cs.measure(torch, "session_write", lambda: sess.session_write(sk, cap, merged, ins, scal),
                     lambda: sess.session_write_plain(sp, cap, merged, ins, scal),
                     cs.write_bytes(m, w["nseg"], w["k"], w["cb"], w["n_ins"]), m * 20, reset=reset,
                     plain_reps=5)
    dumped = int((~merged["ins_act"] | (ins == cap)).sum())
    return [("session_write", "write 2w", rec,
             f"{2 * m} lanes, {w['n_ins']} inserting items, {dumped} items aimed at the dump slot")]


def _parts(cs, torch, kernels, fn, reset=None):
    """Each CUDA function of ``kernels`` (chip_smoke's KERNEL_FUNCS names)
    that one call of ``fn`` launches, timed apart: ``{function: device
    ms a call}`` (a function launched twice a call sums both; ``reset``
    runs before each call, untimed)."""
    import re

    pats = [re.compile(rf"(?<![A-Za-z_]){f}") for k in kernels for f in cs.KERNEL_FUNCS[k]]
    parts = {}
    if reset is not None:
        reset()
    for f in _function_names(torch, fn, pats):
        cs.KERNEL_FUNCS[f"part:{f}"] = (f,)
        parts[f] = cs.kernel_device_ms(torch, f"part:{f}", fn, reset)
    return parts


def _host_ms(torch, fn, reps=200):
    """The wrapper's host time a call: ``reps`` calls enqueued back to back
    (the card keeps up with kernels this short), then one synchronize."""
    import time

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def _what_parts(what, parts):
    return what + "; " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in parts.items())


def k3_shapes(cs, torch, seed, folds_only=False):
    """K3 at its main-path shapes: the fold at phase 2's 65,536 zipf rows
    into 2^20 + 1 slots (the flagship's components), the same rows with
    uniform URLs (what contention on hot slots costs) and with the
    flagship's own timestamps (about a quarter of the rows on one slot);
    the fold at phase 2t's undo shape (65,536 rows into 50 slots, 8
    components); the argset mode at phase 2a's (2 pairs), with the
    wrapper's host time a call.  Each against its twin first, each CUDA
    function's time apart (``folds_only``: the folds, not the argset
    mode).  Returns ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(cs.DEVICE)
    out = []
    for traffic in ("phase2", "uniform", "flagship"):
        rng = np.random.default_rng(seed + 3)
        store, scratch, layout, slots, contribs, act = cs.make_fold_case(torch, hs, rng, dev, traffic)
        sk, sp = cs._clone(store), cs._clone(store)
        cs._assert_equal(torch, "fold_and_mark.winners", hs.fold_and_mark(sk, scratch, layout, slots, contribs, act),
                         hs.fold_and_mark_plain(sp, layout, slots, contribs, act))
        for key in store:
            cs._assert_equal(torch, f"fold_and_mark.{key}", sk[key], sp[key])

        def fold(sk=sk, scratch=scratch, layout=layout, slots=slots, contribs=contribs, act=act):
            hs.fold_and_mark(sk, scratch, layout, slots, contribs, act)

        rec = cs.measure(torch, "fold_and_mark", fold,
                         lambda: hs.fold_and_mark_plain(sp, layout, slots, contribs, act),
                         cs.fold_bytes(torch, slots, act, contribs), slots.shape[0] * 6, plain_reps=5)
        parts = _parts(cs, torch, ["fold_and_mark"], fold)
        hot = int(torch.bincount(slots[act].long()).max())
        out.append(("fold_and_mark", f"fold {traffic}", dict(rec, parts=parts),
                    _what_parts(f"{slots.shape[0]} rows, hottest slot {hot} rows", parts)))
        del store, sk, sp, scratch
    rng = np.random.default_rng(seed + 4)
    base, scratch, layout, slots, contribs, act = cs.make_undo_fold_case(torch, hs, rng, dev)
    sk, sp = cs._clone(base), cs._clone(base)
    cs._assert_equal(torch, "fold_and_mark[undo].winners", hs.fold_and_mark(sk, scratch, layout, slots, contribs, act),
                     hs.fold_and_mark_plain(sp, layout, slots, contribs, act))
    for key in base:
        cs._assert_equal(torch, f"fold_and_mark[undo].{key}", sk[key], sp[key], 1e-12)

    def undo():
        hs.fold_and_mark(sk, scratch, layout, slots, contribs, act)

    n, nc = slots.shape[0], len(layout.components)
    rec = cs.measure(torch, "fold_and_mark", undo, lambda: hs.fold_and_mark_plain(sp, layout, slots, contribs, act),
                     n * (4 + 1 + 1 + 8 * nc) + cs.TA_REGIONS * (8 * nc + 1), n * nc,
                     reset=lambda: cs._restore(sk, base), plain_reps=5)
    parts = _parts(cs, torch, ["fold_and_mark"], undo)
    out.append(("fold_and_mark", "fold undo 2t", dict(rec, parts=parts),
                _what_parts(f"{n} rows into {cs.TA_REGIONS} slots, {nc} components", parts)))
    del base, sk, sp
    if folds_only:
        return out
    rng = np.random.default_rng(seed + 70)
    store, scratch, layout, slots, contribs = cs.make_argset_case(torch, hs, rng, dev)
    base, want = cs._clone(store), cs._clone(store)
    hs.fold_argset_plain(want, layout, slots, contribs)
    hs.fold_argset(store, scratch, layout, slots, contribs)
    for k in store:
        cs._assert_equal(torch, f"fold_and_mark[argset].{k}", cs._bits(torch, store[k]), cs._bits(torch, want[k]))
    pairs = hs.argset_pairs(layout)
    per = {j: int(((slots != layout.capacity) & (contribs[o] == want[f"a{o}"][slots.long()])).sum())
           for j, o in pairs}

    def argset():
        hs.fold_argset(store, scratch, layout, slots, contribs)

    lib_slots = torch.where(slots == layout.capacity, torch.zeros_like(slots), slots).long()
    rec = cs.measure(torch, "fold_and_mark", argset, lambda: hs.fold_argset_plain(store, layout, slots, contribs),
                     cs.argset_bytes(slots, contribs, layout, hs, per), 0, reset=lambda: cs._restore(store, base),
                     library=lambda: [store[f"a{j}"].index_put_((lib_slots,), contribs[j].to(store[f"a{j}"].dtype))
                                      for j, _o in pairs])
    parts = _parts(cs, torch, ["fold_and_mark"], argset)
    host = _host_ms(torch, argset)
    out.append(("fold_and_mark", "argset 2a", dict(rec, parts=parts, host_ms=host),
                _what_parts(f"{slots.shape[0]} rows, {len(pairs)} pairs, {sum(per.values())} winning (row, pair)s; "
                            f"wrapper host {host:.4f} ms a call", parts)))
    return out


def k20_shapes(cs, torch, seed):
    """K20's set and hist modes at phase 2v's cases (``make_vector_case``'s
    COLLECT_SET, ``make_hist_case``) and again with every slot's stored
    prefix emptied (the prefix scans' share), its hist mode on phase 2t's
    undo side (``make_orders_case``), and its append and ring modes at
    2v's; each against its twin, each K20 CUDA function and K13's sorts
    within the call apart.  Returns ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import vector as vec

    dev = torch.device(cs.DEVICE)
    out = []

    def one(tag, layout, store, j, contribs, slots, mode, what):
        keys = [f"a{j + t}" for t in range(3)]
        saved = {k: store[k].clone() for k in keys}
        work = {k: store[k].clone() for k in keys}
        twin = {k: store[k].clone() for k in keys}
        vec.vec_collect(work, layout, j, contribs, slots, mode)
        vec.vec_collect_plain(twin, layout, j, contribs, slots, mode)
        cs._assert_store(torch, f"vec_collect[{tag}]", work, twin, keys)

        def call():
            vec.vec_collect(work, layout, j, contribs, slots, mode)

        def reset():
            for k in keys:
                work[k].copy_(saved[k])

        n, cap = slots.shape[0], layout.capacity
        s_np = slots.cpu().numpy()
        touched = np.unique(s_np[s_np != cap])
        K = layout.components[j + 1].width
        scan = int(saved[f"a{j}"][torch.from_numpy(touched).to(dev)].clamp(max=K).sum()) * 9
        rec = cs.measure(torch, "vec_collect", call, lambda: vec.vec_collect_plain(work, layout, j, contribs, slots, mode),
                         n * 21 + touched.size * 16 + (scan if mode in ("set", "hist") else 0), n * 40,
                         reset=reset, plain_reps=5)
        parts = _parts(cs, torch, ["vec_collect", "seg_sort"], call)
        out.append(("vec_collect", tag, dict(rec, parts=parts),
                    _what_parts(f"{what}: {n} rows into {touched.size} slots", parts)))

    rng = np.random.default_rng(seed + 17)
    c = cs.make_vector_case(torch, rng, dev)
    names = [sp.fname for sp in c["q"].agg_specs]
    for fname, mode in (("COLLECT_SET", "set"), ("COLLECT_LIST", "append"), ("LATEST_BY_OFFSET", "ring")):
        j = c["starts"][names.index(fname)]
        one(f"{mode} 2v", c["layout"], c["store"], j, c["contribs"], c["slots"], mode, fname)
        if mode == "set":
            empty = dict(c["store"], **{f"a{j}": torch.zeros_like(c["store"][f"a{j}"])})
            one("set 2v empty prefixes", c["layout"], empty, j, c["contribs"], c["slots"], mode, fname)
    del c
    h = cs.make_hist_case(torch, np.random.default_rng(seed + 18), dev)
    j = h["j"]
    one("hist 2v", h["layout"], h["store"], j, h["contribs"], h["slots"], "hist", "HISTOGRAM")
    empty = dict(h["store"], **{f"a{j}": torch.zeros_like(h["store"][f"a{j}"])})
    one("hist 2v empty prefixes", h["layout"], empty, j, h["contribs"], h["slots"], "hist", "HISTOGRAM")
    del h
    o = cs.make_orders_case(torch, np.random.default_rng(seed + 19), dev)
    one("hist undo 2t", o["layout"], o["store"], 6, o["contribs"], o["slots"], "hist", "HISTOGRAM(STATUS) undo")
    return out


def _undo_rows(rng, cnt, ids, pool, n, cap, K):
    """``n`` undo rows of ``make_orders_case``'s kind over the slots of
    ``pool``: zipf-ish slots, an id the slot holds (85%) or an absent one,
    2% missed (the dump slot).  Returns (slots, ids) as numpy."""
    slots = pool[(rng.zipf(1.3, n) % 100_003) * 2654435761 % pool.size].astype(np.int64)
    pos = (rng.random(n) * np.minimum(cnt[slots], K)).astype(np.int64)
    oid = np.where(rng.random(n) < 0.85, ids[slots, pos], rng.integers(0, 1 << 40, n))
    slots[rng.random(n) < 0.02] = cap
    return slots, oid


def k23_shapes(cs, torch, seed):
    """K23 at phase 2t's shape (``make_orders_case`` after phase 2t's K8
    case, from the same seed: 4,096 undo rows of COLLECT_LIST(ID), K =
    1,000), then the same store with every undo row on slots below the cap
    and with every undo row on slots at or past it (what a walk of a
    slot's stored prefix costs); each against its twin, the call's CUDA
    functions (K13's sort among them) apart, and the wrapper's host time
    a call.  Returns ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import vector as vec

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 40)
    cs.make_find_case(torch, hs, rng, dev)  # phase 2t draws its K8 case first
    c = cs.make_orders_case(torch, rng, dev)
    layout, store, slots, contribs = c["layout"], c["store"], c["slots"], c["contribs"]
    cap, n = layout.capacity, slots.shape[0]
    K = layout.components[4].width
    cnt, ids = store["a3"].cpu().numpy(), store["a4"].cpu().numpy()
    filled = np.nonzero(cnt[:cap] > 0)[0]
    cases = [("remove 2t", slots, contribs)]
    for tag, pool in (("below the cap", filled[cnt[filled] < K]), ("capped", filled[cnt[filled] >= K])):
        s, oid = _undo_rows(np.random.default_rng(seed + 41), cnt, ids, pool, n, cap, K)
        moved = list(contribs)
        moved[4] = torch.from_numpy(oid).to(dev)
        cases.append((f"remove {tag}", torch.from_numpy(s.astype(np.int32)).to(dev), moved))
    out = []
    keys = ("a3", "a4", "a5")
    cs.KERNEL_FUNCS["vec_remove_call"] = cs.KERNEL_FUNCS["vec_remove"] + cs.KERNEL_FUNCS["seg_sort"]
    for shape, sl, cb in cases:
        rec, what = cs.check_vec_remove(torch, layout, store, sl, cb, dev)
        work = {k: store[k].clone() for k in keys}

        def call(work=work, sl=sl, cb=cb):
            vec.vec_remove(work, layout, 3, cb, sl)

        def reset(work=work):
            for k in keys:
                work[k].copy_(store[k])

        parts = _parts(cs, torch, ["vec_remove", "seg_sort"], call, reset)
        whole = cs.kernel_device_ms(torch, "vec_remove_call", call, reset)
        host = _host_ms(torch, call)
        out.append(("vec_remove", shape, dict(rec, parts=parts, host_ms=host, call_device_ms=whole),
                    _what_parts(f"{what}; the call's kernels with any K13 sort {whole:.4f} ms; "
                                f"wrapper host {host:.4f} ms a call", parts)))
    return out


def k5_shapes(cs, torch, seed):
    """K5 at phase 2h's shape (``make_sliced_case`` after phase 2h's K1
    draws, from the same seed: 16,384 zipf(1.3) rows over a 70%-full
    2^16-slot store, a 102-cell ring, BASELINE #2's 8 components), then
    with uniform slots (what contention on hot slots costs), with every
    row live and no cell stale (no dump-row stores, no resets) and at
    phase 7's 8,192-row batch; each against its twin, each CUDA function
    apart, with the ``index_add_``/``index_reduce_`` yardstick.  Returns
    ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(cs.DEVICE)
    cap, ring, n = cs.HOP_STORE, cs.HOP_RING, cs.HOP_ROWS
    rng = np.random.default_rng(seed + 10)
    rng.zipf(1.3, n)  # phase 2h's K1 draws come first
    rng.random((1, n))
    rng.integers(0, 31 * cs.HOUR_MS, n)
    layout, store, rows = cs.make_sliced_case(hs, rng, cap, ring, n)
    cases = [("sliced 2h", store, rows)]
    occupied = np.nonzero(store["occ"][:-1])[0]
    r2 = np.random.default_rng(seed + 11)
    uni = dict(rows, slots=rows["slots"].copy())
    on_live = np.isin(uni["slots"], occupied)
    uni["slots"][on_live] = r2.choice(occupied, int(on_live.sum())).astype(np.int32)
    cases.append(("sliced uniform", store, uni))
    # every row live on a stored key, each cell already holding the row's slice
    fresh = dict(rows, slots=rows["slots"].copy(), active=np.ones(n, bool), wstart=rows["wstart"].copy())
    off = ~np.isin(fresh["slots"], occupied) | ~rows["active"]
    fresh["slots"][off] = occupied[(r2.zipf(1.3, int(off.sum())) - 1) % occupied.size]
    newest = int(rows["wstart"][rows["active"]].max()) // cs.SLICE_MS
    fresh["wstart"][off] = (newest - np.minimum(r2.geometric(0.3, int(off.sum())) - 1, ring - 2)) * cs.SLICE_MS
    fstore = {k: v.copy() for k, v in store.items()}
    sidx = fresh["wstart"] // cs.SLICE_MS
    fstore["slice_id"][fresh["slots"], sidx % ring] = sidx
    cases.append(("sliced all live, none stale", fstore, fresh))
    layout7, store7, rows7 = cs.make_sliced_case(hs, np.random.default_rng(seed + 12), cap, ring, cs.LONG_ROWS)
    out = []
    for shape, st, rw in cases + [("sliced phase 7 batch", store7, rows7)]:
        lay = layout7 if shape.endswith("7 batch") else layout
        sk, rec, what = cs.check_sliced_fold(torch, lay, st, rw, dev)
        from ksql_tpu_torch.ops import slicing

        scratch = slicing.init_slice_scratch(cap, ring, cs.HOUR_MS // cs.SLICE_MS, dev)
        args = [torch.from_numpy(rw[k]).to(dev) for k in ("slots", "wstart")]
        contribs = [torch.from_numpy(x).to(dev) for x in rw["contribs"]]
        act = torch.from_numpy(rw["active"]).to(dev)

        base = {k: torch.from_numpy(v).to(dev) for k, v in st.items()}

        def call(sk=sk, scratch=scratch, lay=lay, args=args, contribs=contribs, act=act):
            slicing.sliced_fold(sk, scratch, lay, args[0], args[1], contribs, act, cs.SLICE_MS)

        parts = _parts(cs, torch, ["sliced_fold"], call, lambda sk=sk, base=base: cs._restore(sk, base))
        out.append(("sliced_fold", shape, dict(rec, parts=parts), _what_parts(what, parts)))
        del sk, base
    return out


def k21_shapes(cs, torch, seed):
    """K21 in each mode on phase 2v's case (``make_vector_case``, from
    phase 2v's seed) at each of ``cs.TOPK_SKEWS``' batches; each against
    its twin, the call's CUDA functions (any K13 sort among them) apart and
    together, and the wrapper's host time a call.  Returns ``[(kernel,
    shape, record, what)]``."""
    from ksql_tpu_torch.ops import vector as vec

    dev = torch.device(cs.DEVICE)
    c = cs.make_vector_case(torch, np.random.default_rng(seed + 17), dev)
    layout, store = c["layout"], c["store"]
    names = [s.fname for s in c["q"].agg_specs]
    cs.KERNEL_FUNCS["vec_topk_call"] = cs.KERNEL_FUNCS["vec_topk"] + cs.KERNEL_FUNCS["seg_sort"]
    out = []
    for fname, mode in (("TOPK", "plain"), ("TOPKDISTINCT", "distinct")):
        j = c["starts"][names.index(fname)] + 1
        key = f"a{j}"
        for kind in cs.TOPK_SKEWS:
            if kind == "2v":
                slots, vals = c["slots"], c["contribs"][j]
            else:
                slots, vals = cs.topk_skew(torch, c, j, kind, np.random.default_rng(seed + 23))
            rec, what = cs.check_vec_topk(torch, layout, store, j, vals, slots, f"{mode} {kind}", plain_reps=5)
            work = {key: store[key].clone()}

            def call(work=work, j=j, vals=vals, slots=slots):
                vec.vec_topk(work, layout, j, vals, slots)

            def reset(work=work, key=key):
                work[key].copy_(store[key])

            parts = _parts(cs, torch, ["vec_topk", "seg_sort"], call, reset)
            whole = cs.kernel_device_ms(torch, "vec_topk_call", call, reset)
            host = _host_ms(torch, call)
            out.append(("vec_topk", f"{mode} {kind}", dict(rec, parts=parts, host_ms=host, call_device_ms=whole),
                        _what_parts(f"{what}; the call's kernels with any K13 sort {whole:.4f} ms; "
                                    f"wrapper host {host:.4f} ms a call", parts)))
    return out


def k4_shapes(cs, torch, seed):
    """K4 in each mode at the stores its phases check it on: sliced at
    phase 2h's (``make_sliced_case`` after 2h's K1 draws, half the keys'
    newest slice past 25 h; then the same store with no key past it),
    tumbling at phase 2's flagship store (``make_store``, 70% full, the
    keys of the oldest hours past 25 h) and over phase 2v's vector store
    (``width_k_evict_case``), suppress at phase 2f's (``make_suppress_case``,
    the stream time 4 h on); each against its twin first.  Returns
    ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.state import state_from_numpy

    dev = torch.device(cs.DEVICE)
    out = []

    def one(shape, layout, ev0, retention, **mode):
        rec, expired, _ek = cs.check_evict(torch, layout, ev0, retention, **mode)
        out.append(("evict", shape, rec, f"{expired} of {int(ev0['occ'].sum())} occupied slots of "
                                         f"{layout.capacity + 1} expire"))

    cap, ring, n = cs.HOP_STORE, cs.HOP_RING, cs.HOP_ROWS
    rng = np.random.default_rng(seed + 10)
    rng.zipf(1.3, n)  # phase 2h's K1 draws come first
    rng.random((1, n))
    rng.integers(0, 31 * cs.HOUR_MS, n)
    layout, st, _rows = cs.make_sliced_case(hs, rng, cap, ring, n)
    store = state_from_numpy(st, dev)
    retention = 25 * cs.HOUR_MS
    slast = store["slast"][store["occ"]]
    for shape, t in (("sliced 2h", int(slast.median())), ("sliced none expired", int(slast.min()))):
        store["max_ts"].fill_(t + retention)
        one(shape, layout, store, retention, sliced=True)
    del store, st
    url_hashes = np.fromiter((stable_hash64(u) for u in cs._urls(cs.N_URLS)), np.int64, cs.N_URLS)
    layout, store = cs.make_store(torch, hs, cs.STORE, int(0.7 * cs.STORE), np.random.default_rng(seed),
                                  url_hashes, dev)
    store["max_ts"].fill_(int(store["wstart"][store["occ"]].min()) + 29 * cs.HOUR_MS)
    one("tumbling flagship", layout, store, 25 * cs.HOUR_MS)
    del store
    rng = np.random.default_rng(seed + 17)
    c = cs.make_vector_case(torch, rng, dev)
    one("tumbling 2v width-K", c["layout"], cs.width_k_evict_case(torch, c, rng), cs.HOUR_MS)
    del c
    c = cs.make_suppress_case(torch, np.random.default_rng(seed + 11), dev)
    store = c["store"]
    store["max_ts"].fill_(int(c["ts"][-1]) + 4 * cs.HOUR_MS)
    one("suppress 2f", c["layout"], store, cs.FINAL_RETENTION_MS, suppress=True)
    return out


def k25_shapes(cs, torch, seed):
    """K25 at phase 2p's shapes (``cs.make_tap_case`` over the ``USER_ID %
    N = i`` family: 256 lanes x 4,096 rows and 4,096 x 8,192) and at its
    cast (20 instructions) and case (27) corpus families (64 lanes x 4,096
    rows); each against its twin, each CUDA function of a call apart (an
    earlier tree's ``torch.zeros`` of the counts among them), and the
    wrapper's host time a call.  Returns ``[(kernel, shape, record,
    what)]``."""
    from ksql_tpu_torch.ops import tap_residual as tr

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 60)
    cs.KERNEL_FUNCS["tap_call"] = cs.KERNEL_FUNCS["tap_residual"] + ("FillFunctor", "Memset")
    cases = [(f"{lanes}x{rows}", cs.mod_plans(lanes), lanes, rows)
             for lanes, rows in ((cs.TAP_LANES, cs.TAP_ROWS), (cs.TAP_MAX_LANES, cs.TAP_MAX_ROWS))]
    corpus = cs.corpus_plans()
    cases += [(name, corpus[name], cs.TAP_CORPUS_LANES, cs.TAP_ROWS) for name in ("cast", "case")]
    out = []
    for shape, plans, lanes, rows in cases:
        group = cs.tap_group(torch, plans, lanes)
        args = cs.make_tap_case(torch, rng, dev, group, rows)
        prog, matched = cs._check_tap(torch, tr, group, args, f"tap_residual[{shape}]")
        nbytes, ops = cs._tap_bytes_ops(prog, args)

        def call(prog=prog, args=args):
            tr.lane_masks(prog, *args)

        rec = cs.measure(torch, "tap_residual", call,
                         lambda prog=prog, args=args: tr.lane_masks_plain(prog.spec, prog.col_types, *args),
                         nbytes, ops, plain_reps=5)
        parts = _parts(cs, torch, ["tap_call"], call)
        whole = cs.kernel_device_ms(torch, "tap_call", call)
        host = _host_ms(torch, call)
        out.append(("tap_residual", shape, dict(rec, parts=parts, host_ms=host, call_device_ms=whole),
                    _what_parts(f"{lanes} lanes x {rows} rows, {prog.n_instr} instructions, stack "
                                f"{prog.max_depth}, {matched} matches; the call's device work {whole:.4f} ms; "
                                f"wrapper host {host:.4f} ms a call", parts)))
    return out


def k18_shapes(cs, torch, seed):
    """K18 at the shapes phase 2f checks it at: phase 12's (65,536 tumbling
    lanes over a 2^20 + 1-slot store, ``cs.make_suppress_case``), 12h's
    (16,384 rows as 65,536 k = 4 lanes) and 12g's (2^20 lanes); the
    emission clock and the lanes' cut from K17's twin.  Each against its
    twin (``cs._check_suppress_close``), each CUDA function of a call
    apart, and the wrapper's host time a call.  Returns ``[(kernel, shape,
    record, what)]``."""
    from ksql_tpu_torch.ops import suppress as sup

    dev = torch.device(cs.DEVICE)
    grace = cs.FINAL_GRACE_MS
    out = []
    for tag, rows, mode, seed_off, advance in (("12", cs.N_ROWS, "tumbling", 11, cs.FINAL_ADVANCE_MS),
                                              ("12h", cs.HOP_ROWS, "expansion", 12, cs.HOP_ADVANCE_MS),
                                              ("12g", cs.FINAL_GROW_ROWS, "tumbling", 12, cs.HOP_ADVANCE_MS)):
        c = cs.make_suppress_case(torch, np.random.default_rng(seed + seed_off), dev, rows, cs.STORE,
                                  advance=advance)
        ws, act = (c["tws"], c["act_rows"]) if mode == "tumbling" else (c["hws"], c["hact"])
        st = c["store"]
        lanes_act, _c0, cm_emit = sup.suppress_clock_plain(c["ts"], ws, act, c["row_valid"], st["max_ts"],
                                                           st["emit_clock"], cs.HOUR_MS, grace)
        slots = c["slots"] if mode == "tumbling" else c["hop_slots"]
        if tag == "12":  # phase 2f checks K18 on the rows' own activity
            lanes_act = c["act_rows"]
        # records a call counted from a fenced call: an earlier tree's K18 made two
        _sk, rec, what, _w = cs._check_suppress_close(torch, c, slots, lanes_act, cm_emit, grace, per_call=None)
        s0, work = cs._clone(st), cs._clone(st)
        args = (c["layout"], slots, lanes_act, cm_emit, cs.HOUR_MS, grace, cs.FINAL_RETENTION_MS)

        def call(work=work, args=args):
            sup.suppress_close(work, *args)

        def reset(work=work, s0=s0):
            cs._restore(work, s0)

        parts = _parts(cs, torch, ["suppress_close"], call, reset)
        host = _host_ms(torch, call)
        out.append(("suppress_close", tag, dict(rec, parts=parts, host_ms=host),
                    _what_parts(f"{what}; wrapper host {host:.4f} ms a call", parts)))
        del c, st, s0, work, _sk
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=HERE, help="the checkout whose package is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", default="k10,k13,k8k24,k17,k16,k3,k20,k23,k5,k21,k4,k25,k18",
                    help="comma-separated: k10, k13, k8k24, k17, k16, k3, k20, k23, k5, k21, k4, k25, k18")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.KERNEL_FUNCS.update(EARLIER_FUNCS)
    import ksql_tpu_torch

    if not ksql_tpu_torch.__file__.startswith(root):
        print(f"imported {ksql_tpu_torch.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    records = []
    groups = {"k10": k10_shapes, "k13": k13_shapes, "k8k24": k8_k24_shapes, "k17": k17_shapes,
              "k16": k16_shapes, "k3": k3_shapes, "k20": k20_shapes, "k23": k23_shapes,
              "k5": k5_shapes, "k21": k21_shapes, "k4": k4_shapes, "k25": k25_shapes, "k18": k18_shapes}
    shapes = []
    for g in args.groups.split(","):
        shapes += groups[g](cs, torch, args.seed)
    for kernel, shape, rec, what in shapes:
        records.append(dict(rec, kernel=kernel, shape=shape, what=what))
        print(f"[{kernel}[{shape}]] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms")
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
