"""Time K9 and K15 at their main shapes, and phase 19's kernels at one change, for a checkout.

Runs ``redesign_shapes`` below on this checkout's ``chip_smoke`` cases
(K9's side mode at 65,536 changes and its join mode at 65,536 changelog
rows, K15's merge and argset modes at 270,336 items, then K1's table mode,
K8's live mode, K9's side mode and K24 at one change a step) against the
``ksql_tpu_torch`` package of the checkout at ROOT (this one by default),
so that one call on the card times an earlier commit's kernels at the same
shapes as this tree's:

    git archive <commit> | tar -x -C build/parent
    python scripts/torch_slice_times.py build/parent
    python scripts/torch_slice_times.py

Each kernel is held against its twin first (exact), then timed as
chip_smoke times it (device ms from torch.profiler, call ms from CUDA
events).  Prints the card's name and power limit, then one JSON line of
``{"root", "records": [{"kernel", "shape", "what", ...}]}``.  Needs a
CUDA device; exits 1 without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the kernel functions of K9's and K15's first versions beside this
#: tree's, so the profiler finds an earlier tree's
EARLIER_FUNCS = {
    "table_upsert": ("upsert_block_kernel", "upsert_grid_kernel", "claim_kernel", "upsert_kernel",
                     "dump_kernel"),
    "session_merge": ("permute_kernel", "merge_kernel", "runs_kernel", "finish_kernel"),
}


def redesign_shapes(cs, torch, seed):
    """The shapes at which one tree's K9 and K15 are held against another's
    in one call, from chip_smoke ``cs``'s cases: K9's side mode on phase
    2x's 65,536 user changes and its join mode on phase 2j's changelog
    batch; K15's argset mode on phase 2a's case and its merge mode on the
    same items with two components, an int64 max of the ends and an int64
    count (phase 2w's components); then ``cs.per_record_kernels``.  Each
    against its twin first.  Returns ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import session as sess

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 60)
    out = []
    # ---- K9 side mode at phase 2x's shape
    c = cs.make_tt_case(torch, rng, dev, cs.TT_ROWS, cs.TT_STORE, cs.TT_USERS, cs.TT_USERS)
    st, cap, slots = c["store"], cs.TT_STORE, c["slots"]
    keys = ["l_live"] + [f"l_{p}_{name}" for name in c["values"] for p in ("v", "m")]
    saved = {k: st[k].clone() for k in keys}
    args = (cap, slots, c["touched"], c["delete"], c["act"], cs.tt_side_cols(c))

    def reset():
        for k in keys:
            st[k].copy_(saved[k])

    hs.upsert_side(st["l_live"], c["scratch"], *args)
    work = {k: st[k].clone() for k in keys}
    reset()
    hs.upsert_side_plain(st["l_live"], *args)
    for k in keys:
        cs._assert_equal(torch, f"table_upsert[side].{k}", work[k], st[k])
    sbytes, winners = cs.side_bytes(slots.cpu().numpy(), c["touched"].cpu().numpy(), c["delete"].cpu().numpy(),
                                 [d.element_size() for d, _v in c["values"].values()], cap)
    out.append(("table_upsert", "side", cs.measure(
        torch, "table_upsert", lambda: hs.upsert_side(st["l_live"], c["scratch"], *args),
        lambda: hs.upsert_side_plain(st["l_live"], *args), sbytes, 0, reset=reset),
        f"{cs.TT_ROWS} user changes into {winners} slots"))
    del c, st, saved, work
    # ---- K9 join mode at phase 2j's shape
    n, cap = cs.JOIN_ROWS, cs.JOIN_STORE
    store = {k: torch.from_numpy(v).to(dev) for k, v in cs.make_join_case(torch, hs, rng, cap, cs.JOIN_USERS).items()}
    keys_np, kv, dels, tact = cs.table_batch(rng, n, cs.JOIN_USERS)
    reprs = torch.from_numpy(keys_np.reshape(1, n)).to(dev)
    act, khash, base = hs.table_prologue(reprs, torch.from_numpy(kv.reshape(1, n)).to(dev),
                                         torch.from_numpy(tact).to(dev), cap)
    scratch = hs.init_table_scratch(cap, dev)
    slots = hs.probe_insert(store, scratch, cap, base, khash, torch.zeros_like(khash), reprs,
                            torch.zeros(n, dtype=torch.int32, device=dev), act)
    vals = {c: (torch.from_numpy(cs._col_values(rng, d, n)).to(dev), torch.from_numpy(rng.random(n) > 0.05).to(dev))
            for c, d in cs.JOIN_COLS}
    delete = torch.from_numpy(dels).to(dev)
    after = cs._clone(store)
    hs.table_upsert(store, scratch, cap, slots, act, delete, vals)
    work = cs._clone(after)
    hs.table_upsert_plain(work, cap, slots, act, delete, vals)
    for k in store:
        cs._assert_equal(torch, f"table_upsert[join].{k}", store[k], work[k])
    width = sum(np.dtype(cs._NP[d]).itemsize + 1 for _, d in cs.JOIN_COLS)
    out.append(("table_upsert", "join", cs.measure(
        torch, "table_upsert", lambda: hs.table_upsert(store, scratch, cap, slots, act, delete, vals),
        lambda: hs.table_upsert_plain(store, cap, slots, act, delete, vals),
        n * (4 + 1 + 1 + width) + n * width, n * 10, reset=lambda: cs._restore(store, after)),
        f"{n} changelog rows into {cap} slots"))
    del store, after, work
    # ---- K15's argset and merge modes at phase 2a's and 2w's shapes
    items, perm, comps = cs.make_merge_case(torch, sess, hs, rng, dev)
    counts = [hs.AggComponent("max", "int64", cs.I64_MIN), hs.AggComponent("add", "int64", 0)]
    merge_items = dict(items, comps=[items["end"].clone(), items["alive"].long()])
    m = perm.shape[0]
    for shape, its, cps in (("argset", items, comps), ("merge", merge_items, counts)):
        a = (its, perm, cs.SESS_ROWS, cs.SESS_2W_SLOTS, cs.SESS_GAP_MS, cps, cs.SESS_STORE)
        got, want = sess.session_merge(*a), sess.session_merge_plain(*a)
        sf = want["segfirst"].long()
        for key in sess.MERGE_ITEM_KEYS + ("sess_ovf",):
            cs._assert_tree(torch, f"session_merge[{shape}].{key}", got[key], want[key])
        for key in sess.MERGE_SEG_KEYS:
            pick = (lambda x: x[..., sf]) if key != "seg_comps" else (lambda xs: [x[sf] for x in xs])
            cs._assert_tree(torch, f"session_merge[{shape}].{key}", pick(got[key]), pick(want[key]))
        nseg = int((want["segfirst"] == torch.arange(m, device=dev, dtype=torch.int32)).sum())
        cb = sum(x.element_size() for x in its["comps"])
        run, tiles = cs.longest_run(torch, sess, want["kh"])
        rec = cs.measure(torch, "session_merge", lambda a=a: sess.session_merge(*a),
                      lambda a=a: sess.session_merge_plain(*a), cs.merge_bytes(m, nseg, 1, cb), 0, plain_reps=1)
        out.append(("session_merge", shape, dict(rec, longest_run=run, longest_run_tiles=tiles),
                    f"{m} items, {nseg} segments, {len(cps)} components, longest run {run} items"))
    return out + cs.per_record_kernels(torch, seed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=HERE, help="the checkout whose package is timed")
    ap.add_argument("--seed", type=int, default=0)
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
    for kernel, shape, rec, what in redesign_shapes(cs, torch, args.seed):
        records.append(dict(rec, kernel=kernel, shape=shape, what=what))
        print(f"[{kernel}[{shape}]] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms")
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
