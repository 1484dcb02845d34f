"""Time K8's live mode and K24 at their main shapes, and phase 19's kernels at one change, for a checkout.

Runs ``k8_k24_shapes`` below on this checkout's ``chip_smoke`` cases
against the ``ksql_tpu_torch`` package of the checkout at ROOT (this one
by default), so that one call on the card times an earlier commit's
kernels at the same shapes as this tree's:

    git archive <commit> | tar -x -C build/parent
    python scripts/torch_slice_times.py build/parent
    python scripts/torch_slice_times.py

The shapes: K8's live mode at 65,536 foreign keys over 2^18 slots, alone
and as a left change's pair of key sets (an earlier tree's two single
calls), K24 over a 2^18 + 1-slot orders store for the hottest customer
and for one with none, then K1's table mode, K8's pair, K9's side mode
and K24 at one change a step.  Each kernel is held against its twin first
(exact), then timed as chip_smoke times it (device ms from
torch.profiler, its records counted, call ms from CUDA events).  Prints
the card's name and power limit, then one JSON line of ``{"root",
"records": [{"kernel", "shape", "what", ...}]}``.  Needs a CUDA device;
exits 1 without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the kernel functions of K24's first version beside this tree's, so
#: the profiler finds an earlier tree's
EARLIER_FUNCS = {
    "fk_fanout": ("fanout_kernel", "fanout_count_kernel", "fanout_scan_kernel", "fanout_write_kernel"),
}


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
    for kernel, shape, rec, what in k8_k24_shapes(cs, torch, args.seed):
        records.append(dict(rec, kernel=kernel, shape=shape, what=what))
        print(f"[{kernel}[{shape}]] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms")
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
