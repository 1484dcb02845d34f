#!/usr/bin/env python3
"""Rows the keyed store loses to its probe limit as it fills.

Inserts batches of keys into one ``ksql_tpu_torch`` store with the
``probe_insert`` wrapper (the reference's exact round semantics: 32 rounds,
lowest row wins a claim) and prints, per batch, the store's load and its
cumulative ``overflow`` (rows that found no slot within the probe limit).
A fraction ``--new`` of each batch are new keys, the rest repeat keys
already inserted.  Counts only; on the CPU (the default) it says nothing
about time.

    python3 scripts/torch_store_overflow.py --capacity 1048576 --batch 65536 --new 1.0 --seed 0
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

from ksql_tpu_torch.ops import hash_store as hs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=1 << 16)
    ap.add_argument("--new", type=float, default=1.0, help="fraction of new keys per batch")
    ap.add_argument("--max-load", type=float, default=0.57)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cap, n = args.capacity, args.batch
    layout = hs.StoreLayout(cap, 1, (hs.AggComponent("max", "int64", 0),))
    store = hs.init_store(layout, dev)
    scratch = hs.init_scratch(cap, dev)
    rng = np.random.default_rng(args.seed)
    i64 = np.iinfo(np.int64)
    keys = np.zeros(0, np.int64)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    while float(store["occ"].sum()) / cap < args.max_load:
        n_new = max(1, int(n * args.new)) if keys.size else n
        new = rng.integers(i64.min, i64.max, n_new, dtype=np.int64)
        old = keys[rng.integers(0, keys.size, n - n_new)] if n > n_new else new[:0]
        keys = np.concatenate([keys, new])
        batch = np.concatenate([new, old])
        rng.shuffle(batch)
        reprs = torch.from_numpy(batch).reshape(1, n).to(dev)
        valid = torch.ones(1, n, dtype=torch.bool, device=dev)
        ts = torch.zeros(n, dtype=torch.int64, device=dev)
        wstart, knull, act, khash, base, _c0 = hs.row_prologue(
            reprs, valid, ts, ones, 0, 0, store["max_ts"], cap
        )
        hs.probe_insert(store, scratch, cap, base, khash, wstart, reprs, knull, act)
        print(json.dumps({
            "capacity": cap, "batch": n, "new": args.new, "seed": args.seed,
            "load": round(float(store["occ"].sum()) / cap, 4),
            "overflow": int(store["overflow"]),
        }), flush=True)


if __name__ == "__main__":
    main()
