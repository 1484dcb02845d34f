#!/usr/bin/env python3
"""Rows the keyed store loses to its probe limit as it fills.

Inserts batches of keys into one ``ksql_tpu_torch`` store with the
``probe_insert`` wrapper (the reference's exact round semantics: 32 rounds,
lowest row wins a claim) and prints, per batch, the store's load and its
cumulative ``overflow`` (rows that found no slot within the probe limit).
A fraction ``--new`` of each batch are new keys, the rest repeat keys
already inserted.  Counts only; on the CPU (the default) it says nothing
about time.

With ``--table`` it loads a join table instead: ``--users`` distinct USERS
keys through the ENRICHED plan's ``TorchCompiledQuery.process_table`` (K1's
table mode, K2 and K9), ``--batch`` records per table batch, into a store
of ``--capacity`` slots that grows by the reference's rule (double when
occupancy + the query's batch capacity ``--query-batch`` passes 0.75 of the
store), and prints per table batch the store's slots, grows, load and
cumulative ``overflow``.  ``chip_smoke.py`` phase 9g's sizes are
``--capacity 16384 --batch 4096``; phase 9's are ``--capacity 262144
--batch 65536``.

With ``--session`` it runs BASELINE #5's plan (``pv_sessions.json``) over
``--batches`` batches of ``--batch`` records of ``chip_smoke.py``'s session
traffic (bench.py's ``_pv_batches``) from a store of ``--capacity`` slots
and ``--slots`` session slots, both growing by the reference's rules, and
prints per batch the store's slots, grows, load, cumulative ``overflow``
and the session slots.  ``chip_smoke.py`` phase 11g's sizes are
``--capacity 16384 --batch 8192 --batches 8 --slots 4``.

    python3 scripts/torch_store_overflow.py --capacity 1048576 --batch 65536 --new 1.0 --seed 0
    python3 scripts/torch_store_overflow.py --table --users 100000 --capacity 16384 --batch 4096
    python3 scripts/torch_store_overflow.py --session --capacity 16384 --batch 8192 --batches 8 --slots 4
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

from ksql_tpu_torch.ops import hash_store as hs  # noqa: E402


def fill_store(args) -> None:
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


def load_table(args) -> None:
    from ksql_tpu_torch.common.batch import HostBatch
    from ksql_tpu_torch.common.errors import QueryRuntimeException
    from ksql_tpu_torch.execution.steps import plan_from_json
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    with open(os.path.join(ROOT, "ksql_tpu_torch", "plans", "enriched_join.json")) as f:
        plan = plan_from_json(json.load(f))
    q = TorchCompiledQuery(plan, capacity=args.query_batch, device=args.device,
                           table_store_capacity=args.capacity)
    schema = q.join_chain[0].table_source.schema
    for start in range(0, args.users, args.batch):
        ids = range(start, min(start + args.batch, args.users))
        rows = [{"ID": k, "NAME": f"user{k}", "REGION": f"r{k % 50}"} for k in ids]
        try:
            q.process_table(HostBatch.from_rows(schema, rows, timestamps=[0] * len(rows)),
                            np.zeros(len(rows), bool))
        except QueryRuntimeException as e:  # the store lost rows: report and stop
            print(json.dumps({"users": ids.stop, "slots": q.table_store_capacity, "error": str(e)}))
            sys.exit(1)
        jt = q.state["jtab"]
        print(json.dumps({
            "users": ids.stop, "slots": q.table_store_capacity, "grows": q.table_grows,
            "load": round(int(jt["occ"].sum()) / q.table_store_capacity, 4),
            "overflow": int(jt["overflow"]),
        }), flush=True)


def load_sessions(args) -> None:
    import chip_smoke
    from ksql_tpu_torch.common.batch import HostBatch
    from ksql_tpu_torch.execution.steps import plan_from_json
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    with open(os.path.join(ROOT, "ksql_tpu_torch", "plans", "pv_sessions.json")) as f:
        plan = plan_from_json(json.load(f))
    n = args.batch
    q = TorchCompiledQuery(plan, capacity=n, store_capacity=args.capacity, device=args.device,
                           session_slots=args.slots)
    url_idx, uid, ts = chip_smoke.session_traffic(args.batches, n)
    for b in range(args.batches):
        s = slice(b * n, (b + 1) * n)
        rows = [{"URL": f"/page/{u}", "USER_ID": int(i), "VIEWTIME": int(t)}
                for u, i, t in zip(url_idx[s].tolist(), uid[s].tolist(), ts[s].tolist())]
        q.process(HostBatch.from_rows(q.source.schema, rows, timestamps=ts[s].tolist()))
        print(json.dumps({
            "batch": b, "slots": q.store_capacity, "grows": q.grows,
            "load": round(int((q.state["occ"] | q.state["grave"]).sum()) / q.store_capacity, 4),
            "overflow": int(q.state["overflow"]), "session_slots": q.session_slots,
            "session_restarts": q.session_grows,
        }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--capacity", type=int, default=1 << 20, help="(first) store slots")
    ap.add_argument("--batch", type=int, default=1 << 16, help="rows per batch")
    ap.add_argument("--new", type=float, default=1.0, help="fraction of new keys per batch")
    ap.add_argument("--max-load", type=float, default=0.57)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--table", action="store_true", help="load ENRICHED's USERS table")
    ap.add_argument("--users", type=int, default=100_000, help="--table: distinct keys")
    ap.add_argument("--query-batch", type=int, default=1 << 16,
                    help="--table: the query's batch capacity (the load check's headroom)")
    ap.add_argument("--session", action="store_true", help="run BASELINE #5's session plan")
    ap.add_argument("--batches", type=int, default=8, help="--session: batches")
    ap.add_argument("--slots", type=int, default=4, help="--session: first session slots")
    args = ap.parse_args()
    (load_sessions if args.session else load_table if args.table else fill_store)(args)


if __name__ == "__main__":
    main()
