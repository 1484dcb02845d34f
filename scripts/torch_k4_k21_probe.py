"""Time design variants of K4 (evict) and K21 (vec_topk) on the card.

Builds copies of ``csrc/evict.cu`` and ``csrc/vec_topk.cu`` with text
edits (one ``nvcc`` each, all started together), holds each against its
twin (exact) and times it as chip_smoke times a kernel (device ms from
torch.profiler, call ms from CUDA events) at the shapes of
``scripts/torch_slice_times.py``'s ``k4`` and ``k21`` groups:

* K4 at phase 2h's sliced store, phase 2v's width-K store and the
  flagship's tumbling store: ``kept`` (a warp tests 2 slots), 32, 16, 8, 4
  and 1 slots a warp (fewer or more warps, each writing more or fewer rows),
  ``element stores`` (no 16-byte stores); beside them a ``fill_`` of a
  buffer of the bytes the pass writes, the rate a contiguous write reaches;
* K21 at phase 2v's batch and its ``alone`` skew, each mode: ``kept``
  (a block for every 32 rows, groups of more than 64 rows a block's),
  ``a block for every 8``, ``64`` and ``128 rows`` (the grid's size
  against the grid barriers' cost), ``no block groups`` (every group a
  warp's), block groups past 32 or past 128 rows, ``no sleep in the
  wait`` (phase 2's rows spin on their group's range without
  ``__nanosleep``).

    python scripts/torch_k4_k21_probe.py

Prints the card's name and power limit, a line a variant and shape, and
one JSON line of the records.  Needs a CUDA device; exits 1 without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_SLOTS = "constexpr int kSlots = 2;"
_BODY = "  uint64_t a16 = (start + 15) & ~static_cast<uint64_t>(15);\n"
#: (name, text edits of csrc/evict.cu)
K4_VARIANTS = [
    ("kept", []),
    ("32 slots a warp", [(_SLOTS, "constexpr int kSlots = 32;")]),
    ("16 slots a warp", [(_SLOTS, "constexpr int kSlots = 16;")]),
    ("8 slots a warp", [(_SLOTS, "constexpr int kSlots = 8;")]),
    ("4 slots a warp", [(_SLOTS, "constexpr int kSlots = 4;")]),
    ("1 slot a warp", [(_SLOTS, "constexpr int kSlots = 1;")]),
    ("element stores", [(_BODY, "  uint64_t a16 = end;\n")]),
]
_BLOCKS = "  const int64_t want = (n + 31) / 32;\n"
#: (name, text edits of csrc/vec_topk.cu)
K21_VARIANTS = [
    ("kept", []),
    ("a block for every 8 rows", [(_BLOCKS, "  const int64_t want = (n + 7) / 8;\n")]),
    ("a block for every 128 rows", [(_BLOCKS, "  const int64_t want = (n + 127) / 128;\n")]),
    ("a block for every 64 rows", [(_BLOCKS, "  const int64_t want = (n + 63) / 64;\n")]),
    ("no block groups", [("constexpr int64_t kBig = 64;", "constexpr int64_t kBig = INT32_MAX;")]),
    ("block groups past 32 rows", [("constexpr int64_t kBig = 64;", "constexpr int64_t kBig = 32;")]),
    ("block groups past 128 rows", [("constexpr int64_t kBig = 64;", "constexpr int64_t kBig = 128;")]),
    ("no sleep in the wait", [("< 0) __nanosleep(64);", "< 0) {\n    }")]),
]


def _k3p():
    spec = importlib.util.spec_from_file_location("k3p", os.path.join(HERE, "scripts", "torch_k3_probe.py"))
    k3p = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k3p)
    return k3p


def k4_cases(cs, torch, seed):
    """(shape, layout, store, retention, sliced) at the k4 group's stores."""
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.state import state_from_numpy

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 10)
    n = cs.HOP_ROWS
    rng.zipf(1.3, n)  # phase 2h's K1 draws come first
    rng.random((1, n))
    rng.integers(0, 31 * cs.HOUR_MS, n)
    layout, st, _rows = cs.make_sliced_case(hs, rng, cs.HOP_STORE, cs.HOP_RING, n)
    store = state_from_numpy(st, dev)
    retention = 25 * cs.HOUR_MS
    store["max_ts"].fill_(int(store["slast"][store["occ"]].median()) + retention)
    out = [("sliced 2h", layout, store, retention, True)]
    c = cs.make_vector_case(torch, np.random.default_rng(seed + 17), dev)
    out.append(("tumbling 2v width-K", c["layout"], cs.width_k_evict_case(torch, c, np.random.default_rng(seed + 18)),
                cs.HOUR_MS, False))
    url_hashes = np.fromiter((stable_hash64(u) for u in cs._urls(cs.N_URLS)), np.int64, cs.N_URLS)
    flayout, fstore = cs.make_store(torch, hs, cs.STORE, int(0.7 * cs.STORE), np.random.default_rng(seed),
                                    url_hashes, dev)
    fstore["max_ts"].fill_(int(fstore["wstart"][fstore["occ"]].min()) + 29 * cs.HOUR_MS)
    out.append(("tumbling flagship", flayout, fstore, 25 * cs.HOUR_MS, False))
    return out


def k4_variants(cs, torch, out_dir, seed, report):
    from ksql_tpu_torch.ops import cuda

    k3p = _k3p()
    src = (cuda.SRC_DIR / "evict.cu").read_text()
    paths = [k3p._write(os.path.join(out_dir, f"k4_v{i}.cu"), k3p._edited(src, edits))
             for i, (_name, edits) in enumerate(K4_VARIANTS)]
    libs = k3p.build_all(paths, str(cuda.SRC_DIR))
    cases = k4_cases(cs, torch, seed)
    written = {}
    for (name, _edits), lib in zip(K4_VARIANTS, libs):
        cuda._LIBS["ksql_evict"] = k3p._bind(lib, "evict", "ksql_evict")
        for shape, layout, store, retention, sliced in cases:
            rec, expired, _ek = cs.check_evict(torch, layout, store, retention, sliced=sliced)
            written[shape] = cs.evict_bytes(layout, store, expired, sliced)
            report("evict", name, shape, rec, f"{expired} slots expire")
    cuda._LIBS.pop("ksql_evict", None)
    for shape, nbytes in written.items():
        buf = torch.empty(nbytes // 8, dtype=torch.int64, device=torch.device(cs.DEVICE))
        ms = cs.time_events(torch, lambda: buf.fill_(-1))
        report("evict", "fill_ yardstick", shape,
               dict(ms=ms, call_ms=ms, plain_ms=0.0, bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3),
               f"{nbytes} contiguous bytes (CUDA events: its call time)")
        del buf


def k21_variants(cs, torch, out_dir, seed, report):
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import vector as vec

    k3p = _k3p()
    src = (cuda.SRC_DIR / "vec_topk.cu").read_text()
    paths = [k3p._write(os.path.join(out_dir, f"k21_v{i}.cu"), k3p._edited(src, edits))
             for i, (_name, edits) in enumerate(K21_VARIANTS)]
    libs = k3p.build_all(paths, str(cuda.SRC_DIR))
    dev = torch.device(cs.DEVICE)
    c = cs.make_vector_case(torch, np.random.default_rng(seed + 17), dev)
    names = [s.fname for s in c["q"].agg_specs]
    for (name, _edits), lib in zip(K21_VARIANTS, libs):
        cuda._LIBS["ksql_vec_topk"] = k3p._bind(lib, "vec_topk", "ksql_vec_topk")
        for fname, mode in (("TOPK", "plain"), ("TOPKDISTINCT", "distinct")):
            j = c["starts"][names.index(fname)] + 1
            for kind in ("2v", "alone"):
                slots, vals = ((c["slots"], c["contribs"][j]) if kind == "2v"
                               else cs.topk_skew(torch, c, j, kind, np.random.default_rng(seed + 23)))
                rec, what = cs.check_vec_topk(torch, c["layout"], c["store"], j, vals, slots, f"{name} {mode}",
                                              plain_reps=1)
                report("vec_topk", name, f"{mode} {kind}", rec, what)
    cuda._LIBS.pop("ksql_vec_topk", None)
    vec._TOPK_SLOTS.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", default="k4,k21", help="comma-separated: k4, k21")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join(HERE, "build", "probe")
    records = []

    def report(kernel, variant, shape, rec, what):
        records.append(dict(rec, kernel=kernel, variant=variant, shape=shape, what=what))
        print(f"[{kernel} {variant} {shape}] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.5f} ms")

    groups = {"k4": k4_variants, "k21": k21_variants}
    for g in args.groups.split(","):
        groups[g](cs, torch, out_dir, args.seed, report)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
