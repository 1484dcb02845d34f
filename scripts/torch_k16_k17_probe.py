"""Time design variants of K16 (session_write, write mode) and K17
(suppress_clock) on the card.

Builds copies of the kernels' sources with text edits (one ``nvcc`` each,
all started together), holds each against its twin (exact, except where
a variant is built to be wrong: the step-0 copy without its atomic) and
times it as chip_smoke times a kernel (device ms from torch.profiler,
call ms from CUDA events):

* ``step0``: the write mode of the K16 source under ``--step0-root`` (a
  checkout whose write mode finds the dump item with one same-address
  ``atomicMax`` an item, then a one-thread launch), as it is and with that
  atomic taken out, at phase 2w's 270,336 items
  (``chip_smoke.session_write_case``): the share of its time the atomic
  costs.  Its entry point is called with that design's own arguments
  (``STEP0_SIG``), whatever this tree's wrapper takes.
* ``k16``: this tree's write mode as it is and K16_VARIANTS.
* ``k17``: this tree's K17, K17_VARIANTS (its tile choice) and the two-launch
  reduce-then-scan (``TWO_PASS``) against it, at phase 2f's 65,536
  tumbling and 196,608 expansion lanes, 12h's 65,536 lanes and 12g's 2^20
  rows.

    python scripts/torch_k16_k17_probe.py --groups step0 --step0-root build/parent
    python scripts/torch_k16_k17_probe.py --groups k16,k17

Prints the card's name and power limit, a line a variant and shape, and
one JSON line of the records.  Needs a CUDA device; exits 1 without one.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
_P = ctypes.c_void_p
_I = ctypes.c_int64
#: the step-0 design's write entry point: store pointers and capacity, key
#: and component descriptors, the item and segment columns, scal, an int64
#: scratch, the six lane outputs, the stream
STEP0_SIG = [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, *[_P] * 12, _P, _P, *[_P] * 6, _P]
STEP0_ATOMIC = "    atomicMax(dump_item, static_cast<long long>(p));\n"


def _write(path, src):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def _edited(src, edits):
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def build_all(paths, include):
    """Compile every source path into a shared library, all at once."""
    from ksql_tpu_torch.ops import cuda

    procs = []
    for path in paths:
        so = path[:-3] + ".so"
        cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", include, "-o", so, path]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so))
    libs = []
    for proc, so in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log)
        libs.append(ctypes.CDLL(so))
    return libs


#: K16's variants: (name, text edits of csrc/session_write.cu); the first
#: is the source's own
K16_VARIANTS = [
    ("final", []),
    ("element size in the loop", [("  bool all8 = true;\n", "  bool all8 = false;\n")]),
]
#: K17's look-back over a window of 128 predecessors (four flags a lane,
#: loaded relaxed and then ordered by one acquire fence, so that they
#: overlap) in place of the source's 32 (one acquire load a lane)
WIDE_LOOK_BACK = """
constexpr int kLookItems = 4;

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acquire() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// The maximum over tiles 0..t-1 of chain c, by one warp (t >= 1): a
// window of 32 x kLookItems predecessors a round, their flags loaded at
// once (relaxed, then one acquire fence), folded back to the nearest
// inclusive prefix.
__device__ int64_t look_back(Chain c, int64_t t, unsigned long long epoch, int lane) {
  const unsigned long long empty = epoch << 2 | kInclusive;  // before tile 0
  int64_t prefix = INT64_MIN;
  for (int64_t top = t - 1;; top -= 32 * kLookItems) {
    unsigned long long f[kLookItems];
#pragma unroll
    for (int u = 0; u < kLookItems; ++u) {
      const int64_t j = top - (u * 32 + lane);
      f[u] = j >= 0 ? load_relaxed(&c.flag[j]) : empty;
    }
#pragma unroll
    for (int u = 0; u < kLookItems; ++u) {
      while ((f[u] >> 2) != epoch) f[u] = load_relaxed(&c.flag[top - (u * 32 + lane)]);
    }
    fence_acquire();
    int stop_u = kLookItems, stop_lane = 31;  // the nearest inclusive prefix
#pragma unroll
    for (int u = 0; u < kLookItems; ++u) {
      const unsigned inclusive = __ballot_sync(kAll, (f[u] & 3) == kInclusive);
      if (inclusive && stop_u == kLookItems) {
        stop_u = u;
        stop_lane = __ffs(inclusive) - 1;
      }
    }
    int64_t m = INT64_MIN;
#pragma unroll
    for (int u = 0; u < kLookItems; ++u) {
      const int64_t j = top - (u * 32 + lane);
      if (j >= 0 && (u < stop_u || (u == stop_u && lane <= stop_lane))) {
        m = imax(m, __ldcg(reinterpret_cast<const long long*>(&c.val[j])));
      }
    }
    prefix = imax(prefix, warp_max(m));
    if (stop_u < kLookItems) return prefix;
  }
}

"""
#: K17's variants: (name, text edits of csrc/suppress_clock.cu); the first
#: is the source's own
K17_VARIANTS = [
    ("final", []),
    ("look-back window of 128", [("__device__ int64_t look_back(", WIDE_LOOK_BACK + "__device__ int64_t look_back_32(")]),
    ("kMinTiles 264", [("constexpr int64_t kMinTiles = 128;", "constexpr int64_t kMinTiles = 264;")]),
    ("kMinTiles 32", [("constexpr int64_t kMinTiles = 128;", "constexpr int64_t kMinTiles = 32;")]),
]
#: K17 as a two-launch reduce-then-scan: a first launch writes each tile's
#: lane and row maxima; the second is the single-pass kernel whose tile
#: prefix folds the maxima of the tiles before it instead of looking back
TWO_PASS_REDUCE = """
template <int ITEMS>
__global__ void __launch_bounds__(kThreads) clock_reduce_kernel(
    const int64_t* __restrict__ ts, const bool* __restrict__ active_in,
    const bool* __restrict__ row_valid, int64_t n, int64_t row_tiles, int64_t* lane_max,
    int64_t* row_max) {
  constexpr int kTile = kThreads * ITEMS;
  __shared__ int64_t s_w[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t h = t / row_tiles, r = t - h * row_tiles;
  const bool rows = h == 0;
  const int64_t row0 = r * kTile + warp * 32 * ITEMS + lane;
  int64_t lm = INT64_MIN, rm = INT64_MIN;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int64_t i = row0 + q * 32;
    if (i < n) {
      const int64_t v = ts[i];
      if (active_in[h * n + i]) lm = imax(lm, v);
      if (rows && row_valid[i]) rm = imax(rm, v);
    }
  }
  lm = warp_max(lm);
  rm = warp_max(rm);
  if (lane == 0) {
    s_w[0][warp] = lm;
    s_w[1][warp] = rm;
  }
  __syncthreads();
  if (warp == 0) {
    lm = warp_max(lane < kWarps ? s_w[0][lane] : INT64_MIN);
    rm = warp_max(lane < kWarps ? s_w[1][lane] : INT64_MIN);
    if (lane == 0) {
      lane_max[t] = lm;
      if (rows) row_max[r] = rm;
    }
  }
}

template <int ITEMS>
int launch("""
TWO_PASS = [
    ("\ntemplate <int ITEMS>\nint launch(", TWO_PASS_REDUCE),
    ("""  if (t == 0) {
    if (lane == 0) publish(c, 0, agg, epoch << 2 | kInclusive);
  } else {
    if (lane == 0) publish(c, t, agg, epoch << 2 | kAggregate);
    prefix = look_back(c, t, epoch, lane);
    if (lane == 0) publish(c, t, imax(prefix, agg), epoch << 2 | kInclusive);
  }""", """  for (int64_t j = lane; j < t; j += 32) prefix = imax(prefix, __ldcg(reinterpret_cast<const long long*>(&c.val[j])));
  prefix = warp_max(prefix);"""),
    ("""  clock_kernel<ITEMS><<<""", """  clock_reduce_kernel<ITEMS><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      ts, active_in, row_valid, n, row_tiles, lanes_c.val, rows_c.val);
  clock_kernel<ITEMS><<<"""),
]


def step0_call(torch, fn, store, cap, merged, ins, scal):
    """One call of the step-0 design's write entry ``fn`` (its wrapper's
    argument marshalling); returns its lanes."""
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops.hash_store import _stream

    m = ins.shape[0]
    dev = ins.device

    def e(dt):
        return torch.empty(2 * m, dtype=dt, device=dev)

    k = merged["reprs"].shape[0]
    lanes = {"mask": e(torch.bool), "keys": [e(torch.int64) for _ in range(k)], "comps": [],
             "ws": e(torch.int64), "we": e(torch.int64), "tombstone": e(torch.bool),
             "ord_a": e(torch.int64), "ord_b": e(torch.int64)}
    keys = []
    for r, s, o in zip(merged["reprs"], merged["seg_reprs"], lanes["keys"]):
        keys += [r.data_ptr(), s.data_ptr(), o.data_ptr()]
    comps = []
    for j, (c, s) in enumerate(zip(merged["comps"], merged["seg_comps"])):
        col = store[f"a{j}"]
        o = e(c.dtype)
        lanes["comps"].append(o)
        comps += [col.data_ptr(), c.data_ptr(), s.data_ptr(), o.data_ptr(), col.element_size()]
    scratch = torch.empty(1, dtype=torch.int64, device=dev)
    cuda.check("session_write", fn(
        store["sess_start"].data_ptr(), store["sess_end"].data_ptr(), store["dirty"].data_ptr(),
        store["max_ts"].data_ptr(), cap, cuda.host_i64(keys), k, cuda.host_i64(comps),
        len(merged["comps"]), m, ins.data_ptr(),
        *(merged[name].data_ptr() for name in (
            "start", "end", "alive", "isrow", "segfirst", "winner", "ins_act", "seg_start",
            "seg_end", "seg_has_row", "seg_minrow")),
        scal.data_ptr(), scratch.data_ptr(),
        *(lanes[name].data_ptr() for name in ("mask", "ws", "we", "tombstone", "ord_a", "ord_b")),
        _stream(dev)))
    return lanes


def step0(cs, torch, root, out_dir, seed, report):
    """The step-0 design's write mode under ``root``, as it is and without
    its atomic, at phase 2w's items."""
    from ksql_tpu_torch.ops import session as sess

    src = open(os.path.join(root, "ksql_tpu_torch", "csrc", "session_write.cu")).read()
    paths = [_write(os.path.join(out_dir, "step0_atomic.cu"), src),
             _write(os.path.join(out_dir, "step0_no_atomic.cu"), _edited(src, [(STEP0_ATOMIC, "")]))]
    libs = build_all(paths, os.path.join(root, "ksql_tpu_torch", "csrc"))
    plan = json.load(open(os.path.join(HERE, "ksql_tpu_torch", "plans", "pv_sessions.json")))
    dev = torch.device("cuda")
    w = cs.session_write_case(torch, plan, seed, dev)
    cap, merged, ins, scal, m = w["cap"], w["merged"], w["ins"], w["scal"], w["m"]
    dumped = int((~merged["ins_act"] | (ins == cap)).sum())
    cs.KERNEL_FUNCS["session_write"] = ("write_kernel", "dump_kernel")
    for name, lib in zip(("as it is", "without the atomic"), libs):
        fn = getattr(lib, "ksql_session_write")
        fn.argtypes = STEP0_SIG
        fn.restype = ctypes.c_int
        sk, sp = cs._clone(w["store"]), cs._clone(w["store"])
        got = step0_call(torch, fn, sk, cap, merged, ins, scal)
        want = sess.session_write_plain(sp, cap, merged, ins, scal)
        cs._assert_tree(torch, "step0 lanes", got, want)
        if name == "as it is":
            cs._assert_tree(torch, "step0 store", sk, sp)

        def reset(sk=sk):
            cs._restore(sk, w["store"])

        rec = cs.measure(torch, "session_write", lambda fn=fn, sk=sk: step0_call(torch, fn, sk, cap, merged, ins, scal),
                         lambda: sess.session_write_plain(sp, cap, merged, ins, scal),
                         cs.write_bytes(m, w["nseg"], w["k"], w["cb"], w["n_ins"]), m * 20, reset=reset,
                         plain_reps=3)
        report("session_write", f"step 0, {name}", "write 2w", rec,
               f"{2 * m} lanes, {dumped} items aimed at the dump slot")


def _bind(lib, kernel, entry):
    from ksql_tpu_torch.ops import cuda

    fn = getattr(lib, entry)
    fn.argtypes = cuda.SIGNATURES[kernel][entry]
    fn.restype = ctypes.c_int
    return fn


def k16_variants(cs, torch, out_dir, seed, report):
    """This tree's K16 write mode and K16_VARIANTS at phase 2w's items."""
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import session as sess

    src = (cuda.SRC_DIR / "session_write.cu").read_text()
    paths = [_write(os.path.join(out_dir, f"k16_v{i}.cu"), _edited(src, edits))
             for i, (_name, edits) in enumerate(K16_VARIANTS)]
    libs = build_all(paths, str(cuda.SRC_DIR))
    plan = json.load(open(os.path.join(HERE, "ksql_tpu_torch", "plans", "pv_sessions.json")))
    w = cs.session_write_case(torch, plan, seed, torch.device("cuda"))
    cap, merged, ins, scal, m = w["cap"], w["merged"], w["ins"], w["scal"], w["m"]
    for (name, _edits), lib in zip(K16_VARIANTS, libs):
        cuda._LIBS["ksql_session_write"] = _bind(lib, "session_write", "ksql_session_write")
        sk, sp = cs._clone(w["store"]), cs._clone(w["store"])
        cs._assert_tree(torch, f"k16 {name} lanes", sess.session_write(sk, cap, merged, ins, scal),
                        sess.session_write_plain(sp, cap, merged, ins, scal))
        cs._assert_tree(torch, f"k16 {name} store", sk, sp)

        def reset(sk=sk):
            cs._restore(sk, w["store"])

        rec = cs.measure(torch, "session_write", lambda sk=sk: sess.session_write(sk, cap, merged, ins, scal),
                         lambda: sess.session_write_plain(sp, cap, merged, ins, scal),
                         cs.write_bytes(m, w["nseg"], w["k"], w["cb"], w["n_ins"]), m * 20, reset=reset,
                         plain_reps=3)
        report("session_write", name, "write 2w", rec, f"{2 * m} lanes")


def k17_variants(cs, torch, out_dir, seed, report):
    """This tree's K17, K17_VARIANTS and the two-pass variant at the
    shapes of ``torch_slice_times.k17_shapes``."""
    import importlib.util

    from ksql_tpu_torch.ops import cuda

    spec = importlib.util.spec_from_file_location("sts", os.path.join(HERE, "scripts", "torch_slice_times.py"))
    sts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sts)
    src = (cuda.SRC_DIR / "suppress_clock.cu").read_text()
    variants = K17_VARIANTS + [("two launches", TWO_PASS)]
    paths = [_write(os.path.join(out_dir, f"k17_v{i}.cu"), _edited(src, edits))
             for i, (_name, edits) in enumerate(variants)]
    libs = build_all(paths, str(cuda.SRC_DIR))
    cs.KERNEL_FUNCS["suppress_clock"] = ("clock_kernel", "clock_reduce_kernel")
    for (name, _edits), lib in zip(variants, libs):
        cuda._LIBS["ksql_suppress_clock"] = _bind(lib, "suppress_clock", "ksql_suppress_clock")
        for _kernel, shape, rec, what in sts.k17_shapes(cs, torch, seed):
            report("suppress_clock", name, shape, rec, what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default="k16,k17", help="comma-separated: step0, k16, k17")
    ap.add_argument("--step0-root", default=HERE, help="the checkout whose K16 step 0 times")
    ap.add_argument("--seed", type=int, default=0)
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
        lib = "" if rec.get("library_ms") is None else f", yardstick {rec['library_ms']:.4f} ms"
        print(f"[{kernel} {variant} {shape}] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms{lib}")

    groups = args.groups.split(",")
    if "step0" in groups:
        step0(cs, torch, os.path.abspath(args.step0_root), out_dir, args.seed, report)
    if "k16" in groups:
        k16_variants(cs, torch, out_dir, args.seed, report)
    if "k17" in groups:
        k17_variants(cs, torch, out_dir, args.seed, report)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
