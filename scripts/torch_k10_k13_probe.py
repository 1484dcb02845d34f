"""Time design variants of K10 (ss_match) and K13 (seg_sort) on the card.

Builds copies of ``csrc/ss_match.cu`` and ``csrc/seg_sort.cu`` with their
tile constants changed (one ``nvcc`` each, all started together), swaps
each copy's entry points in for the package's, holds the result against
the twin (exact) and times it as chip_smoke times a kernel (device ms
from torch.profiler, call ms from CUDA events):

* K10: rows a block (``kThreads``) x ring tile (``kTile``), count and
  write, at phase 2s's case, at a 16,385-entry ring with every entry live
  and a 65,537-entry ring with 37%;
* K13: K13_VARIANTS (constants such as ``kRun``, items a thread sorts in
  registers, and text edits of the source), at 2v's 4,096 vector-order
  rows, 2w's 8,192 session rows and its 270,336 items
  (``torch_slice_times.k13_keys``), and a copy of the first variant
  marked with the SM clock at each merge level.

    python scripts/torch_k10_k13_probe.py

Prints the card's name and power limit, a line a variant and shape, and
one JSON line of the records.  Needs a CUDA device; exits 1 without one.
"""

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
#: (kThreads, kTile) of K10's count and write: rows a block, ring entries a
#: tile; the first is the source's own
K10_VARIANTS = [(256, 512), (256, 1024), (512, 512), (256, 256)]
#: K13's block sort with its warp levels as bitonic merges in registers,
#: across lanes by shuffles (inserted before the block sort)
WARP_MERGE = """
constexpr unsigned kShflAll = 0xffffffffu;
__device__ __forceinline__ void warp_merge(int64_t* k1, int64_t* k2, int* id) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 2 * kRun; s <= kWarpItems; s <<= 1) {
    {
      const int m = s / kRun - 1;
      const bool low = (lane & (s / (2 * kRun))) == 0;
      int64_t p1[kRun], p2[kRun];
      int pi[kRun];
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        p1[q] = __shfl_xor_sync(kShflAll, k1[kRun - 1 - q], m);
        p2[q] = __shfl_xor_sync(kShflAll, k2[kRun - 1 - q], m);
        pi[q] = __shfl_xor_sync(kShflAll, id[kRun - 1 - q], m);
      }
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        if (less3(p1[q], p2[q], pi[q], k1[q], k2[q], id[q]) == low) {
          k1[q] = p1[q];
          k2[q] = p2[q];
          id[q] = pi[q];
        }
      }
    }
#pragma unroll
    for (int j = s / 4; j > 0; j >>= 1) {
      if (j >= kRun) {
        const int m = j / kRun;
        const bool low = (lane & m) == 0;
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          const int64_t o1 = __shfl_xor_sync(kShflAll, k1[q], m);
          const int64_t o2 = __shfl_xor_sync(kShflAll, k2[q], m);
          const int oi = __shfl_xor_sync(kShflAll, id[q], m);
          if (less3(o1, o2, oi, k1[q], k2[q], id[q]) == low) {
            k1[q] = o1;
            k2[q] = o2;
            id[q] = oi;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          const int l = q ^ j;
          if (l > q && less3(k1[l], k2[l], id[l], k1[q], k2[q], id[q])) {
            const int64_t x1 = k1[q], x2 = k2[q];
            const int xi = id[q];
            k1[q] = k1[l];
            k2[q] = k2[l];
            id[q] = id[l];
            k1[l] = x1;
            k2[l] = x2;
            id[l] = xi;
          }
        }
      }
    }
  }
}

"""
#: K13's variants: (name, constants, text replacements); the first is the
#: source's own
K13_VARIANTS = [
    ("final", {}, []),
    ("runs of 16", {"kRun": 16}, []),
    ("tie loads behind the k1 test", {}, [("  const int64_t x = k2[a], y = k2[b];",
                                           "  const volatile int64_t* v = k2;\n  const int64_t x = v[a], y = v[b];")]),
    ("runs of consecutive items", {}, [("    const int i = q * threads + t;\n    id[q] = i;",
                                        "    const int i = kRun * t + q;\n    id[q] = i;")]),
    ("warp levels by shuffles", {}, [("// One block sorts the items", WARP_MERGE + "// One block sorts the items"),
                                     ("  sort_run(r1, r2, id);\n", "  sort_run(r1, r2, id);\n  warp_merge(r1, r2, id);\n"),
                                     ("for (int len = kRun; len < npad;", "for (int len = kWarpItems; len < npad;")]),
]
#: where a marked copy of K13's block sort reads the SM clock (thread 0 of
#: block 0): after each anchor line, the mark's number
K13_MARKS = [("  const int threads = blockDim.x, t = threadIdx.x;\n", "0"),
             ("  __syncthreads();  // the keys, for every level\n", "1"),
             ("    const int d0 = kRun * t;\n", "2 + (level++)"),
             ("  __syncthreads();\n  for (int i = t; i < cnt; i += threads) {\n", "31")]


def _variant(src_name, consts, tag, edits=()):
    """A copy of ``csrc/<src_name>.cu`` with ``constexpr int <name> = ...``
    set from ``consts`` and each (old, new) text of ``edits`` replaced,
    under build/probe; returns its source path."""
    from ksql_tpu_torch.ops import cuda

    src = (cuda.SRC_DIR / f"{src_name}.cu").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};", src)
        assert n == 1, name
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{src_name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def _marked(path):
    """A copy of K13's variant at ``path`` whose block sort writes the SM
    clock at K13_MARKS into a device array, read by ``probe_marks``."""
    src = open(path).read()
    src = src.replace("namespace {", "__device__ long long g_marks[32];\nnamespace {", 1)
    for anchor, mark in K13_MARKS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, anchor + f"  if (blockIdx.x == 0 && threadIdx.x == 0) g_marks[{mark}] = clock64();\n")
    src = src.replace("  int* b = a + npad;\n", "  int* b = a + npad;\n  int level = 0;\n", 1)
    src += ('extern "C" int probe_marks(long long* host) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks)));\n}\n")
    out = path[:-3] + "_marked.cu"
    with open(out, "w") as f:
        f.write(src)
    return out


def build_all(specs):
    """Compile every (source path) into a shared library, all at once."""
    from ksql_tpu_torch.ops import cuda

    procs = []
    for path in specs:
        so = path[:-3] + ".so"
        cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", str(cuda.SRC_DIR), "-o", so, path]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so))
    libs = []
    for proc, so in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log)
        libs.append(ctypes.CDLL(so))
    return libs


def _bind(lib, kernel, entry):
    from ksql_tpu_torch.ops import cuda

    fn = getattr(lib, entry)
    fn.argtypes = cuda.SIGNATURES[kernel][entry]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import session as sess
    from ksql_tpu_torch.ops import ss_join as ssj

    spec = importlib.util.spec_from_file_location("sts", os.path.join(HERE, "scripts", "torch_slice_times.py"))
    sts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sts)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    k10 = [_variant("ss_match", {"kThreads": b, "kTile": t}, f"b{b}_t{t}") for b, t in K10_VARIANTS]
    k13 = [_variant("seg_sort", consts, f"v{i}", edits) for i, (_nm, consts, edits) in enumerate(K13_VARIANTS)]
    libs = build_all(k10 + k13 + [_marked(k13[0])])
    dev = torch.device("cuda")
    records = []

    def report(kernel, variant, shape, rec, what):
        records.append(dict(rec, kernel=kernel, variant=variant, shape=shape, what=what))
        print(f"[{kernel} {variant} {shape}] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms")

    # ---- K10
    shapes = [("2s", 1 << 14, None), ("16385@1.00", 1 << 14, 1.0), ("65537@0.37", 1 << 16, 0.37)]
    for (threads, tile), lib in zip(K10_VARIANTS, libs[:len(k10)]):
        cuda._LIBS["ksql_ss_match_count"] = _bind(lib, "ss_match", "ksql_ss_match_count")
        cuda._LIBS["ksql_ss_match_write"] = _bind(lib, "ss_match", "ksql_ss_match_write")
        ssj._TILE = tile
        for tag, ring, share in shapes:
            rng = np.random.default_rng(30)
            case = cs.make_ss_case(rng, ring, cs.SS_ROWS)
            if share is not None:
                live = rng.random(ring + 1) < share
                live[ring] = False
                case["ring_r"]["live"] = live
            base = cs.ss_case_tensors(torch, case, dev)
            kc, pc = cs._clone_case(base), cs._clone_case(base)
            _g, _w, recs, info = cs.check_ss_match(torch, kc, pc, 8 * cs.SS_ROWS)
            for mode in ("count", "write"):
                report("ss_match", f"block {threads} tile {tile}", f"{mode} {tag}", recs[mode],
                       f"{info['look']} rows, {info['live']} live, {info['total']} matches")
    # ---- K13
    for (name, _consts, _edits), lib in zip(K13_VARIANTS, libs[len(k10):]):
        cuda._LIBS["ksql_seg_sort"] = _bind(lib, "seg_sort", "ksql_seg_sort")
        rng = np.random.default_rng(17)
        for shape in ("vector", "rows", "items"):
            k1, k2 = sts.k13_keys(torch, rng, dev, shape)
            n = k1.shape[0]
            try:
                cs._assert_equal(torch, f"seg_sort[{shape}]", sess.seg_sort(k1, k2), sess.seg_sort_plain(k1, k2))
            except RuntimeError as e:  # a variant that cannot launch at this size (registers)
                print(f"[seg_sort {name} {shape}] {e}")
                continue
            rec = cs.measure(torch, "seg_sort", lambda: sess.seg_sort(k1, k2), lambda: sess.seg_sort_plain(k1, k2),
                             n * 20, 0, plain_reps=3)
            report("seg_sort", name, shape, rec, f"{n} items")
    # ---- K13's first variant, marked: SM cycles from the kernel's start
    cuda._LIBS["ksql_seg_sort"] = _bind(libs[-1], "seg_sort", "ksql_seg_sort")
    marks = (ctypes.c_longlong * 32)()
    rng = np.random.default_rng(17)
    for shape in ("vector", "rows"):
        k1, k2 = sts.k13_keys(torch, rng, dev, shape)
        for _ in range(3):
            sess.seg_sort(k1, k2)
        torch.cuda.synchronize()
        ctypes.memset(marks, 0, ctypes.sizeof(marks))
        assert libs[-1].probe_marks(marks) == 0
        t0 = marks[0]
        cyc = [m - t0 for m in marks if m]
        records.append({"kernel": "seg_sort", "variant": "marked", "shape": shape, "cycles": cyc})
        print(f"[seg_sort marked {shape}] SM cycles at load+sort, each level, the end: {cyc}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
