"""Time K8's live mode against a warp-a-key variant of its walk, on the card.

K8 (``ksql_tpu_torch/csrc/probe_find.cu``) walks a key's probe chain with
one thread: one dependent read of the store a candidate.  The variant
below gives each key a warp: lane ``l`` reads candidate ``base + l`` at
once, and two ballots (a live match; a truly empty slot) give the first
match before the first empty slot, the same slot the walk finds (the
chain has at most 32 candidates, one a lane).  Its lanes then gather the
key's columns, one a lane.  It takes K8's arguments, device descriptor
and output layout, so both write the same lanes.

This script builds the variant with nvcc into ``build/``, holds it against
K8's twin on phase 19's one foreign key over 2^16 slots and on phase 2x's
65,536 over 2^18 (``chip_smoke.make_fkr_case``), and times both kernels
with ``chip_smoke.kernel_device_ms`` (device ms, records counted):

    python scripts/torch_k8_warp_probe.py

Prints the card's name and power limit, then one JSON line of
``{"records": [{"shape", "k8_ms", "warp_ms"}]}``.  Needs a CUDA device;
exits 1 without one.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANT = r'''
#include "common.cuh"

constexpr int kDescWords = 1 + 3 * KSQL_MAX_COLS + 2 * (2 + 2 * KSQL_MAX_COLS);

__global__ void probe_find_warp_kernel(
    const bool* __restrict__ occ, const bool* __restrict__ grave, const int64_t* __restrict__ kh,
    const int64_t* __restrict__ ws, const int64_t* __restrict__ key0, const bool* __restrict__ live,
    int64_t capacity, const int64_t* __restrict__ desc, int64_t words, char* __restrict__ out,
    const int64_t* __restrict__ krepr, const bool* __restrict__ kvalid,
    const bool* __restrict__ active, int64_t n) {
  __shared__ int64_t s_desc[kDescWords];
  const int64_t dv = threadIdx.x < words ? desc[threadIdx.x] : 0;
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int64_t slot = capacity;
  bool found = false;
  if (r < n && active[r] && kvalid[r]) {
    const uint64_t h = ksql::mix64(ksql::kGold ^ (static_cast<uint64_t>(krepr[r]) + ksql::kGold));
    const int64_t mask = capacity - 1;
    const int64_t base = static_cast<int64_t>(ksql::mix64(h) & static_cast<uint64_t>(mask));
    const int64_t cand = (base + lane) & mask;
    const bool o = occ[cand];
    const bool g = grave[cand];
    const bool hit = o && kh[cand] == static_cast<int64_t>(h) && ws[cand] == 0;
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    const unsigned empty = __ballot_sync(0xffffffffu, !o && !g);
    const int first_hit = hits ? __ffs(hits) - 1 : 32;
    const int first_empty = empty ? __ffs(empty) - 1 : 32;
    if (first_hit < first_empty) {
      slot = (base + first_hit) & mask;
      found = live == nullptr || live[slot];
    }
  }
  if (threadIdx.x < words) s_desc[threadIdx.x] = dv;
  __syncthreads();
  if (r >= n) return;
  const int64_t count = s_desc[0];
  const int64_t* cd = s_desc + 1;
  const int64_t* od = s_desc + 1 + 3 * count;
  if (lane < count) {
    ksql::copy_elem(out + od[2 + 2 * lane], r, reinterpret_cast<const void*>(cd[3 * lane]), slot,
                    cd[3 * lane + 1]);
    reinterpret_cast<bool*>(out + od[3 + 2 * lane])[r] =
        reinterpret_cast<const bool*>(cd[3 * lane + 2])[slot] && found;
  }
  if (lane == 31) {
    reinterpret_cast<int64_t*>(out + od[0])[r] = key0[slot];
    reinterpret_cast<bool*>(out + od[1])[r] = found;
  }
}

extern "C" int ksql_probe_find_warp(const void* occ, const void* grave, const void* kh,
                                    const void* ws, const void* key0, const void* live,
                                    int64_t capacity, const void* desc, int64_t words, void* out,
                                    const void* krepr, const void* kvalid, const void* active,
                                    int64_t n, void* stream) {
  const int threads = 256;
  probe_find_warp_kernel<<<ksql::blocks_for(n * 32, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(occ), static_cast<const bool*>(grave),
      static_cast<const int64_t*>(kh), static_cast<const int64_t*>(ws),
      static_cast<const int64_t*>(key0), static_cast<const bool*>(live), capacity,
      static_cast<const int64_t*>(desc), words, static_cast<char*>(out),
      static_cast<const int64_t*>(krepr), static_cast<const bool*>(kvalid),
      static_cast<const bool*>(active), n);
  return static_cast<int>(cudaGetLastError());
}
'''


def build_variant(cuda):
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    src = os.path.join(HERE, "build", "probe_find_warp.cu")
    lib = os.path.join(HERE, "build", "libprobe_find_warp.so")
    with open(src, "w") as f:
        f.write(VARIANT)
    subprocess.run([cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", str(cuda.SRC_DIR), "-o", lib, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).ksql_probe_find_warp
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import hash_store as hs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    warp = build_variant(cuda)
    cs.KERNEL_FUNCS["probe_find_warp"] = ("probe_find_warp_kernel",)
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    records = []
    for shape, n, cap, users in (("19: one key over 2^16 slots", 1, cs.FK_STORE, cs.FK_USERS),
                                 ("2x: 65,536 keys over 2^18 slots", cs.TT_ROWS, cs.TT_STORE, cs.TT_USERS)):
        c = cs.make_fkr_case(torch, rng, dev, n, cap, users)
        st, fk, valid = c["store"], c["fk"], c["valid"]
        cols = [col.name for col in c["query"].fk_cols["r"]]
        plan = hs.find_plan(st, cap, cols, st["live"])
        desc = plan.desc(n, 1)

        def run_warp():
            buf = plan.lanes.alloc(n, dev)
            cuda.check("probe_find_warp", warp(*plan.ptrs, cap, desc.data_ptr(), desc.shape[0],
                                               buf.data_ptr(), fk.data_ptr(), valid.data_ptr(),
                                               valid.data_ptr(), n, hs._stream(fk.device)))
            return plan.lanes.views(buf, n, n)[0]

        got = run_warp()
        lanes, key0, found = hs.probe_find_gather_plain(st, cap, fk, valid, valid, cols, live=st["live"])
        for name, want in (("key0", key0), ("found", found), *lanes.items()):
            cs._assert_equal(torch, f"probe_find_warp.{name}", got[name], want)
        k8_ms = cs.kernel_device_ms(torch, "probe_find",
                                    lambda: hs.probe_find(st, cap, fk, valid, valid, cols, live=st["live"]),
                                    per_call=1)
        warp_ms = cs.kernel_device_ms(torch, "probe_find_warp", run_warp, per_call=1)
        print(f"[{shape}] K8 {k8_ms:.4f} ms, warp a key {warp_ms:.4f} ms (device; both exact against the twin)")
        records.append({"shape": shape, "k8_ms": k8_ms, "warp_ms": warp_ms})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
