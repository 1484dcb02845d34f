// K5 sliced_fold: fold each row into its key slot's slice-ring cell.
//
// Replaces runtime/lowering.py:_sliced_scatter (B8).  A sliced store keeps
// one slot per group key and, per aggregate component, a ring of `ring`
// slice partials ([C+1, ring], row-major); row i folds into cell
// (slot, sidx % ring), sidx = floor(wstart / width) its absolute slice.
// One cooperative launch (sliced_fold_kernel), a grid of at most the blocks
// the card holds at once, each warp striding over 32 rows at a time:
//   reset: a live row (active, slot != C) whose cell holds another slice
//     (slice_id != sidx) is a recycled cell of an earlier ring wrap and
//     resets it to the component inits; every other row writes the inits at
//     (C, pos) instead (the reference's scatter of the stale mask sends
//     them to the dump row).  Every writer of one cell writes the same
//     values.  A non-live row also claims ring_last[pos] = max(row) for the
//     dump row's slice_id.
//   grid.sync(), then fold: the warp's active rows that share a cell fold
//     their contributions in lane order in shared memory and the group's
//     lowest lane makes ONE atomic per component (common.cuh fold_group; a
//     warp whose rows all aim at cells of their own folds each row with its
//     own atomics) and sets slice_id; the live rows that share a slot make
//     one atomicMax of their newest slice start into slast and one dirty
//     store.  The non-live row that won ring_last[pos] writes its sidx into
//     slice_id[C, pos] (XLA applies the reference's unmasked duplicate
//     scatter in row order, so the highest such row's index stays there)
//     and resets its claim to -1.
// The barrier keeps every reset before every fold into the same cell.  Rows
// that target one live cell carry the same sidx (K1's horizon cut keeps a
// batch's live slices within ring - 1 of each other), so the resets are
// idempotent.  Inactive rows carry identity contributions and skip the
// fold, as in K3.
//
// Bound: memory.  Per row it reads slot, wstart, active, one slice_id cell
// and J contributions; per touched cell it read-modify-writes J ring cells
// and slice_id, per touched slot slast and dirty; at BASELINE #2 (n =
// 16,384, J = 8) about 1.8 MB (~0.54 us at 3.35 TB/s).  A zipf-hot slot
// takes one atomic a warp, cell and component, not one a row.  float64
// adds are summed in a warp in lane order, then added atomically in an
// order that is not fixed, so float sums agree with the plain version to
// rounding only (the chip check uses rtol 1e-12).  On the card the time
// goes to the cold store's random 32-byte sectors a touched cell costs, and
// to the barrier, not to bytes.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // a batch over more SMs than 256 (torch_k5_probe.py)
constexpr int kWarps = kThreads / 32;
constexpr long long kSlastNone = -(1LL << 62);  // ops/hash_store.py SLAST_NONE

struct Comps {
  void* col[KSQL_MAX_COMPS];
  const void* contrib[KSQL_MAX_COMPS];
  int64_t kind[KSQL_MAX_COMPS];  // combine * 3 + dtype
  int64_t init_bits[KSQL_MAX_COMPS];
  int64_t count;
};

struct Row {
  int64_t ws, sidx, pos, eff;
  bool act, live;
};

__device__ __forceinline__ Row row_of(int64_t i, const int32_t* slots,
                                      const int64_t* wstart, const bool* active,
                                      int64_t capacity, int64_t ring,
                                      int64_t width) {
  Row r;
  r.ws = wstart[i];
  r.sidx = ksql::floor_div(r.ws, width);
  r.pos = ksql::floor_mod(r.sidx, ring);
  r.act = active[i];
  const int64_t slot = slots[i];
  r.eff = r.act ? slot : capacity;
  r.live = r.act && slot != capacity;
  return r;
}

__global__ void __launch_bounds__(kThreads) sliced_fold_kernel(
    Comps c, const int32_t* __restrict__ slots, const int64_t* __restrict__ wstart,
    const bool* __restrict__ active, int64_t n, int64_t capacity, int64_t ring, int64_t width,
    int64_t* __restrict__ slice_id, int64_t* __restrict__ slast, bool* __restrict__ dirty,
    int32_t* __restrict__ ring_last) {
  __shared__ long long s_vals[kWarps][32];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  long long* vals = s_vals[threadIdx.x >> 5];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);

  // ---- reset: stale cells, the dump row's positions, the ring_last claims
  // (a thread's first row is kept in registers for the fold: its 64-bit
  // divisions are made once)
  Row kept{};
  for (int64_t base = warp0; base < n; base += stride) {
    const int64_t i = base + lane;
    if (i >= n) break;
    const Row r = row_of(i, slots, wstart, active, capacity, ring, width);
    if (base == warp0) kept = r;
    const bool stale = r.live && slice_id[r.eff * ring + r.pos] != r.sidx;
    const int64_t cell = (stale ? r.eff : capacity) * ring + r.pos;
    for (int64_t j = 0; j < c.count; ++j) {
      ksql::store_init(c.col[j], cell, c.kind[j] % 3, c.init_bits[j]);
    }
    if (!r.live) atomicMax(&ring_last[r.pos], static_cast<int32_t>(i));
  }
  grid.sync();

  // ---- fold
  if (blockIdx.x == 0 && threadIdx.x == 0) dirty[capacity] = false;
  bool dumped = false;
  for (int64_t base = warp0; base < n; base += stride) {
    const int64_t i = base + lane;
    const bool in = i < n;
    Row r = base == warp0 ? kept : Row{};
    if (base != warp0 && in) r = row_of(i, slots, wstart, active, capacity, ring, width);
    const int64_t cell = r.act ? r.eff * ring + r.pos : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const unsigned live = __ballot_sync(0xffffffffu, r.act);
    // a warp whose rows all aim at cells of their own folds them straight in
    const bool shared = __any_sync(0xffffffffu, r.act && (peers & (peers - 1)) != 0);
    const int64_t slot = r.live ? r.eff : -1 - lane;
    const unsigned mates = __match_any_sync(0xffffffffu, slot);
    const int64_t ws = r.live ? r.ws : 0;
    if (r.act) {
      const bool lead = lane == __ffs(peers) - 1;
      for (int64_t j = 0; j < c.count; ++j) {
        if (shared) {
          ksql::fold_group(c.col[j], c.contrib[j], c.kind[j], i, cell, peers, live, lead, vals, lane);
        } else {
          ksql::atomic_fold(c.col[j], cell, c.contrib[j], i, c.kind[j]);
        }
      }
      if (r.live && lead) slice_id[cell] = r.sidx;
    }
    // the slot's newest slice start: one atomicMax a slot group
    __syncwarp();
    vals[lane] = ws;
    __syncwarp();
    if (r.live && lane == __ffs(mates) - 1) {
      long long newest = ws;
      for (unsigned rest = mates & (mates - 1); rest != 0; rest &= rest - 1) {
        const long long v = vals[__ffs(rest) - 1];
        newest = v > newest ? v : newest;
      }
      atomicMax(reinterpret_cast<long long*>(&slast[r.eff]), newest);
      dirty[r.eff] = true;
    }
    __syncwarp();  // vals is read before the next rows' writes
    dumped = dumped || (in && !r.live);
    if (in && !r.live && ring_last[r.pos] == static_cast<int32_t>(i)) {
      slice_id[capacity * ring + r.pos] = r.sidx;
      ring_last[r.pos] = -1;  // only the claim's winner resets it
    }
  }
  // the reference's amax of SLAST_NONE into the dump slot, by any row not
  // live: one atomic a block
  if (__syncthreads_or(dumped) && threadIdx.x == 0) {
    atomicMax(reinterpret_cast<long long*>(&slast[capacity]), kSlastNone);
  }
}

// the cooperative grid's most blocks, per device (sliced_fold_kernel's
// occupancy times the SMs), asked once
int g_most[64];

}  // namespace

extern "C" int ksql_sliced_fold(const int64_t* comps, int64_t count,
                                const void* slots, const void* wstart,
                                const void* active, int64_t n,
                                int64_t capacity, int64_t ring, int64_t width,
                                void* slice_id, void* slast, void* dirty,
                                void* ring_last, void* stream) {
  if (count > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  Comps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[4 * j]);
    c.contrib[j] = reinterpret_cast<const void*>(comps[4 * j + 1]);
    c.kind[j] = comps[4 * j + 2];
    c.init_bits[j] = comps[4 * j + 3];
  }
  c.count = count;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_most[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sliced_fold_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_most[dev] = per_sm * sms;
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(need < 1 ? 1 : (need < g_most[dev] ? need : g_most[dev]));
  const int32_t* s = static_cast<const int32_t*>(slots);
  const int64_t* ws = static_cast<const int64_t*>(wstart);
  const bool* a = static_cast<const bool*>(active);
  int64_t* sid = static_cast<int64_t*>(slice_id);
  int64_t* sl = static_cast<int64_t*>(slast);
  bool* d = static_cast<bool*>(dirty);
  int32_t* rl = static_cast<int32_t*>(ring_last);
  void* params[] = {&c, &s, &ws, &a, &n, &capacity, &ring, &width, &sid, &sl, &d, &rl};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sliced_fold_kernel), dim3(blocks),
                                    dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
