// K3 fold_and_mark: fold per-row aggregate contributions into their slots,
// mark the slots dirty, and pick one representative row per touched slot.
//
// Replaces ops/hash_store.py:scatter_combine (B3: the add/min/max branches
// plus the `dirty` marking) and ops/hash_store.py:winners_per_slot (B4).
// One cooperative launch (fold_mark_kernel), a grid of at most the blocks
// the card holds at once, each warp striding over 32 rows at a time:
//   fold: the warp's active rows that share a slot find each other
//     (__match_any_sync on the slot; a warp whose rows all have slots of
//     their own folds each row with its own atomics); per component every lane puts its
//     contribution in shared memory and the group's lowest lane folds the
//     group's values in lane order (int64 adds wrap; float64 min/max keep
//     XLA's order: NaN wins, -0.0 is below +0.0).  Every lowest lane runs
//     the same loop, as long as its warp's largest group: groups do not
//     take turns, as shuffles within each group would.  The lowest lane
//     then makes ONE atomic per component (atomicAdd, atomicMin/Max, or
//     common.cuh's CAS loop for float64 min/max), sets dirty[slot] and
//     makes one atomicMin of its row (the group's lowest) into
//     first[slot].  A zipf-hot slot takes one atomic a warp and
//     component, not one a row.
//   grid.sync(), then winners: a row wins iff first[slot] is its own
//     index; the winner resets first[slot] (INT32_MAX when clean), and
//     dirty[C] is cleared.
// Inactive rows carry identity contributions (every device_aggs contrib
// masks them), so skipping them leaves the dump slot exactly as the
// reference's full scatter does.
//
// Bound: memory.  Per row it reads the slot, the mask and J contributions;
// per touched slot it read-modify-writes J store cells.  float64 adds are
// summed in a warp in lane order, then added atomically in a different
// order each run, so float sums agree with the plain version to rounding
// only (the chip check uses rtol 1e-12).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Comps {
  void* col[KSQL_MAX_COMPS];
  const void* contrib[KSQL_MAX_COMPS];
  int64_t kind[KSQL_MAX_COMPS];  // combine * 3 + dtype
  int64_t count;
};

__global__ void __launch_bounds__(kThreads) fold_mark_kernel(
    Comps c, const int32_t* __restrict__ slots, const bool* __restrict__ active, int64_t n,
    int32_t capacity, bool* __restrict__ dirty, int32_t* __restrict__ first,
    bool* __restrict__ winners) {
  __shared__ long long s_vals[kWarps][32];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  long long* vals = s_vals[threadIdx.x >> 5];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  for (int64_t base = warp0; base < n; base += stride) {
    const int64_t i = base + lane;
    const bool act = i < n && active[i];
    // an inactive lane's key is its own (slots are >= 0)
    const int32_t s = act ? slots[i] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const unsigned live = __ballot_sync(0xffffffffu, act);
    // a warp whose rows all have slots of their own folds them straight in
    const bool shared = __any_sync(0xffffffffu, act && (peers & (peers - 1)) != 0);
    if (!act) continue;
    const bool lead = lane == __ffs(peers) - 1;
    for (int64_t j = 0; j < c.count; ++j) {
      if (shared) {
        ksql::fold_group(c.col[j], c.contrib[j], c.kind[j], i, s, peers, live, lead, vals, lane);
      } else {
        ksql::atomic_fold(c.col[j], s, c.contrib[j], i, c.kind[j]);
      }
    }
    if (lead && s != capacity) {
      dirty[s] = true;
      atomicMin(&first[s], static_cast<int32_t>(i));
    }
  }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) dirty[capacity] = false;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const int32_t s = slots[i];
    bool win = false;
    if (active[i] && s != capacity && first[s] == static_cast<int32_t>(i)) {
      win = true;
      first[s] = INT32_MAX;  // only the winner resets its cell
    }
    winners[i] = win;
  }
}

// the cooperative grid's most blocks, per device (fold_mark_kernel's
// occupancy times the SMs), asked once
int g_most[64];

}  // namespace

extern "C" int ksql_fold_and_mark(const int64_t* comps, int64_t count,
                                  const void* slots, const void* active,
                                  int64_t n, int64_t capacity, void* dirty,
                                  void* first, void* winners, void* stream) {
  if (count > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  Comps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[3 * j]);
    c.contrib[j] = reinterpret_cast<const void*>(comps[3 * j + 1]);
    c.kind[j] = comps[3 * j + 2];
  }
  c.count = count;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_most[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_mark_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_most[dev] = per_sm * sms;
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(need < 1 ? 1 : (need < g_most[dev] ? need : g_most[dev]));
  const int32_t cap = static_cast<int32_t>(capacity);
  const int32_t* s = static_cast<const int32_t*>(slots);
  const bool* a = static_cast<const bool*>(active);
  bool* d = static_cast<bool*>(dirty);
  int32_t* f = static_cast<int32_t*>(first);
  bool* w = static_cast<bool*>(winners);
  void* params[] = {&c, &s, &a, &n, const_cast<int32_t*>(&cap), &d, &f, &w};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fold_mark_kernel), dim3(blocks),
                                    dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3, argset mode: the arg-min/max payloads of scalar EARLIEST/LATEST_BY_OFFSET.
//
// Replaces ops/hash_store.py:scatter_combine's 'argset' branch (:552-558).
// It runs after the fold above has settled every order component.  For each
// argset component j, o the nearest order component before it, row i (every
// row, inactive ones too: their slot is the dump) is a winner when its slot s
// is not the dump and contrib_o[i] == a_o[s]; a winner writes contrib_j[i] to
// a_j[s].  Every other row is aimed at the dump slot, and the reference's
// duplicate-index .at[].set leaves the payload of the highest such row there.
// One launch, one thread a row: each warp takes the highest such row a
// component with __reduce_max_sync, each block the highest of its warps',
// and makes one atomicMax into the component's dump cell (scratch, -1
// between calls); the last block to finish (a wrapping atomicInc ticket
// after a __threadfence) writes that row's payload to a_j[C] and resets the
// cell.  Real slots have no other ties: the order values are unique
// sequence numbers, except at a slot that never had a candidate, where
// every row with the init order wins and writes the same zero payload.
//
// Bound: memory.  Per row and component it reads the slot, the two
// contributions and the order cell, and a winner writes one payload cell.
namespace {

constexpr int kArgsetWarps = kThreads / 32;

struct ArgsetComps {
  void* col[KSQL_MAX_COMPS];             // a_j, the payload column
  const void* contrib[KSQL_MAX_COMPS];   // contrib_j
  const void* order[KSQL_MAX_COMPS];     // a_o after the fold
  const void* ocontrib[KSQL_MAX_COMPS];  // contrib_o
  int64_t dtype[KSQL_MAX_COMPS];         // payload dtype code
  int64_t odtype[KSQL_MAX_COMPS];        // order dtype code
  int64_t count;
};

__device__ __forceinline__ int64_t elem_bytes(int64_t dtype) {
  return dtype == ksql::kInt32 ? 4 : (dtype == ksql::kInt8 ? 1 : 8);
}

// the order cell and the row's order contribution compare as their dtype
// (float64 by value: -0.0 equals +0.0, NaN equals nothing, as XLA's ==)
__device__ __forceinline__ bool order_equal(const void* contrib, int64_t i, const void* col,
                                            int64_t s, int64_t dtype) {
  if (dtype == ksql::kInt32) {
    return static_cast<const int32_t*>(contrib)[i] == static_cast<const int32_t*>(col)[s];
  }
  if (dtype == ksql::kFloat64) {
    return static_cast<const double*>(contrib)[i] == static_cast<const double*>(col)[s];
  }
  return static_cast<const int64_t*>(contrib)[i] == static_cast<const int64_t*>(col)[s];
}

__global__ void __launch_bounds__(kThreads) argset_kernel(
    ArgsetComps c, const int32_t* __restrict__ slots, int64_t n, int32_t capacity,
    int32_t* __restrict__ dump_row, unsigned* __restrict__ ticket) {
  __shared__ int32_t s_best[KSQL_MAX_COMPS][kArgsetWarps];
  __shared__ bool s_last;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t s = i < n ? slots[i] : capacity;
  for (int64_t j = 0; j < c.count; ++j) {
    int32_t lost = -1;
    if (i < n) {
      if (s != capacity && order_equal(c.ocontrib[j], i, c.order[j], s, c.odtype[j])) {
        ksql::copy_elem(c.col[j], s, c.contrib[j], i, elem_bytes(c.dtype[j]));
      } else {
        lost = static_cast<int32_t>(i);
      }
    }
    lost = __reduce_max_sync(0xffffffffu, lost);
    if (lane == 0) s_best[j][warp] = lost;
  }
  __syncthreads();
  if (threadIdx.x < c.count) {
    int32_t best = -1;
    for (int w = 0; w < kArgsetWarps; ++w) best = s_best[threadIdx.x][w] > best ? s_best[threadIdx.x][w] : best;
    if (best >= 0) atomicMax(&dump_row[threadIdx.x], best);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: every block's atomicMax is done
  __threadfence();
  if (threadIdx.x < c.count) {
    const int32_t r = atomicExch(&dump_row[threadIdx.x], -1);
    if (r >= 0) {
      ksql::copy_elem(c.col[threadIdx.x], capacity, c.contrib[threadIdx.x], r,
                      elem_bytes(c.dtype[threadIdx.x]));
    }
  }
}

}  // namespace

// comps: count x (payload column, payload contributions, order column, order
// contributions, payload dtype, order dtype); dump_row: KSQL_MAX_COMPS int32
// cells, -1 between calls; ticket: one uint32, 0 between calls (the last
// block's increment wraps it back).
extern "C" int ksql_fold_argset(const int64_t* comps, int64_t count, const void* slots,
                                int64_t n, int64_t capacity, void* dump_row, void* ticket,
                                void* stream) {
  if (count > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  ArgsetComps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[6 * j]);
    c.contrib[j] = reinterpret_cast<const void*>(comps[6 * j + 1]);
    c.order[j] = reinterpret_cast<const void*>(comps[6 * j + 2]);
    c.ocontrib[j] = reinterpret_cast<const void*>(comps[6 * j + 3]);
    c.dtype[j] = comps[6 * j + 4];
    c.odtype[j] = comps[6 * j + 5];
  }
  c.count = count;
  argset_kernel<<<ksql::blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const int32_t*>(slots), n, static_cast<int32_t>(capacity),
      static_cast<int32_t*>(dump_row), static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
