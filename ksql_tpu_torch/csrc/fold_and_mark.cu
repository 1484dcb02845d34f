// K3 fold_and_mark: fold per-row aggregate contributions into their slots,
// mark the slots dirty, and pick one representative row per touched slot.
//
// Replaces ops/hash_store.py:scatter_combine (B3: the add/min/max branches
// plus the `dirty` marking) and ops/hash_store.py:winners_per_slot (B4).
// Phase 1, one thread per active row: fold each component with an atomic
// (common.cuh atomic_fold: int64 add as unsigned long long, which wraps like
// two's complement; int32/int64 min/max with the native atomics; float64 add
// with atomicAdd(double*); float64 min/max with a CAS loop that keeps XLA's
// semantics — NaN wins, -0.0 is below +0.0 — which fmin/fmax would not);
// then dirty[slot] and atomicMin(first[slot], row).  Phase 2: a row wins
// iff first[slot] is its own index; the winner resets first[slot]
// (INT32_MAX when clean), and dirty[C] is cleared.  Inactive rows carry identity contributions (every
// device_aggs contrib masks them), so skipping them leaves the dump slot
// exactly as the reference's full scatter does.
//
// Bound: memory.  Per row it reads the slot, the mask and J contributions,
// and read-modify-writes J store cells; float64 atomic adds land in a
// different order each run, so float sums agree with the plain version to
// rounding only (the chip check uses rtol 1e-12).
#include "common.cuh"

namespace {

struct Comps {
  void* col[KSQL_MAX_COMPS];
  const void* contrib[KSQL_MAX_COMPS];
  int64_t kind[KSQL_MAX_COMPS];  // combine * 3 + dtype
  int64_t count;
};

__global__ void fold_kernel(Comps c, const int32_t* __restrict__ slots,
                            const bool* __restrict__ active, int64_t n,
                            int32_t capacity, bool* __restrict__ dirty,
                            int32_t* __restrict__ first) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !active[i]) return;
  const int32_t s = slots[i];
  for (int64_t j = 0; j < c.count; ++j) {
    ksql::atomic_fold(c.col[j], s, c.contrib[j], i, c.kind[j]);
  }
  if (s != capacity) {
    dirty[s] = true;
    atomicMin(&first[s], static_cast<int32_t>(i));
  }
}

__global__ void winners_kernel(const int32_t* __restrict__ slots,
                               const bool* __restrict__ active, int64_t n,
                               int32_t capacity, bool* __restrict__ dirty,
                               int32_t* __restrict__ first,
                               bool* __restrict__ winners) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) dirty[capacity] = false;
  if (i >= n) return;
  const int32_t s = slots[i];
  bool win = false;
  if (active[i] && s != capacity && first[s] == static_cast<int32_t>(i)) {
    win = true;
    first[s] = INT32_MAX;  // only the winner resets its cell
  }
  winners[i] = win;
}

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = ksql::blocks_for(n, threads);
  const int32_t cap = static_cast<int32_t>(capacity);
  fold_kernel<<<blocks, threads, 0, st>>>(
      c, static_cast<const int32_t*>(slots), static_cast<const bool*>(active),
      n, cap, static_cast<bool*>(dirty), static_cast<int32_t*>(first));
  winners_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const int32_t*>(slots), static_cast<const bool*>(active), n,
      cap, static_cast<bool*>(dirty), static_cast<int32_t*>(first),
      static_cast<bool*>(winners));
  return static_cast<int>(cudaGetLastError());
}
