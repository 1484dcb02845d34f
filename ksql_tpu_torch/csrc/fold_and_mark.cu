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

// ---------------------------------------------------------------------------
// K3, argset mode: the arg-min/max payloads of scalar EARLIEST/LATEST_BY_OFFSET.
//
// Replaces ops/hash_store.py:scatter_combine's 'argset' branch (:552-558).
// It runs after the fold above has settled every order component.  For each
// argset component j, o the nearest order component before it, row i (every
// row, inactive ones too: their slot is the dump) is a winner when its slot s
// is not the dump and contrib_o[i] == a_o[s]; a winner writes contrib_j[i] to
// a_j[s].  Every other row is aimed at the dump slot, and the reference's
// duplicate-index .at[].set leaves the payload of the highest such row there:
// one atomicMax of the row index into the component's dump cell (scratch,
// -1 between calls), then one thread per component writes that row's payload
// to a_j[C] and resets the cell.  Real slots have no other ties: the order
// values are unique sequence numbers, except at a slot that never had a
// candidate, where every row with the init order wins and writes the same
// zero payload.
//
// Bound: memory.  Per row and component it reads the slot, the two
// contributions and the order cell, and a winner writes one payload cell.
namespace {

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

__global__ void argset_kernel(ArgsetComps c, const int32_t* __restrict__ slots, int64_t n,
                              int32_t capacity, int32_t* __restrict__ dump_row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = slots[i];
  for (int64_t j = 0; j < c.count; ++j) {
    if (s != capacity && order_equal(c.ocontrib[j], i, c.order[j], s, c.odtype[j])) {
      ksql::copy_elem(c.col[j], s, c.contrib[j], i, elem_bytes(c.dtype[j]));
    } else {
      atomicMax(&dump_row[j], static_cast<int32_t>(i));
    }
  }
}

__global__ void argset_dump_kernel(ArgsetComps c, int32_t capacity,
                                   int32_t* __restrict__ dump_row) {
  const int64_t j = threadIdx.x;
  if (j >= c.count) return;
  const int32_t r = dump_row[j];
  if (r >= 0) ksql::copy_elem(c.col[j], capacity, c.contrib[j], r, elem_bytes(c.dtype[j]));
  dump_row[j] = -1;
}

}  // namespace

// comps: count x (payload column, payload contributions, order column, order
// contributions, payload dtype, order dtype); dump_row: KSQL_MAX_COMPS int32
// cells, -1 between calls.
extern "C" int ksql_fold_argset(const int64_t* comps, int64_t count, const void* slots,
                                int64_t n, int64_t capacity, void* dump_row, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int32_t cap = static_cast<int32_t>(capacity);
  auto* cells = static_cast<int32_t*>(dump_row);
  if (n > 0) {
    argset_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
        c, static_cast<const int32_t*>(slots), n, cap, cells);
  }
  argset_dump_kernel<<<1, KSQL_MAX_COMPS, 0, st>>>(c, cap, cells);
  return static_cast<int>(cudaGetLastError());
}
