// K5 sliced_fold: fold each row into its key slot's slice-ring cell.
//
// Replaces runtime/lowering.py:_sliced_scatter (B8).  A sliced store keeps
// one slot per group key and, per aggregate component, a ring of `ring`
// slice partials ([C+1, ring], row-major); row i folds into cell
// (slot, sidx % ring), sidx = floor(wstart / width) its absolute slice.
//   launch 1, one thread per row: a live row (active, slot != C) whose cell
//     holds another slice (slice_id != sidx) is a recycled cell of an
//     earlier ring wrap and resets it to the component inits; every other
//     row writes the inits at (C, pos) instead — the reference's scatter of
//     the stale mask sends them to the dump row.  A non-live row also
//     claims ring_last[pos] = max(row) for the dump row's slice_id.
//   launch 2, one thread per row: active rows fold add/min/max into
//     (eff, pos) with the atomics of common.cuh (eff = C for an active row
//     that overflowed the store); live rows set slice_id, atomicMax slast
//     with the slice start and set dirty; the non-live row that won
//     ring_last[pos] writes its sidx into slice_id[C, pos] (XLA applies the
//     reference's unmasked duplicate scatter in row order, so the highest
//     such row's index stays there) and resets its claim to -1.
// The launches must be separate: a row resetting a cell after another row
// folded into it would erase the fold.  Rows that target one live cell
// carry the same sidx (K1's horizon cut keeps a batch's live slices within
// ring - 1 of each other), so the resets are idempotent.  Inactive rows
// carry identity contributions and skip the fold, as in K3.
//
// Bound: memory.  Per row it reads slot, wstart, active, one slice_id cell
// and J contributions, and read-modify-writes J ring cells plus slice_id,
// slast and dirty; at BASELINE #2 (n = 16,384, J = 8) about 2.5 MB (~0.8 us
// at 3.35 TB/s).  Float64 atomic adds land in no fixed order, so float sums
// agree with the plain version to rounding only.
#include "common.cuh"

namespace {

struct Comps {
  void* col[KSQL_MAX_COMPS];
  const void* contrib[KSQL_MAX_COMPS];
  int64_t kind[KSQL_MAX_COMPS];  // combine * 3 + dtype
  int64_t init_bits[KSQL_MAX_COMPS];
  int64_t count;
};

struct Row {
  int64_t sidx, pos, eff;
  bool act, live;
};

__device__ __forceinline__ Row row_of(int64_t i, const int32_t* slots,
                                      const int64_t* wstart, const bool* active,
                                      int64_t capacity, int64_t ring,
                                      int64_t width) {
  Row r;
  r.sidx = ksql::floor_div(wstart[i], width);
  r.pos = ksql::floor_mod(r.sidx, ring);
  r.act = active[i];
  const int64_t slot = slots[i];
  r.eff = r.act ? slot : capacity;
  r.live = r.act && slot != capacity;
  return r;
}

__global__ void slice_reset_kernel(Comps c, const int32_t* __restrict__ slots,
                                   const int64_t* __restrict__ wstart,
                                   const bool* __restrict__ active, int64_t n,
                                   int64_t capacity, int64_t ring, int64_t width,
                                   const int64_t* __restrict__ slice_id,
                                   int32_t* __restrict__ ring_last) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Row r = row_of(i, slots, wstart, active, capacity, ring, width);
  const bool stale = r.live && slice_id[r.eff * ring + r.pos] != r.sidx;
  const int64_t cell = (stale ? r.eff : capacity) * ring + r.pos;
  for (int64_t j = 0; j < c.count; ++j) {
    ksql::store_init(c.col[j], cell, c.kind[j] % 3, c.init_bits[j]);
  }
  if (!r.live) atomicMax(&ring_last[r.pos], static_cast<int32_t>(i));
}

__global__ void slice_fold_kernel(Comps c, const int32_t* __restrict__ slots,
                                  const int64_t* __restrict__ wstart,
                                  const bool* __restrict__ active, int64_t n,
                                  int64_t capacity, int64_t ring, int64_t width,
                                  int64_t* __restrict__ slice_id,
                                  int64_t* __restrict__ slast,
                                  bool* __restrict__ dirty,
                                  int32_t* __restrict__ ring_last) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) dirty[capacity] = false;
  if (i >= n) return;
  const Row r = row_of(i, slots, wstart, active, capacity, ring, width);
  const int64_t cell = r.eff * ring + r.pos;
  if (r.act) {
    for (int64_t j = 0; j < c.count; ++j) {
      ksql::atomic_fold(c.col[j], cell, c.contrib[j], i, c.kind[j]);
    }
  }
  if (r.live) {
    slice_id[cell] = r.sidx;
    atomicMax(reinterpret_cast<long long*>(&slast[r.eff]),
              static_cast<long long>(wstart[i]));
    dirty[r.eff] = true;
  } else if (ring_last[r.pos] == static_cast<int32_t>(i)) {
    slice_id[capacity * ring + r.pos] = r.sidx;
    ring_last[r.pos] = -1;  // only the claim's winner resets it
  }
}

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = ksql::blocks_for(n, threads);
  slice_reset_kernel<<<blocks, threads, 0, st>>>(
      c, static_cast<const int32_t*>(slots), static_cast<const int64_t*>(wstart),
      static_cast<const bool*>(active), n, capacity, ring, width,
      static_cast<const int64_t*>(slice_id), static_cast<int32_t*>(ring_last));
  slice_fold_kernel<<<blocks, threads, 0, st>>>(
      c, static_cast<const int32_t*>(slots), static_cast<const int64_t*>(wstart),
      static_cast<const bool*>(active), n, capacity, ring, width,
      static_cast<int64_t*>(slice_id), static_cast<int64_t*>(slast),
      static_cast<bool*>(dirty), static_cast<int32_t*>(ring_last));
  return static_cast<int>(cudaGetLastError());
}
