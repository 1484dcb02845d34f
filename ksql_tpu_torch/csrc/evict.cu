// K4 evict: the windowed store's retention pass.
//
// Replaces runtime/lowering.py:_trace_evict (B7), its non-sliced,
// non-suppress branch: a slot whose window start plus retention is below
// the stream time (read from device memory) is expired — occ off, grave on,
// dirty off, and every aggregate component reset to its init value.  The
// pass runs every 64 batches and when the store passes its load threshold.
//
// Bound: memory.  One elementwise pass over C+1 slots: it reads occ and
// wstart (9 bytes a slot) and writes only the expired slots' cells, so at
// C = 2^20 the floor is about 9.4 MB (~2.8 us at 3.35 TB/s) plus 3 + the
// component bytes per expired slot.  One thread per slot, coalesced.
#include "common.cuh"

namespace {

struct Comps {
  void* col[KSQL_MAX_COMPS];
  int64_t dtype[KSQL_MAX_COMPS];
  int64_t init_bits[KSQL_MAX_COMPS];  // the init value's bit pattern
  int64_t count;
};

__global__ void evict_kernel(Comps c, bool* __restrict__ occ,
                             bool* __restrict__ grave, bool* __restrict__ dirty,
                             const int64_t* __restrict__ wstart,
                             const int64_t* __restrict__ max_ts,
                             int64_t retention, int64_t slots) {
  int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= slots || !occ[s]) return;
  const int64_t horizon = static_cast<int64_t>(
      static_cast<uint64_t>(wstart[s]) + static_cast<uint64_t>(retention));
  if (!(horizon < *max_ts)) return;
  occ[s] = false;
  grave[s] = true;
  dirty[s] = false;
  for (int64_t j = 0; j < c.count; ++j) {
    if (c.dtype[j] == ksql::kInt32) {
      static_cast<int32_t*>(c.col[j])[s] = static_cast<int32_t>(c.init_bits[j]);
    } else {
      static_cast<int64_t*>(c.col[j])[s] = c.init_bits[j];  // int64 / float64 bits
    }
  }
}

}  // namespace

extern "C" int ksql_evict(const int64_t* comps, int64_t count, void* occ,
                          void* grave, void* dirty, const void* wstart,
                          const void* max_ts, int64_t retention,
                          int64_t capacity, void* stream) {
  if (count > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  Comps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[3 * j]);
    c.dtype[j] = comps[3 * j + 1];
    c.init_bits[j] = comps[3 * j + 2];
  }
  c.count = count;
  const int64_t slots = capacity + 1;
  const int threads = 256;
  evict_kernel<<<ksql::blocks_for(slots, threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<bool*>(occ), static_cast<bool*>(grave),
      static_cast<bool*>(dirty), static_cast<const int64_t*>(wstart),
      static_cast<const int64_t*>(max_ts), retention, slots);
  return static_cast<int>(cudaGetLastError());
}
