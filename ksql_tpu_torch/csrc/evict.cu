// K4 evict: the windowed store's retention pass.
//
// Replaces runtime/lowering.py:_trace_evict (B7).  A windowed slot whose
// window start plus retention is below the stream time (read from device
// memory) is expired: occ off, grave on, dirty off, and every aggregate
// component reset to its init value.  Under EMIT FINAL (suppress) a slot
// that is still dirty (its window has not emitted its final result) is
// kept until a flush, and an expired slot's born resets to INT64_MAX and
// its emitted bit to false; under HAVING retraction an expired slot's
// hpass verdict clears (hpass, born and emitted may be null).  On a
// sliced store (ring > 0: one slot per group key, a ring of slice partials
// per component) a slot expires once its newest slice start `slast` left
// the retention; its `slast` resets to -2^62, its `slice_id` row to -1 and
// every ring cell of every component to its init.  A component of width K
// (the slice ring, or a vector aggregate's K elements, ops/vector.py)
// resets all K cells of the slot's row.  The pass runs every 64 batches and
// when the store passes its load threshold.
//
// Bound: memory.  One elementwise pass over C+1 slots: it reads occ and
// wstart (or slast), 9 bytes a slot, and writes only the expired slots'
// cells, so at C = 2^20 the floor is about 9.4 MB (~2.8 us at 3.35 TB/s)
// plus 3 + the component bytes per expired slot (times the ring when
// sliced: 8 + 56 bytes per ring cell at BASELINE #2's layout).  One thread
// per slot, coalesced on the slot columns; an expired sliced slot's thread
// writes its ring rows alone (contiguous, one slot's row per component).
#include "common.cuh"

namespace {

struct Comps {
  void* col[KSQL_MAX_COMPS];
  int64_t dtype[KSQL_MAX_COMPS];
  int64_t init_bits[KSQL_MAX_COMPS];  // the init value's bit pattern
  int64_t width[KSQL_MAX_COMPS];      // cells per slot (ring or vector width)
  int64_t count;
};

__global__ void evict_kernel(Comps c, bool* __restrict__ occ,
                             bool* __restrict__ grave, bool* __restrict__ dirty,
                             const int64_t* __restrict__ wstart,
                             int64_t* __restrict__ slast,
                             int64_t* __restrict__ slice_id, int64_t ring,
                             const int64_t* __restrict__ max_ts,
                             int64_t retention, int64_t slots, int64_t suppress,
                             bool* __restrict__ hpass, int64_t* __restrict__ born,
                             bool* __restrict__ emitted) {
  int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= slots || !occ[s]) return;
  const int64_t start = ring > 0 ? slast[s] : wstart[s];
  if (!(ksql::wadd(start, retention) < *max_ts)) return;
  if (suppress && dirty[s]) return;
  occ[s] = false;
  grave[s] = true;
  dirty[s] = false;
  if (hpass != nullptr) hpass[s] = false;
  if (born != nullptr) {
    born[s] = INT64_MAX;
    emitted[s] = false;
  }
  if (ring > 0) {
    slast[s] = -(1LL << 62);
    for (int64_t p = 0; p < ring; ++p) slice_id[s * ring + p] = -1;
  }
  for (int64_t j = 0; j < c.count; ++j) {
    const int64_t cells = c.width[j];
    for (int64_t p = 0; p < cells; ++p) {
      ksql::store_init(c.col[j], s * cells + p, c.dtype[j], c.init_bits[j]);
    }
  }
}

}  // namespace

extern "C" int ksql_evict(const int64_t* comps, int64_t count, void* occ,
                          void* grave, void* dirty, const void* wstart,
                          void* slast, void* slice_id, int64_t ring,
                          const void* max_ts, int64_t retention,
                          int64_t capacity, int64_t suppress, void* hpass,
                          void* born, void* emitted, void* stream) {
  if (count > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  Comps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[4 * j]);
    c.dtype[j] = comps[4 * j + 1];
    c.init_bits[j] = comps[4 * j + 2];
    c.width[j] = comps[4 * j + 3];
  }
  c.count = count;
  const int64_t slots = capacity + 1;
  const int threads = 256;
  evict_kernel<<<ksql::blocks_for(slots, threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<bool*>(occ), static_cast<bool*>(grave),
      static_cast<bool*>(dirty), static_cast<const int64_t*>(wstart),
      static_cast<int64_t*>(slast), static_cast<int64_t*>(slice_id), ring,
      static_cast<const int64_t*>(max_ts), retention, slots, suppress,
      static_cast<bool*>(hpass), static_cast<int64_t*>(born),
      static_cast<bool*>(emitted));
  return static_cast<int>(cudaGetLastError());
}
