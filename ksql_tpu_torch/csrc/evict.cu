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
// Bound: memory.  It reads occ (1 byte a slot) and an occupied slot's
// start (8), and writes only the expired slots' cells: 3 flag bytes, born,
// emitted and hpass where kept, and each component's row (times the ring
// when sliced: 8 + 56 bytes a ring cell at BASELINE #2's layout, ~6.5 KB a
// slot; ~18 KB a slot of pv_vectors' width-K rows).  So a wide store's pass
// is bound by the rows it writes.  One launch, of one of two kernels:
//   evict_kernel, a store without rows (one cell a slot in every column): a
//     thread a slot, coalesced on the slot columns;
//   evict_rows_kernel, a store with rows: a warp owns kSlots consecutive
//     slots; each lane tests its slot and writes its flags and one-cell
//     columns, and a ballot of the expired lanes cuts them into runs of
//     consecutive slots, whose rows are one contiguous range per component:
//     the whole warp stores each range with 16-byte stores of the init
//     pattern (element stores at its unaligned ends), 512 bytes a warp
//     store.  No thread writes a row alone.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 2;  // the slots a warp tests, one a lane (more warps in flight)

struct Comps {
  void* col[KSQL_MAX_COMPS];
  int64_t dtype[KSQL_MAX_COMPS];
  int64_t init_bits[KSQL_MAX_COMPS];  // the init value's bit pattern
  int64_t width[KSQL_MAX_COMPS];      // cells per slot (ring or vector width)
  int64_t count;
};

__device__ __forceinline__ int64_t elem_size(int64_t dtype) {
  return dtype == ksql::kInt32 ? 4 : dtype == ksql::kInt8 ? 1 : 8;
}

// Cells [first, first + cells) of `col` (elements of `dtype`) set to the
// init bits by the whole warp: element stores up to the first 16-byte
// boundary and after the last, 16-byte stores of the repeated pattern
// between them.
__device__ void fill_range(void* col, int64_t dtype, int64_t bits, int64_t first, int64_t cells,
                           int lane) {
  const int64_t es = elem_size(dtype);
  char* const base = static_cast<char*>(col);
  const uint64_t start = reinterpret_cast<uint64_t>(base) + static_cast<uint64_t>(first * es);
  const uint64_t end = start + static_cast<uint64_t>(cells * es);
  uint64_t a16 = (start + 15) & ~static_cast<uint64_t>(15);
  if (a16 > end) a16 = end;
  uint64_t e16 = end & ~static_cast<uint64_t>(15);
  if (e16 < a16) e16 = a16;
  const int64_t head = static_cast<int64_t>(a16 - start) / es;
  for (int64_t p = lane; p < head; p += 32) ksql::store_init(col, first + p, dtype, bits);
  uint64_t p8 = static_cast<uint64_t>(bits);
  if (es == 4) {
    p8 = (p8 & 0xffffffffull) * 0x0000000100000001ull;
  } else if (es == 1) {
    p8 = (p8 & 0xffull) * 0x0101010101010101ull;
  }
  const uint4 v = make_uint4(static_cast<unsigned>(p8), static_cast<unsigned>(p8 >> 32),
                             static_cast<unsigned>(p8), static_cast<unsigned>(p8 >> 32));
  for (uint64_t a = a16 + 16 * static_cast<uint64_t>(lane); a < e16; a += 16 * 32) {
    *reinterpret_cast<uint4*>(a) = v;
  }
  const int64_t tail0 = first + static_cast<int64_t>(e16 - start) / es;
  for (int64_t p = tail0 + lane; p < first + cells; p += 32) ksql::store_init(col, p, dtype, bits);
}

// Slot s expired: its flags and its cells of the one-cell components.
__device__ __forceinline__ void expire_slot(const Comps& c, int64_t s, bool* occ, bool* grave, bool* dirty,
                                            int64_t* slast, int64_t ring, bool* hpass, int64_t* born,
                                            bool* emitted) {
  occ[s] = false;
  grave[s] = true;
  dirty[s] = false;
  if (hpass != nullptr) hpass[s] = false;
  if (born != nullptr) {
    born[s] = INT64_MAX;
    emitted[s] = false;
  }
  if (ring > 0) slast[s] = -(1LL << 62);
  for (int64_t j = 0; j < c.count; ++j) {
    if (c.width[j] == 1) ksql::store_init(c.col[j], s, c.dtype[j], c.init_bits[j]);
  }
}

__device__ __forceinline__ bool is_expired(int64_t s, int64_t slots, const bool* occ, const bool* dirty,
                                           const int64_t* wstart, const int64_t* slast, int64_t ring,
                                           const int64_t* max_ts, int64_t retention, int64_t suppress) {
  if (s >= slots || !occ[s]) return false;
  const int64_t start = ring > 0 ? slast[s] : wstart[s];
  return ksql::wadd(start, retention) < *max_ts && !(suppress && dirty[s]);
}

// A store without rows (one cell a slot in every column): a thread a slot.
__global__ void __launch_bounds__(kThreads) evict_kernel(
    Comps c, bool* __restrict__ occ, bool* __restrict__ grave, bool* __restrict__ dirty,
    const int64_t* __restrict__ wstart, const int64_t* __restrict__ max_ts, int64_t retention,
    int64_t slots, int64_t suppress, bool* __restrict__ hpass, int64_t* __restrict__ born,
    bool* __restrict__ emitted) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (!is_expired(s, slots, occ, dirty, wstart, nullptr, 0, max_ts, retention, suppress)) return;
  expire_slot(c, s, occ, grave, dirty, nullptr, 0, hpass, born, emitted);
}

// A store with rows: a warp tests kSlots consecutive slots, one a lane,
// and writes its expired slots' rows, a run of consecutive expired slots as
// one range a component.
__global__ void __launch_bounds__(kThreads) evict_rows_kernel(
    Comps c, bool* __restrict__ occ, bool* __restrict__ grave, bool* __restrict__ dirty,
    const int64_t* __restrict__ wstart, int64_t* __restrict__ slast,
    int64_t* __restrict__ slice_id, int64_t ring, const int64_t* __restrict__ max_ts,
    int64_t retention, int64_t slots, int64_t suppress, bool* __restrict__ hpass,
    int64_t* __restrict__ born, bool* __restrict__ emitted) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) * kSlots;
  const int64_t s = warp0 + lane;
  const bool expired = lane < kSlots && is_expired(s, slots, occ, dirty, wstart, slast, ring, max_ts,
                                                   retention, suppress);
  const unsigned mask = __ballot_sync(0xffffffffu, expired);
  if (mask == 0u) return;  // the whole warp
  if (expired) expire_slot(c, s, occ, grave, dirty, slast, ring, hpass, born, emitted);
  for (unsigned m = mask; m != 0u;) {
    const int a = __ffs(m) - 1;
    const unsigned rest = ~(m >> a);
    const int len = rest == 0u ? 32 - a : __ffs(rest) - 1;
    const int64_t first = warp0 + a;
    if (ring > 0) fill_range(slice_id, ksql::kInt64, -1, first * ring, len * ring, lane);
    for (int64_t j = 0; j < c.count; ++j) {
      const int64_t w = c.width[j];
      if (w > 1) fill_range(c.col[j], c.dtype[j], c.init_bits[j], first * w, len * w, lane);
    }
    m = a + len >= 32 ? 0u : m & ~((1u << (a + len)) - 1u);
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
  bool rows = ring > 0;
  for (int64_t j = 0; j < count; ++j) rows = rows || c.width[j] > 1;
  const int64_t slots = capacity + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows) {
    evict_rows_kernel<<<ksql::blocks_for(slots, kThreads / 32 * kSlots), kThreads, 0, st>>>(
        c, static_cast<bool*>(occ), static_cast<bool*>(grave), static_cast<bool*>(dirty),
        static_cast<const int64_t*>(wstart), static_cast<int64_t*>(slast), static_cast<int64_t*>(slice_id),
        ring, static_cast<const int64_t*>(max_ts), retention, slots, suppress, static_cast<bool*>(hpass),
        static_cast<int64_t*>(born), static_cast<bool*>(emitted));
  } else {
    evict_kernel<<<ksql::blocks_for(slots, kThreads), kThreads, 0, st>>>(
        c, static_cast<bool*>(occ), static_cast<bool*>(grave), static_cast<bool*>(dirty),
        static_cast<const int64_t*>(wstart), static_cast<const int64_t*>(max_ts), retention, slots, suppress,
        static_cast<bool*>(hpass), static_cast<int64_t*>(born), static_cast<bool*>(emitted));
  }
  return static_cast<int>(cudaGetLastError());
}
