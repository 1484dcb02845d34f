// K16 session_write: the store rewrite and the emission lanes of the
// session step.
//
// Replaces the rest of runtime/lowering.py:post_session_exchange (B16):
// the deletes before its probe_insert, the .at[tgt_ins].set writes, dirty,
// max_ts and the 2m emission lanes.  Two entry points:
//   delete (one thread per sorted item), before K2: an alive stored-session
//     item (not a row) turns its slot into a grave (occ false, grave true),
//     so that K2 reclaims the slot when the merged set puts the same
//     (khash, rank) back; thread 0 clears occ and grave of the dump slot C
//     (no alive stored item sits there: it was found);
//   write, after K2: one thread per sorted item p, one launch.  An
//     inserting item (ins_act) writes its segment's start, end and
//     components (read at the segment's first position segfirst[p]) at its
//     K2 slot, and sets dirty there; the inserting items have distinct
//     slots.  Every other item targets C, and XLA applies duplicate
//     .at[C].set updates in order, so the highest such item is the one
//     that stays.  A warp finds its highest one from a ballot (the highest
//     set lane), a block from its warps' in shared memory, and each block
//     publishes that one value; the last block to finish (a wrapping
//     atomicInc ticket after a __threadfence) folds the blocks' values,
//     writes that item's values into C, clears dirty[C] and folds the
//     batch's max ts (scal[1]) into max_ts.  No same-address atomic an
//     item, no memset, no second launch.
//     The same threads write lanes p (part A: the item as the stored
//     session it was, a tombstone when it was deleted and its segment
//     holds a row) and m + p (part B: its segment, emitted at the
//     segment's winner when the segment holds a row): mask, key reprs,
//     raw components, WINDOWSTART/END, tombstone, and the emission order
//     ord_a (the segment's lowest row, 0 if none) / ord_b (part A's start,
//     then INT64_MAX).
//
// Bound: bytes.  The write mode reads ~70 bytes and writes ~80 bytes of
// lanes an item at one key and two int64 components (~59 MB at 270,336
// items: ~18 us at 3.35 TB/s); the store writes are one slot per merged
// session.  Coalesced per-item reads and lane writes; the segment reads go
// through segfirst, which is mostly the item's own position or a near one.
// The dump item is one ballot a warp and one word a block: a same-address
// atomic an item would serialise ~267,000 of phase 2w's 270,336 items in
// one L2 slice (PERF.md).
#include "common.cuh"

namespace {

struct WriteCols {
  const int64_t* reprs[KSQL_MAX_KEYS];      // sorted item key reprs
  const int64_t* seg_reprs[KSQL_MAX_KEYS];  // segment key reprs
  int64_t* key_lane[KSQL_MAX_KEYS];         // 2m
  void* col[KSQL_MAX_COMPS];                // store a<j>
  const void* comp[KSQL_MAX_COMPS];         // sorted item components
  const void* seg[KSQL_MAX_COMPS];          // segment folds
  void* comp_lane[KSQL_MAX_COMPS];          // 2m
  int64_t size[KSQL_MAX_COMPS];
};

struct WriteIn {
  const int32_t* ins_slots;
  const int64_t *start, *end;
  const bool *alive, *isrow;
  const int32_t* segfirst;
  const bool *winner, *ins_act;
  const int64_t *seg_start, *seg_end;
  const bool* seg_has_row;
  const int64_t* seg_minrow;
};

struct Lanes {
  bool* mask;
  int64_t *ws, *we;
  bool* tombstone;
  int64_t *ord_a, *ord_b;
};

__global__ void delete_kernel(bool* __restrict__ occ, bool* __restrict__ grave, int64_t capacity,
                              const int32_t* __restrict__ slot, const bool* __restrict__ isrow,
                              const bool* __restrict__ alive, int64_t m) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p == 0) {
    occ[capacity] = false;
    grave[capacity] = false;
  }
  if (p >= m || isrow[p] || !alive[p]) return;
  const int32_t s = slot[p];
  occ[s] = false;
  grave[s] = true;
}

constexpr int kWriteThreads = 256;
constexpr int kWriteWarps = kWriteThreads / 32;

template <bool kAll8>
__device__ __forceinline__ void copy_comp(void* dst, int64_t di, const void* src, int64_t si,
                                          int64_t size) {
  if (kAll8) {
    static_cast<int64_t*>(dst)[di] = static_cast<const int64_t*>(src)[si];
  } else {
    ksql::copy_elem(dst, di, src, si, size);
  }
}

// kAll8: every component is 8 bytes wide (the element size leaves the
// inner loops).  `last` holds a done count, then one int a block: its
// highest item aimed at the dump slot, or -1.
template <bool kAll8>
__global__ void __launch_bounds__(kWriteThreads) write_kernel(
    int64_t* __restrict__ sess_start, int64_t* __restrict__ sess_end, bool* __restrict__ dirty,
    int64_t* __restrict__ max_ts, int64_t capacity, WriteCols c, int64_t k, int64_t ncomp,
    int64_t m, WriteIn in, const int64_t* __restrict__ scal, int32_t* last, Lanes out) {
  __shared__ int s_best[kWriteWarps];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWriteThreads + threadIdx.x;
  bool dump = false;
  if (p < m) {
    const int32_t sf = in.segfirst[p];
    const int64_t tgt = in.ins_act[p] ? in.ins_slots[p] : capacity;
    if (tgt != capacity) {
      sess_start[tgt] = in.seg_start[sf];
      sess_end[tgt] = in.seg_end[sf];
      for (int64_t j = 0; j < ncomp; ++j) copy_comp<kAll8>(c.col[j], tgt, c.seg[j], sf, c.size[j]);
      dirty[tgt] = true;
    } else {
      dump = true;
    }
    const int64_t q = m + p;
    const bool has_row = in.seg_has_row[sf];
    const int64_t start = in.start[p];
    out.mask[p] = !in.isrow[p] && in.alive[p] && has_row;
    out.mask[q] = in.winner[p] && has_row;
    for (int64_t r = 0; r < k; ++r) {
      c.key_lane[r][p] = c.reprs[r][p];
      c.key_lane[r][q] = c.seg_reprs[r][sf];
    }
    for (int64_t j = 0; j < ncomp; ++j) {
      copy_comp<kAll8>(c.comp_lane[j], p, c.comp[j], p, c.size[j]);
      copy_comp<kAll8>(c.comp_lane[j], q, c.seg[j], sf, c.size[j]);
    }
    out.ws[p] = start;
    out.ws[q] = in.seg_start[sf];
    out.we[p] = in.end[p];
    out.we[q] = in.seg_end[sf];
    out.tombstone[p] = true;
    out.tombstone[q] = false;
    const int64_t minrow = in.seg_minrow[sf];
    const int64_t ord = minrow == INT64_MAX ? 0 : minrow;
    out.ord_a[p] = ord;
    out.ord_a[q] = ord;
    out.ord_b[p] = start;
    out.ord_b[q] = INT64_MAX;
  }
  // the block's highest item aimed at the dump slot: the highest set lane
  // of each warp's ballot, then the warps' maximum
  const unsigned b = __ballot_sync(0xffffffffu, dump);
  if (lane == 0) s_best[warp] = b ? static_cast<int>(p) + 31 - __clz(b) : -1;
  __syncthreads();
  if (warp == 0) {
    const int best = __reduce_max_sync(0xffffffffu, lane < kWriteWarps ? s_best[lane] : -1);
    if (lane == 0) {
      last[1 + blockIdx.x] = best;
      __threadfence();
      s_last = atomicInc(reinterpret_cast<unsigned*>(last), gridDim.x - 1) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every other block's value is published
  __threadfence();
  int best = -1;
  for (int64_t i = threadIdx.x; i < gridDim.x; i += kWriteThreads) {
    const int v = __ldcg(&last[1 + i]);
    best = v > best ? v : best;
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int d = __reduce_max_sync(0xffffffffu, lane < kWriteWarps ? s_best[lane] : -1);
    if (d >= 0) {
      const int32_t sf = in.segfirst[d];
      for (int64_t j = lane; j < ncomp; j += 32) {
        copy_comp<kAll8>(c.col[j], capacity, c.seg[j], sf, c.size[j]);
      }
      if (lane == 0) {
        sess_start[capacity] = in.seg_start[sf];
        sess_end[capacity] = in.seg_end[sf];
      }
    }
    if (lane == 0) {
      dirty[capacity] = false;
      if (scal[1] > *max_ts) *max_ts = scal[1];
    }
  }
}

}  // namespace

extern "C" int ksql_session_delete(void* occ, void* grave, int64_t capacity, const void* slot,
                                   const void* isrow, const void* alive, int64_t m, void* stream) {
  const int threads = 256;
  delete_kernel<<<ksql::blocks_for(m, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bool*>(occ), static_cast<bool*>(grave), capacity,
      static_cast<const int32_t*>(slot), static_cast<const bool*>(isrow),
      static_cast<const bool*>(alive), m);
  return static_cast<int>(cudaGetLastError());
}

// keys: k x (sorted reprs, segment reprs, lane); comps: ncomp x (store
// a<j>, sorted component, segment fold, lane, element bytes); scratch:
// 1 + scratch_blocks int32, zeroed when allocated (the done count wraps
// back to 0 in every call; a block's word is written before it is read).
extern "C" int ksql_session_write(
    void* sess_start, void* sess_end, void* dirty, void* max_ts, int64_t capacity,
    const int64_t* keys, int64_t k, const int64_t* comps, int64_t ncomp, int64_t m,
    const void* ins_slots, const void* start, const void* end, const void* alive,
    const void* isrow, const void* segfirst, const void* winner, const void* ins_act,
    const void* seg_start, const void* seg_end, const void* seg_has_row, const void* seg_minrow,
    const void* scal, void* scratch, int64_t scratch_blocks, void* mask, void* ws, void* we,
    void* tombstone, void* ord_a, void* ord_b, void* stream) {
  const int blocks = ksql::blocks_for(m, kWriteThreads);
  if (k > KSQL_MAX_KEYS || ncomp > KSQL_MAX_COMPS || m < 1 || blocks > scratch_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WriteCols c{};
  for (int64_t r = 0; r < k; ++r) {
    c.reprs[r] = reinterpret_cast<const int64_t*>(keys[3 * r]);
    c.seg_reprs[r] = reinterpret_cast<const int64_t*>(keys[3 * r + 1]);
    c.key_lane[r] = reinterpret_cast<int64_t*>(keys[3 * r + 2]);
  }
  for (int64_t j = 0; j < ncomp; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[5 * j]);
    c.comp[j] = reinterpret_cast<const void*>(comps[5 * j + 1]);
    c.seg[j] = reinterpret_cast<const void*>(comps[5 * j + 2]);
    c.comp_lane[j] = reinterpret_cast<void*>(comps[5 * j + 3]);
    c.size[j] = comps[5 * j + 4];
  }
  WriteIn in{static_cast<const int32_t*>(ins_slots), static_cast<const int64_t*>(start),
             static_cast<const int64_t*>(end), static_cast<const bool*>(alive),
             static_cast<const bool*>(isrow), static_cast<const int32_t*>(segfirst),
             static_cast<const bool*>(winner), static_cast<const bool*>(ins_act),
             static_cast<const int64_t*>(seg_start), static_cast<const int64_t*>(seg_end),
             static_cast<const bool*>(seg_has_row), static_cast<const int64_t*>(seg_minrow)};
  Lanes out{static_cast<bool*>(mask), static_cast<int64_t*>(ws), static_cast<int64_t*>(we),
            static_cast<bool*>(tombstone), static_cast<int64_t*>(ord_a),
            static_cast<int64_t*>(ord_b)};
  bool all8 = true;
  for (int64_t j = 0; j < ncomp; ++j) all8 = all8 && c.size[j] == 8;
  auto* kernel = all8 ? &write_kernel<true> : &write_kernel<false>;
  kernel<<<blocks, kWriteThreads, 0, st>>>(
      static_cast<int64_t*>(sess_start), static_cast<int64_t*>(sess_end),
      static_cast<bool*>(dirty), static_cast<int64_t*>(max_ts), capacity, c, k, ncomp, m, in,
      static_cast<const int64_t*>(scal), static_cast<int32_t*>(scratch), out);
  return static_cast<int>(cudaGetLastError());
}
