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
//   write, after K2: one thread per sorted item p.  An inserting item
//     (ins_act) writes its segment's start, end and components (read at
//     the segment's first position segfirst[p]) at its K2 slot, and sets
//     dirty there; the inserting items have distinct slots.  Every other
//     item targets C, and XLA applies duplicate .at[C].set updates in
//     order, so the highest such item is the one that stays: it is found
//     with one atomicMax, and a one-thread launch then writes its values
//     into C, clears dirty[C] and folds the batch's max ts into max_ts.
//     The same threads write lanes p (part A: the item as the stored
//     session it was, a tombstone when it was deleted and its segment
//     holds a row) and m + p (part B: its segment, emitted at the
//     segment's winner when the segment holds a row): mask, key reprs,
//     raw components, WINDOWSTART/END, tombstone, and the emission order
//     ord_a (the segment's lowest row, 0 if none) / ord_b (part A's start,
//     then INT64_MAX).
//
// Bound: bytes.  The write mode reads ~70 bytes and writes ~80 bytes of
// lanes an item at one key and two int64 components (~80 MB at 532,480
// items: ~24 us at 3.35 TB/s); the store writes are one slot per merged
// session.  Coalesced per-item reads and lane writes; the segment reads go
// through segfirst, which is mostly the item's own position or a near one.
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

__global__ void write_kernel(int64_t* __restrict__ sess_start, int64_t* __restrict__ sess_end,
                             bool* __restrict__ dirty, int64_t capacity, WriteCols c, int64_t k,
                             int64_t ncomp, int64_t m, WriteIn in, long long* __restrict__ dump_item,
                             Lanes out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= m) return;
  const int32_t sf = in.segfirst[p];
  const int64_t tgt = in.ins_act[p] ? in.ins_slots[p] : capacity;
  if (tgt != capacity) {
    sess_start[tgt] = in.seg_start[sf];
    sess_end[tgt] = in.seg_end[sf];
    for (int64_t j = 0; j < ncomp; ++j) ksql::copy_elem(c.col[j], tgt, c.seg[j], sf, c.size[j]);
    dirty[tgt] = true;
  } else {
    atomicMax(dump_item, static_cast<long long>(p));
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
    ksql::copy_elem(c.comp_lane[j], p, c.comp[j], p, c.size[j]);
    ksql::copy_elem(c.comp_lane[j], q, c.seg[j], sf, c.size[j]);
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

__global__ void dump_kernel(int64_t* __restrict__ sess_start, int64_t* __restrict__ sess_end,
                            bool* __restrict__ dirty, int64_t* __restrict__ max_ts,
                            int64_t capacity, WriteCols c, int64_t ncomp, WriteIn in,
                            const int64_t* __restrict__ scal,
                            const long long* __restrict__ dump_item) {
  const long long d = *dump_item;
  if (d >= 0) {
    const int32_t sf = in.segfirst[d];
    sess_start[capacity] = in.seg_start[sf];
    sess_end[capacity] = in.seg_end[sf];
    for (int64_t j = 0; j < ncomp; ++j) ksql::copy_elem(c.col[j], capacity, c.seg[j], sf, c.size[j]);
  }
  dirty[capacity] = false;
  if (scal[1] > *max_ts) *max_ts = scal[1];
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
// a<j>, sorted component, segment fold, lane, element bytes); scratch: one
// int64 (the highest item that targets the dump slot).
extern "C" int ksql_session_write(
    void* sess_start, void* sess_end, void* dirty, void* max_ts, int64_t capacity,
    const int64_t* keys, int64_t k, const int64_t* comps, int64_t ncomp, int64_t m,
    const void* ins_slots, const void* start, const void* end, const void* alive,
    const void* isrow, const void* segfirst, const void* winner, const void* ins_act,
    const void* seg_start, const void* seg_end, const void* seg_has_row, const void* seg_minrow,
    const void* scal, void* scratch, void* mask, void* ws, void* we, void* tombstone, void* ord_a,
    void* ord_b, void* stream) {
  if (k > KSQL_MAX_KEYS || ncomp > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
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
  auto* dump_item = static_cast<long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(dump_item, 0xff, sizeof(long long), st);  // -1
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  write_kernel<<<ksql::blocks_for(m, threads), threads, 0, st>>>(
      static_cast<int64_t*>(sess_start), static_cast<int64_t*>(sess_end),
      static_cast<bool*>(dirty), capacity, c, k, ncomp, m, in, dump_item, out);
  dump_kernel<<<1, 1, 0, st>>>(static_cast<int64_t*>(sess_start), static_cast<int64_t*>(sess_end),
                               static_cast<bool*>(dirty), static_cast<int64_t*>(max_ts), capacity,
                               c, ncomp, in, static_cast<const int64_t*>(scal), dump_item);
  return static_cast<int>(cudaGetLastError());
}
