// K8 probe_find: the stream side of a stream-table join, one launch per
// join probe per batch (join mode); the right-row lookups of a foreign-key
// join's left changes, the new and the old foreign key in one launch (join
// mode with a liveness column, live mode); the undo side of a table
// aggregation, one launch per change batch (find mode); and the other
// side's gather of a table-table join's changes at the slots K2 gave them
// (gather mode, below).
//
// Replaces ops/hash_store.py:probe_find (B12) and the gather of
// runtime/lowering.py:_apply_join.  One thread per row of one of two row
// sets (thread i < n0 takes row i of set 0, the others row i - n0 of set
// 1; the join mode passes one set):
//   1. the probe hash, combine_hash([repr]) = mix64(GOLD ^ (repr + GOLD)),
//      and the base slot mix64(hash ^ 0 * GOLD) & mask (the table store
//      keys with window 0);
//   2. the find-only walk of the reference, for rows that are active with
//      a valid key: at most KSQL_MAX_PROBES candidates (base + offset) &
//      mask; a LIVE slot (occ) whose khash and wstart (0) match ends the
//      walk found; a truly empty slot (neither occ nor grave) ends it
//      absent; graves and other keys are walked past.  A row that is not
//      looked up, not found, or still walking after the last round reads
//      the dump slot C, as the reference's `slots = capacity` does;
//   3. the gather at that slot: every v_<col> into the set's output lane,
//      every m_<col> AND found, key0 (the right side's primary key repr),
//      and `found`.  In live mode (runtime/lowering.py:_trace_fk_left's
//      right_of, called for the new and for the old foreign key: replaces
//      its probe_finds and gathers) a found slot also needs live[slot]: a
//      slot whose row was deleted keeps its key, so the walk finds it, its
//      values are gathered, and `found` is False.  Nothing writes the store
//      between the reference's two right_of calls, so one launch serves
//      both key sets.
// A row that is not found thus carries the DUMP ROW's data in its lanes,
// bit for bit the reference's lanes (only the valid bits are cleared).
//
// Bound: memory, and the latency of dependent random reads.  The per-row
// inputs and outputs are coalesced (about 10 + 9 * cols bytes a row in,
// the same out); the store reads are scattered: 18 bytes a probe
// (occ, grave, khash, wstart) plus the gathered row.  At 65,536 rows and
// two columns that is about 4 MB (~1.2 us at 3.35 TB/s); a 2^18-slot
// table's occ/grave/khash fit in L2 (50 MB), so most probes hit it.  At a
// foreign-key join's one change a step the call is a launch floor: one
// launch for both key sets replaces the two of the first version.  The
// column descriptor (each column's store arrays and element size, each
// output lane's byte offset in the call's one output allocation) lives in
// device memory, packed once per set of store buffers and batch length
// (ops/hash_store.py: FindPlan); a block copies it into shared memory
// while its threads walk, so a launch passes a dozen scalars.
#include "common.cuh"

namespace {

// Words of a join- or live-mode descriptor: the column count, then 3 a
// column (store values, element bytes, store valid bits), then per row set
// the byte offsets of its key0 and found lanes and 2 a column (value lane,
// valid lane) in the output allocation.
constexpr int kDescWords = 1 + 3 * KSQL_MAX_COLS + 2 * (2 + 2 * KSQL_MAX_COLS);
constexpr int kFindThreads = 256;
constexpr int kBatch = 8;  // columns whose loads a row issues before their stores
static_assert(kDescWords <= kFindThreads, "one descriptor word a thread");

__global__ void probe_find_kernel(const bool* __restrict__ occ, const bool* __restrict__ grave,
                                  const int64_t* __restrict__ kh, const int64_t* __restrict__ ws,
                                  const int64_t* __restrict__ key0, const bool* __restrict__ live,
                                  int64_t capacity, const int64_t* __restrict__ desc,
                                  int64_t words, char* __restrict__ out,
                                  const int64_t* __restrict__ krepr0, const bool* __restrict__ kvalid0,
                                  const bool* __restrict__ active0, const int64_t* __restrict__ krepr1,
                                  const bool* __restrict__ kvalid1, const bool* __restrict__ active1,
                                  int64_t n, int64_t rows) {
  __shared__ int64_t s_desc[kDescWords];
  // the descriptor word this thread copies, loaded now and stored after
  // the walk, whose loads do not wait for it
  const int64_t dv = threadIdx.x < words ? desc[threadIdx.x] : 0;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int set = i >= n;
  const int64_t r = i - set * n;
  int64_t slot = capacity;
  bool found = false;
  if (i < rows && (set ? active1 : active0)[r] && (set ? kvalid1 : kvalid0)[r]) {
    const uint64_t h = ksql::mix64(
        ksql::kGold ^ (static_cast<uint64_t>((set ? krepr1 : krepr0)[r]) + ksql::kGold));
    const int64_t mask = capacity - 1;
    const int64_t base = static_cast<int64_t>(ksql::mix64(h) & static_cast<uint64_t>(mask));
    const int64_t at = ksql::find_slot(occ, grave, kh, ws, mask, base, static_cast<int64_t>(h), 0);
    if (at >= 0) {
      slot = at;
      found = live == nullptr || live[at];
    }
  }
  if (threadIdx.x < words) s_desc[threadIdx.x] = dv;
  __syncthreads();
  if (i >= rows) return;
  const int64_t count = s_desc[0];
  const int64_t* cd = s_desc + 1;
  const int64_t* od = s_desc + 1 + 3 * count + set * (2 + 2 * count);
  const int64_t k0 = key0[slot];
  // kBatch columns' loads in flight before their stores
  for (int64_t j0 = 0; j0 < count; j0 += kBatch) {
    int64_t v[kBatch];
    bool mv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t j = j0 + u;
      if (j < count) {
        v[u] = ksql::load_elem(reinterpret_cast<const void*>(cd[3 * j]), slot, cd[3 * j + 1]);
        mv[u] = reinterpret_cast<const bool*>(cd[3 * j + 2])[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t j = j0 + u;
      if (j < count) {
        ksql::store_elem(out + od[2 + 2 * j], r, cd[3 * j + 1], v[u]);
        reinterpret_cast<bool*>(out + od[3 + 2 * j])[r] = mv[u] && found;
      }
    }
  }
  reinterpret_cast<int64_t*>(out + od[0])[r] = k0;
  reinterpret_cast<bool*>(out + od[1])[r] = found;
}

// Find mode (replaces ops/hash_store.py:probe_find with window 0, called
// by runtime/lowering.py:_ta_side on the undo side): one thread a row,
// given the group hash and base slot K1 computed (its unwindowed mode);
// a row that is inactive, absent or unresolved after 32 rounds reads the
// dump slot C.  No gather: the undo side folds into the slots.
//
// Bound: memory and dependent-read latency, as the join mode: 13 bytes a
// row in, 4 out, and 18 bytes a probe from the store (L2-resident for a
// table aggregation's store of group keys).
__global__ void find_slots_kernel(const bool* __restrict__ occ, const bool* __restrict__ grave,
                                  const int64_t* __restrict__ kh, const int64_t* __restrict__ ws,
                                  int64_t capacity, const int64_t* __restrict__ khash,
                                  const int32_t* __restrict__ base,
                                  const bool* __restrict__ active, int64_t n,
                                  int32_t* __restrict__ slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t slot = -1;
  if (active[i]) {
    slot = ksql::find_slot(occ, grave, kh, ws, capacity - 1, base[i], khash[i], 0);
  }
  slots[i] = static_cast<int32_t>(slot < 0 ? capacity : slot);
}

// Gather mode (replaces runtime/lowering.py:_tt_joined_env's gathers of
// the OTHER side, tt[{other}_v_*][slots], `{other}_live[slots] & found`):
// one thread a change row, at the slot K2 gave it (no walk; the dump slot
// C for a row K2 did not place).  o_live = live[slot] && slot != C; every
// v_<col> at the slot into a fresh lane, every m_<col> AND o_live.  The
// old and the new rows of a change share the slot, so one launch serves
// both joined environments.
//
// Bound: memory.  Per row 4 bytes of slot in, 1 + 9 * cols out, and the
// scattered row (1 + 9 * cols bytes) from the store.
__global__ void gather_kernel(const bool* __restrict__ live, int64_t capacity, ksql::Gather g,
                              const int32_t* __restrict__ slots, int64_t n,
                              bool* __restrict__ olive_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t slot = slots[i];
  const bool ol = slot != capacity && live[slot];
  for (int64_t j = 0; j < g.count; ++j) {
    ksql::copy_elem(g.vdst[j], i, g.vsrc[j], slot, g.size[j]);
    g.mdst[j][i] = g.msrc[j][slot] && ol;
  }
  olive_out[i] = ol;
}

}  // namespace

extern "C" int ksql_probe_gather(const void* live, int64_t capacity, const int64_t* cols,
                                 int64_t count, const void* slots, int64_t n, void* olive_out,
                                 void* stream) {
  ksql::Gather g;
  if (!ksql::gather_from_desc(cols, count, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  gather_kernel<<<ksql::blocks_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(live), capacity, g, static_cast<const int32_t*>(slots), n,
      static_cast<bool*>(olive_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_probe_find_slots(
    const void* occ, const void* grave, const void* kh, const void* ws, int64_t capacity,
    const void* khash, const void* base, const void* active, int64_t n, void* slots,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  find_slots_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      static_cast<const bool*>(occ), static_cast<const bool*>(grave),
      static_cast<const int64_t*>(kh), static_cast<const int64_t*>(ws), capacity,
      static_cast<const int64_t*>(khash), static_cast<const int32_t*>(base),
      static_cast<const bool*>(active), n, static_cast<int32_t*>(slots));
  return static_cast<int>(cudaGetLastError());
}

// `desc` is the device descriptor above (`words` int64); `out` the call's
// output allocation; the second row set's pointers are ignored when
// `sets` is 1.
extern "C" int ksql_probe_find(const void* occ, const void* grave, const void* kh, const void* ws,
                               const void* key0, const void* live, int64_t capacity,
                               const void* desc, int64_t words, void* out, const void* krepr0,
                               const void* kvalid0, const void* active0, const void* krepr1,
                               const void* kvalid1, const void* active1, int64_t n, int64_t sets,
                               void* stream) {
  if (words > kDescWords || sets < 1 || sets > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = n * sets;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  probe_find_kernel<<<ksql::blocks_for(rows, kFindThreads), kFindThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(occ), static_cast<const bool*>(grave),
      static_cast<const int64_t*>(kh), static_cast<const int64_t*>(ws),
      static_cast<const int64_t*>(key0), static_cast<const bool*>(live), capacity,
      static_cast<const int64_t*>(desc), words, static_cast<char*>(out),
      static_cast<const int64_t*>(krepr0), static_cast<const bool*>(kvalid0),
      static_cast<const bool*>(active0), static_cast<const int64_t*>(krepr1),
      static_cast<const bool*>(kvalid1), static_cast<const bool*>(active1), n, rows);
  return static_cast<int>(cudaGetLastError());
}
