// K8 probe_find: the stream side of a stream-table join, one launch per
// join probe per batch (join mode); the right-row lookup of a foreign-key
// join's left changes (join mode with a liveness column, live mode); the
// undo side of a table aggregation, one launch per change batch (find
// mode); and the other side's gather of a table-table join's changes at
// the slots K2 gave them (gather mode, below).
//
// Replaces ops/hash_store.py:probe_find (B12) and the gather of
// runtime/lowering.py:_apply_join.  One thread per stream row:
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
//   3. the gather at that slot: every v_<col> into a fresh output lane,
//      every m_<col> AND found, key0 (the right side's primary key repr),
//      and `found`.  In live mode (runtime/lowering.py:_trace_fk_left's
//      right_of, replaces its probe_find and gathers) a found slot also
//      needs live[slot]: a slot whose row was deleted keeps its key, so the
//      walk finds it, its values are gathered, and `found` is False.
// A row that is not found thus carries the DUMP ROW's data in its lanes,
// bit for bit the reference's lanes (only the valid bits are cleared).
//
// Bound: memory, and the latency of dependent random reads.  The per-row
// inputs and outputs are coalesced (about 10 + 9 * cols bytes a row in,
// the same out); the store reads are scattered: 18 bytes a probe
// (occ, grave, khash, wstart) plus the gathered row.  At 65,536 rows and
// two columns that is about 4 MB (~1.2 us at 3.35 TB/s); a 2^18-slot
// table's occ/grave/khash fit in L2 (50 MB), so most probes hit it.  The
// kernel is one launch, so at this size launch latency is its real limit.
#include "common.cuh"

namespace {

__global__ void probe_find_kernel(
    const int64_t* __restrict__ krepr, const bool* __restrict__ kvalid,
    const bool* __restrict__ active, int64_t n, const bool* __restrict__ occ,
    const bool* __restrict__ grave, const int64_t* __restrict__ kh,
    const int64_t* __restrict__ ws, const int64_t* __restrict__ key0,
    const bool* __restrict__ live, int64_t capacity, ksql::Gather g,
    int64_t* __restrict__ key_out, bool* __restrict__ found_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t mask = capacity - 1;
  int64_t slot = capacity;
  bool found = false;
  if (active[i] && kvalid[i]) {
    const uint64_t h =
        ksql::mix64(ksql::kGold ^ (static_cast<uint64_t>(krepr[i]) + ksql::kGold));
    const int64_t hs = static_cast<int64_t>(h);
    const int64_t base = static_cast<int64_t>(ksql::mix64(h) & static_cast<uint64_t>(mask));
    const int64_t at = ksql::find_slot(occ, grave, kh, ws, mask, base, hs, 0);
    if (at >= 0) {
      slot = at;
      found = live == nullptr || live[at];
    }
  }
  for (int64_t j = 0; j < g.count; ++j) {
    ksql::copy_elem(g.vdst[j], i, g.vsrc[j], slot, g.size[j]);
    g.mdst[j][i] = g.msrc[j][slot] && found;
  }
  key_out[i] = key0[slot];
  found_out[i] = found;
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

extern "C" int ksql_probe_find(
    const void* occ, const void* grave, const void* kh, const void* ws,
    const void* key0, const void* live, int64_t capacity, const int64_t* cols,
    int64_t count, const void* krepr, const void* kvalid, const void* active, int64_t n,
    void* key_out, void* found_out, void* stream) {
  ksql::Gather g;
  if (!ksql::gather_from_desc(cols, count, &g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  probe_find_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      static_cast<const int64_t*>(krepr), static_cast<const bool*>(kvalid),
      static_cast<const bool*>(active), n, static_cast<const bool*>(occ),
      static_cast<const bool*>(grave), static_cast<const int64_t*>(kh),
      static_cast<const int64_t*>(ws), static_cast<const int64_t*>(key0),
      static_cast<const bool*>(live), capacity, g, static_cast<int64_t*>(key_out),
      static_cast<bool*>(found_out));
  return static_cast<int>(cudaGetLastError());
}
