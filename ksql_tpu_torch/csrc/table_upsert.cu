// K9 table_upsert: fold one batch of a table's changelog into its join
// store, after K1 (table mode: the key hash) and K2 (the insert) have
// resolved each row's slot (table mode); and fold one side's batch of a
// table-table or foreign-key join's changes into its columns of the join
// store (side mode, below).
//
// Table mode replaces the body of runtime/lowering.py:_trace_table_step
// after its probe_insert (B13).  The reference picks, per slot, the LAST
// row of the batch that reached it (scatter-max of the row index: the
// opposite of K2's and K3's lowest-row winners), then
//   upsert winners (winner & ~delete) write every v_<col> / m_<col>;
//   delete winners (winner & delete) set occ False and grave True, so a
//     probe chain through the slot stays intact until a host rebuild;
//   every other row (losers, inactive and padding rows) scatters its values
//     into the dump row C, where XLA applies duplicate updates in row
//     order: the dump row ends with the HIGHEST such row's values;
//   the dump row ends with occ and grave False.
// Side mode replaces runtime/lowering.py:_upsert_side (B20), called by
// _trace_tt_step, _trace_fk_left and _trace_fk_right: the same winner rule
// over the rows that are `touched` (a valid key) with a real slot, but a
// delete winner writes live[slot] = False and an upsert winner live[slot]
// = True instead of touching occ/grave (a deleted key keeps its slot), the
// side's m_<col> take `valid & act` (act: the row passed the side's
// TableFilters), a column flagged without act (the foreign-key join's
// fkrepr/fkvalid pair) takes its valid bits as they are, and the dump row
// ends with live False and occ/grave untouched.
// Three launches:
//   1. claim, one thread per active row with a real slot: atomicMax of its
//      row index into last[slot] (int32[C+1], -1 when clean);
//   2. write, one thread per row: a row whose index is last[slot] is the
//      winner, writes its upsert or delete and resets last[slot] to -1 (a
//      loser reads either the winner's index or -1, never its own); every
//      non-upserting row claims the dump row with atomicMax(last[C], row);
//   3. dump fix-up, one thread: the dump row takes row last[C]'s values
//      and occ/grave False (table mode) or live False (side mode), and
//      last[C] is reset.
// The scratch is clean after every call.  The occupancy sum and the
// overflow readback stay torch reductions in the caller.
//
// Bound: memory.  Per row it reads the slot, the flags and each column's
// value (9 bytes a column), and a winner writes 9 bytes a column into a
// scattered slot: about 2.5 MB at 65,536 rows and three columns (~0.8 us
// at 3.35 TB/s).  Three launches make it launch-bound at this size.
// Side mode's function needs less: per row its slot and three flags
// (touched, delete, act); the columns only of each upserting winner, read
// and written with its live bit; a deleting winner's live bit; and the
// dump row's columns from the highest non-upserting row.
#include "common.cuh"

namespace {

struct Cols {
  void* vdst[KSQL_MAX_COLS];
  const void* vsrc[KSQL_MAX_COLS];
  int64_t size[KSQL_MAX_COLS];  // element bytes: 1, 4 or 8
  bool* mdst[KSQL_MAX_COLS];
  const bool* msrc[KSQL_MAX_COLS];
  bool use_act[KSQL_MAX_COLS];  // side mode: m = valid && act
  int64_t count;
};

// The valid bit row `i` of column `j` writes.
__device__ __forceinline__ bool valid_of(const Cols& c, int64_t j, int64_t i,
                                         const bool* __restrict__ act) {
  return c.msrc[j][i] && (!c.use_act[j] || act[i]);
}

__global__ void claim_kernel(const int32_t* __restrict__ slots,
                             const bool* __restrict__ active, int64_t n,
                             int32_t capacity, int32_t* __restrict__ last) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !active[i]) return;
  const int32_t s = slots[i];
  if (s != capacity) atomicMax(&last[s], static_cast<int32_t>(i));
}

__global__ void upsert_kernel(Cols c, const int32_t* __restrict__ slots,
                              const bool* __restrict__ active,
                              const bool* __restrict__ del,
                              const bool* __restrict__ act, int64_t n,
                              int32_t capacity, bool* __restrict__ occ,
                              bool* __restrict__ grave, bool* __restrict__ live,
                              int32_t* __restrict__ last) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = slots[i];
  const bool winner = active[i] && s != capacity && last[s] == static_cast<int32_t>(i);
  if (winner && !del[i]) {
    for (int64_t j = 0; j < c.count; ++j) {
      ksql::copy_elem(c.vdst[j], s, c.vsrc[j], i, c.size[j]);
      c.mdst[j][s] = valid_of(c, j, i, act);
    }
    if (live != nullptr) live[s] = true;
  } else {
    atomicMax(&last[capacity], static_cast<int32_t>(i));
  }
  if (winner) {
    if (del[i] && live != nullptr) {
      live[s] = false;
    } else if (del[i]) {
      occ[s] = false;
      grave[s] = true;
    }
    last[s] = -1;  // only the winner resets its cell
  }
}

__global__ void dump_kernel(Cols c, const bool* __restrict__ act, int32_t capacity,
                            bool* __restrict__ occ, bool* __restrict__ grave,
                            bool* __restrict__ live, int32_t* __restrict__ last) {
  const int32_t d = last[capacity];
  if (d >= 0) {
    for (int64_t j = 0; j < c.count; ++j) {
      ksql::copy_elem(c.vdst[j], capacity, c.vsrc[j], d, c.size[j]);
      c.mdst[j][capacity] = valid_of(c, j, d, act);
    }
    last[capacity] = -1;
  }
  if (live != nullptr) {
    live[capacity] = false;
  } else {
    occ[capacity] = false;
    grave[capacity] = false;
  }
}

int launch(void* occ, void* grave, void* live, int64_t capacity, const int64_t* cols,
           int64_t count, const void* slots, const void* active, const void* del,
           const void* act, int64_t n, void* last, void* stream) {
  if (count > KSQL_MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  Cols c{};
  for (int64_t j = 0; j < count; ++j) {
    c.vdst[j] = reinterpret_cast<void*>(cols[6 * j]);
    c.vsrc[j] = reinterpret_cast<const void*>(cols[6 * j + 1]);
    c.size[j] = cols[6 * j + 2];
    c.mdst[j] = reinterpret_cast<bool*>(cols[6 * j + 3]);
    c.msrc[j] = reinterpret_cast<const bool*>(cols[6 * j + 4]);
    c.use_act[j] = cols[6 * j + 5] != 0;
  }
  c.count = count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = ksql::blocks_for(n, threads);
  const int32_t cap = static_cast<int32_t>(capacity);
  const auto* slots_p = static_cast<const int32_t*>(slots);
  const auto* active_p = static_cast<const bool*>(active);
  const auto* act_p = static_cast<const bool*>(act);
  auto* occ_p = static_cast<bool*>(occ);
  auto* grave_p = static_cast<bool*>(grave);
  auto* live_p = static_cast<bool*>(live);
  auto* last_p = static_cast<int32_t*>(last);
  claim_kernel<<<blocks, threads, 0, st>>>(slots_p, active_p, n, cap, last_p);
  upsert_kernel<<<blocks, threads, 0, st>>>(
      c, slots_p, active_p, static_cast<const bool*>(del), act_p, n, cap, occ_p,
      grave_p, live_p, last_p);
  dump_kernel<<<1, 1, 0, st>>>(c, act_p, cap, occ_p, grave_p, live_p, last_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Table mode: `cols` holds 6 int64 per column (value dst, value src,
// element bytes, valid dst, valid src, 0).
extern "C" int ksql_table_upsert(void* occ, void* grave, int64_t capacity,
                                 const int64_t* cols, int64_t count,
                                 const void* slots, const void* active,
                                 const void* del, int64_t n, void* last,
                                 void* stream) {
  return launch(occ, grave, nullptr, capacity, cols, count, slots, active, del, nullptr, n,
                last, stream);
}

// Side mode: `active` is the reference's `touched`, `del` its ~has_new,
// `act` the side's filter verdict; the last int64 of a column's six is 1
// where its valid bits take `act`.
extern "C" int ksql_table_upsert_side(void* live, int64_t capacity, const int64_t* cols,
                                      int64_t count, const void* slots, const void* touched,
                                      const void* del, const void* act, int64_t n, void* last,
                                      void* stream) {
  return launch(nullptr, nullptr, live, capacity, cols, count, slots, touched, del, act, n,
                last, stream);
}
