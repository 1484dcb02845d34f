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
//
// One launch a call, in three steps: every active row with a real slot
// claims it with atomicMax of its row index into last[slot] (int32[C+1],
// -1 when clean); behind a barrier, the row whose index is last[slot] is
// the winner, writes its upsert or delete and resets last[slot] to -1 (a
// loser reads either the winner's index or -1, never its own); every
// non-upserting row offers its index to a max-reduction, and behind a
// second barrier the dump row takes the highest such row's values and
// occ/grave False (table mode) or live False (side mode).
//   n <= kSolo (4,096): upsert_block_kernel, one block of up to kThreads
//     (1,024; the warps n needs at kPerThread rows a thread, one for a
//     per-record step); each thread owns the rows threadIdx.x + q *
//     blockDim.x, q < 4, and keeps their slots in registers; the dump row
//     comes from a block max-reduction and the scratch's dump cell is
//     never touched.
//   n > kSolo: upsert_grid_kernel, a persistent cooperative launch of
//     kGridThreads-thread blocks (the grid is the smaller of the blocks n
//     needs and what the card holds at once, from the occupancy query,
//     cached per device) walking the rows with a grid stride; grid.sync()
//     is the claims' barrier; each block folds its non-upserting rows'
//     maximum into last[C] with one atomicMax and counts itself settled,
//     and the last block to settle writes the dump row and resets last[C]
//     and the count (no second grid barrier).
// The scratch is clean after every call.  The occupancy sum and the
// overflow readback stay torch reductions in the caller.
//
// Bound: memory.  Per row it reads the slot and the flags (touched,
// delete, act); an upserting winner reads its columns (9 bytes a column:
// value and valid bit) and writes them with its live bit into a scattered
// slot, a deleting winner writes its flags, and the dump row takes one
// row's columns: about 0.8 us at 65,536 changes and three columns at 3.35
// TB/s.  What the kernel waits on is a chain of dependent accesses a row
// (slot, claim, the claim cell read back, its columns).  At one change a
// step the call is a launch floor: one launch replaces the three of the
// first version (claim, write, a one-thread dump), and the host side
// packs the store half of the descriptor once per set of store buffers
// (ops/hash_store.py: upsert_plan).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 4;
constexpr int kSolo = kThreads * kPerThread;  // rows one block carries in registers
constexpr int kGridThreads = 256;  // a grid block's threads: blocks on every SM

struct Cols {
  void* vdst[KSQL_MAX_COLS];
  const void* vsrc[KSQL_MAX_COLS];
  int64_t size[KSQL_MAX_COLS];  // element bytes: 1, 4 or 8
  bool* mdst[KSQL_MAX_COLS];
  const bool* msrc[KSQL_MAX_COLS];
  bool use_act[KSQL_MAX_COLS];  // side mode: m = valid && act
  int64_t count;
};

struct Args {
  Cols c;
  const int32_t* slots;
  const bool* active;
  const bool* del;
  const bool* act;
  int64_t n;
  int32_t capacity;
  bool* occ;    // table mode (live is null)
  bool* grave;
  bool* live;   // side mode (occ and grave are null)
  int32_t* last;
};

// The valid bit row `i` of column `j` writes.
__device__ __forceinline__ bool valid_of(const Args& a, int64_t j, int64_t i) {
  return a.c.msrc[j][i] && (!a.c.use_act[j] || a.act[i]);
}

// Row i's claim: its slot when it takes part, else the dump row.
__device__ __forceinline__ int32_t claim(const Args& a, int64_t i) {
  const int32_t s = a.slots[i];
  if (a.active[i] && s != a.capacity) {
    atomicMax(&a.last[s], static_cast<int32_t>(i));
    return s;
  }
  return a.capacity;
}

// Row i, which claimed slot s (the dump row when it took no part), after
// every claim: a winner writes its upsert or delete and cleans its cell.
// Returns whether the row aims at the dump row (it does not upsert).
__device__ __forceinline__ bool settle(const Args& a, int64_t i, int32_t s) {
  const bool winner = s != a.capacity && __ldcg(&a.last[s]) == static_cast<int32_t>(i);
  const bool del = a.del[i];
  if (!winner) return true;
  if (!del) {
    for (int64_t j = 0; j < a.c.count; ++j) {
      ksql::copy_elem(a.c.vdst[j], s, a.c.vsrc[j], i, a.c.size[j]);
      a.c.mdst[j][s] = valid_of(a, j, i);
    }
    if (a.live != nullptr) a.live[s] = true;
  } else if (a.live != nullptr) {
    a.live[s] = false;
  } else {
    a.occ[s] = false;
    a.grave[s] = true;
  }
  a.last[s] = -1;  // only the winner resets its cell
  return del;
}

// The dump row takes row d's columns (d < 0: no row aimed at it) and
// ends unoccupied; thread j < count copies column j.
__device__ __forceinline__ void write_dump(const Args& a, int d) {
  const int64_t j = threadIdx.x;
  if (d >= 0 && j < a.c.count) {
    ksql::copy_elem(a.c.vdst[j], a.capacity, a.c.vsrc[j], d, a.c.size[j]);
    a.c.mdst[j][a.capacity] = valid_of(a, j, d);
  }
  if (threadIdx.x == 0) {
    if (a.live != nullptr) {
      a.live[a.capacity] = false;
    } else {
      a.occ[a.capacity] = false;
      a.grave[a.capacity] = false;
    }
  }
}

// The block's maximum of one int a thread; every thread must call it and
// gets the result.
__device__ __forceinline__ int block_max(int v, int* warp_max) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    int w = threadIdx.x < (blockDim.x >> 5) ? warp_max[threadIdx.x] : -1;
    w = __reduce_max_sync(0xffffffffu, w);
    if (threadIdx.x == 0) warp_max[0] = w;
  }
  __syncthreads();
  return warp_max[0];
}

__global__ void __launch_bounds__(kThreads) upsert_block_kernel(Args a) {
  __shared__ int warp_max[kThreads / 32];
  int32_t slot[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int64_t i = threadIdx.x + static_cast<int64_t>(q) * blockDim.x;
    slot[q] = i < a.n ? claim(a, i) : a.capacity;
  }
  __syncthreads();
  int dump = -1;  // this thread's highest non-upserting row
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int64_t i = threadIdx.x + static_cast<int64_t>(q) * blockDim.x;
    if (i < a.n && settle(a, i, slot[q])) dump = static_cast<int>(i);
  }
  write_dump(a, block_max(dump, warp_max));
}

// blocks of the grid that have settled their rows; the last one writes
// the dump row and resets it (the port launches on one stream a device)
__device__ unsigned int g_settled;

__global__ void __launch_bounds__(kGridThreads) upsert_grid_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int warp_max[kGridThreads / 32];
  __shared__ bool s_last;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kGridThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGridThreads;
  for (int64_t i = t0; i < a.n; i += stride) claim(a, i);
  grid.sync();
  int dump = -1;
  for (int64_t i = t0; i < a.n; i += stride) {
    const int32_t s = a.slots[i];
    const int32_t aimed = a.active[i] ? s : a.capacity;
    if (settle(a, i, aimed)) dump = static_cast<int>(i);
  }
  const int top = block_max(dump, warp_max);
  if (threadIdx.x == 0) {
    if (top >= 0) atomicMax(&a.last[a.capacity], top);
    __threadfence();
    s_last = atomicAdd(&g_settled, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int d = __ldcg(&a.last[a.capacity]);
  __syncthreads();  // every thread of the last block has read the cell
  write_dump(a, d);
  if (threadIdx.x == 0) {
    a.last[a.capacity] = -1;
    g_settled = 0;
  }
}

int g_blocks_per_sm[64];
int g_sms[64];

int launch(void* occ, void* grave, void* live, int64_t capacity, const int64_t* cols,
           int64_t count, const void* slots, const void* active, const void* del,
           const void* act, int64_t n, void* last, void* stream) {
  if (count > KSQL_MAX_COLS || n >= INT32_MAX || capacity >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  for (int64_t j = 0; j < count; ++j) {
    a.c.vdst[j] = reinterpret_cast<void*>(cols[6 * j]);
    a.c.vsrc[j] = reinterpret_cast<const void*>(cols[6 * j + 1]);
    a.c.size[j] = cols[6 * j + 2];
    a.c.mdst[j] = reinterpret_cast<bool*>(cols[6 * j + 3]);
    a.c.msrc[j] = reinterpret_cast<const bool*>(cols[6 * j + 4]);
    a.c.use_act[j] = cols[6 * j + 5] != 0;
  }
  a.c.count = count;
  a.slots = static_cast<const int32_t*>(slots);
  a.active = static_cast<const bool*>(active);
  a.del = static_cast<const bool*>(del);
  a.act = static_cast<const bool*>(act);
  a.n = n;
  a.capacity = static_cast<int32_t>(capacity);
  a.occ = static_cast<bool*>(occ);
  a.grave = static_cast<bool*>(grave);
  a.live = static_cast<bool*>(live);
  a.last = static_cast<int32_t*>(last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kSolo) {
    // the warps the rows need, kPerThread rows a thread (one warp for a
    // per-record step); write_dump needs a thread a column
    int64_t rows = (n + kPerThread - 1) / kPerThread;
    if (rows < count) rows = count;
    const unsigned threads = rows < 32 ? 32u : static_cast<unsigned>((rows + 31) / 32 * 32);
    upsert_block_kernel<<<1, threads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, upsert_grid_kernel, kGridThreads,
                                                        0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_blocks_per_sm[dev] = per_sm;
    g_sms[dev] = sms;
  }
  const int64_t need = (n + kGridThreads - 1) / kGridThreads;
  const int64_t most = static_cast<int64_t>(g_blocks_per_sm[dev]) * g_sms[dev];
  const unsigned blocks = static_cast<unsigned>(need < most ? need : most);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(upsert_grid_kernel), dim3(blocks),
                                    dim3(kGridThreads), params, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
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
