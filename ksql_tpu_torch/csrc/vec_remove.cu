// K23 vec_remove: COLLECT_LIST's undo in a table aggregation.
//
// Replaces ops/hash_store.py:_vec_remove (B19; run by scatter_combine only
// with vec_undo=True, on the undo side of runtime/lowering.py:_ta_side).
// Computes what the reference computes, not its steps.  The r-th undo row
// of a (slot, value, null bit), in row order, claims the r-th equal entry
// of the slot's first min(count, K) (values equal by IEEE ==: +-0.0 alike,
// a NaN equal to nothing).  Which row claims which entry does not change
// the result: an entry goes when fewer equal entries come before it than
// the slot has undo rows of its value.  So the rows need grouping by slot
// only, and no sort.  One cooperative launch (remove_kernel), a grid of at
// most the blocks the card holds at once:
//   1. each removing row (head < 0, slot != C) takes a ticket in its slot's
//      count (slot_cnt, 0 between calls); the slot's first ticket adds the
//      slot to the work list;
//   2. each listed slot takes its range of a bucket array (one atomicAdd a
//      slot on a cursor);
//   3. each removing row writes its index at its ticket in its slot's range;
//   4. a block a listed slot: it reads the slot's first min(count, K)
//      entries once into shared memory and inserts them into a hash table
//      there (open addressing on the value and null bit; a table cell
//      counts the value's entries), looks up each of the slot's undo rows
//      and counts them on their value's cell; an entry of a value with L
//      undo rows and N entries goes when L >= N, stays when L = 0, and
//      otherwise when its rank among its value's entries is below L (one
//      warp ranks just those entries in order, __match_any_sync on the
//      cell); the kept entries are packed left with block scans, each
//      double rewritten as v + 0.0 (a -0.0 comes back +0.0, as the
//      reference's scatter-add into zeros gives), the rest of the K cells
//      zeroed, and the logical count (which may exceed K) falls by the
//      entries removed.  The block resets the slot's ticket count.
// Between the steps, grid.sync().  The last block also rewrites the dump
// row when some row of the batch is not the lowest undo row of its slot
// (fewer listed slots than rows: the reference's non-winners write the dump
// row's own compaction): entries past min(count[C], K) become 0, the
// others +0.0-canonical, its count unchanged.
//
// Bound: memory.  Per row 8 + e + 1 + 4 bytes in (head, value, bit, slot);
// per touched slot its count read and written and its first min(count, K)
// entries read ((e + 1) min(count, K) bytes) and its K cells written (the
// kept entries and zeros: the reference rewrites the whole row); the dump
// row's K cells when it is rewritten.  The hash table keeps each slot's
// matching in shared memory: a slot's entries are read once however many
// undo rows it has.
#include <cooperative_groups.h>

#include "common.cuh"

#define KSQL_MAX_VEC 4096

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int64_t canon(int64_t bits, int64_t isfloat) {
  // v + 0.0 for a double: only -0.0 changes
  return (isfloat && bits == INT64_MIN) ? 0 : bits;
}

__device__ __forceinline__ bool is_nan(int64_t bits, int64_t isfloat) {
  return isfloat && ksql::as_f64(bits) != ksql::as_f64(bits);
}

// the table cell a (value, bit) starts its probe at: ±0.0 alike (sort_key)
__device__ __forceinline__ int64_t probe_start(int64_t bits, int8_t b, int64_t isfloat,
                                               int64_t mask) {
  const uint64_t k = static_cast<uint64_t>(ksql::sort_key(bits, isfloat));
  return static_cast<int64_t>(ksql::mix64(k ^ (static_cast<uint64_t>(static_cast<uint8_t>(b)) * ksql::kGold)) &
                              static_cast<uint64_t>(mask));
}

// Inclusive sum of one int a thread across the block (warp shuffles, then
// the warps' totals); `tot` gets the block's total.  Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_tot[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_tot[warp - 1] : 0);
  *tot = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is read before the next call writes it
  return out;
}

struct Args {
  const int64_t* head;
  const void* vals;
  const int8_t* vbits;
  int64_t esize, isfloat;
  const int32_t* slots;
  int64_t n, capacity;
  int64_t* cnt;
  void* data;
  int8_t* vbit;
  int64_t K, H;  // H: the table's cells, a power of two >= 2K
  int32_t* slot_cnt;  // C + 1 ticket counts, 0 between calls
  int32_t* ctrl;      // [listed slots, cursor], 0 between calls
  int32_t* work;      // n: the listed slots
  int32_t* local;     // n: each removing row's ticket
  int32_t* bucket;    // n: the removing rows by slot
  int32_t* slot_off;  // C + 1: each listed slot's range in bucket
};

// One listed slot s, its undo rows bucket[off, off + rows), by the block.
__device__ void remove_slot(const Args& a, int64_t s, int32_t off, int32_t rows, char* smem,
                            int* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t K = a.K, esize = a.esize, isfloat = a.isfloat;
  const int64_t cn = a.cnt[s];
  const int64_t occ = cn < 0 ? 0 : (cn < K ? cn : K);
  int64_t hs = 32;
  while (hs < 2 * occ) hs <<= 1;
  const int64_t hmask = hs - 1;
  int64_t* sv = reinterpret_cast<int64_t*>(smem);
  int32_t* thead = reinterpret_cast<int32_t*>(sv + K);
  int32_t* nocc = thead + a.H;
  int32_t* nundo = nocc + a.H;
  int32_t* nseen = nundo + a.H;
  int32_t* vid = nseen + a.H;
  const int64_t wordsK = (K + 31) / 32;
  unsigned* gone = reinterpret_cast<unsigned*>(vid + K);
  unsigned* need = gone + wordsK;
  int8_t* sb = reinterpret_cast<int8_t*>(need + wordsK);
  const int64_t rowbase = s * K;

  for (int64_t p = t; p < occ; p += kThreads) {
    sv[p] = ksql::load_elem(a.data, rowbase + p, esize);
    sb[p] = a.vbit[rowbase + p];
  }
  for (int64_t h = t; h < hs; h += kThreads) {
    thead[h] = -1;
    nocc[h] = 0;
    nundo[h] = 0;
    nseen[h] = 0;
  }
  __syncthreads();
  // the entries into the table (a NaN matches nothing: no cell)
  for (int64_t p = t; p < occ; p += kThreads) {
    const int64_t v = sv[p];
    const int8_t b = sb[p];
    if (is_nan(v, isfloat)) {
      vid[p] = -1;
      continue;
    }
    int64_t h = probe_start(v, b, isfloat, hmask);
    while (true) {
      const int32_t prev = atomicCAS(&thead[h], -1, static_cast<int32_t>(p));
      if (prev == -1 || (sb[prev] == b && ksql::elem_eq(sv[prev], v, isfloat))) {
        vid[p] = static_cast<int32_t>(h);
        atomicAdd(&nocc[h], 1);
        break;
      }
      h = (h + 1) & hmask;
    }
  }
  __syncthreads();
  // the slot's undo rows onto their values' cells
  for (int32_t r = t; r < rows; r += kThreads) {
    const int64_t row = a.bucket[off + r];
    const int64_t v = ksql::load_elem(a.vals, row, esize);
    const int8_t b = a.vbits[row];
    if (is_nan(v, isfloat)) continue;
    int64_t h = probe_start(v, b, isfloat, hmask);
    while (true) {
      const int32_t q = thead[h];
      if (q == -1) break;  // no such entry: the row claims nothing
      if (sb[q] == b && ksql::elem_eq(sv[q], v, isfloat)) {
        atomicAdd(&nundo[h], 1);
        break;
      }
      h = (h + 1) & hmask;
    }
  }
  __syncthreads();
  // verdicts a 32-entry word: gone (every entry of the value claimed) or
  // needing its rank (fewer undo rows than entries)
  const int64_t words = (occ + 31) / 32;
  for (int64_t w = warp; w < words; w += kWarps) {
    const int64_t p = w * 32 + lane;
    bool g = false, nd = false;
    if (p < occ && vid[p] >= 0) {
      const int32_t L = nundo[vid[p]], N = nocc[vid[p]];
      g = L > 0 && L >= N;
      nd = L > 0 && L < N;
    }
    const unsigned gw = __ballot_sync(0xffffffffu, g);
    const unsigned nw = __ballot_sync(0xffffffffu, nd);
    if (lane == 0) {
      gone[w] = gw;
      need[w] = nw;
    }
  }
  __syncthreads();
  // ranks, in entry order, of the entries that need them: one warp
  if (warp == 0) {
    const unsigned lower = (1u << lane) - 1u;
    for (int64_t wb = 0; wb < words; wb += 32) {
      const unsigned mine = wb + lane < words ? need[wb + lane] : 0u;
      for (unsigned pending = __ballot_sync(0xffffffffu, mine != 0u); pending != 0u;
           pending &= pending - 1) {
        const int k = __ffs(pending) - 1;
        const unsigned bits = __shfl_sync(0xffffffffu, mine, k);
        const int64_t wi = wb + k;
        const bool nd = (bits >> lane) & 1u;
        const int32_t v = nd ? vid[wi * 32 + lane] : -1 - lane;
        const unsigned peers = __match_any_sync(0xffffffffu, v);
        const int32_t base = nd ? nseen[v] : 0;
        __syncwarp();
        const bool g = nd && base + __popc(peers & lower) < nundo[v];
        if (nd && lane == __ffs(peers) - 1) nseen[v] = base + __popc(peers);
        const unsigned gw = __ballot_sync(0xffffffffu, g);
        if (lane == 0) gone[wi] |= gw;
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // pack the kept entries left, zero the rest of the row
  int32_t kept = 0;
  for (int64_t r0 = 0; r0 < occ; r0 += kThreads) {
    const int64_t p = r0 + t;
    const bool keep = p < occ && !((gone[p >> 5] >> (p & 31)) & 1u);
    int total = 0;
    const int incl = block_scan(keep ? 1 : 0, warp_tot, &total);
    if (keep) {
      const int64_t cell = rowbase + kept + incl - 1;
      ksql::store_elem(a.data, cell, esize, canon(sv[p], isfloat));
      a.vbit[cell] = sb[p];
    }
    kept += total;
  }
  for (int64_t p = kept + t; p < K; p += kThreads) {
    ksql::store_elem(a.data, rowbase + p, esize, 0);
    a.vbit[rowbase + p] = 0;
  }
  if (t == 0) {
    a.cnt[s] = ksql::wsub(cn, occ - kept);
    a.slot_cnt[s] = 0;  // the ticket count is clean for the next call
  }
  __syncthreads();  // the shared arrays are reused by the block's next slot
}

__global__ void __launch_bounds__(kThreads) remove_kernel(Args a) {
  extern __shared__ int64_t s_dyn[];
  __shared__ int warp_tot[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // 1. tickets and the work list
  for (int64_t i = first; i < a.n; i += stride) {
    const int32_t s = a.slots[i];
    if (a.head[i] < 0 && s != a.capacity) {
      const int32_t l = atomicAdd(&a.slot_cnt[s], 1);
      a.local[i] = l;
      if (l == 0) a.work[atomicAdd(&a.ctrl[0], 1)] = s;
    }
  }
  grid.sync();
  const int32_t listed = __ldcg(&a.ctrl[0]);
  // 2. each listed slot's range
  for (int64_t w = first; w < listed; w += stride) {
    const int32_t s = a.work[w];
    a.slot_off[s] = atomicAdd(&a.ctrl[1], __ldcg(&a.slot_cnt[s]));
  }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctrl[0] = 0;  // every block holds `listed`; the cursor is spent
    a.ctrl[1] = 0;
  }
  // 3. the rows into their slots' ranges
  for (int64_t i = first; i < a.n; i += stride) {
    const int32_t s = a.slots[i];
    if (a.head[i] < 0 && s != a.capacity) a.bucket[a.slot_off[s] + a.local[i]] = static_cast<int32_t>(i);
  }
  grid.sync();
  // the dump row's compaction without claims (no slot's ticket counts are
  // read or written here)
  if (blockIdx.x == gridDim.x - 1 && listed < a.n) {
    const int64_t cc = a.cnt[a.capacity];
    const int64_t occ = cc < a.K ? cc : a.K;
    for (int64_t p = threadIdx.x; p < a.K; p += kThreads) {
      const int64_t cell = a.capacity * a.K + p;
      if (p < occ) {
        ksql::store_elem(a.data, cell, a.esize,
                         canon(ksql::load_elem(a.data, cell, a.esize), a.isfloat));
      } else {
        ksql::store_elem(a.data, cell, a.esize, 0);
        a.vbit[cell] = 0;
      }
    }
  }
  // 4. a block a listed slot
  for (int64_t w = blockIdx.x; w < listed; w += gridDim.x) {
    const int32_t s = a.work[w];
    remove_slot(a, s, a.slot_off[s], __ldcg(&a.slot_cnt[s]), reinterpret_cast<char*>(s_dyn),
                warp_tot);
  }
}

// the dynamic shared bytes of a block for K entries and H table cells
inline int64_t smem_bytes(int64_t K, int64_t H) {
  return K * 8 + 4 * H * 4 + K * 4 + 2 * ((K + 31) / 32) * 4 + K;
}

// the cooperative grid's most blocks, per device and dynamic shared bytes
// (remove_kernel's occupancy times the SMs), asked again when K changes
int g_most[64];
int64_t g_smem[64];

}  // namespace

// slot_cnt: capacity + 1 int32, ctrl: 2 int32, both 0 between calls (the
// kernel leaves them so); buf: 3 n + capacity + 1 int32 of scratch.
extern "C" int ksql_vec_remove(const void* head, const void* vals, const void* vbits,
                               int64_t esize, int64_t isfloat, const void* slots, int64_t n,
                               int64_t capacity, void* cnt, void* data, void* vbit, int64_t K,
                               void* slot_cnt, void* ctrl, void* buf, void* stream) {
  if (K > KSQL_MAX_VEC || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t H = 32;
  while (H < 2 * K) H <<= 1;
  const int64_t smem = smem_bytes(K, H);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_most[dev] == 0 || g_smem[dev] != smem) {
    err = cudaFuncSetAttribute(remove_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, remove_kernel, kThreads,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_most[dev] = per_sm * sms;
    g_smem[dev] = smem;
  }
  Args a;
  a.head = static_cast<const int64_t*>(head);
  a.vals = vals;
  a.vbits = static_cast<const int8_t*>(vbits);
  a.esize = esize;
  a.isfloat = isfloat;
  a.slots = static_cast<const int32_t*>(slots);
  a.n = n;
  a.capacity = capacity;
  a.cnt = static_cast<int64_t*>(cnt);
  a.data = data;
  a.vbit = static_cast<int8_t*>(vbit);
  a.K = K;
  a.H = H;
  a.slot_cnt = static_cast<int32_t*>(slot_cnt);
  a.ctrl = static_cast<int32_t*>(ctrl);
  int32_t* b = static_cast<int32_t*>(buf);
  a.work = b;
  a.local = b + n;
  a.bucket = b + 2 * n;
  a.slot_off = b + 3 * n;
  // a block a touched slot at most, and at least one
  const int64_t want = n < 1 ? 1 : n;
  const unsigned blocks = static_cast<unsigned>(want < g_most[dev] ? want : g_most[dev]);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(remove_kernel), dim3(blocks),
                                    dim3(kThreads), params, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
