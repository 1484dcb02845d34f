// K13 seg_sort: the stable two-key sort of the session step and of the
// vector aggregates' orders.
//
// Replaces the two jnp.lexsort calls of runtime/lowering.py:
// post_session_exchange (B16): the batch's rows by (where(active, khash,
// 0), 0), which finds each key's first active row, and the m = n (S + 1)
// session items by (kh, start), which lines every key's sessions up for
// the interval merge; and the argsorts of ops/hash_store.py's vector
// aggregates (B18).  The output is the int32 permutation of
// jnp.lexsort((k2, k1)): signed k1, then signed k2, then item index (the
// lexsort is stable), so every (k1, k2, index) triple is unique and the
// order is total: no two items ever compare equal.
//
// Bound: bytes.  The least work reads each key pair once and writes the
// permutation: 20 bytes an item (0.024 us at 4,096 items, 1.6 us at
// 270,336).
//
// The first design sorted 2,048-item tiles by a bitonic network, one block
// each: 66 barrier steps, each moving a (k1, k2, index) triple, ~40 bytes
// an item, through one SM's shared memory, ~0.045 ms at every size, then
// merged the tiles in passes (2-3 launches at 4,096 and 8,192 items, 2-4
// of 132 SMs working).  This design:
//
//   1. Block sort (block_sort_kernel): one block sorts up to 8 x its
//      threads items.  The key pairs go once into shared memory, k1 and k2
//      in arrays of their own (16 bytes an item, loads and stores
//      coalesced), and each thread sorts a run of 8 of them (items t,
//      t + threads, ...) in registers by a bitonic network, no barrier.
//      Runs then merge pairwise by merge path: each thread owns 8
//      consecutive outputs, finds where they start in the two runs by a
//      co-rank binary search and merges them sequentially, comparing
//      through the items' indices into the key arrays (k2 only on equal
//      k1), so that a level moves 4 bytes an item.  Levels whose merged
//      runs fit a warp's 256 items sync the warp only; a block barrier
//      comes from runs of 512 up.  Keys plus two index buffers take 24
//      bytes an item: up to 8,192 items (196,608 bytes) in one block.
//      What bounds it: one SM's shared memory, as bank conflicts.  The
//      searches and merges gather keys at random indices (a warp's random
//      8-byte gather takes several times the 2 wavefronts of a coalesced
//      one), so every level costs thousands of SM cycles, about as many at
//      runs of 8 as at runs of 2,048, and twice as many at 8,192 items as
//      at 4,096 (the SM clock at each level: scripts/torch_k10_k13_probe.py,
//      which also times runs of 16 a thread, faster at 8,192 items only
//      and slower at the 4,096 of the vector orders, which most calls
//      sort; warp levels by shuffles in registers; tie loads kept behind
//      the k1 test: both slower).
//   2. Up to 8,192 items that one block is the whole sort: one launch, no
//      global scratch, the permutation written straight out (every
//      vector order at 4,096 rows and the session rows at 8,192).
//   3. Past it (the session items, 139,264 to 270,336), blocks of 256
//      threads sort 2,048-item tiles, one a block (132 tiles at 270,336:
//      a block per SM), and write (k1, k2, index) triples; merge passes
//      (merge_pass_kernel) then merge runs of 2,048, 4,096, ... pairwise,
//      every item finding its output position as its rank in its run plus
//      a lower bound of its triple in the partner run (binary search; the
//      triples are unique, so no two items claim one position), reading
//      and writing ping-pong buffers; the last pass writes only the
//      indices.  1 + ceil(log2(tiles)) launches: 9 at 270,336 items,
//      where the passes, ~0.009 ms each (a chain of dependent L2 reads an
//      item), take most of the time.
#include "common.cuh"

namespace {

constexpr int kRun = 8;  // items a thread sorts in registers
constexpr int kWarpItems = 32 * kRun;
constexpr int kBlockMax = 8192;  // the one-block route's limit
constexpr int kMaxThreads = kBlockMax / kRun;
constexpr int kTile = 2048;  // the large route's tile, a block each
constexpr int kSmemPerItem = 16 + 2 * 4;

__device__ __forceinline__ bool less3(int64_t a1, int64_t a2, int32_t ai, int64_t b1, int64_t b2,
                                      int32_t bi) {
  if (a1 != b1) return a1 < b1;
  if (a2 != b2) return a2 < b2;
  return ai < bi;
}

// The order of items a and b, indices into the block's key arrays, whose
// k1 are equal: k2, then index.
__device__ __forceinline__ bool tie_less(const int64_t* k2, int a, int b) {
  const int64_t x = k2[a], y = k2[b];
  return x != y ? x < y : a < b;
}

// item a before item b
__device__ __forceinline__ bool less_at(const int64_t* k1, const int64_t* k2, int a, int b) {
  const int64_t x = k1[a], y = k1[b];
  return x != y ? x < y : tie_less(k2, a, b);
}

// Sorts kRun triples in registers: a bitonic network, its indices
// compile-time constants once unrolled.
__device__ __forceinline__ void sort_run(int64_t* k1, int64_t* k2, int* id) {
#pragma unroll
  for (int k = 2; k <= kRun; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int l = i ^ j;
        if (l > i && less3(k1[l], k2[l], id[l], k1[i], k2[i], id[i]) == ((i & k) == 0)) {
          const int64_t x1 = k1[i], x2 = k2[i];
          const int xi = id[i];
          k1[i] = k1[l];
          k2[i] = k2[l];
          id[i] = id[l];
          k1[l] = x1;
          k2[l] = x2;
          id[l] = xi;
        }
      }
    }
  }
}

// One block sorts the items [base, base + cnt) of (k1, k2), base =
// blockIdx.x * 8 * blockDim.x and cnt the rest of n up to that many,
// padded with (INT64_MAX, INT64_MAX) items whose indices follow every
// real one, so that they sort last.  Writes the sorted global indices
// into perm when it is given (the one-block route), else the sorted
// triples into o1, o2, oi at the tile's own positions.  Dynamic shared
// memory: 24 bytes an item of the padded tile.
__global__ void __launch_bounds__(kMaxThreads) block_sort_kernel(
    const int64_t* __restrict__ k1, const int64_t* __restrict__ k2, int64_t n,
    int32_t* __restrict__ perm, int64_t* __restrict__ o1, int64_t* __restrict__ o2,
    int32_t* __restrict__ oi) {
  extern __shared__ int64_t smem[];
  const int threads = blockDim.x, t = threadIdx.x;
  const int npad = threads * kRun;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * npad;
  const int cnt = static_cast<int>(n - base < npad ? n - base : npad);
  int64_t* s1 = smem;
  int64_t* s2 = smem + npad;
  int* a = reinterpret_cast<int*>(smem + 2 * npad);
  int* b = a + npad;
  // the thread's run: items t, t + threads, ... (loads and stores
  // coalesced), sorted in registers; any kRun items make a run, since
  // every comparison reads the items' own indices
  int64_t r1[kRun], r2[kRun];
  int id[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const int i = q * threads + t;
    id[q] = i;
    r1[q] = i < cnt ? k1[base + i] : INT64_MAX;
    r2[q] = i < cnt ? k2[base + i] : INT64_MAX;
    s1[i] = r1[q];
    s2[i] = r2[q];
  }
  sort_run(r1, r2, id);
#pragma unroll
  for (int q = 0; q < kRun; q += 4) {
    reinterpret_cast<int4*>(a)[(kRun * t + q) / 4] =
        make_int4(id[q], id[q + 1], id[q + 2], id[q + 3]);
  }
  __syncthreads();  // the keys, for every level
  for (int len = kRun; len < npad; len <<= 1) {
    // level `len`: runs of len merge into runs of 2 len; the thread's
    // outputs [d0, d0 + kRun) lie in one pair of runs
    if (2 * len <= kWarpItems) {
      __syncwarp();
    } else {
      __syncthreads();
    }
    const int d0 = kRun * t;
    const int lo0 = d0 & ~(2 * len - 1);
    const int a_end = min(lo0 + len, npad), b_end = min(lo0 + 2 * len, npad);
    const int la = a_end - lo0, lb = b_end - a_end, d = d0 - lo0;
    // co-rank: the number of the first d outputs that come from run A
    int lo = max(0, d - lb), hi = min(d, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (less_at(s1, s2, a[lo0 + mid], a[a_end + d - mid - 1])) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // the sequential merge of kRun outputs, without a branch on the side
    int ia = lo0 + lo, ib = a_end + d - lo;
    // (a run's reads stay inside the pair's region, which this level's
    // sync covers: past a run's end they re-read its last item, unused)
    int va = a[min(ia, a_end - 1)], vb = a[min(ib, b_end - 1)];
    int64_t ka = s1[va], kb = s1[vb];
    int out[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      bool take_a = ia < a_end;
      if (take_a && ib < b_end) {
        take_a = ka != kb ? ka < kb : tie_less(s2, va, vb);
      }
      out[q] = take_a ? va : vb;
      ia += take_a;
      ib += !take_a;
      const int next = a[take_a ? min(ia, a_end - 1) : min(ib, b_end - 1)];
      const int64_t kn = s1[next];
      va = take_a ? next : va;
      ka = take_a ? kn : ka;
      vb = take_a ? vb : next;
      kb = take_a ? kb : kn;
    }
#pragma unroll
    for (int q = 0; q < kRun; q += 4) {
      reinterpret_cast<int4*>(b)[(kRun * t + q) / 4] =
          make_int4(out[q], out[q + 1], out[q + 2], out[q + 3]);
    }
    int* swap = a;
    a = b;
    b = swap;
  }
  __syncthreads();
  for (int i = t; i < cnt; i += threads) {
    const int v = a[i];
    if (perm != nullptr) {
      perm[i] = v;
    } else {
      o1[base + i] = s1[v];
      o2[base + i] = s2[v];
      oi[base + i] = static_cast<int32_t>(base + v);
    }
  }
}

// The number of items of [l, r) whose triple is below (x1, x2, xi).
__device__ __forceinline__ int64_t lower_bound3(const int64_t* __restrict__ a1,
                                                const int64_t* __restrict__ a2,
                                                const int32_t* __restrict__ ai, int64_t l,
                                                int64_t r, int64_t x1, int64_t x2, int32_t xi) {
  const int64_t l0 = l;
  while (l < r) {
    const int64_t c = l + ((r - l) >> 1);
    if (less3(a1[c], a2[c], ai[c], x1, x2, xi)) {
      l = c + 1;
    } else {
      r = c;
    }
  }
  return l - l0;
}

__global__ void merge_pass_kernel(const int64_t* __restrict__ a1, const int64_t* __restrict__ a2,
                                  const int32_t* __restrict__ ai, int64_t n, int64_t w,
                                  int64_t* __restrict__ b1, int64_t* __restrict__ b2,
                                  int32_t* __restrict__ bi, int keys_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t lo = (i / (2 * w)) * (2 * w);
  const int64_t mid = lo + w < n ? lo + w : n;
  const int64_t hi = lo + 2 * w < n ? lo + 2 * w : n;
  const int64_t x1 = a1[i], x2 = a2[i];
  const int32_t xi = ai[i];
  int64_t pos;
  if (i < mid) {
    pos = i + lower_bound3(a1, a2, ai, mid, hi, x1, x2, xi);
  } else {
    pos = lo + (i - mid) + lower_bound3(a1, a2, ai, lo, mid, x1, x2, xi);
  }
  bi[pos] = xi;
  if (keys_out) {
    b1[pos] = x1;
    b2[pos] = x2;
  }
}

}  // namespace

// work: 5 n int64 (two ping-pong sets of k1, k2 and int32 indices) for n
// past kBlockMax (ops/session.py: SEG_SORT_BLOCK_MAX); null up to it.
extern "C" int ksql_seg_sort(const void* k1, const void* k2, int64_t n, void* perm, void* work,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerItem * kBlockMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x1 = static_cast<const int64_t*>(k1);
  const auto* x2 = static_cast<const int64_t*>(k2);
  auto* out = static_cast<int32_t*>(perm);
  if (n <= kBlockMax) {
    const int threads = static_cast<int>((n + kWarpItems - 1) / kWarpItems) * 32;
    block_sort_kernel<<<1, threads, kSmemPerItem * threads * kRun, st>>>(x1, x2, n, out, nullptr,
                                                                        nullptr, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto* base = static_cast<int64_t*>(work);
  int64_t* c1 = base;
  int64_t* c2 = base + n;
  int64_t* d1 = base + 2 * n;
  int64_t* d2 = base + 3 * n;
  auto* ci = reinterpret_cast<int32_t*>(base + 4 * n);
  int32_t* di = ci + n;
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  block_sort_kernel<<<tiles, kTile / kRun, kSmemPerItem * kTile, st>>>(x1, x2, n, nullptr, c1, c2,
                                                                       ci);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  for (int64_t w = kTile; w < n; w <<= 1) {
    const bool last = 2 * w >= n;
    merge_pass_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
        c1, c2, ci, n, w, d1, d2, last ? out : di, last ? 0 : 1);
    int64_t* t1 = c1;
    int64_t* t2 = c2;
    int32_t* ti = ci;
    c1 = d1;
    c2 = d2;
    ci = di;
    d1 = t1;
    d2 = t2;
    di = ti;
  }
  return static_cast<int>(cudaGetLastError());
}
