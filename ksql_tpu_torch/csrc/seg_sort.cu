// K13 seg_sort: the stable two-key sort of the session step.
//
// Replaces the two jnp.lexsort calls of runtime/lowering.py:
// post_session_exchange (B16): the batch's rows by (where(active, khash,
// 0), 0), which finds each key's first active row, and the m = n (S + 1)
// session items by (kh, start), which lines every key's sessions up for
// the interval merge.  The output is the int32 permutation of
// jnp.lexsort((k2, k1)): signed k1, then signed k2, then item index (the
// lexsort is stable), so every (k1, k2, index) triple is unique and the
// order is total.
//
// Design, the simple one that is right:
//   1. tile sort: each block of 1,024 threads loads a tile of 2,048 items
//      as (k1, k2, index) triples into shared memory (40 KB), pads a
//      ragged last tile with (INT64_MAX, INT64_MAX, INT32_MAX), which sorts
//      after every real item, and runs a bitonic network on it, one
//      compare-exchange per thread per step;
//   2. merge passes: runs of 2,048, 4,096, ... items merge pairwise until
//      one run holds all; in each pass every item finds its output
//      position as its rank in its own run plus a lower_bound of its
//      triple in the partner run (binary search; the triples are unique,
//      so no two items claim one position), reading and writing ping-pong
//      buffers.  The last pass writes only the indices, into the output.
//
// Bound: bytes.  The least work reads each key once and writes the
// permutation (20 bytes an item); the design moves 20 bytes an item per
// pass plus log2(run) dependent reads for the binary search, ~9 passes at
// 532,480 items.  The buffers (10 MB at that size) stay in the 50 MB L2,
// so the searches hit it; the serial depth of the merge passes, not the
// card's memory rate, is the limit.  A radix sort with decoupled
// look-back is the later speed-up.
#include "common.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kTileThreads = kTile / 2;

__device__ __forceinline__ bool less3(int64_t a1, int64_t a2, int32_t ai, int64_t b1, int64_t b2,
                                      int32_t bi) {
  if (a1 != b1) return a1 < b1;
  if (a2 != b2) return a2 < b2;
  return ai < bi;
}

__global__ void __launch_bounds__(kTileThreads) tile_sort_kernel(
    const int64_t* __restrict__ k1, const int64_t* __restrict__ k2, int64_t n,
    int64_t* __restrict__ o1, int64_t* __restrict__ o2, int32_t* __restrict__ oi) {
  __shared__ int64_t s1[kTile];
  __shared__ int64_t s2[kTile];
  __shared__ int32_t si[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const int64_t g = base + t;
    if (g < n) {
      s1[t] = k1[g];
      s2[t] = k2[g];
      si[t] = static_cast<int32_t>(g);
    } else {
      s1[t] = INT64_MAX;
      s2[t] = INT64_MAX;
      si[t] = INT32_MAX;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int lo = 2 * j * (t / j) + (t % j);
      const int hi = lo + j;
      const bool up = (lo & k) == 0;
      if (less3(s1[hi], s2[hi], si[hi], s1[lo], s2[lo], si[lo]) == up) {
        const int64_t x1 = s1[lo], x2 = s2[lo];
        const int32_t xi = si[lo];
        s1[lo] = s1[hi];
        s2[lo] = s2[hi];
        si[lo] = si[hi];
        s1[hi] = x1;
        s2[hi] = x2;
        si[hi] = xi;
      }
      __syncthreads();
    }
  }
  for (int u = threadIdx.x; u < kTile; u += blockDim.x) {
    const int64_t g = base + u;
    if (g < n) {
      o1[g] = s1[u];
      o2[g] = s2[u];
      oi[g] = si[u];
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

// work: 5 n int64 (two ping-pong sets of k1, k2 and int32 indices).
extern "C" int ksql_seg_sort(const void* k1, const void* k2, int64_t n, void* perm, void* work,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int passes = 0;
  for (int64_t w = kTile; w < n; w <<= 1) ++passes;
  auto* base = static_cast<int64_t*>(work);
  int64_t* c1 = base;
  int64_t* c2 = base + n;
  int64_t* d1 = base + 2 * n;
  int64_t* d2 = base + 3 * n;
  auto* ci = reinterpret_cast<int32_t*>(base + 4 * n);
  int32_t* di = ci + n;
  auto* out = static_cast<int32_t*>(perm);
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  tile_sort_kernel<<<tiles, kTileThreads, 0, st>>>(static_cast<const int64_t*>(k1),
                                                   static_cast<const int64_t*>(k2), n, c1, c2,
                                                   passes == 0 ? out : ci);
  int64_t w = kTile;
  const int threads = 256;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
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
    w <<= 1;
  }
  return static_cast<int>(cudaGetLastError());
}
