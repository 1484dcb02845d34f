// K21 vec_topk: fold a micro-batch into a TOPK / TOPKDISTINCT column.
//
// Replaces ops/hash_store.py:_vec_topk, with its :_sort_desc and
// :_desc_key (B18).  State per slot: top[K] (int8/int32/int64/float64),
// descending, the dtype floor `sent` marking an empty entry.  Launches,
// with K13 seg_sort (csrc/seg_sort.cu) between them from ops/vector.py:
//   keys: per row, eff = slot when its value is not `sent` and its slot is
//     not the dump slot C, else C; the sort keys (eff, XLA's key of the
//     reference's _desc_key) and the value as int64 bits.
//   [K13] dedup (distinct only): per sorted position, a value equal
//     (IEEE) to the previous position's in the same slot becomes (C, sent);
//     the position-indexed keys and values are sorted again [K13].
//   merge: gather materializes the final order (eff, value) by position;
//     pstar finds the last position that is not its run's first (atomicMax);
//     top, one thread, merges that position's window into a scratch row
//     (XLA's scatter leaves it in the dump row); top, one thread per run
//     winner, merges the run's first K values with the slot's stored K and
//     writes the first K; dump copies the scratch row into the dump row.
//   The merge is XLA's jnp.sort(...)[::-1]: descending by XLA's key (NaN
//     first, -0.0 equal to +0.0), equal keys in reverse order of the merged
//     list — an insertion sort of the 2K values taken from the back,
//     stable, in thread-local memory (2K <= 512); distinct mode then drops
//     a value equal (IEEE) to the one before it and sorts again.
//
// Bound: bytes.  The least work reads the batch (value and slot, 12 bytes a
// row at int64) and each touched slot's stored K values, and writes them
// back; the two or three sorts are the design's extra passes.  One thread a
// winner merging 2K values is simple and right; at pv_vectors' k = 3 that
// is 6 values.
#include "common.cuh"

namespace {

__global__ void topk_keys_kernel(const void* vals, int64_t esize, int64_t isfloat, int64_t sent,
                                 const int32_t* __restrict__ slots, int64_t n, int64_t cap,
                                 int64_t* __restrict__ k1, int64_t* __restrict__ k2,
                                 int64_t* __restrict__ vraw) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t v = ksql::load_elem(vals, r, esize);
  const int64_t slot = slots[r];
  const bool live = !ksql::elem_eq(v, sent, isfloat) && slot != cap;
  k1[r] = live ? slot : cap;
  k2[r] = ksql::desc_key(v, isfloat);
  vraw[r] = v;
}

__global__ void topk_dedup_kernel(const int32_t* __restrict__ perm, int64_t n,
                                  const int64_t* __restrict__ k1,
                                  const int64_t* __restrict__ vraw, int64_t isfloat,
                                  int64_t sent, int64_t cap, int64_t* __restrict__ e2,
                                  int64_t* __restrict__ d2, int64_t* __restrict__ v2) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t r = perm[p];
  int64_t e = k1[r];
  int64_t v = vraw[r];
  if (p > 0) {
    const int64_t q = perm[p - 1];
    if (k1[q] == e && ksql::elem_eq(vraw[q], v, isfloat)) {
      e = cap;
      v = sent;
    }
  }
  e2[p] = e;
  d2[p] = ksql::desc_key(v, isfloat);
  v2[p] = v;
}

__global__ void topk_gather_kernel(const int32_t* __restrict__ perm, int64_t n,
                                   const int64_t* __restrict__ src_e,
                                   const int64_t* __restrict__ src_v, int64_t* __restrict__ se,
                                   int64_t* __restrict__ sv) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n) return;
  se[q] = src_e[perm[q]];
  sv[q] = src_v[perm[q]];
}

__device__ __forceinline__ bool is_winner(const int64_t* se, int64_t q, int64_t cap) {
  return (q == 0 || se[q] != se[q - 1]) && se[q] != cap;
}

__global__ void topk_pstar_kernel(const int64_t* __restrict__ se, int64_t n, int64_t cap,
                                  unsigned long long* __restrict__ pstar) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n || is_winner(se, q, cap)) return;
  atomicMax(pstar, static_cast<unsigned long long>(q + 1));  // 0: every position wins
}

// XLA's jnp.sort(a)[::-1] of m values: descending by sort key, equal keys
// in reverse order of `a`; inserting a[m-1], ..., a[0] stably does both.
template <int M>
__device__ void sort_desc(int64_t* a, int m, int64_t isfloat) {
  int64_t key[M];
  int64_t val[M];
  for (int i = 0; i < m; ++i) {
    const int64_t v = a[m - 1 - i];
    const int64_t k = ksql::sort_key(v, isfloat);
    int j = i;
    while (j > 0 && key[j - 1] < k) {
      key[j] = key[j - 1];
      val[j] = val[j - 1];
      --j;
    }
    key[j] = k;
    val[j] = v;
  }
  for (int i = 0; i < m; ++i) a[i] = val[i];
}

template <int M>
__device__ void merge_top(const int64_t* se, const int64_t* sv, int64_t n, int64_t q,
                          const void* col, int64_t esize, int64_t isfloat, int64_t sent,
                          int64_t K, int64_t distinct, int64_t* out) {
  int64_t a[M];
  const int64_t e = se[q];
  for (int64_t t = 0; t < K; ++t) {
    const int64_t o = q + t;
    a[t] = (o < n && se[o] == e) ? sv[o] : sent;
    a[K + t] = ksql::load_elem(col, e * K + t, esize);
  }
  const int m = static_cast<int>(2 * K);
  sort_desc<M>(a, m, isfloat);
  if (distinct) {
    int64_t prev = a[0];
    for (int i = 1; i < m; ++i) {
      const int64_t cur = a[i];
      if (ksql::elem_eq(cur, prev, isfloat)) a[i] = sent;
      prev = cur;
    }
    sort_desc<M>(a, m, isfloat);
  }
  for (int64_t t = 0; t < K; ++t) out[t] = a[t];
}

template <int M>
__global__ void topk_top_kernel(const int64_t* __restrict__ se, const int64_t* __restrict__ sv,
                                int64_t n, void* col, int64_t esize, int64_t isfloat,
                                int64_t sent, int64_t K, int64_t cap, int64_t distinct,
                                const unsigned long long* __restrict__ pstar,
                                int64_t* __restrict__ topbuf, int64_t phase) {
  int64_t out[M / 2];
  if (phase == 0) {  // the dump row's merge, before any winner writes
    if (threadIdx.x != 0 || blockIdx.x != 0 || *pstar == 0) return;
    merge_top<M>(se, sv, n, static_cast<int64_t>(*pstar) - 1, col, esize, isfloat, sent, K,
                 distinct, out);
    for (int64_t t = 0; t < K; ++t) topbuf[t] = out[t];
    return;
  }
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n || !is_winner(se, q, cap)) return;
  merge_top<M>(se, sv, n, q, col, esize, isfloat, sent, K, distinct, out);
  for (int64_t t = 0; t < K; ++t) ksql::store_elem(col, se[q] * K + t, esize, out[t]);
}

__global__ void topk_dump_kernel(void* col, int64_t esize, int64_t K, int64_t cap,
                                 const unsigned long long* __restrict__ pstar,
                                 const int64_t* __restrict__ topbuf) {
  const int64_t t = threadIdx.x;
  if (*pstar == 0) return;
  for (int64_t i = t; i < K; i += blockDim.x) ksql::store_elem(col, cap * K + i, esize, topbuf[i]);
}

template <int M>
void launch_top(cudaStream_t st, const int64_t* se, const int64_t* sv, int64_t n, void* col,
                int64_t esize, int64_t isfloat, int64_t sent, int64_t K, int64_t cap,
                int64_t distinct, const unsigned long long* pstar, int64_t* topbuf) {
  const int threads = 128;
  topk_top_kernel<M><<<1, 1, 0, st>>>(se, sv, n, col, esize, isfloat, sent, K, cap, distinct,
                                      pstar, topbuf, 0);
  topk_top_kernel<M><<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      se, sv, n, col, esize, isfloat, sent, K, cap, distinct, pstar, topbuf, 1);
}

}  // namespace

extern "C" int ksql_vec_topk_keys(const void* vals, int64_t esize, int64_t isfloat, int64_t sent,
                                  const void* slots, int64_t n, int64_t capacity, void* k1,
                                  void* k2, void* vraw, void* stream) {
  const int threads = 256;
  topk_keys_kernel<<<ksql::blocks_for(n, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      vals, esize, isfloat, sent, static_cast<const int32_t*>(slots), n, capacity,
      static_cast<int64_t*>(k1), static_cast<int64_t*>(k2), static_cast<int64_t*>(vraw));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_topk_dedup(const void* perm, int64_t n, const void* k1, const void* vraw,
                                   int64_t isfloat, int64_t sent, int64_t capacity, void* e2,
                                   void* d2, void* v2, void* stream) {
  const int threads = 256;
  topk_dedup_kernel<<<ksql::blocks_for(n, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(k1),
      static_cast<const int64_t*>(vraw), isfloat, sent, capacity, static_cast<int64_t*>(e2),
      static_cast<int64_t*>(d2), static_cast<int64_t*>(v2));
  return static_cast<int>(cudaGetLastError());
}

// work: 2n + K + 1 int64 (se, sv, the dump row's scratch, pstar)
extern "C" int ksql_vec_topk_merge(const void* perm, int64_t n, const void* src_e,
                                   const void* src_v, void* col, int64_t esize, int64_t isfloat,
                                   int64_t sent, int64_t K, int64_t capacity, int64_t distinct,
                                   void* work, void* stream) {
  if (K < 1 || K > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t* se = static_cast<int64_t*>(work);
  int64_t* sv = se + n;
  int64_t* topbuf = sv + n;
  auto* pstar = reinterpret_cast<unsigned long long*>(topbuf + K);
  cudaMemsetAsync(pstar, 0, sizeof(unsigned long long), st);
  const int threads = 256;
  topk_gather_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(src_e),
      static_cast<const int64_t*>(src_v), se, sv);
  topk_pstar_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(se, n, capacity, pstar);
  if (K <= 8) {
    launch_top<16>(st, se, sv, n, col, esize, isfloat, sent, K, capacity, distinct, pstar, topbuf);
  } else if (K <= 32) {
    launch_top<64>(st, se, sv, n, col, esize, isfloat, sent, K, capacity, distinct, pstar, topbuf);
  } else {
    launch_top<512>(st, se, sv, n, col, esize, isfloat, sent, K, capacity, distinct, pstar,
                    topbuf);
  }
  topk_dump_kernel<<<1, 128, 0, st>>>(col, esize, K, capacity, pstar, topbuf);
  return static_cast<int>(cudaGetLastError());
}
