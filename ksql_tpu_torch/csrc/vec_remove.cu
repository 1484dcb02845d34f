// K23 vec_remove: COLLECT_LIST's undo in a table aggregation.
//
// Replaces ops/hash_store.py:_vec_remove (B19; run by scatter_combine only
// with vec_undo=True, on the undo side of runtime/lowering.py:_ta_side).
// Computes what the reference computes, not its steps:
//   1. keys (one thread a row): a row removes when its head is negative and
//      its slot is not the dump slot C; its sort keys are
//      (eff * 256 + bit + 128, sort_key(value)) with eff its slot (C for the
//      other rows, which sort last);
//   K13 seg_sort orders the rows by (slot, bit, value, row): the reference's
//      lexsort((rowidx, vbits, vals, eff)) groups the same runs in the same
//      row order;
//   2. claim (one warp a sorted position): the row's rank r in its run of
//      equal (slot, bit, value) — runs by IEEE ==, so +-0.0 share one and a
//      NaN matches nothing — and the position of the r-th entry of the
//      slot's first min(count, K) equal to (value, bit), found with warp
//      ballots over the row in order (-1 when there is none);
//   3. apply: a block per slot run of the removing rows ORs its rows' claims
//      into a shared-memory bitmap (K <= 4096 bits), copies the slot's row
//      to shared memory, keeps the unclaimed entries below min(count, K),
//      packs them left with a block prefix sum, zeroes the tail, and
//      subtracts the number removed from the logical count (which may
//      exceed K).  Every rewritten double is v + 0.0: a -0.0 comes back
//      +0.0, as the reference's scatter-add into zeros gives.  Then one
//      block rewrites the dump row when some row of the batch is not its
//      slot's lowest undo row (the reference's non-winners write the dump
//      row's own compaction): entries past min(count[C], K) become 0, the
//      others +0.0-canonical, its count unchanged.
//
// Bound: memory.  Per row 8 + e + 1 + 4 bytes in (head, value, bit, slot);
// per touched slot its count read and written and its first min(count, K)
// entries read and written back ((e + 1) min(count, K) bytes each way: the
// cells past them are 0 already, since K20 appends below the cap and this
// kernel zeroes the tail); when the dump row is rewritten, its first
// min(count[C], K) entries read and all K written.  The claims rescan a
// slot's prefix once per undo row of the slot, which the L2 (50 MB) serves.
// A simple correct kernel: a warp per undo row and a block per touched slot.
#include "common.cuh"

#define KSQL_MAX_VEC 4096

namespace {

__device__ __forceinline__ int64_t canon(int64_t bits, int64_t isfloat) {
  // v + 0.0 for a double: only -0.0 changes
  return (isfloat && bits == INT64_MIN) ? 0 : bits;
}

__global__ void remove_keys_kernel(const int64_t* __restrict__ head, const void* __restrict__ vals,
                                   const int8_t* __restrict__ vbits, int64_t esize,
                                   int64_t isfloat, const int32_t* __restrict__ slots, int64_t n,
                                   int64_t capacity, int64_t* __restrict__ k1,
                                   int64_t* __restrict__ k2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = slots[i];
  const bool removing = head[i] < 0 && s != capacity;
  const int64_t eff = removing ? s : capacity;
  k1[i] = eff * 256 + static_cast<int64_t>(vbits[i]) + 128;
  k2[i] = ksql::sort_key(ksql::load_elem(vals, i, esize), isfloat);
}

// First sorted position in [lo, hi) whose k2 (through perm) is >= key.
__device__ __forceinline__ int64_t k2_lower(const int32_t* perm, const int64_t* k2, int64_t lo,
                                            int64_t hi, int64_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (k2[perm[mid]] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void remove_claim_kernel(const int32_t* __restrict__ perm, int64_t n,
                                    const int64_t* __restrict__ k1,
                                    const int64_t* __restrict__ k2,
                                    const int64_t* __restrict__ cnt, const void* __restrict__ data,
                                    const int8_t* __restrict__ vbit, int64_t esize,
                                    int64_t isfloat, int64_t K, int64_t capacity,
                                    const void* __restrict__ vals,
                                    const int8_t* __restrict__ vbits,
                                    int32_t* __restrict__ claim) {
  const int64_t q = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (q >= n) return;
  const int64_t row = perm[q];
  const int64_t key1 = k1[row];
  const int64_t s = key1 / 256;
  if (s == capacity) {  // not a removing row (they sort last)
    if (lane == 0) claim[row] = -1;
    return;
  }
  // run start: the first position of this (slot, bit) whose value key is
  // this one's (equal keys are equal values, a NaN aside: it matches nothing)
  const int64_t lo1 = ksql::bound_of(perm, k1, n, key1, false);
  const int64_t q0 = k2_lower(perm, k2, lo1, q, k2[row]);
  int64_t want = q - q0;
  const int64_t v = ksql::load_elem(vals, row, esize);
  const int8_t b = vbits[row];
  const int64_t occ = cnt[s] < K ? cnt[s] : K;
  int64_t found = -1;
  for (int64_t base = 0; base < occ; base += 32) {
    const int64_t p = base + lane;
    bool m = false;
    if (p < occ) {
      const int64_t cell = s * K + p;
      m = vbit[cell] == b && ksql::elem_eq(ksql::load_elem(data, cell, esize), v, isfloat);
    }
    unsigned bits = __ballot_sync(0xffffffffu, m);
    const int64_t c = __popc(bits);
    if (want < c) {
      for (int64_t k = 0; k < want; ++k) bits &= bits - 1;
      found = base + __ffs(bits) - 1;
      break;
    }
    want -= c;
  }
  if (lane == 0) claim[row] = static_cast<int32_t>(found);
}

__global__ void remove_compact_kernel(const int32_t* __restrict__ perm, int64_t n,
                                      const int64_t* __restrict__ k1,
                                      const int32_t* __restrict__ claim, int64_t* __restrict__ cnt,
                                      void* __restrict__ data, int8_t* __restrict__ vbit,
                                      int64_t esize, int64_t isfloat, int64_t K,
                                      int64_t capacity, unsigned long long* __restrict__ winners) {
  __shared__ int64_t row_v[KSQL_MAX_VEC];
  __shared__ int8_t row_b[KSQL_MAX_VEC];
  __shared__ unsigned rem[KSQL_MAX_VEC / 32];
  __shared__ int64_t scan[256];
  const int t = threadIdx.x;
  for (int64_t q = blockIdx.x; q < n; q += gridDim.x) {
    const int64_t s = k1[perm[q]] / 256;
    if (s == capacity) break;  // past the removing rows
    if (q > 0 && k1[perm[q - 1]] / 256 == s) continue;  // not the head of its slot's run
    const int64_t hi = ksql::bound_of(perm, k1, n, (s + 1) * 256, false);
    for (int64_t p = t; p < K; p += blockDim.x) {
      row_v[p] = ksql::load_elem(data, s * K + p, esize);
      row_b[p] = vbit[s * K + p];
    }
    for (int64_t w = t; w < (K + 31) / 32; w += blockDim.x) rem[w] = 0u;
    __syncthreads();
    for (int64_t r = q + t; r < hi; r += blockDim.x) {
      const int32_t c = claim[perm[r]];
      if (c >= 0) atomicOr(&rem[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
    const int64_t occ = cnt[s] < K ? cnt[s] : K;
    const int64_t per = (K + blockDim.x - 1) / blockDim.x;
    const int64_t a = t * per < K ? t * per : K;
    const int64_t e = a + per < K ? a + per : K;
    int64_t kept = 0, removed = 0;
    for (int64_t p = a; p < e; ++p) {
      const bool gone = (rem[p >> 5] >> (p & 31)) & 1u;
      if (p < occ) {
        kept += gone ? 0 : 1;
        removed += gone ? 1 : 0;
      }
    }
    const int64_t incl = ksql::block_inclusive_scan(kept, scan, ksql::AddOp());
    int64_t out = incl - kept;
    const int64_t total = scan[blockDim.x - 1];
    for (int64_t p = a; p < e; ++p) {
      const bool gone = (rem[p >> 5] >> (p & 31)) & 1u;
      if (p < occ && !gone) {
        ksql::store_elem(data, s * K + out, esize, canon(row_v[p], isfloat));
        vbit[s * K + out] = row_b[p];
        ++out;
      }
      if (p >= total) {  // the tail past the kept entries
        ksql::store_elem(data, s * K + p, esize, 0);
        vbit[s * K + p] = 0;
      }
    }
    __syncthreads();  // every thread's `total` read precedes the next scan
    const int64_t nrem = ksql::block_inclusive_scan(removed, scan, ksql::AddOp());
    if (t == blockDim.x - 1) {
      cnt[s] = ksql::wsub(cnt[s], nrem);
      atomicAdd(winners, 1ull);
    }
    __syncthreads();  // the shared row is reused by this block's next slot
  }
}

// One block: the dump row's compaction without claims, when some row of
// the batch is not a winner (winners < n).
__global__ void remove_dump_kernel(int64_t n, const int64_t* __restrict__ cnt,
                                   void* __restrict__ data, int8_t* __restrict__ vbit,
                                   int64_t esize, int64_t isfloat, int64_t K, int64_t capacity,
                                   const unsigned long long* __restrict__ winners) {
  if (static_cast<int64_t>(*winners) >= n) return;
  const int64_t occ = cnt[capacity] < K ? cnt[capacity] : K;
  for (int64_t p = threadIdx.x; p < K; p += blockDim.x) {
    const int64_t cell = capacity * K + p;
    if (p < occ) {
      ksql::store_elem(data, cell, esize, canon(ksql::load_elem(data, cell, esize), isfloat));
    } else {
      ksql::store_elem(data, cell, esize, 0);
      vbit[cell] = 0;
    }
  }
}

}  // namespace

extern "C" int ksql_vec_remove_keys(const void* head, const void* vals, const void* vbits,
                                    int64_t esize, int64_t isfloat, const void* slots, int64_t n,
                                    int64_t capacity, void* k1, void* k2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  remove_keys_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      static_cast<const int64_t*>(head), vals, static_cast<const int8_t*>(vbits), esize, isfloat,
      static_cast<const int32_t*>(slots), n, capacity, static_cast<int64_t*>(k1),
      static_cast<int64_t*>(k2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_remove_claim(const void* perm, int64_t n, const void* k1, const void* k2,
                                     const void* cnt, const void* data, const void* vbit,
                                     int64_t esize, int64_t isfloat, int64_t K, int64_t capacity,
                                     const void* vals, const void* vbits, void* claim,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // 8 warps: 8 sorted positions a block
  remove_claim_kernel<<<ksql::blocks_for(n * 32, threads), threads, 0, st>>>(
      static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(k1),
      static_cast<const int64_t*>(k2), static_cast<const int64_t*>(cnt), data,
      static_cast<const int8_t*>(vbit), esize, isfloat, K, capacity, vals,
      static_cast<const int8_t*>(vbits), static_cast<int32_t*>(claim));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_remove_apply(const void* perm, int64_t n, const void* k1,
                                     const void* claim, void* cnt, void* data, void* vbit,
                                     int64_t esize, int64_t isfloat, int64_t K, int64_t capacity,
                                     void* winners, void* stream) {
  if (K > KSQL_MAX_VEC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // the size of the compact kernel's scan buffer
  const int64_t blocks = n < 1024 ? (n < 1 ? 1 : n) : 1024;
  remove_compact_kernel<<<static_cast<int>(blocks), threads, 0, st>>>(
      static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(k1),
      static_cast<const int32_t*>(claim), static_cast<int64_t*>(cnt), data,
      static_cast<int8_t*>(vbit), esize, isfloat, K, capacity,
      static_cast<unsigned long long*>(winners));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  remove_dump_kernel<<<1, threads, 0, st>>>(
      n, static_cast<const int64_t*>(cnt), data, static_cast<int8_t*>(vbit), esize, isfloat, K,
      capacity, static_cast<const unsigned long long*>(winners));
  return static_cast<int>(cudaGetLastError());
}
