// K20 vec_collect: fold a micro-batch into a collect group (COLLECT_LIST,
// COLLECT_SET, EARLIEST_BY_OFFSET(n), LATEST_BY_OFFSET(n)) or the first
// phase of a histogram (HISTOGRAM, ATTR).
//
// Replaces ops/hash_store.py:_vec_collect, :_batch_membership and
// :_slot_ranks, and phase 1 of :_vec_hist (B18).  State per slot: cnt
// (int64), data[K] (int8/int32/int64/float64 values) and vbit[K] (int8 null
// bits).  Modes: 0 append, 1 set, 2 ring, 3 hist.  Launches, with K13
// seg_sort (csrc/seg_sort.cu) between them from ops/vector.py:
//   prologue: one warp a row.  A row contributes when head > 0 and its slot
//     is not the dump slot C.  append/ring: eff = slot if it contributes,
//     else C.  set/hist: the warp scans the slot's stored prefix of
//     min(cnt, K) entries for an equal (value, bit) (IEEE equality for
//     doubles) and writes the sort keys of the first-occurrence order,
//     k1 = eff0 * 2 + bit and k2 = the value's XLA sort key.
//   [K13 on (k1, k2)] first (set/hist): per sorted position, a row is the
//     first of its (slot, value, bit) when its k1 or value differs from the
//     previous position's; a row is kept (eff = slot) when it contributes,
//     is no member and is first.  Equal values are adjacent in the order
//     (zeros and NaNs share keys), the order is stable, so the first is the
//     lowest row, as in the reference; a NaN equals nothing, so each NaN is
//     first.
//   [K13 on (eff, eff)] place: per sorted position p of row r, its slot
//     run [lo, hi) by binary search; rank = p - lo; pos = cnt[eff] + rank
//     (int32).  ring: a kept row writes when pos >= cnt + (hi - lo) - K, at
//     pos % K; the others: when pos < K, at min(pos, K - 1).  A writer
//     stores its value and bit (the cells are distinct); every other row
//     aims at the dump row's cell and takes it with atomicMax of its row
//     index (XLA's duplicate scatter leaves the last row).  The run's first
//     row records the count to add (the kept rows; hist: the written ones).
//   finish: the dump row's cells from the winning rows, the count adds.
//
// Bound: bytes.  The least work reads the batch (head, value, bit, slot:
// 21 bytes a row at int64 values), each kept row's slot count and, in set
// and hist modes, the contributing rows' stored prefixes (min(cnt, K) x 9
// bytes), and writes the kept cells; the two sorts and the binary searches
// are the design's extra passes.  One warp a row for the prefix scan keeps
// its loads coalesced along the slot's row.
#include "common.cuh"

namespace {

constexpr int64_t kSet = 1, kRing = 2, kHist = 3;

__global__ void collect_prologue_kernel(int64_t mode, const int64_t* __restrict__ cnt,
                                        const void* data, const int8_t* __restrict__ vbit,
                                        int64_t esize, int64_t isfloat, int64_t K, int64_t cap,
                                        const int64_t* __restrict__ head, const void* vals,
                                        const int8_t* __restrict__ vbits,
                                        const int32_t* __restrict__ slots, int64_t n,
                                        int8_t* __restrict__ flags, int64_t* __restrict__ k1,
                                        int64_t* __restrict__ k2, int64_t* __restrict__ eff) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n) return;
  const int64_t slot = slots[r];
  const bool contributing = head[r] > 0 && slot != cap;
  if (mode != kSet && mode != kHist) {
    if (lane == 0) eff[r] = contributing ? slot : cap;
    return;
  }
  const int64_t v = ksql::load_elem(vals, r, esize);
  const int8_t b = vbits[r];
  bool member = false;
  if (contributing) {
    const int64_t c = cnt[slot];
    const int64_t m = c < K ? c : K;
    const int64_t row = slot * K;
    for (int64_t base = 0; base < m && !member; base += 32) {
      const int64_t p = base + lane;
      const bool eq = p < m && vbit[row + p] == b &&
                      ksql::elem_eq(ksql::load_elem(data, row + p, esize), v, isfloat);
      member = __any_sync(0xffffffffu, eq);
    }
  }
  if (lane == 0) {
    const int64_t eff0 = contributing ? slot : cap;
    flags[r] = contributing && !member;
    k1[r] = eff0 * 2 + (b != 0);
    k2[r] = ksql::sort_key(v, isfloat);
  }
}

__global__ void collect_first_kernel(const int32_t* __restrict__ perm, int64_t n,
                                     const int64_t* __restrict__ k1, const void* vals,
                                     int64_t esize, int64_t isfloat,
                                     const int8_t* __restrict__ flags,
                                     const int32_t* __restrict__ slots, int64_t cap,
                                     int64_t* __restrict__ eff) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t r = perm[p];
  bool first = true;
  if (p > 0) {
    const int64_t q = perm[p - 1];
    first = k1[q] != k1[r] ||
            !ksql::elem_eq(ksql::load_elem(vals, q, esize), ksql::load_elem(vals, r, esize), isfloat);
  }
  eff[r] = (flags[r] && first) ? static_cast<int64_t>(slots[r]) : cap;
}

__global__ void collect_place_kernel(int64_t mode, const int32_t* __restrict__ perm, int64_t n,
                                     const int64_t* __restrict__ eff,
                                     const int64_t* __restrict__ cnt, void* data,
                                     int8_t* __restrict__ vbit, int64_t esize, int64_t K,
                                     int64_t cap, const void* vals,
                                     const int8_t* __restrict__ vbits,
                                     int32_t* __restrict__ dumplast, int64_t* __restrict__ inc) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t r = perm[p];
  const int64_t e = eff[r];
  const int64_t lo = ksql::bound_of(perm, eff, n, e, false);
  const int64_t hi = ksql::bound_of(perm, eff, n, e, true);
  const bool kept = e != cap;
  const int32_t c32 = static_cast<int32_t>(cnt[e]);
  const int32_t pos = static_cast<int32_t>(static_cast<uint32_t>(c32) +
                                           static_cast<uint32_t>(p - lo));
  const int32_t k32 = static_cast<int32_t>(K);
  bool write;
  int64_t tpos;
  if (mode == kRing) {
    const int32_t end = static_cast<int32_t>(static_cast<uint32_t>(c32) +
                                             static_cast<uint32_t>(kept ? hi - lo : 0));
    write = kept && pos >= end - k32;
    tpos = ksql::floor_mod(pos, K);
  } else {
    write = kept && pos < k32;
    tpos = pos < 0 ? 0 : (pos > k32 - 1 ? k32 - 1 : pos);
  }
  if (write) {
    ksql::store_elem(data, e * K + tpos, esize, ksql::load_elem(vals, r, esize));
    vbit[e * K + tpos] = vbits[r];
  } else {
    atomicMax(&dumplast[tpos], static_cast<int32_t>(r));
  }
  int64_t add = 0;
  if (kept && p == lo) {
    const int64_t len = hi - lo;
    if (mode == kHist) {
      const int64_t room = K - c32;
      add = room < 0 ? 0 : (room < len ? room : len);
    } else {
      add = len;
    }
  }
  inc[r] = add;
}

__global__ void collect_finish_kernel(int64_t n, const int64_t* __restrict__ eff,
                                      int64_t* __restrict__ cnt, void* data,
                                      int8_t* __restrict__ vbit, int64_t esize, int64_t K,
                                      int64_t cap, const void* vals,
                                      const int8_t* __restrict__ vbits,
                                      const int32_t* __restrict__ dumplast,
                                      const int64_t* __restrict__ inc) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < K) {
    const int32_t r = dumplast[t];
    if (r >= 0) {
      ksql::store_elem(data, cap * K + t, esize, ksql::load_elem(vals, r, esize));
      vbit[cap * K + t] = vbits[r];
    }
  }
  if (t < n && inc[t] != 0) cnt[eff[t]] = ksql::wadd(cnt[eff[t]], inc[t]);
}

}  // namespace

extern "C" int ksql_vec_collect_prologue(int64_t mode, const void* cnt, const void* data,
                                         const void* vbit, int64_t esize, int64_t isfloat,
                                         int64_t K, int64_t capacity, const void* head,
                                         const void* vals, const void* vbits, const void* slots,
                                         int64_t n, void* flags, void* k1, void* k2, void* eff,
                                         void* stream) {
  const int threads = 256;
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  collect_prologue_kernel<<<static_cast<int>(blocks < 1 ? 1 : blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const int64_t*>(cnt), data, static_cast<const int8_t*>(vbit), esize,
      isfloat, K, capacity, static_cast<const int64_t*>(head), vals,
      static_cast<const int8_t*>(vbits), static_cast<const int32_t*>(slots), n,
      static_cast<int8_t*>(flags), static_cast<int64_t*>(k1), static_cast<int64_t*>(k2),
      static_cast<int64_t*>(eff));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_collect_first(const void* perm, int64_t n, const void* k1,
                                      const void* vals, int64_t esize, int64_t isfloat,
                                      const void* flags, const void* slots, int64_t capacity,
                                      void* eff, void* stream) {
  const int threads = 256;
  collect_first_kernel<<<ksql::blocks_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(k1), vals, esize,
      isfloat, static_cast<const int8_t*>(flags), static_cast<const int32_t*>(slots), capacity,
      static_cast<int64_t*>(eff));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_collect_place(int64_t mode, const void* perm, int64_t n,
                                      const void* eff, void* cnt, void* data, void* vbit,
                                      int64_t esize, int64_t K, int64_t capacity,
                                      const void* vals, const void* vbits, void* dumplast,
                                      void* inc, void* stream) {
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  collect_place_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      mode, static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(eff),
      static_cast<const int64_t*>(cnt), data, static_cast<int8_t*>(vbit), esize, K, capacity,
      vals, static_cast<const int8_t*>(vbits), static_cast<int32_t*>(dumplast),
      static_cast<int64_t*>(inc));
  collect_finish_kernel<<<ksql::blocks_for(n > K ? n : K, threads), threads, 0, st>>>(
      n, static_cast<const int64_t*>(eff), static_cast<int64_t*>(cnt), data,
      static_cast<int8_t*>(vbit), esize, K, capacity, vals, static_cast<const int8_t*>(vbits),
      static_cast<const int32_t*>(dumplast), static_cast<const int64_t*>(inc));
  return static_cast<int>(cudaGetLastError());
}
