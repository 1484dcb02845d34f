// K20 vec_collect: fold a micro-batch into a collect group (COLLECT_LIST,
// COLLECT_SET, EARLIEST_BY_OFFSET(n), LATEST_BY_OFFSET(n)) or the first
// phase of a histogram (HISTOGRAM, ATTR).
//
// Replaces ops/hash_store.py:_vec_collect, :_batch_membership and
// :_slot_ranks, and phase 1 of :_vec_hist (B18).  State per slot: cnt
// (int64), data[K] (int8/int32/int64/float64 values) and vbit[K] (int8 null
// bits).  Modes: 0 append, 1 set, 2 ring, 3 hist.  A row contributes when
// head > 0 and its slot is not the dump slot C.  Launches, with K13
// seg_sort (csrc/seg_sort.cu) between them from ops/vector.py:
//   keys: one thread a row; every row keeps its slot's count as the batch
//     found it (snap).  append/ring: eff = slot if it contributes, else C,
//     and the contributing rows are counted (kept).  set/hist: the sort keys
//     of the first-occurrence order, k1 = eff0 * 2 + bit (eff0 = slot if it
//     contributes, else C) and k2 = the value's XLA sort key; eff = C.
//   [K13 on (k1, k2)] member (set/hist): one block a sorted position; the
//     block at the start of a contributing slot's run (the rows of one
//     slot are adjacent, by bit and value), and the block at each multiple
//     of 256 inside one, reads the slot's stored prefix of min(cnt, K)
//     entries into a hash table in shared memory (their (sort key, bit)
//     pairs; a NaN is never inserted: it equals nothing): once a slot and
//     256 of its rows, so no block walks a hot slot's whole run.  Then a
//     thread a position up to the next multiple of 256: a row is the first
//     of its (slot, value, bit) when its k1 or value differs from the
//     previous position's (zeros and NaNs
//     share keys, the order is stable, so the first is the lowest row, as
//     in the reference; a NaN equals nothing, so each NaN is first), and is
//     kept (eff = slot) when it is first and its (value, bit) is not in the
//     table (IEEE equality for doubles); the kept rows are counted.  Every
//     other block exits.
//   [K13 on (eff, eff)] place: one thread a sorted position.  The kept
//     rows sort first ([0, kept)), the rest form the dump run [kept, n).  A
//     kept row's slot run [lo, hi) comes from its warp's ballot of run
//     heads, and for a run that crosses the warp's edge from warp-wide
//     32-way searches (a few rounds of 32 probes); rank = p - lo; pos =
//     count + rank (int32), the count the snap (C's own for the dump run).
//     ring: a kept row writes when pos >= count + (hi - lo) - K, at pos %
//     K; the others: when pos < K, at min(pos, K - 1).  A writer stores its
//     value and bit (the cells are distinct); every other row aims at the
//     dump row's cell, and the rows of a warp aimed at one cell make one
//     atomicMax of the highest row (XLA's duplicate scatter leaves the last
//     row).  The run's first row stores the slot's new count (the kept
//     rows added; hist: the written ones): no row reads a count the launch
//     writes.  The last block to finish (a wrapping atomicInc ticket after
//     a __threadfence) writes the dump row's cells from the winning rows
//     and leaves its scratch clean.
//
// Bound: bytes.  The least work reads the batch (head, value, bit, slot:
// 21 bytes a row at int64 values), each kept row's slot count and, in set
// and hist modes, the contributing slots' stored prefixes (min(cnt, K) x 9
// bytes, once a slot), and writes the kept cells; the two sorts are the
// design's extra passes.
#include "common.cuh"

namespace {

constexpr int64_t kSet = 1, kRing = 2, kHist = 3;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // the cells a member or last place thread loads at once
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) collect_keys_kernel(
    int64_t mode, const int64_t* __restrict__ head, const void* vals, const int8_t* __restrict__ vbits,
    int64_t esize, int64_t isfloat, const int32_t* __restrict__ slots, const int64_t* __restrict__ cnt,
    int64_t n, int64_t cap, int64_t* __restrict__ k1, int64_t* __restrict__ k2,
    int64_t* __restrict__ eff, int64_t* __restrict__ snap, int32_t* __restrict__ kept_total) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool contributing = false;
  int64_t slot = cap;
  if (r < n) {
    slot = slots[r];
    contributing = head[r] > 0 && slot != cap;
    if (contributing) snap[r] = cnt[slot];
  }
  if (mode != kSet && mode != kHist) {
    // append/ring keep every contributing row: count them for the place launch
    const int kept = __syncthreads_count(contributing);
    if (threadIdx.x == 0 && kept > 0) atomicAdd(kept_total, kept);
    if (r < n) eff[r] = contributing ? slot : cap;
    return;
  }
  if (r >= n) return;
  k1[r] = (contributing ? slot : cap) * 2 + (vbits[r] != 0);
  k2[r] = ksql::sort_key(ksql::load_elem(vals, r, esize), isfloat);
  eff[r] = cap;
}

__device__ __forceinline__ uint32_t table_hash(int64_t key, int8_t bit, int64_t mask) {
  return static_cast<uint32_t>(ksql::mix64(static_cast<uint64_t>(key) * 2 + (bit != 0)) & mask);
}

__global__ void __launch_bounds__(kThreads, 8) collect_member_kernel(
    const int32_t* __restrict__ perm, int64_t n, const int64_t* __restrict__ k1, const void* vals,
    const int8_t* __restrict__ vbits, int64_t esize, int64_t isfloat,
    const int64_t* __restrict__ cnt, const void* data, const int8_t* __restrict__ vbit, int64_t K,
    int64_t cap, int64_t table, int64_t* __restrict__ eff, int32_t* __restrict__ kept_total) {
  extern __shared__ int64_t smem[];
  // block p0 takes the positions of its run from p0 to the next multiple of
  // 256 when its run starts at p0, or to p0 + 256 when p0 is such a
  // multiple inside a run; every other block, and the dump run's, exits
  const int64_t p0 = blockIdx.x;
  const int64_t e0 = k1[perm[p0]] >> 1;
  if (e0 == cap) return;
  if (p0 % kThreads != 0 && (k1[perm[p0 - 1]] >> 1) == e0) return;
  const int64_t c = cnt[e0];
  const int64_t m = c < 0 ? 0 : (c < K ? c : K);
  int64_t size = 32;  // the run's table: twice its prefix, at most `table`
  while (size < 2 * m && size < table) size <<= 1;
  const int64_t mask = size - 1;
  int64_t* skey = smem;                                    // m sort keys
  int32_t* tab = reinterpret_cast<int32_t*>(smem + K);    // prefix index + 1, 0 empty
  int8_t* sbit = reinterpret_cast<int8_t*>(tab + table);  // m null bits
  for (int64_t t = threadIdx.x; t < size; t += kThreads) tab[t] = 0;
  __syncthreads();
  for (int64_t t0 = 0; t0 < m; t0 += kThreads * kUnroll) {
    int64_t v[kUnroll];
    int8_t b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the loads first, all in flight
      const int64_t t = t0 + u * kThreads + threadIdx.x;
      if (t < m) {
        v[u] = ksql::load_elem(data, e0 * K + t, esize);
        b[u] = vbit[e0 * K + t];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = t0 + u * kThreads + threadIdx.x;
      if (t >= m) continue;
      skey[t] = ksql::sort_key(v[u], isfloat);
      sbit[t] = b[u];
      if (isfloat && ksql::as_f64(v[u]) != ksql::as_f64(v[u])) continue;  // a NaN matches nothing
      for (uint32_t h = table_hash(skey[t], b[u], mask);; h = (h + 1) & mask) {
        if (atomicCAS(&tab[h], 0, static_cast<int32_t>(t + 1)) == 0) break;
      }
    }
  }
  __syncthreads();
  int kept = 0;
  const int64_t p = p0 + threadIdx.x;
  if (p < n && p < (p0 / kThreads + 1) * kThreads) {
    const int64_t r = perm[p];
    const int64_t kr = k1[r];
    if ((kr >> 1) == e0) {  // else past the run: the order is sorted
      const int64_t v = ksql::load_elem(vals, r, esize);
      bool keep = p == 0;  // the first of its (slot, value, bit): the lowest row
      if (!keep) {
        const int64_t q = perm[p - 1];
        keep = k1[q] != kr || !ksql::elem_eq(ksql::load_elem(vals, q, esize), v, isfloat);
      }
      if (keep && !(isfloat && ksql::as_f64(v) != ksql::as_f64(v))) {
        const int8_t b = vbits[r];
        const int64_t key = ksql::sort_key(v, isfloat);
        for (uint32_t h = table_hash(key, b, mask);; h = (h + 1) & mask) {
          const int32_t at = tab[h];
          if (at == 0) break;
          if (skey[at - 1] == key && sbit[at - 1] == b) {
            keep = false;
            break;
          }
        }
      }
      eff[r] = keep ? e0 : cap;
      kept = keep;
    }
  }
  // the segment's kept rows, for the place launch: one atomic a warp
  kept = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(kept)));
  if ((threadIdx.x & 31) == 0 && kept > 0) atomicAdd(kept_total, kept);
}

// The first sorted positions of two warp-uniform searches at once, each a
// lower (`upper` false: key >= x) or upper (key > x) bound over eff[perm[q]]
// in [a, b) (b if none; an empty range is skipped): 32 probes a round each,
// each round narrowing its range 32-fold, the two rounds' loads in flight
// together.
__device__ __forceinline__ void warp_bounds(const int32_t* perm, const int64_t* key, int64_t& a1,
                                            int64_t b1, int64_t x1, bool upper1, int64_t& a2, int64_t b2,
                                            int64_t x2, bool upper2, int lane) {
  while (a1 < b1 || a2 < b2) {
    const int64_t s1 = (b1 - a1 + 31) / 32, s2 = (b2 - a2 + 31) / 32;
    const int64_t q1 = a1 + (lane + 1) * s1 - 1, q2 = a2 + (lane + 1) * s2 - 1;
    const bool in1 = a1 < b1 && q1 < b1, in2 = a2 < b2 && q2 < b2;
    const int64_t r1 = in1 ? perm[q1] : 0, r2 = in2 ? perm[q2] : 0;
    const int64_t v1 = in1 ? key[r1] : 0, v2 = in2 ? key[r2] : 0;
    const int64_t c1 = __popc(__ballot_sync(kFull, in1 && (v1 < x1 || (upper1 && v1 == x1))));
    const int64_t c2 = __popc(__ballot_sync(kFull, in2 && (v2 < x2 || (upper2 && v2 == x2))));
    if (a1 < b1) {
      if (s1 == 1) {
        a1 += c1;
        b1 = a1;
      } else {
        const int64_t nb = a1 + (c1 + 1) * s1 - 1;  // probe c1: the first not below, if in range
        a1 += c1 * s1;
        b1 = nb < b1 ? nb : b1;
      }
    }
    if (a2 < b2) {
      if (s2 == 1) {
        a2 += c2;
        b2 = a2;
      } else {
        const int64_t nb = a2 + (c2 + 1) * s2 - 1;
        a2 += c2 * s2;
        b2 = nb < b2 ? nb : b2;
      }
    }
  }
}

// scratch: K dump cells (-1 between calls), the kept count (0), the done
// ticket (0)
__global__ void __launch_bounds__(kThreads) collect_place_kernel(
    int64_t mode, const int32_t* __restrict__ perm, int64_t n, const int64_t* __restrict__ eff,
    const int64_t* __restrict__ snap, int64_t* __restrict__ cnt, void* data, int8_t* __restrict__ vbit,
    int64_t esize, int64_t K, int64_t cap, const void* vals, const int8_t* __restrict__ vbits,
    int32_t* __restrict__ scratch) {
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1;  // lanes <= this one
  const int32_t k32 = static_cast<int32_t>(K);
  int32_t* dumplast = scratch;
  const int64_t kept = scratch[K];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  const int64_t p = base + lane;
  if (base < n) {
    const bool valid = p < n;
    const int64_t r = valid ? perm[p] : 0;
    const int64_t e = valid ? (p < kept ? eff[r] : cap) : -1;
    int64_t prev = __shfl_up_sync(kFull, e, 1);
    if (lane == 0) prev = p == 0 ? -1 : (p - 1 < kept ? eff[perm[p - 1]] : cap);
    // a lane past n counts as a head, so no run reaches past n
    const unsigned heads = __ballot_sync(kFull, !valid || prev != e);
    const int64_t e_first = __shfl_sync(kFull, e, 0), e_last = __shfl_sync(kFull, e, 31);
    const int64_t next = base + 32;
    // the warp's first run began before it, its last goes on past it: the
    // dump run is [kept, n); a kept run is found in [0, kept)
    int64_t lo_run = base, hi_run = next < n ? next : n;
    const bool back = !(heads & 1u) && e_first != cap;
    const bool across = next < kept && e_last != cap && eff[perm[next]] == e_last;
    if (!(heads & 1u) && e_first == cap) lo_run = kept;
    if (e_last == cap) hi_run = n;
    int64_t lo_b = back ? 0 : base, hi_a = across ? next : hi_run;
    if (back || across) {
      warp_bounds(perm, eff, lo_b, base, e_first, false, hi_a, across ? kept : hi_a, e_last, true, lane);
      if (back) lo_run = lo_b;
      if (across) hi_run = hi_a;
    }
    const unsigned below = heads & upto, above = heads & ~upto;
    const int64_t lo = below ? base + 31 - __clz(below) : lo_run;
    const int64_t hi = above ? base + __ffs(above) - 1 : hi_run;
    int64_t tpos = -1;
    bool write = false;
    if (valid) {
      const bool is_kept = e != cap;
      const int64_t c = is_kept ? snap[r] : cnt[cap];
      const int32_t c32 = static_cast<int32_t>(c);
      const int32_t pos = static_cast<int32_t>(static_cast<uint32_t>(c32) + static_cast<uint32_t>(p - lo));
      if (mode == kRing) {
        const int32_t end = static_cast<int32_t>(static_cast<uint32_t>(c32) +
                                                 static_cast<uint32_t>(is_kept ? hi - lo : 0));
        write = is_kept && pos >= end - k32;
        tpos = ksql::floor_mod(pos, K);
      } else {
        write = is_kept && pos < k32;
        tpos = pos < 0 ? 0 : (pos > k32 - 1 ? k32 - 1 : pos);
      }
      if (write) {
        ksql::store_elem(data, e * K + tpos, esize, ksql::load_elem(vals, r, esize));
        vbit[e * K + tpos] = vbits[r];
      }
      if (is_kept && p == lo) {
        const int64_t len = hi - lo;
        int64_t add = len;
        if (mode == kHist) {
          const int64_t room = K - c32;
          add = room < 0 ? 0 : (room < len ? room : len);
        }
        cnt[e] = ksql::wadd(c, add);  // the run's one writer; every reader read the snap
      }
    }
    // the rows of the warp aimed at one dump cell: one atomicMax of the highest
    const bool aim = valid && !write;
    const unsigned peers = __match_any_sync(kFull, aim ? tpos : -1 - lane);
    if (aim) {
      const int best = __reduce_max_sync(peers, static_cast<int>(r));
      if (lane == __ffs(peers) - 1) atomicMax(&dumplast[tpos], best);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicInc(reinterpret_cast<unsigned*>(&scratch[K + 1]), gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every block's atomicMax is done and the kept count read
  __threadfence();
  for (int64_t t0 = 0; t0 < K; t0 += kThreads * kUnroll) {
    int32_t r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the cells first, all in flight
      const int64_t t = t0 + u * kThreads + threadIdx.x;
      r[u] = t < K ? atomicExch(&dumplast[t], -1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] < 0) continue;
      const int64_t t = t0 + u * kThreads + threadIdx.x;
      ksql::store_elem(data, cap * K + t, esize, ksql::load_elem(vals, r[u], esize));
      vbit[cap * K + t] = vbits[r[u]];
    }
  }
  if (threadIdx.x == 0) scratch[K] = 0;
}

// the dynamic shared memory collect_member_kernel is allowed, bytes
int64_t g_member_smem = 48 * 1024;

}  // namespace

// scratch: K + 2 int32 cells, the dump row's K (-1 between calls), the
// count of kept rows and the place launch's done ticket (0 between calls);
// the place launch leaves them so.
extern "C" int ksql_vec_collect_keys(int64_t mode, const void* head, const void* vals,
                                     const void* vbits, int64_t esize, int64_t isfloat,
                                     const void* slots, const void* cnt, int64_t n, int64_t capacity,
                                     void* k1, void* k2, void* eff, void* snap, void* scratch, int64_t K,
                                     void* stream) {
  collect_keys_kernel<<<ksql::blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const int64_t*>(head), vals, static_cast<const int8_t*>(vbits), esize,
      isfloat, static_cast<const int32_t*>(slots), static_cast<const int64_t*>(cnt), n, capacity,
      static_cast<int64_t*>(k1), static_cast<int64_t*>(k2), static_cast<int64_t*>(eff),
      static_cast<int64_t*>(snap), static_cast<int32_t*>(scratch) + K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_collect_member(const void* perm, int64_t n, const void* k1,
                                       const void* vals, const void* vbits, int64_t esize,
                                       int64_t isfloat, const void* cnt, const void* data,
                                       const void* vbit, int64_t K, int64_t capacity, void* eff,
                                       void* scratch, void* stream) {
  int64_t table = 64;
  while (table < 2 * K) table <<= 1;
  const int64_t smem = K * 8 + table * 4 + K;
  if (smem > g_member_smem) {
    if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        collect_member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_member_smem = smem;
  }
  collect_member_kernel<<<static_cast<unsigned>(n), kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(k1), vals,
      static_cast<const int8_t*>(vbits), esize, isfloat, static_cast<const int64_t*>(cnt), data,
      static_cast<const int8_t*>(vbit), K, capacity, table, static_cast<int64_t*>(eff),
      static_cast<int32_t*>(scratch) + K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_vec_collect_place(int64_t mode, const void* perm, int64_t n,
                                      const void* eff, const void* snap, void* cnt, void* data,
                                      void* vbit, int64_t esize, int64_t K, int64_t capacity,
                                      const void* vals, const void* vbits, void* scratch, void* stream) {
  collect_place_kernel<<<ksql::blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const int32_t*>(perm), n, static_cast<const int64_t*>(eff),
      static_cast<const int64_t*>(snap), static_cast<int64_t*>(cnt), data, static_cast<int8_t*>(vbit),
      esize, K, capacity, vals, static_cast<const int8_t*>(vbits), static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
