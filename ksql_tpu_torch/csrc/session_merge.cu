// K15 session_merge: the segmented interval merge of the session step.
//
// Replaces runtime/lowering.py:post_session_exchange's sort-apply,
// associative_scan (the segmented running max of the session ends),
// boundary and cumsum, its jax.ops.segment_* folds, key_id/key_first_seg
// and rank, and sess_ovf (:3618-3715 of the reference; B16).  It writes no
// store state.  Three launches:
//   1. permute (one thread per sorted position p): K13's permutation
//      applied to every item column (kh, start, end, alive, slot, key
//      reprs, components); isrow = the item was a row and is alive.
//      Thread 0 zeroes sess_ovf.
//   2. runs (one thread per run of equal kh, started at the run's first
//      position, the others return): the thread walks its run in sorted
//      order with the running max of end (the reference's segend); a
//      position opens a segment when it opens the run or its start lies
//      more than the gap past the running max of the positions before it.
//      Per segment it folds, in item order, min start, max end, alive,
//      holds-an-alive-row, the lowest row index of its alive rows, the key
//      reprs (max over alive items, INT64_MIN if none) and every
//      component (dead items as the component's init): add sums (int
//      sums wrap; float64 sums add in item order, the order of XLA's CPU
//      segment_sum, so they agree bit for bit), min/max by XLA's rules
//      (NaN wins, -0.0 below +0.0).  The results go to the segment's first
//      position; every position gets segfirst (its segment's first
//      position) and rank (its segment's index within the run).  Runs are
//      contiguous after the sort, so no two threads touch one segment and
//      nothing is atomic.
//   3. finish (one thread per position): winner = the position opens an
//      alive segment; ins_act = winner and rank < S; K2's base slot for
//      (kh, rank); the key reprs of the segment for K2; sess_ovf += the
//      winners with rank >= S (one atomic per warp).
// Position 0 always opens a run and a segment (the reference compares it
// with a key of -1 and a running end of INT64_MIN: the same unless a key
// hash is exactly -1).
//
// argset mode (EARLIEST/LATEST_BY_OFFSET; :3671-3694 of the reference): an
// argset component's segment value is the sum, in item order from +0, of
// the values of the alive items whose order (the nearest order component
// before it, an int64 min or max of unique sequence numbers) equals the
// segment's final order and is not the init.  The walk carries it beside
// the running order in a register: an alive item whose order is strictly
// better than the running order restarts the sum at 0 + value, one that
// ties adds its value, any other leaves it.  Starting from +0 is the
// reference's segment_sum: a -0.0 payload comes out +0.0, NaN stays NaN.
//
// Bound: bytes, and the serial walk of the longest run.  Every item column
// is read and written about twice (~100 bytes an item at one key and two
// int64 components: ~53 MB at 532,480 items, ~16 us at 3.35 TB/s); the
// hottest key's run (its rows and stored sessions: ~2,100 items at
// BASELINE #5's zipf(1.3) traffic) is walked by one thread, which is the
// real limit of this first version.  The open segment's folds stay in
// registers (local memory for wide queries), so an item costs its own
// loads and no load-store round trip on an accumulator.  A block per long
// run with a segmented block scan is the later speed-up.
#include "common.cuh"

namespace {

constexpr int64_t kI32Max = 2147483647;
constexpr int64_t kArgset = 3;  // ops/hash_store.py _COMBINE_CODES

struct MergeCols {
  const void* src[KSQL_MAX_COMPS];  // unsorted item components
  void* srt[KSQL_MAX_COMPS];        // sorted item components
  void* seg[KSQL_MAX_COMPS];        // per-segment folds (at first positions)
  int64_t kind[KSQL_MAX_COMPS];     // combine * 3 + dtype
  int64_t init[KSQL_MAX_COMPS];     // init value's bits
};

struct MergeOut {
  int64_t *kh, *start, *end;
  bool *alive, *isrow;
  int32_t* slot;
  int64_t* reprs;
  int32_t* segfirst;
  int64_t *rank, *seg_start, *seg_end;
  bool *seg_alive, *seg_has_row;
  int64_t *seg_minrow, *seg_reprs;
  bool *winner, *ins_act;
  int32_t* base;
  int64_t* ins_reprs;
  unsigned long long* sess_ovf;
};

__device__ __forceinline__ int64_t elem_size(int64_t dtype) { return dtype == ksql::kInt32 ? 4 : 8; }

__global__ void permute_kernel(const int32_t* __restrict__ perm, int64_t m, int64_t n,
                               const int64_t* __restrict__ kh, const int64_t* __restrict__ start,
                               const int64_t* __restrict__ end, const bool* __restrict__ alive,
                               const int32_t* __restrict__ slot, const int64_t* __restrict__ reprs,
                               int64_t k, MergeCols c, int64_t ncomp, MergeOut o) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p == 0) *o.sess_ovf = 0;
  if (p >= m) return;
  const int64_t q = perm[p];
  const bool a = alive[q];
  o.kh[p] = kh[q];
  o.start[p] = start[q];
  o.end[p] = end[q];
  o.alive[p] = a;
  o.isrow[p] = q < n && a;
  o.slot[p] = slot[q];
  for (int64_t r = 0; r < k; ++r) o.reprs[r * m + p] = reprs[r * m + q];
  for (int64_t j = 0; j < ncomp; ++j) {
    ksql::copy_elem(c.srt[j], p, c.src[j], q, elem_size(c.kind[j] % 3));
  }
}

// The identity of a component's fold (the value before a segment's first
// item), as bits.
__device__ __forceinline__ int64_t fold_identity(int64_t kind) {
  const int64_t combine = kind / 3, dtype = kind % 3;
  if (combine == ksql::kAdd || combine == kArgset) return 0;
  const bool is_min = combine == ksql::kMin;
  if (dtype == ksql::kInt32) return is_min ? kI32Max : -kI32Max - 1;
  if (dtype == ksql::kInt64) return is_min ? INT64_MAX : INT64_MIN;
  // float64 +inf / -inf
  return is_min ? int64_t{0x7ff0000000000000} : static_cast<int64_t>(0xfff0000000000000ull);
}

// acc (bits) folded with value v (bits) by the component's combine.
__device__ __forceinline__ int64_t fold_bits(int64_t kind, int64_t acc, int64_t v) {
  const int64_t combine = kind / 3, dtype = kind % 3;
  if (dtype == ksql::kFloat64) {
    const double a = __longlong_as_double(acc), b = __longlong_as_double(v);
    double r;
    if (combine == ksql::kAdd) {
      r = a + b;
    } else if (combine == ksql::kMin) {
      r = ksql::xla_min(a, b);
    } else {
      r = ksql::xla_max(a, b);
    }
    return __double_as_longlong(r);
  }
  if (dtype == ksql::kInt32) {
    const int32_t a = static_cast<int32_t>(acc), b = static_cast<int32_t>(v);
    int32_t r;
    if (combine == ksql::kAdd) {
      r = static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
    } else if (combine == ksql::kMin) {
      r = a < b ? a : b;
    } else {
      r = a > b ? a : b;
    }
    return r;
  }
  if (combine == ksql::kAdd) return ksql::wadd(acc, v);
  if (combine == ksql::kMin) return acc < v ? acc : v;
  return acc > v ? acc : v;
}

__device__ __forceinline__ int64_t load_bits(const void* col, int64_t i, int64_t dtype) {
  if (dtype == ksql::kInt32) return static_cast<const int32_t*>(col)[i];
  return static_cast<const int64_t*>(col)[i];
}

__device__ __forceinline__ void store_bits(void* col, int64_t i, int64_t dtype, int64_t bits) {
  if (dtype == ksql::kInt32) {
    static_cast<int32_t*>(col)[i] = static_cast<int32_t>(bits);
  } else {
    static_cast<int64_t*>(col)[i] = bits;
  }
}

// The open segment's key reprs and component folds live in arrays of MK
// and MC entries.  At up to kRegKeys keys and kRegComps components the
// loops over them run to the arrays' width and unroll, each step guarded
// by the query's count, so every index is a constant and the arrays stay
// in registers; wider queries loop to their own counts and keep the
// arrays in the thread's local memory (L1), since registers for
// KSQL_MAX_COMPS components spill and cut the occupancy that the other
// runs' threads need.
constexpr int kRegKeys = 2;
constexpr int kRegComps = 4;

template <int W, int R>
__device__ __forceinline__ int64_t loop_bound(int64_t count) {
  return W <= R ? W : count;
}

// Writes a closed segment's folds at its first position.
template <int MC, int MK>
__device__ __forceinline__ void close_segment(const MergeCols& c, int64_t ncomp, int64_t k,
                                              int64_t m, const MergeOut& o, int64_t first,
                                              int64_t s_start, int64_t s_end, bool s_alive,
                                              bool s_row, int64_t s_minrow, const int64_t* rep,
                                              const int64_t* acc) {
  o.seg_start[first] = s_start;
  o.seg_end[first] = s_end;
  o.seg_alive[first] = s_alive;
  o.seg_has_row[first] = s_row;
  o.seg_minrow[first] = s_minrow;
#pragma unroll(MK <= kRegKeys ? MK : 1)
  for (int r = 0; r < loop_bound<MK, kRegKeys>(k); ++r) {
    if (r < k) o.seg_reprs[r * m + first] = rep[r];
  }
#pragma unroll(MC <= kRegComps ? MC : 1)
  for (int j = 0; j < loop_bound<MC, kRegComps>(ncomp); ++j) {
    if (j < ncomp) store_bits(c.seg[j], first, c.kind[j] % 3, acc[j]);
  }
}

template <int MC, int MK>
__global__ void runs_kernel(const int32_t* __restrict__ perm, int64_t m, int64_t n, int64_t gap,
                            int64_t k, MergeCols c, int64_t ncomp, MergeOut o) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= m) return;
  const int64_t key = o.kh[p];
  if (p > 0 && o.kh[p - 1] == key) return;  // not the first position of its run
  int64_t runmax = INT64_MIN;
  int64_t rank = -1;
  int64_t first = p;
  int64_t s_start = INT64_MAX, s_end = INT64_MIN, s_minrow = INT64_MAX;
  bool s_alive = false, s_row = false;
  int64_t rep[MK];
  int64_t acc[MC];
  for (int64_t q = p; q < m && (q == p || o.kh[q] == key); ++q) {
    const int64_t st = o.start[q];
    if (q == p || st > ksql::wadd(runmax, gap)) {
      if (q != p) {
        close_segment<MC, MK>(c, ncomp, k, m, o, first, s_start, s_end, s_alive, s_row, s_minrow,
                              rep, acc);
      }
      first = q;
      ++rank;
      s_start = INT64_MAX;
      s_end = INT64_MIN;
      s_minrow = INT64_MAX;
      s_alive = false;
      s_row = false;
#pragma unroll(MK <= kRegKeys ? MK : 1)
      for (int r = 0; r < loop_bound<MK, kRegKeys>(k); ++r) rep[r] = INT64_MIN;
#pragma unroll(MC <= kRegComps ? MC : 1)
      for (int j = 0; j < loop_bound<MC, kRegComps>(ncomp); ++j) {
        if (j < ncomp) acc[j] = fold_identity(c.kind[j]);
      }
    }
    const int64_t en = o.end[q];
    const bool a = o.alive[q];
    if (st < s_start) s_start = st;
    if (en > s_end) s_end = en;
    s_alive = s_alive || a;
    if (o.isrow[q]) {  // isrow implies alive
      s_row = true;
      const int64_t row = perm[q] % n;
      if (row < s_minrow) s_minrow = row;
    }
    if (a) {
#pragma unroll(MK <= kRegKeys ? MK : 1)
      for (int r = 0; r < loop_bound<MK, kRegKeys>(k); ++r) {
        if (r < k) {
          const int64_t v = o.reprs[r * m + q];
          if (v > rep[r]) rep[r] = v;
        }
      }
    }
    // the nearest order component's fold before and after this item, its
    // contribution, its combine and its init (the argset payloads' key)
    int64_t ord_before = 0, ord_item = 0, ord_kind = 0, ord_init = 0;
#pragma unroll(MC <= kRegComps ? MC : 1)
    for (int j = 0; j < loop_bound<MC, kRegComps>(ncomp); ++j) {
      if (j < ncomp) {
        const int64_t kind = c.kind[j];
        if (kind / 3 == kArgset) {
          if (a && ord_item != ord_init) {
            const bool better = ord_kind / 3 == ksql::kMin ? ord_item < ord_before
                                                           : ord_item > ord_before;
            const int64_t v = load_bits(c.srt[j], q, kind % 3);
            if (better) {
              acc[j] = fold_bits(kind % 3, 0, v);  // restart: +0 + value
            } else if (ord_item == ord_before) {
              acc[j] = fold_bits(kind % 3, acc[j], v);
            }
          }
        } else {
          const int64_t v = a ? load_bits(c.srt[j], q, kind % 3) : c.init[j];
          ord_before = acc[j];
          ord_item = v;
          ord_kind = kind;
          ord_init = c.init[j];
          acc[j] = fold_bits(kind, acc[j], v);
        }
      }
    }
    o.segfirst[q] = static_cast<int32_t>(first);
    o.rank[q] = rank;
    if (en > runmax) runmax = en;
  }
  close_segment<MC, MK>(c, ncomp, k, m, o, first, s_start, s_end, s_alive, s_row, s_minrow, rep,
                        acc);
}

__global__ void finish_kernel(int64_t m, int64_t S, int64_t capacity, int64_t k, MergeOut o) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool ovf = false;
  if (p < m) {
    const int32_t sf = o.segfirst[p];
    const bool w = sf == p && o.seg_alive[sf];
    const int64_t rank = o.rank[p];
    o.winner[p] = w;
    o.ins_act[p] = w && rank < S;
    ovf = w && rank >= S;
    const uint64_t h = static_cast<uint64_t>(o.kh[p]);
    o.base[p] = static_cast<int32_t>(
        ksql::mix64(h ^ (static_cast<uint64_t>(rank) * ksql::kGold)) &
        static_cast<uint64_t>(capacity - 1));
    for (int64_t r = 0; r < k; ++r) o.ins_reprs[r * m + p] = o.seg_reprs[r * m + sf];
  }
  const unsigned votes = __ballot_sync(0xffffffffu, ovf);
  if (votes != 0 && (threadIdx.x & 31) == 0) {
    atomicAdd(o.sess_ovf, static_cast<unsigned long long>(__popc(votes)));
  }
}

}  // namespace

// comps: ncomp x (unsorted src, sorted out, segment out, combine * 3 +
// dtype, init bits).
extern "C" int ksql_session_merge(
    const void* perm, int64_t m, int64_t n, int64_t S, int64_t gap, int64_t capacity,
    const void* kh, const void* start, const void* end, const void* alive, const void* slot,
    const void* reprs, int64_t k, const int64_t* comps, int64_t ncomp, void* kh_o, void* start_o,
    void* end_o, void* alive_o, void* isrow_o, void* slot_o, void* reprs_o, void* segfirst,
    void* rank, void* seg_start, void* seg_end, void* seg_alive, void* seg_has_row,
    void* seg_minrow, void* seg_reprs, void* winner, void* ins_act, void* base, void* ins_reprs,
    void* sess_ovf, void* stream) {
  if (k > KSQL_MAX_KEYS || ncomp > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MergeCols c{};
  for (int64_t j = 0; j < ncomp; ++j) {
    c.src[j] = reinterpret_cast<const void*>(comps[5 * j]);
    c.srt[j] = reinterpret_cast<void*>(comps[5 * j + 1]);
    c.seg[j] = reinterpret_cast<void*>(comps[5 * j + 2]);
    c.kind[j] = comps[5 * j + 3];
    c.init[j] = comps[5 * j + 4];
  }
  MergeOut o{static_cast<int64_t*>(kh_o), static_cast<int64_t*>(start_o),
             static_cast<int64_t*>(end_o), static_cast<bool*>(alive_o),
             static_cast<bool*>(isrow_o), static_cast<int32_t*>(slot_o),
             static_cast<int64_t*>(reprs_o), static_cast<int32_t*>(segfirst),
             static_cast<int64_t*>(rank), static_cast<int64_t*>(seg_start),
             static_cast<int64_t*>(seg_end), static_cast<bool*>(seg_alive),
             static_cast<bool*>(seg_has_row), static_cast<int64_t*>(seg_minrow),
             static_cast<int64_t*>(seg_reprs), static_cast<bool*>(winner),
             static_cast<bool*>(ins_act), static_cast<int32_t*>(base),
             static_cast<int64_t*>(ins_reprs), static_cast<unsigned long long*>(sess_ovf)};
  const auto* perm_p = static_cast<const int32_t*>(perm);
  const int threads = 256;
  const int blocks = ksql::blocks_for(m, threads);
  permute_kernel<<<blocks, threads, 0, st>>>(
      perm_p, m, n, static_cast<const int64_t*>(kh), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(end), static_cast<const bool*>(alive),
      static_cast<const int32_t*>(slot), static_cast<const int64_t*>(reprs), k, c, ncomp, o);
  if (ncomp <= kRegComps && k <= kRegKeys) {
    runs_kernel<kRegComps, kRegKeys><<<blocks, threads, 0, st>>>(perm_p, m, n, gap, k, c, ncomp, o);
  } else {
    runs_kernel<KSQL_MAX_COMPS, KSQL_MAX_KEYS>
        <<<blocks, threads, 0, st>>>(perm_p, m, n, gap, k, c, ncomp, o);
  }
  finish_kernel<<<blocks, threads, 0, st>>>(m, S, capacity, k, o);
  return static_cast<int>(cudaGetLastError());
}
