// K15 session_merge: the segmented interval merge of the session step.
//
// Replaces runtime/lowering.py:post_session_exchange's sort-apply,
// associative_scan (the segmented running max of the session ends),
// boundary and cumsum, its jax.ops.segment_* folds, key_id/key_first_seg
// and rank, and sess_ovf (:3618-3715 of the reference; B16).  It writes no
// store state.  Two launches:
//   1. permute (one thread per sorted position p): K13's permutation
//      applied to every item column (kh, start, end, alive, slot, key
//      reprs, components); isrow = the item was a row and is alive.
//      Thread 0 zeroes sess_ovf.
//   2. merge (one block of T threads per tile of T sorted positions, T
//      the widest of kTile, kTile / 2 and kTile / 4 whose shared memory
//      fits a block):
//      the block owns the runs of equal kh whose first position lies in
//      its tile, and follows its last run into the tiles after it until
//      the run ends.  A run's positions are taken a tile at a time into
//      shared memory (start, end, alive, isrow, row index, key reprs,
//      components), a thread a position, coalesced, and then block scans
//      (warp shuffles, one barrier pair a pass), each with the tile
//      before's carry, give
//        - the run's running max of end, exclusive: the reference's
//          segend; a position opens a segment (boundary) when it opens its
//          run or its start lies more than the gap past it;
//        - rank, the segment's index in its run (a sum of boundaries);
//        - segmented by the boundaries, in passes of kGroup: segfirst (the
//          last boundary's position), min start, max end, alive,
//          holds-an-alive-row, the lowest row index of its alive rows, the
//          key reprs (max over alive items, INT64_MIN if none) and every
//          component whose combine is associative (dead items as the
//          component's init): int sums (they wrap), int min/max, float
//          min/max by XLA's rules (NaN wins, -0.0 below +0.0);
//        - float64 sums and the argset payloads are walked in item order,
//          a thread a segment piece, from shared memory (float64 sums add
//          in item order, the order of XLA's CPU segment_sum, so they
//          agree bit for bit).
//      The position where a segment ends in the tile writes its folds at
//      its first position; a segment that reaches the tile's end hands
//      every fold to the next tile.  Then the block goes over the
//      positions of its runs once more (the first version's third
//      launch): winner = the position opens an alive segment; ins_act =
//      winner and rank < S; K2's base slot for (kh, rank); the key reprs
//      of the segment for K2; sess_ovf += the winners with rank >= S (a
//      ballot a warp, one atomic a block).
// Position 0 always opens a run and a segment (the reference compares it
// with a key of -1 and a running end of INT64_MIN: the same unless a key
// hash is exactly -1).
//
// argset mode (EARLIEST/LATEST_BY_OFFSET; :3671-3694 of the reference): an
// argset component's segment value is the sum, in item order from +0, of
// the values of the alive items whose order (the nearest order component
// before it, an int64 min or max of unique sequence numbers) equals the
// segment's final order and is not the init.  Each alive item's step
// comes from the running order before it (the order component's scan): a
// strictly better order restarts the sum at 0 + value, a tie adds its
// value, any other leaves it; the walk applies the steps.  Starting from
// +0 is the reference's segment_sum: a -0.0 payload comes out +0.0, NaN
// stays NaN.
//
// Bound: bytes.  Every item column is read and written about twice (~100
// bytes an item at one key and two int64 components: ~53 MB at 532,480
// items, ~16 us at 3.35 TB/s).  The first version gave each run to one
// thread, whose walk waited on a global load an item (~0.9 us an item:
// BASELINE #5's zipf(1.3) traffic puts ~2,000 items on its hottest key,
// one session, so one thread's walk was the whole kernel).  Here the
// hottest run costs its block a tile's loads and a few block scans a
// tile, and only float64 sums and argset payloads are walked (their
// item order is the reference's rounding), a thread a segment piece of
// at most a tile, with nothing but the fold in the loop.
#include "common.cuh"

namespace {

constexpr int64_t kI32Max = 2147483647;
constexpr int64_t kArgset = 3;  // ops/hash_store.py _COMBINE_CODES
constexpr int kTile = 1024;  // positions a block takes at once, a thread each
// the dynamic shared memory a block may take (227 KB less the static part)
constexpr size_t kSmemBlock = 220 * 1024;

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

// A segment's folds are scanned (every fold whose combine is associative:
// int add, min and max, float min and max by XLA's rules, and the
// segment's start, end, flags, lowest row and key reprs) or, for float64
// sums, walked in item order by one thread a segment piece.  A scan pass
// carries kGroup quantities under one set of flags; quantity q is
// segfirst (0), start (1), end (2), the alive and holds-a-row flags (3),
// the lowest row (4), the key reprs (5 ..) and the components (5 + k ..).
// An argset payload is scanned under its order's flags (a segment's first
// item or a strictly better order opens a group): an int payload's group
// sum, and a float payload's group sum, tie count and start, kept at
// slots past the components; a float group with two ties or more is
// summed again in item order, since a scan's tree order would round
// differently.
constexpr int kGroup = 8;
constexpr int kFixed = 5;
// A scan code is a fold's combine << 2 | its dtype (ksql::Combine and
// ksql::Dtype), so that combine() decodes it without a division.
__host__ __device__ constexpr int scan_code(int64_t combine, int64_t dtype) {
  return static_cast<int>(combine << 2 | dtype);
}
constexpr int kOr = scan_code(3, 3);  // bitwise or
constexpr int kNone = -1;             // not scanned here
constexpr int kMaxI64 = scan_code(ksql::kMax, ksql::kInt64);
constexpr int kMinI64 = scan_code(ksql::kMin, ksql::kInt64);
constexpr int kAddI64 = scan_code(ksql::kAdd, ksql::kInt64);
constexpr int kAddF64 = ksql::kAdd * 3 + ksql::kFloat64;  // a component kind (fold_bits)
constexpr int kMaxQ = kFixed + KSQL_MAX_KEYS + 3 * KSQL_MAX_COMPS;
// an argset payload's step at an item: leave, add (a tie) or restart (a
// strictly better order)
constexpr uint8_t kSkip = 0, kAddStep = 1, kRestart = 2;

// The scan code of a component's kind (combine * 3 + dtype).
__device__ __forceinline__ int kind_code(int64_t kind) { return scan_code(kind / 3, kind % 3); }

// An earlier value a folded into a later one b by scan code `code`: int
// sums wrap, int32 values are carried sign-extended, float min/max follow
// XLA's rules.
__device__ __forceinline__ int64_t combine(int code, int64_t a, int64_t b) {
  switch (code) {
    case scan_code(ksql::kAdd, ksql::kInt64):
      return ksql::wadd(a, b);
    case scan_code(ksql::kMin, ksql::kInt64):
    case scan_code(ksql::kMin, ksql::kInt32):
      return a < b ? a : b;
    case scan_code(ksql::kMax, ksql::kInt64):
    case scan_code(ksql::kMax, ksql::kInt32):
      return a > b ? a : b;
    case scan_code(ksql::kAdd, ksql::kInt32):
      return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
    case scan_code(ksql::kAdd, ksql::kFloat64):
      return __double_as_longlong(__longlong_as_double(a) + __longlong_as_double(b));
    case scan_code(ksql::kMin, ksql::kFloat64):
      return __double_as_longlong(ksql::xla_min(__longlong_as_double(a), __longlong_as_double(b)));
    case scan_code(ksql::kMax, ksql::kFloat64):
      return __double_as_longlong(ksql::xla_max(__longlong_as_double(a), __longlong_as_double(b)));
    case kOr:
      return a | b;
    default:
      return b;
  }
}

// Whether a component is walked in item order (a float64 sum), or an
// argset payload.
__device__ __forceinline__ bool walked(int64_t kind) { return kind == kAddF64; }
__device__ __forceinline__ bool is_argset(int64_t kind) { return kind / 3 == kArgset; }

// What one tile of a run hands to the next: the run's running max of end,
// its segments so far, and every quantity of its open segment.
struct Carry {
  int64_t runmax, count;
  int64_t q[kMaxQ];
};

// One tile of T positions in shared memory (dynamic; carve() lays it out).
template <int T>
struct Tile {
  int64_t *start, *end, *scan;
  int64_t* reprs;  // [k][T]: INT64_MIN for a dead item
  int64_t* comps;  // [ncomp][T]: the init for a dead item (argset: as loaded)
  int64_t* incl;   // [ncomp][T]: a scanned component's inclusive fold
  int32_t *row, *pos;  // an alive row's index; the tile's segment pieces
  bool *alive, *isrow, *bnd;
  uint8_t* step;   // [ncomp][T]: the step of the argset payloads of order component j
};

template <int T>
__host__ __device__ __forceinline__ size_t tile_bytes(int64_t k, int64_t ncomp) {
  return static_cast<size_t>(T) * (8 * (3 + k + 2 * ncomp) + 4 + 3 + ncomp) + 4 * (T + 1);
}

template <int T>
__device__ __forceinline__ Tile<T> carve(int64_t* smem, int64_t k, int64_t ncomp) {
  Tile<T> tl;
  tl.start = smem;
  tl.end = smem + T;
  tl.scan = smem + 2 * T;
  tl.reprs = smem + 3 * T;
  tl.comps = tl.reprs + k * T;
  tl.incl = tl.comps + ncomp * T;
  tl.row = reinterpret_cast<int32_t*>(tl.incl + ncomp * T);
  tl.pos = tl.row + T;
  tl.alive = reinterpret_cast<bool*>(tl.pos + T + 1);
  tl.isrow = tl.alive + T;
  tl.bnd = tl.isrow + T;
  tl.step = reinterpret_cast<uint8_t*>(tl.bnd + T);
  return tl;
}

template <int T, int G>
struct ScanBuf {
  long long v[G][T / 32];
  int f[T / 32];
};

// Inclusive scans over the block of G values under one flag a position: a
// flagged position starts a new segment, code[i] folds an earlier value
// into a later one (combine()).  On return `fl` says whether a flagged
// position lies at or before this one.  Every thread must call it.
template <int T, int G>
__device__ __forceinline__ void block_scan(int64_t (&x)[G], const int (&code)[G], bool& fl,
                                           ScanBuf<T, G>& sb) {
  constexpr int W = T / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int f = fl;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int pf = __shfl_up_sync(0xffffffffu, f, d);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (code[i] == kNone) continue;  // the same for every thread
      const long long px = __shfl_up_sync(0xffffffffu, static_cast<long long>(x[i]), d);
      if (lane >= d && !f) x[i] = combine(code[i], px, x[i]);
    }
    if (lane >= d) f |= pf;
  }
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < G; ++i) sb.v[i][w] = x[i];
    sb.f[w] = f;
  }
  __syncthreads();
  if (w == 0) {
    int g = lane < W ? sb.f[lane] : 1;
    long long y[G];
#pragma unroll
    for (int i = 0; i < G; ++i) y[i] = lane < W ? sb.v[i][lane] : 0;
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
      const int pg = __shfl_up_sync(0xffffffffu, g, d);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (code[i] == kNone) continue;
        const long long py = __shfl_up_sync(0xffffffffu, y[i], d);
        if (lane >= d && !g) y[i] = combine(code[i], py, y[i]);
      }
      if (lane >= d) g |= pg;
    }
    if (lane < W) {
#pragma unroll
      for (int i = 0; i < G; ++i) sb.v[i][lane] = y[i];
      sb.f[lane] = g;
    }
  }
  __syncthreads();
  if (w > 0) {
    if (!f) {
#pragma unroll
      for (int i = 0; i < G; ++i) x[i] = combine(code[i], sb.v[i][w - 1], x[i]);
    }
    f |= sb.f[w - 1];
  }
  __syncthreads();  // sb is reused by the next scan
  fl = f != 0;
}

template <int T>
__device__ __forceinline__ int64_t scan1(int64_t v, int code, bool& fl, ScanBuf<T, 1>& sb) {
  int64_t x[1] = {v};
  const int cd[1] = {code};
  block_scan<T, 1>(x, cd, fl, sb);
  return x[0];
}

__device__ __forceinline__ int q_code(const MergeCols& c, int64_t k, int q) {
  if (q == 0 || q == 2) return kMaxI64;  // segfirst, end
  if (q == 1 || q == 4) return kMinI64;  // start, lowest row
  if (q == 3) return kOr;                 // alive | holds a row << 1
  if (q < kFixed + k) return kMaxI64;     // key reprs
  const int64_t kind = c.kind[q - kFixed - k];
  return walked(kind) || is_argset(kind) ? kNone : kind_code(kind);
}

template <int T>
__device__ __forceinline__ int64_t q_value(const Tile<T>& tl, int64_t k, int q, int t, int64_t p,
                                           bool bnd) {
  if (q == 0) return bnd ? p : -1;
  if (q == 1) return tl.start[t];
  if (q == 2) return tl.end[t];
  if (q == 3) return static_cast<int64_t>(tl.alive[t]) | static_cast<int64_t>(tl.isrow[t]) << 1;
  if (q == 4) return tl.isrow[t] ? static_cast<int64_t>(tl.row[t]) : INT64_MAX;
  if (q < kFixed + k) return tl.reprs[(q - kFixed) * T + t];
  return tl.comps[(q - kFixed - k) * T + t];
}

// Writes quantity q of the segment whose first position is sf.
__device__ __forceinline__ void q_store(const MergeOut& o, const MergeCols& c, int64_t k, int64_t m,
                                        int q, int64_t sf, int64_t v) {
  if (q == 1) {
    o.seg_start[sf] = v;
  } else if (q == 2) {
    o.seg_end[sf] = v;
  } else if (q == 3) {
    o.seg_alive[sf] = (v & 1) != 0;
    o.seg_has_row[sf] = (v & 2) != 0;
  } else if (q == 4) {
    o.seg_minrow[sf] = v;
  } else if (q >= kFixed && q < kFixed + k) {
    o.seg_reprs[(q - kFixed) * m + sf] = v;
  } else if (q >= kFixed + k) {
    const int64_t j = q - kFixed - k;
    store_bits(c.seg[j], sf, c.kind[j] % 3, v);
  }
}

template <int T>
__global__ void __launch_bounds__(T)
    merge_kernel(const int32_t* __restrict__ perm, int64_t m, int64_t S, int64_t gap,
                 int64_t capacity, int64_t k, MergeCols c, int64_t ncomp, MergeOut o) {
  extern __shared__ int64_t smem[];
  __shared__ ScanBuf<T, kGroup> sbg;
  __shared__ ScanBuf<T, 1> sb1;
  __shared__ Carry cy[2];  // carry in and carry out, swapped a tile
  __shared__ int s_lo, s_hi;
  __shared__ unsigned long long s_ovf;
  const Tile<T> tl = carve<T>(smem, k, ncomp);
  const int t = threadIdx.x;
  const int nq = static_cast<int>(kFixed + k + ncomp);
  bool any_walked = false, any_argset = false;
  for (int64_t j = 0; j < ncomp; ++j) {
    any_walked = any_walked || walked(c.kind[j]);
    any_argset = any_argset || is_argset(c.kind[j]);
  }
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * T;
  // the block owns the runs that open in its tile
  {
    const int64_t p = tile0 + t;
    const bool head = p < m && (p == 0 || o.kh[p] != o.kh[p - 1]);
    if (t == 0) {
      s_lo = T;
      s_ovf = 0;
    }
    __syncthreads();
    if (head) atomicMin(&s_lo, t);
    __syncthreads();
  }
  if (s_lo == T) return;
  const int64_t own_lo = tile0 + s_lo;
  int64_t lo = own_lo;
  int64_t hi = tile0 + T < m ? tile0 + T : m;
  int64_t key = 0;  // the key of the run followed past the first tile
  bool first_tile = true;
  int cur = 0;
  for (int64_t base = tile0;; base += T) {
    const int64_t tend = base + T < m ? base + T : m;
    const int64_t p = base + t;
    if (!first_tile) {  // the followed run ends at its first position of another key
      if (t == 0) s_hi = T;
      __syncthreads();
      if (p < tend && o.kh[p] != key) atomicMin(&s_hi, t);
      __syncthreads();
      lo = base;
      hi = base + s_hi < tend ? base + s_hi : tend;
    }
    // whether the last run of [lo, hi) ends at hi
    const bool closes = hi < tend || hi >= m || o.kh[hi] != o.kh[hi - 1];
    const bool own = p >= lo && p < hi;
    const bool head = own && first_tile && (p == 0 || o.kh[p] != o.kh[p - 1]);
    int64_t st = 0, en = INT64_MIN;
    if (own) {
      st = o.start[p];
      en = o.end[p];
      const bool alive = o.alive[p];
      const bool isrow = o.isrow[p];
      tl.start[t] = st;
      tl.end[t] = en;
      tl.alive[t] = alive;
      tl.isrow[t] = isrow;
      tl.row[t] = isrow ? perm[p] : 0;  // a row's item index is its row index
      for (int64_t r = 0; r < k; ++r) tl.reprs[r * T + t] = alive ? o.reprs[r * m + p] : INT64_MIN;
      for (int64_t j = 0; j < ncomp; ++j) {
        const int64_t kind = c.kind[j];
        tl.comps[j * T + t] = alive || is_argset(kind) ? load_bits(c.srt[j], p, kind % 3) : c.init[j];
      }
    }
    const Carry& ci = cy[cur];
    Carry& co = cy[cur ^ 1];
    const bool carried = !first_tile;  // the tile's first positions continue a segment
    // running max of end within the run: inclusive, then exclusive
    bool fa = head || !own;
    int64_t incl = scan1<T>(en, kMaxI64, fa, sb1);
    if (!fa && ci.runmax > incl) incl = ci.runmax;  // a followed run's earlier tiles
    tl.scan[t] = incl;
    __syncthreads();
    const int64_t excl = t == 0 ? ci.runmax : tl.scan[t - 1];
    const bool bnd = own && (head || st > ksql::wadd(excl, gap));
    tl.bnd[t] = bnd;
    // rank: the boundaries of the run so far
    bool fb = head || !own;
    const int64_t opened = scan1<T>(bnd ? 1 : 0, kAddI64, fb, sb1);
    const int64_t rank = (fb ? 0 : ci.count) + opened - 1;
    const int hit = static_cast<int>(hi - base);
    // the position where its segment ends in this tile (tl.bnd is visible
    // behind the scan's barriers), the one that hands the open segment on
    const bool seg_last = own && (t + 1 == hit ? closes : tl.bnd[t + 1]);
    const bool carry_out = own && t == hit - 1 && !closes;
    if (carried && t == 0 && bnd) {  // the carried segment ended with the tile before
      for (int q = 1; q < nq; ++q) q_store(o, c, k, m, q, ci.q[0], ci.q[q]);
    }
    int64_t sf = -1;
    for (int g = 0; g < nq; g += kGroup) {
      int64_t x[kGroup];
      int code[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int q = g + i;
        code[i] = q < nq ? q_code(c, k, q) : kNone;
        x[i] = own && q < nq && code[i] != kNone ? q_value<T>(tl, k, q, t, p, bnd) : 0;
      }
      bool f = bnd || !own;
      block_scan<T, kGroup>(x, code, f, sbg);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int q = g + i;
        if (q >= nq || code[i] == kNone) continue;
        if (!f && carried) x[i] = combine(code[i], ci.q[q], x[i]);
        if (q == 0) sf = x[i];
        if (seg_last && q > 0) q_store(o, c, k, m, q, sf, x[i]);
        if (carry_out) co.q[q] = x[i];
        if (own && q >= kFixed + k) tl.incl[(q - kFixed - k) * T + t] = x[i];
      }
    }
    if (own) {
      o.segfirst[p] = static_cast<int32_t>(sf);
      o.rank[p] = rank;
    }
    if (carry_out) {
      co.runmax = incl;
      co.count = rank + 1;
    }
    if (any_argset) {
      __syncthreads();  // tl.incl
      // each order component's step at this item, from the running order
      // before it (its scan, the tile before's carry at position 0)
      if (own) {
        for (int64_t j = 1; j < ncomp; ++j) {
          const int64_t jo = j - 1;
          if (!is_argset(c.kind[j]) || is_argset(c.kind[jo])) continue;
          const int64_t okind = c.kind[jo];
          const int64_t ord = tl.comps[jo * T + t];
          const int64_t before = bnd ? fold_identity(okind)
                                     : t == 0 ? ci.q[kFixed + k + jo] : tl.incl[jo * T + t - 1];
          uint8_t step = kSkip;
          if (tl.alive[t] && ord != c.init[jo]) {
            const bool better = okind / 3 == ksql::kMin ? ord < before : ord > before;
            step = better ? kRestart : ord == before ? kAddStep : kSkip;
          }
          tl.step[jo * T + t] = step;
        }
      }
      // the payloads, a pass per order component (and per kGroup values):
      // flags where a group opens, an int payload's sum, a float payload's
      // sum, ties and group start
      int64_t jo = 0;
      for (int64_t j0 = 0; j0 < ncomp;) {
        if (!is_argset(c.kind[j0])) {
          jo = j0++;
          continue;
        }
        int64_t j1 = j0;
        int nv = 0;
        while (j1 < ncomp && is_argset(c.kind[j1]) &&
               nv + (c.kind[j1] % 3 == ksql::kFloat64 ? 3 : 1) <= kGroup) {
          nv += c.kind[j1] % 3 == ksql::kFloat64 ? 3 : 1;
          ++j1;
        }
        const uint8_t step = own ? tl.step[jo * T + t] : kSkip;
        int64_t x[kGroup];
        int code[kGroup];
        int slot[kGroup];  // the carry slot of each value
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          code[i] = kNone;
          x[i] = 0;
          slot[i] = 0;
        }
        int i = 0;
        for (int64_t j = j0; j < j1; ++j) {
          const int64_t dtype = c.kind[j] % 3;
          const int64_t v = step == kSkip ? 0 : tl.comps[j * T + t];
          const int qj = static_cast<int>(kFixed + k + j);
          const int qx = static_cast<int>(kFixed + k + ncomp + 2 * j);
          if (dtype == ksql::kFloat64) {
            code[i] = scan_code(ksql::kAdd, ksql::kFloat64);  // +0 + v at a restart
            x[i] = step == kSkip ? 0 : fold_bits(kAddF64, 0, v);
            slot[i++] = qj;
            code[i] = kAddI64;
            x[i] = step == kAddStep;
            slot[i++] = qx;
            code[i] = kMaxI64;
            x[i] = -1;
            slot[i++] = qx + 1;
          } else {
            code[i] = scan_code(ksql::kAdd, dtype);
            x[i] = v;
            slot[i++] = qj;
          }
        }
        bool f = bnd || !own || step == kRestart;
        const bool group_head = f;
        // a group's start: its flagged position
        for (int u = 0; u < kGroup; ++u) {
          if (code[u] == kMaxI64) x[u] = group_head && own ? p : -1;
        }
        block_scan<T, kGroup>(x, code, f, sbg);
        i = 0;
        for (int64_t j = j0; j < j1; ++j) {
          const int64_t kind = c.kind[j];
          const bool flt = kind % 3 == ksql::kFloat64;
          const int nvals = flt ? 3 : 1;
          for (int u = i; u < i + nvals; ++u) {
            if (!f && carried) x[u] = combine(code[u], ci.q[slot[u]], x[u]);
          }
          int64_t sum = x[i];
          if (flt && (seg_last || carry_out) && x[i + 1] >= 2) {
            // two ties or more in the group: its sum in item order
            const int64_t lr = x[i + 2];
            int u0 = 0;
            sum = ci.q[slot[i]];
            if (lr >= base) {
              u0 = static_cast<int>(lr - base);
              sum = 0;
            }
            for (int u = u0; u <= t; ++u) {
              const uint8_t su = tl.step[jo * T + u];
              if (su == kRestart) {
                sum = fold_bits(kAddF64, 0, tl.comps[j * T + u]);
              } else if (su == kAddStep) {
                sum = fold_bits(kAddF64, sum, tl.comps[j * T + u]);
              }
            }
          }
          if (seg_last) store_bits(c.seg[j], sf, kind % 3, sum);
          if (carry_out) {
            co.q[slot[i]] = sum;
            for (int u = i + 1; u < i + nvals; ++u) co.q[slot[u]] = x[u];
          }
          i += nvals;
        }
        j0 = j1;
      }
    }
    if (any_walked) {
      // float64 sums, a thread a segment piece, in item order
      const bool piece = own && (bnd || (carried && t == 0));
      bool fz = false;
      const int64_t idx = scan1<T>(piece ? 1 : 0, kAddI64, fz, sb1) - 1;
      if (piece) tl.pos[idx] = t;
      if (own && t == hit - 1) tl.pos[idx + 1] = hit;
      __syncthreads();
      if (piece) {
        const int t1 = tl.pos[idx + 1];
        const bool cont = !bnd;  // the piece goes on with the carried segment
        const bool closing = t1 < hit || closes;
        for (int64_t j = 0; j < ncomp; ++j) {
          if (!walked(c.kind[j])) continue;
          const int64_t* v = tl.comps + j * T;
          double acc = __longlong_as_double(cont ? ci.q[kFixed + k + j] : 0);
          for (int u = t; u < t1; ++u) acc += __longlong_as_double(v[u]);
          const int64_t bits = __double_as_longlong(acc);
          if (closing) {
            store_bits(c.seg[j], sf, ksql::kFloat64, bits);
          } else {
            co.q[kFixed + k + j] = bits;
          }
        }
      }
    }
    __syncthreads();
    if (closes) break;
    key = o.kh[hi - 1];
    first_tile = false;
    cur ^= 1;
  }
  // every position of the block's runs: [own_lo, hi)
  for (int64_t b0 = own_lo; b0 < hi; b0 += T) {
    const int64_t q = b0 + t;
    bool ovf = false;
    if (q < hi) {
      const int32_t sf = o.segfirst[q];
      const bool w = sf == q && o.seg_alive[sf];
      const int64_t rank = o.rank[q];
      o.winner[q] = w;
      o.ins_act[q] = w && rank < S;
      ovf = w && rank >= S;
      const uint64_t h = static_cast<uint64_t>(o.kh[q]);
      o.base[q] = static_cast<int32_t>(
          ksql::mix64(h ^ (static_cast<uint64_t>(rank) * ksql::kGold)) &
          static_cast<uint64_t>(capacity - 1));
      for (int64_t r = 0; r < k; ++r) o.ins_reprs[r * m + q] = o.seg_reprs[r * m + sf];
    }
    const unsigned votes = __ballot_sync(0xffffffffu, ovf);
    if (votes != 0 && (t & 31) == 0) {
      atomicAdd(&s_ovf, static_cast<unsigned long long>(__popc(votes)));
    }
  }
  __syncthreads();
  if (t == 0 && s_ovf != 0) atomicAdd(o.sess_ovf, s_ovf);
}

template <int T>
cudaError_t launch_merge(const int32_t* perm, int64_t m, int64_t S, int64_t gap,
                         int64_t capacity, int64_t k, const MergeCols& c, int64_t ncomp,
                         const MergeOut& o, cudaStream_t st) {
  static size_t allowed = 0;  // the dynamic shared memory the kernel was allowed so far
  const size_t smem = tile_bytes<T>(k, ncomp);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  merge_kernel<T><<<ksql::blocks_for(m, T), T, smem, st>>>(perm, m, S, gap, capacity, k, c, ncomp,
                                                           o);
  return cudaGetLastError();
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
  if (k > KSQL_MAX_KEYS || ncomp > KSQL_MAX_COMPS || m >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  permute_kernel<<<ksql::blocks_for(m, threads), threads, 0, st>>>(
      perm_p, m, n, static_cast<const int64_t*>(kh), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(end), static_cast<const bool*>(alive),
      static_cast<const int32_t*>(slot), static_cast<const int64_t*>(reprs), k, c, ncomp, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest tile whose shared memory fits a block (the hottest run's
  // tiles are the launch's serial part)
  if (tile_bytes<kTile>(k, ncomp) <= kSmemBlock) {
    err = launch_merge<kTile>(perm_p, m, S, gap, capacity, k, c, ncomp, o, st);
  } else if (tile_bytes<kTile / 2>(k, ncomp) <= kSmemBlock) {
    err = launch_merge<kTile / 2>(perm_p, m, S, gap, capacity, k, c, ncomp, o, st);
  } else {
    err = launch_merge<kTile / 4>(perm_p, m, S, gap, capacity, k, c, ncomp, o, st);
  }
  return static_cast<int>(err);
}
