// K17 suppress_clock: the two running stream-time maxima of an EMIT FINAL
// batch.
//
// Replaces the suppress lanes of runtime/lowering.py:pre_exchange (B17,
// :3906-3931 of the reference).  On this route they take the place of K1's
// grace cut (K1 runs without it).  Two scans:
//   lanes (n*k of them; lane h*n + i is row i's hop h, so on the expansion
//     route hops h >= 1 see the whole earlier lane sequence's maximum, as
//     the reference's scan over the tiled lanes does): cm = max(running
//     max of ts over the active lanes, the store's max_ts); a lane stays
//     active while wstart + size + grace > cm (int64 sums wrap, as XLA's),
//     and its watermark contribution c0 is ts where it stays active,
//     INT64_MIN elsewhere;
//   rows (n of them, the raw batch): cm_emit = max(running max of ts over
//     the row_valid rows, the store's emit_clock).  It comes out
//     non-decreasing, which K18's binary search relies on.
//
// One launch, a single pass over many blocks: a running maximum with
// decoupled look-back, the way K24 (csrc/fk_fanout.cu) and CUB's
// single-pass scan work.
//   1. A tile is kThreads x ITEMS items of one hop's lanes (ITEMS 2, 4 or
//      8: the most that still gives kMinTiles tiles, so that 65,536 lanes
//      spread over 128 blocks and 2^20 rows over 512).  Tiles are indexed
//      by (hop, row tile), so a lane's row is tile arithmetic, and a tile
//      of hop 0 also scans the same rows' raw-row sequence.  Each block
//      takes its tile from an atomic ticket (atomicInc, which wraps back
//      to 0 after the call's last tile), so tiles start in order and a
//      look-back never waits on a tile that was never scheduled.
//   2. Each warp owns 32 x ITEMS consecutive items, loaded 32 at a time
//      (coalesced, all loads issued first), scanned with shuffles in
//      registers; the warp totals are scanned by one warp in shared
//      memory, which gives the tile's aggregate.
//   3. Look-back, one warp a sequence (warp 0 the lanes, warp 1 the rows):
//      the tile publishes its aggregate, reads the flags of its 32
//      nearest predecessors at once (a lane each), folds their values
//      back to the nearest inclusive prefix, and publishes its own
//      inclusive prefix.  (A window of 128, four flags a lane loaded
//      relaxed behind one acquire fence, measured slower: PERF.md.)
//      Max is idempotent, so a predecessor's value may be its aggregate or
//      its prefix, whichever is there: a flag and one value word a tile.
//      Flags carry the call's epoch (the wrapper's call count), so the
//      scratch is never reset: an older call's flag reads as not yet.
//   4. Every item's running maximum is the tile's prefix, its warp's
//      prefix and its own; the cut and the outputs are written coalesced.
//
// Bound: bytes.  It reads wstart and active per lane and ts once per row,
// writes active and c0 per lane, and reads row_valid and ts and writes
// cm_emit per row: about 4.7 MB at 196,608 lanes (k = 3), ~1.4 us at
// 3.35 TB/s, and 36.7 MB at 2^20 rows (~11 us).  PERF.md has its times.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMinTiles = 128;  // tiles a call wants before it takes more items a thread
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;
static_assert(kWarps <= 32, "one warp scans the warp totals");

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// inclusive running maximum over the warp's lanes
__device__ __forceinline__ int64_t warp_scan_max(int64_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(kAll, static_cast<long long>(v), d);
    if (lane >= d) v = imax(v, y);
  }
  return v;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = imax(v, __shfl_xor_sync(kAll, static_cast<long long>(v), d));
  return v;
}

__device__ __forceinline__ unsigned long long load_flag(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One running-maximum sequence's look-back state: a flag (epoch << 2 |
// kAggregate or kInclusive) and a value a tile.
struct Chain {
  unsigned long long* flag;
  int64_t* val;
};

__device__ __forceinline__ void publish(Chain c, int64_t t, int64_t v, unsigned long long tag) {
  c.val[t] = v;
  store_flag(&c.flag[t], tag);
}

// The maximum over tiles 0..t-1 of chain c, by one warp (t >= 1): its 32
// nearest predecessors a round, folded back to the nearest inclusive
// prefix.
__device__ int64_t look_back(Chain c, int64_t t, unsigned long long epoch, int lane) {
  int64_t prefix = INT64_MIN;
  for (int64_t top = t - 1;; top -= 32) {
    const int64_t j = top - lane;
    unsigned long long state = kInclusive;  // before tile 0: an empty prefix
    int64_t v = INT64_MIN;
    if (j >= 0) {
      unsigned long long f;
      do {
        f = load_flag(&c.flag[j]);
      } while ((f >> 2) != epoch);
      state = f & 3;
      v = __ldcg(reinterpret_cast<const long long*>(&c.val[j]));
    }
    const unsigned inclusive = __ballot_sync(kAll, state == kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    prefix = imax(prefix, warp_max(lane <= stop ? v : INT64_MIN));
    if (inclusive) return prefix;
  }
}

// Each warp's total in s_tot becomes that warp's exclusive prefix in the
// tile; the tile's exclusive prefix in chain c (tile t) goes to *s_excl.
// Run by one warp.
__device__ void tile_prefix(int64_t* s_tot, int64_t* s_excl, Chain c, int64_t t,
                            unsigned long long epoch, int lane) {
  const int64_t w = lane < kWarps ? s_tot[lane] : INT64_MIN;
  const int64_t incl = warp_scan_max(w, lane);
  int64_t excl = __shfl_up_sync(kAll, static_cast<long long>(incl), 1);
  if (lane == 0) excl = INT64_MIN;
  if (lane < kWarps) s_tot[lane] = excl;
  const int64_t agg = __shfl_sync(kAll, static_cast<long long>(incl), kWarps - 1);
  int64_t prefix = INT64_MIN;
  if (t == 0) {
    if (lane == 0) publish(c, 0, agg, epoch << 2 | kInclusive);
  } else {
    if (lane == 0) publish(c, t, agg, epoch << 2 | kAggregate);
    prefix = look_back(c, t, epoch, lane);
    if (lane == 0) publish(c, t, imax(prefix, agg), epoch << 2 | kInclusive);
  }
  if (lane == 0) *s_excl = prefix;
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads) clock_kernel(
    const int64_t* __restrict__ ts, const int64_t* __restrict__ wstart,
    const bool* __restrict__ active_in, const bool* __restrict__ row_valid, int64_t n,
    int64_t row_tiles, const int64_t* __restrict__ max_ts_p,
    const int64_t* __restrict__ emit_clock_p, int64_t size_ms, int64_t grace_ms,
    bool* __restrict__ active_out, int64_t* __restrict__ c0, int64_t* __restrict__ cm_emit,
    unsigned* ticket, Chain lanes_c, Chain rows_c, unsigned long long epoch) {
  constexpr int kTile = kThreads * ITEMS;
  __shared__ int64_t s_tile;
  __shared__ int64_t s_tot[2][kWarps];  // warp totals, then exclusive prefixes: lanes, rows
  __shared__ int64_t s_excl[2];         // the tile's exclusive prefix: lanes, rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicInc(ticket, gridDim.x - 1);
  const int64_t max_ts = *max_ts_p;
  const int64_t emit_clock = *emit_clock_p;
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t h = t / row_tiles, r = t - h * row_tiles;
  const bool rows = h == 0;  // the tiles of hop 0 also scan the raw rows
  const int64_t row0 = r * kTile + warp * 32 * ITEMS + lane;
  const int64_t* ws = wstart + h * n;
  const bool* act = active_in + h * n;
  int64_t tv[ITEMS], wv[ITEMS];
  bool av[ITEMS], rv[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int64_t i = row0 + q * 32;
    const bool in = i < n;
    tv[q] = in ? ts[i] : INT64_MIN;
    wv[q] = in ? ws[i] : 0;
    av[q] = in && act[i];
    rv[q] = rows && in && row_valid[i];
  }
  // each round's inclusive maximum over its 32 items, then the rounds'
  // carries: lane sequence, and on hop 0 the row sequence
  int64_t lrun[ITEMS], rrun[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) lrun[q] = warp_scan_max(av[q] ? tv[q] : INT64_MIN, lane);
  int64_t carry = INT64_MIN;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int64_t tot = __shfl_sync(kAll, static_cast<long long>(lrun[q]), 31);
    lrun[q] = imax(lrun[q], carry);
    carry = imax(carry, tot);
  }
  if (lane == 0) s_tot[0][warp] = carry;
  if (rows) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) rrun[q] = warp_scan_max(rv[q] ? tv[q] : INT64_MIN, lane);
    carry = INT64_MIN;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int64_t tot = __shfl_sync(kAll, static_cast<long long>(rrun[q]), 31);
      rrun[q] = imax(rrun[q], carry);
      carry = imax(carry, tot);
    }
    if (lane == 0) s_tot[1][warp] = carry;
  }
  __syncthreads();
  if (warp == 0) tile_prefix(s_tot[0], &s_excl[0], lanes_c, t, epoch, lane);
  if (warp == 1 && rows) tile_prefix(s_tot[1], &s_excl[1], rows_c, r, epoch, lane);
  __syncthreads();
  const int64_t lpre = imax(s_excl[0], s_tot[0][warp]);
  bool* aout = active_out + h * n;
  int64_t* c0out = c0 + h * n;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int64_t i = row0 + q * 32;
    if (i < n) {
      const int64_t cm = imax(imax(lpre, lrun[q]), max_ts);
      const bool a = av[q] && ksql::wadd(ksql::wadd(wv[q], size_ms), grace_ms) > cm;
      aout[i] = a;
      c0out[i] = a ? tv[q] : INT64_MIN;
    }
  }
  if (rows) {
    const int64_t rpre = imax(s_excl[1], s_tot[1][warp]);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int64_t i = row0 + q * 32;
      if (i < n) cm_emit[i] = imax(imax(rpre, rrun[q]), emit_clock);
    }
  }
}

template <int ITEMS>
int launch(const int64_t* ts, const int64_t* wstart, const bool* active_in, const bool* row_valid,
           int64_t n, int64_t hops, const int64_t* max_ts, const int64_t* emit_clock,
           int64_t size_ms, int64_t grace_ms, bool* active_out, int64_t* c0, int64_t* cm_emit,
           int64_t* scratch, int64_t scratch_tiles, unsigned long long epoch, cudaStream_t st) {
  const int64_t row_tiles = (n + kThreads * ITEMS - 1) / (kThreads * ITEMS);
  const int64_t tiles = hops * row_tiles;
  if (tiles > scratch_tiles || tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // scratch: the ticket word, then the lane chain's flags and values, then
  // the row chain's
  auto* flags = reinterpret_cast<unsigned long long*>(scratch + 1);
  const Chain lanes_c{flags, scratch + 1 + scratch_tiles};
  const Chain rows_c{flags + 2 * scratch_tiles, scratch + 1 + 3 * scratch_tiles};
  clock_kernel<ITEMS><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      ts, wstart, active_in, row_valid, n, row_tiles, max_ts, emit_clock, size_ms, grace_ms,
      active_out, c0, cm_emit, reinterpret_cast<unsigned*>(scratch), lanes_c, rows_c, epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `scratch` holds 1 + 4 * scratch_tiles int64, zeroed when allocated and
// left consistent by every call (the ticket wraps back to 0, the flags
// carry the call's epoch); `epoch` is 1 + the calls made on it before.
extern "C" int ksql_suppress_clock(const void* ts, const void* wstart, const void* active_in,
                                   const void* row_valid, int64_t n, int64_t lanes,
                                   const void* max_ts, const void* emit_clock, int64_t size_ms,
                                   int64_t grace_ms, void* active_out, void* c0, void* cm_emit,
                                   void* scratch, int64_t scratch_tiles, int64_t epoch,
                                   void* stream) {
  if (n < 1 || lanes % n != 0 || epoch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hops = lanes / n;
  int items = 8;
  while (items > 2 && hops * ((n + kThreads * items - 1) / (kThreads * items)) < kMinTiles) items /= 2;
  auto* run = items == 8 ? &launch<8> : items == 4 ? &launch<4> : &launch<2>;
  return run(static_cast<const int64_t*>(ts), static_cast<const int64_t*>(wstart),
             static_cast<const bool*>(active_in), static_cast<const bool*>(row_valid), n, hops,
             static_cast<const int64_t*>(max_ts), static_cast<const int64_t*>(emit_clock), size_ms,
             grace_ms, static_cast<bool*>(active_out), static_cast<int64_t*>(c0),
             static_cast<int64_t*>(cm_emit), static_cast<int64_t*>(scratch), scratch_tiles,
             static_cast<unsigned long long>(epoch), static_cast<cudaStream_t>(stream));
}
