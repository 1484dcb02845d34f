// K17 suppress_clock: the two running stream-time maxima of an EMIT FINAL
// batch.
//
// Replaces the suppress lanes of runtime/lowering.py:pre_exchange (B17,
// :3906-3931 of the reference).  On this route they take the place of K1's
// grace cut (K1 runs without it).  One block of 1,024 threads runs two
// scans:
//   lanes (n*k of them; lane h*n + i is row i's hop h, so on the expansion
//     route hops h >= 1 see the whole batch's running maximum, as the
//     reference's scan over the tiled lanes does): cm = max(running max of
//     ts over the active lanes, the store's max_ts); a lane stays active
//     while wstart + size + grace > cm (int64 sums wrap, as XLA's), and its
//     watermark contribution c0 is ts where it stays active, INT64_MIN
//     elsewhere;
//   rows (n of them, the raw batch): cm_emit = max(running max of ts over
//     the row_valid rows, the store's emit_clock).  It comes out
//     non-decreasing, which K18's binary search relies on.
// Each scan walks tiles of 4,096 consecutive items: the block loads a tile
// coalesced (item j*1024 + t to thread t) into shared memory, each thread
// folds 4 consecutive items, a warp-shuffle scan over the threads gives
// each its prefix, the running maximum of the earlier tiles is carried in
// a register, and the tile's prefixes are written back coalesced.
//
// Bound: bytes.  It reads wstart and active per lane and ts once per row,
// writes active and c0 per lane, and reads row_valid and ts and writes
// cm_emit per row: about 4.7 MB at 196,608 lanes (k = 3), ~1.4 us at
// 3.35 TB/s.  One block keeps the scan in one launch with no inter-block
// carry (as K14's prologue), so its loads all run from one SM; PERF.md
// has its times.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;  // consecutive items a thread folds per tile
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the warp totals are scanned by one warp");

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ int64_t warp_inclusive_max(int64_t v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, static_cast<long long>(v), d);
    if (lane >= d) v = imax(v, y);
  }
  return v;
}

// The maximum of v over the threads before this one (INT64_MIN for thread
// 0); *total is the maximum over the whole block.  Two barriers; warp_tot
// (kWarps entries) must not still be read by a previous call.
__device__ int64_t block_exclusive_max(int64_t v, int64_t* warp_tot, int64_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t incl = warp_inclusive_max(v, lane);
  int64_t before = __shfl_up_sync(0xffffffffu, static_cast<long long>(incl), 1);
  if (lane == 0) before = INT64_MIN;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_tot[lane] = warp_inclusive_max(warp_tot[lane], lane);
  __syncthreads();
  if (warp > 0) before = imax(before, warp_tot[warp - 1]);
  *total = warp_tot[kWarps - 1];
  return before;
}

// A running maximum over count items in tiles: load(i) gives item i's value
// (INT64_MIN where it does not count), store(i, m) gets the maximum over
// items 0..i.  sh holds a tile, warp_tot the warp totals (read before the
// barrier ahead of the stores, so the next tile's writes never race them).
template <class Load, class Store>
__device__ void tiled_running_max(int64_t count, int64_t* sh, int64_t* warp_tot, Load load,
                                  Store store) {
  const int t = threadIdx.x;
  int64_t carry = INT64_MIN;
  for (int64_t base = 0; base < count; base += kTile) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + j * kThreads + t;
      sh[j * kThreads + t] = i < count ? load(i) : INT64_MIN;
    }
    __syncthreads();
    int64_t part = INT64_MIN;
#pragma unroll
    for (int j = 0; j < kItems; ++j) part = imax(part, sh[t * kItems + j]);
    int64_t total;
    int64_t run = imax(carry, block_exclusive_max(part, warp_tot, &total));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      run = imax(run, sh[t * kItems + j]);
      sh[t * kItems + j] = run;
    }
    carry = imax(carry, total);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + j * kThreads + t;
      if (i < count) store(i, sh[j * kThreads + t]);
    }
    __syncthreads();  // every thread has read sh before the next tile loads
  }
}

__global__ void clock_kernel(const int64_t* __restrict__ ts, const int64_t* __restrict__ wstart,
                             const bool* __restrict__ active_in, const bool* __restrict__ row_valid,
                             int64_t n, int64_t lanes, const int64_t* __restrict__ max_ts_p,
                             const int64_t* __restrict__ emit_clock_p, int64_t size_ms,
                             int64_t grace_ms, bool* __restrict__ active_out,
                             int64_t* __restrict__ c0, int64_t* __restrict__ cm_emit) {
  __shared__ int64_t sh[kTile];
  __shared__ int64_t warp_tot[kWarps];
  const int64_t max_ts = *max_ts_p;
  const int64_t emit_clock = *emit_clock_p;

  // ---- the aggregation lanes
  tiled_running_max(
      lanes, sh, warp_tot,
      [=](int64_t i) {
        const int64_t t = ts[i % n];  // loaded with the flag, not after it
        return active_in[i] ? t : INT64_MIN;
      },
      [=](int64_t i, int64_t run) {
        const int64_t cm = imax(run, max_ts);
        const bool a = active_in[i] && ksql::wadd(ksql::wadd(wstart[i], size_ms), grace_ms) > cm;
        active_out[i] = a;
        c0[i] = a ? ts[i % n] : INT64_MIN;
      });

  // ---- the raw rows
  tiled_running_max(
      n, sh, warp_tot,
      [=](int64_t i) {
        const int64_t t = ts[i];
        return row_valid[i] ? t : INT64_MIN;
      },
      [=](int64_t i, int64_t run) { cm_emit[i] = imax(run, emit_clock); });
}

}  // namespace

extern "C" int ksql_suppress_clock(const void* ts, const void* wstart, const void* active_in,
                                   const void* row_valid, int64_t n, int64_t lanes,
                                   const void* max_ts, const void* emit_clock, int64_t size_ms,
                                   int64_t grace_ms, void* active_out, void* c0, void* cm_emit,
                                   void* stream) {
  if (n < 1 || lanes % n != 0) return static_cast<int>(cudaErrorInvalidValue);
  clock_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ts), static_cast<const int64_t*>(wstart),
      static_cast<const bool*>(active_in), static_cast<const bool*>(row_valid), n, lanes,
      static_cast<const int64_t*>(max_ts), static_cast<const int64_t*>(emit_clock), size_ms,
      grace_ms, static_cast<bool*>(active_out), static_cast<int64_t*>(c0),
      static_cast<int64_t*>(cm_emit));
  return static_cast<int>(cudaGetLastError());
}
