// K1 row_prologue: the fixed per-row part of the aggregate step.
//
// Replaces, on the TPU side, ops/hash_store.py:mix64/combine_hash (B1), the
// window/key/grace part of runtime/lowering.py:pre_exchange (B5), the
// base-slot hash at the top of ops/hash_store.py:probe_insert, and
// ops/window.py:hopping_starts/expand (B11).  Per row: the null-key bitmask,
// the group hash folded over the key reprs and the bitmask, and per mode
//   0  unwindowed / TUMBLING: window start (floor remainder, like
//      jnp.remainder) and the grace cut against the stream time at batch
//      start (read from device memory, so the host never syncs; a null
//      max_ts skips the cut: under EMIT FINAL, K17 cuts against the
//      running stream time instead);
//   1  sliced HOPPING: the slice start; admission while the newest
//      advance-aligned window over the row is open at batch start, and the
//      ring-wrap horizon cut against batch_max = max(max_ts, max ts over
//      the active rows before the null-key mask), which a first one-block
//      launch reduces into device memory; the base slot hashes window 0
//      (the sliced store keys by group key only);
//   2  k-fold HOPPING expansion: the row's k lanes h*n + i (hop-major, as
//      jnp.tile lays them out), each with its window start, in-window test
//      and tumbling-style grace cut (none when max_ts is null, as in mode
//      0); hash and knull are computed once per row and repeated to each
//      lane;
//   3  table: a join table's changelog key (runtime/lowering.py:
//      _trace_table_step), hashed over the key reprs alone, without the
//      null-key bitmask (combine_hash([repr]), which is also what the
//      stream side probes with), window 0, no grace cut; it reads no ts
//      and writes only active, khash and base (ts, max_ts, wstart, knull
//      and c0 may be null);
//   4  session (runtime/lowering.py:pre_session_exchange): the hash
//      combine_hash(reprs + [0]), whose last part is 0 whatever the key's
//      validity, and active = active AND every key column valid; it reads
//      no ts and writes only active and khash (the session step's own
//      prologue, csrc/session_items.cu, does the late drop).
// Then the probe's base slot and the watermark contribution c0.
//
// Bound: memory.  Per row it reads 9k+9 bytes and writes 33 per lane, about
// 1 MB at k = 1 for 16,384 rows (~0.3 us at 3.35 TB/s), k times the writes
// when expanding; the table mode reads 9k+1 and writes 13.  Its ~30
// integer ops per key column are far below the
// card's rate.  The design is the plain coalesced one: consecutive threads
// touch consecutive rows (and, per hop, consecutive lanes), and the key
// matrix is [k, n] so each column read is coalesced too.  The batch_max
// reduction is one block of 1024 threads striding over the rows: a few
// microseconds, against a grid-wide reduction that would need a second
// pass or an initialised atomic.
#include "common.cuh"

namespace {

constexpr int kReduceThreads = 1024;

__global__ void batch_max_kernel(const int64_t* __restrict__ ts,
                                 const bool* __restrict__ active, int64_t n,
                                 const int64_t* __restrict__ max_ts,
                                 int64_t* __restrict__ batch_max) {
  __shared__ long long warp_max[kReduceThreads / 32];
  long long m = INT64_MIN;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    if (active[i] && ts[i] > m) m = ts[i];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, m, off);
    if (o > m) m = o;
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b = *max_ts;
    for (int w = 0; w < kReduceThreads / 32; ++w) {
      if (warp_max[w] > b) b = warp_max[w];
    }
    *batch_max = b;
  }
}

__global__ void row_prologue_kernel(
    const int64_t* __restrict__ reprs, const bool* __restrict__ valid,
    int64_t k, int64_t n, const int64_t* __restrict__ ts,
    const bool* __restrict__ active_in, int64_t mode, int64_t size_ms,
    int64_t advance_ms, int64_t grace_ms, int64_t width, int64_t ring,
    int64_t hops, const int64_t* __restrict__ max_ts, int64_t mask,
    const int64_t* __restrict__ batch_max, int64_t* __restrict__ wstart,
    int32_t* __restrict__ knull, bool* __restrict__ active_out,
    int64_t* __restrict__ khash, int32_t* __restrict__ base,
    int64_t* __restrict__ c0) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t kn = 0;
  for (int64_t j = 0; j < k; ++j) {
    if (!valid[j * n + i]) kn |= static_cast<int32_t>(1u << j);
  }
  const bool act_row = active_in[i] && kn == 0;
  // combine_hash: h = mix64(h ^ (p + GOLD)) over the reprs, then knull
  uint64_t h = ksql::kGold;
  for (int64_t j = 0; j < k; ++j) {
    h = ksql::mix64(h ^ (static_cast<uint64_t>(reprs[j * n + i]) + ksql::kGold));
  }
  if (mode == 3) {  // window 0: the probe hashes h ^ (0 * GOLD)
    active_out[i] = act_row;
    khash[i] = static_cast<int64_t>(h);
    base[i] = static_cast<int32_t>(ksql::mix64(h) & static_cast<uint64_t>(mask));
    return;
  }
  if (mode == 4) {  // session: the last part is 0, not the null bitmask
    active_out[i] = act_row;
    khash[i] = static_cast<int64_t>(ksql::mix64(h ^ ksql::kGold));
    return;
  }
  h = ksql::mix64(h ^ (static_cast<uint64_t>(static_cast<int64_t>(kn)) + ksql::kGold));
  const int64_t t = ts[i];
  const bool cut = max_ts != nullptr;
  const int64_t clock = cut ? *max_ts : 0;

  if (mode == 2) {
    const int64_t first = t - ksql::floor_mod(t, advance_ms);
    for (int64_t hop = 0; hop < hops; ++hop) {
      const int64_t ws = ksql::wadd(first, -ksql::wmul(hop, advance_ms));
      const bool in_win = ws >= 0 && ksql::wadd(ws, size_ms) > t;
      const bool act = act_row && in_win &&
                       (!cut || ksql::wadd(ksql::wadd(ws, size_ms), grace_ms) > clock);
      const int64_t lane = hop * n + i;
      const uint64_t probe = ksql::mix64(h ^ (static_cast<uint64_t>(ws) * ksql::kGold));
      wstart[lane] = ws;
      knull[lane] = kn;
      active_out[lane] = act;
      khash[lane] = static_cast<int64_t>(h);
      base[lane] = static_cast<int32_t>(probe & static_cast<uint64_t>(mask));
      c0[lane] = act ? t : INT64_MIN;
    }
    return;
  }

  int64_t ws = 0;
  int64_t probe_w = 0;
  bool act = act_row;
  if (mode == 1) {
    ws = t - ksql::floor_mod(t, width);
    const int64_t newest = t - ksql::floor_mod(t, advance_ms);
    const bool open_any = ksql::wadd(ksql::wadd(newest, size_ms), grace_ms) > clock;
    const bool horizon_ok = ksql::wadd(ws, ksql::wmul(ring - 1, width)) > *batch_max;
    act = act && open_any && horizon_ok;
  } else if (mode == 0 && size_ms > 0) {
    ws = t - ksql::floor_mod(t, size_ms);
    probe_w = ws;
    act = act && (!cut || ksql::wadd(ksql::wadd(ws, size_ms), grace_ms) > clock);
  }
  const uint64_t probe = ksql::mix64(h ^ (static_cast<uint64_t>(probe_w) * ksql::kGold));
  wstart[i] = ws;
  knull[i] = kn;
  active_out[i] = act;
  khash[i] = static_cast<int64_t>(h);
  base[i] = static_cast<int32_t>(probe & static_cast<uint64_t>(mask));
  c0[i] = act ? t : INT64_MIN;
}

}  // namespace

extern "C" int ksql_row_prologue(
    const void* reprs, const void* valid, int64_t k, int64_t n, const void* ts,
    const void* active_in, int64_t mode, int64_t size_ms, int64_t advance_ms,
    int64_t grace_ms, int64_t width, int64_t ring, int64_t hops,
    const void* max_ts, int64_t mask, void* batch_max, void* wstart,
    void* knull, void* active_out, void* khash, void* base, void* c0,
    void* stream) {
  if (k > KSQL_MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    batch_max_kernel<<<1, kReduceThreads, 0, st>>>(
        static_cast<const int64_t*>(ts), static_cast<const bool*>(active_in), n,
        static_cast<const int64_t*>(max_ts), static_cast<int64_t*>(batch_max));
  }
  const int threads = 256;
  row_prologue_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      static_cast<const int64_t*>(reprs), static_cast<const bool*>(valid), k, n,
      static_cast<const int64_t*>(ts), static_cast<const bool*>(active_in),
      mode, size_ms, advance_ms, grace_ms, width, ring, hops,
      static_cast<const int64_t*>(max_ts), mask,
      static_cast<const int64_t*>(batch_max), static_cast<int64_t*>(wstart),
      static_cast<int32_t*>(knull), static_cast<bool*>(active_out),
      static_cast<int64_t*>(khash), static_cast<int32_t*>(base),
      static_cast<int64_t*>(c0));
  return static_cast<int>(cudaGetLastError());
}
