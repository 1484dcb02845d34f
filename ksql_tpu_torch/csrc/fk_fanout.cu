// K24 fk_fanout: the store-wide fan-out of one right-table change of a
// foreign-key table-table join, one call per right change.
//
// Replaces the `match` scan and the left-side lanes of
// runtime/lowering.py:_trace_fk_right (B20, :2640-2672).  The reference
// scans all C + 1 left slots for
//   match = live & fkvalid & (fkrepr == krepr[0]) & touched[0]
// and runs the post-join chain over C + 1 lanes, of which only the matched
// ones can emit.  The port compacts the matching slots, IN SLOT ORDER, and
// gathers their left columns (v_<col>, m_<col>) and key0 (the left primary
// key's repr) into lanes of the matched count; the chain then runs over
// those lanes alone.  The dump slot C never matches: live[C] is False.
//
// One launch, a single pass: an order-keeping stream compaction with
// decoupled look-back, the way CUB's single-pass scan works.
//   1. Each block takes its tile id from an atomic ticket (not blockIdx),
//      so tiles start in id order and a tile's look-back never waits on a
//      tile that has not started.  A tile is kTile (4,096) slots: each of
//      its 16 warps owns 256 consecutive ones, 32 a load (one slot a
//      lane), so every load is coalesced, and all 24 loads of a thread are
//      issued before any match is tested; the scanned columns (live,
//      fkvalid, fkrepr) are read once.  Tile 0 publishes its inclusive
//      prefix at once, so up to 33 tiles (2^17 + 1 slots) look back one
//      window of 32; a longer tile would leave most SMs idle at phase 19's
//      2^16 + 1 slots (17 tiles here).
//   2. Per load a warp ballot; a warp's matches are ranked by the ballots
//      before theirs, and one warp scans the 16 warp totals, which gives
//      the tile's aggregate.
//   3. Look-back: the tile publishes its aggregate (flag A) in its status
//      word, one 64-bit word of flag and count, so that a flag is never
//      seen without its count; warp 0 then reads the statuses of its 32
//      nearest predecessors at once, sums back to the nearest inclusive
//      prefix (flag P), moves its window back while there is none, and
//      publishes its own inclusive prefix.
//   4. Write: every match writes its slot number at prefix + rank and its
//      offset in the tile into shared memory; then the block gathers the
//      tile's matched rows, key0 and every column, a (column, row) pair a
//      thread, kGather pairs' loads in flight before their stores.
//   5. Finish: each tile counts itself done; the last one writes the total
//      (the inclusive prefix of the last tile) and resets the ticket, the
//      done count and the status words, so the scratch is clean after
//      every call.  The entry point copies the total into pinned host
//      memory and synchronizes the stream once; the wrapper takes the
//      first `total` rows of output lanes allocated for C + 1.
// The column descriptor (each left column's store arrays and element size,
// each output lane's byte offset in the call's one output allocation)
// lives in device memory, packed once per set of store buffers
// (ops/table_join.py: FanoutPlan); a block copies it into shared memory
// while its loads are in flight, so a launch passes a dozen scalars.
//
// Bound: memory, by the bytes the function needs: 10 bytes a slot read
// once (live, fkvalid, fkrepr), and per matched slot its key0 and columns
// read (8 + 9 bytes a 64-bit column) and its slot number, key0 and columns
// written (12 + 9 a column): at 2^18 + 1 slots about 2.6 MB (~0.78 us at
// 3.35 TB/s), with the hottest customer's orders on top.  The single pass
// reads the scanned columns once (the first version read them twice, in a
// count pass and a write pass) and replaces its three launches (count, a
// one-block scan, write) and the host readback between them with one
// launch and one synchronization.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // loads a warp makes: 32 slots each
constexpr int kTile = kThreads * kItems;
constexpr int kGather = 8;  // (column, row) pairs a thread loads before it stores them
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;

// Words of the descriptor: the column count, 3 a column (store values,
// element bytes, store valid bits), the byte offsets of the slot and key0
// lanes, then 2 a column (value lane, valid lane).
constexpr int kDescWords = 1 + 3 * KSQL_MAX_COLS + 2 + 2 * KSQL_MAX_COLS;
static_assert(kDescWords <= kThreads, "one descriptor word a thread");
static_assert(kWarps <= 32, "one warp scans the warp totals");

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads) fanout_kernel(
    const bool* __restrict__ live, const bool* __restrict__ fkvalid,
    const int64_t* __restrict__ fkrepr, const int64_t* __restrict__ key0, int64_t c1,
    const int64_t* __restrict__ krepr, const bool* __restrict__ touched,
    const int64_t* __restrict__ desc, int64_t words, char* __restrict__ out,
    unsigned long long* status, int32_t* ticket, int32_t* done, int64_t* total) {
  __shared__ int64_t s_desc[kDescWords];
  __shared__ int s_rows[kTile];  // the tile's matched slots, by rank, as offsets in the tile
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];  // exclusive rank of each warp's first match in the tile
  __shared__ int s_agg;
  __shared__ int64_t s_prefix;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = gridDim.x;
  // the descriptor word this thread copies, loaded now and stored once
  // the tile's own loads are in flight
  const int64_t dv = threadIdx.x < words ? desc[threadIdx.x] : 0;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t tile_base = static_cast<int64_t>(tile) * kTile;
  const int wbase = warp * (32 * kItems);  // the warp's first slot in the tile
  const int64_t want = krepr[0];
  const bool on = touched[0];
  // every load of the tile first, none waiting on another (a match test
  // that short-circuits would chain them), then the ballots
  bool lv[kItems], fv[kItems];
  int64_t fr[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int64_t i = tile_base + wbase + q * 32 + lane;
    const bool in = i < c1;
    lv[q] = in ? live[i] : false;
    fv[q] = in ? fkvalid[i] : false;
    fr[q] = in ? fkrepr[i] : 0;
  }
  unsigned ballots[kItems];
  int matches = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    ballots[q] = __ballot_sync(0xffffffffu, on & lv[q] & fv[q] & (fr[q] == want));
    matches += __popc(ballots[q]);
  }
  if (lane == 0) s_warp[warp] = matches;
  if (threadIdx.x < words) s_desc[threadIdx.x] = dv;
  __syncthreads();
  if (warp == 0) {
    // the warps' totals in slot order: their exclusive scan and the tile's
    const int c = lane < kWarps ? s_warp[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane < kWarps) s_warp[lane] = incl - c;
    const int tile_total = __shfl_sync(0xffffffffu, incl, kWarps - 1);
    const unsigned long long agg = static_cast<unsigned long long>(tile_total);
    int64_t prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(&status[0], kFlagPrefix | agg);
    } else {
      if (lane == 0) store_status(&status[tile], kFlagAggregate | agg);
      // look back over the 32 nearest predecessors at a time
      int64_t top = tile - 1;
      while (true) {
        const int64_t j = top - lane;
        unsigned long long st = kFlagPrefix;  // before tile 0: an inclusive 0
        if (j >= 0) {
          do {
            st = load_status(&status[j]);
          } while ((st >> 32) == 0);
        }
        const unsigned inclusive = __ballot_sync(0xffffffffu, (st >> 32) == 2);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        int64_t cnt = lane <= stop ? static_cast<int64_t>(st & 0xffffffffull) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, d);
        prefix += __shfl_sync(0xffffffffu, cnt, 0);
        if (inclusive) break;
        top -= 32;
      }
      if (lane == 0) {
        store_status(&status[tile], kFlagPrefix | static_cast<unsigned long long>(prefix + agg));
      }
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_agg = tile_total;
    }
  }
  __syncthreads();
  const int64_t prefix = s_prefix;
  const int agg = s_agg;
  const int64_t count = s_desc[0];
  const int64_t* cd = s_desc + 1;
  const int64_t* od = s_desc + 1 + 3 * count;
  int32_t* slot_out = reinterpret_cast<int32_t*>(out + od[0]);
  int rank = s_warp[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if ((ballots[q] >> lane) & 1u) {
      const int at = rank + __popc(ballots[q] & below);
      const int off = wbase + q * 32 + lane;
      s_rows[at] = off;
      slot_out[prefix + at] = static_cast<int32_t>(tile_base + off);
    }
    rank += __popc(ballots[q]);
  }
  __syncthreads();
  // the gather: (column, row) pairs, column 0 key0, then each left
  // column's values and valid bits
  const int ncol = 1 + 2 * static_cast<int>(count);
  const int work = agg * ncol;
  for (int w0 = threadIdx.x; w0 < work; w0 += kThreads * kGather) {
    int64_t v[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int w = w0 + u * kThreads;
      if (w < work) {
        const int c = w / agg, r = w - c * agg;
        const int64_t i = tile_base + s_rows[r];
        if (c == 0) {
          v[u] = key0[i];
        } else if (c & 1) {
          v[u] = ksql::load_elem(reinterpret_cast<const void*>(cd[3 * (c >> 1)]), i,
                                 cd[3 * (c >> 1) + 1]);
        } else {
          v[u] = reinterpret_cast<const bool*>(cd[3 * ((c >> 1) - 1) + 2])[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int w = w0 + u * kThreads;
      if (w < work) {
        const int c = w / agg, r = w - c * agg;
        const int64_t at = prefix + r;
        if (c == 0) {
          reinterpret_cast<int64_t*>(out + od[1])[at] = v[u];
        } else if (c & 1) {
          ksql::store_elem(out + od[2 + 2 * (c >> 1)], at, cd[3 * (c >> 1) + 1], v[u]);
        } else {
          reinterpret_cast<bool*>(out + od[3 + 2 * ((c >> 1) - 1)])[at] = v[u] != 0;
        }
      }
    }
  }
  // the last tile to finish: every look-back is over, so the scratch can
  // be reset for the next call
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1) == ntiles - 1;
    if (s_last) {
      __threadfence();
      *total = static_cast<int64_t>(load_status(&status[ntiles - 1]) & 0xffffffffull);
      *ticket = 0;
      *done = 0;
    }
  }
  __syncthreads();
  if (s_last) {
    for (int t = threadIdx.x; t < ntiles; t += kThreads) status[t] = 0;
  }
}

}  // namespace

// `desc` is the device descriptor above (`words` int64) and `out` the
// call's output allocation (lanes of C + 1 rows); `status` (ceil((C + 1)
// / 4,096) words), `ticket` and `done` are the store's clean scratch;
// `total` a device int64 and `host_total` pinned host memory, which holds
// the match count when the call returns (it synchronizes the stream).
extern "C" int ksql_fk_fanout(const void* live, const void* fkvalid, const void* fkrepr,
                              const void* key0, int64_t c1, const void* krepr,
                              const void* touched, const void* desc, int64_t words, void* out,
                              void* status, void* ticket, void* done, void* total,
                              void* host_total, void* stream) {
  if (words > kDescWords) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fanout_kernel<<<ksql::blocks_for(c1, kTile), kThreads, 0, st>>>(
      static_cast<const bool*>(live), static_cast<const bool*>(fkvalid),
      static_cast<const int64_t*>(fkrepr), static_cast<const int64_t*>(key0), c1,
      static_cast<const int64_t*>(krepr), static_cast<const bool*>(touched),
      static_cast<const int64_t*>(desc), words, static_cast<char*>(out),
      static_cast<unsigned long long*>(status), static_cast<int32_t*>(ticket),
      static_cast<int32_t*>(done), static_cast<int64_t*>(total));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(host_total, total, sizeof(int64_t), cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}
