// K10 ss_match: the WITHIN-window equi-match of a stream-stream join, one
// batch of one side against the other side's ring buffer.
//
// Replaces the match part of runtime/lowering.py:_trace_ss_step (B14): the
// n x (B+1) mask `active & live & key_eq & tw`, its sum and any(axis=1),
// the nonzero(size=oc, fill_value=0) compaction, the match lanes' gathers
// and the opposite ring's any(axis=0).  The mask is never built.  A pair
// (row i, entry j) matches when the row is active with a valid key, the
// entry is live with a valid key, the key reprs are equal and the entry
// lies in the row's window (bounds inclusive; left row: ts-before <= ots
// <= ts+after, right row: ots-before <= ts <= ots+after; int64 sums wrap,
// as XLA's do).
//
// Bound: bytes, 0.00011 ms at phase 2s's count (2,048 rows' key, valid,
// active and ts and 18 bytes an entry of the 16,385-entry ring, read once,
// and the count's outputs written once).  A design that tests every pair
// does 2,048 x 16,385 = 33.5 M pair tests, ~0.004 ms at the card's
// integer rate.
//
// The first design gave each row a warp that walked the whole ring, 32
// entries a step, in a test that short-circuited: each step a chain of
// dependent global loads (live, kval, krepr, ts), ~15 warps an SM to hide
// them, 0.172 ms for the count and 0.127 ms for a write that walked again
// from the start, whatever the live share (x3.7-3.9 the time for x4 the
// ring); the scan of the counts was a second launch.  Now:
//
//   * Ring tiles in shared memory.  The grid is (row tile of 256 rows) x
//     (ring chunk); a chunk is `span` tiles of kTile (512) entries, span 1
//     until the ring passes 64 tiles.  A block loads its tile once,
//     coalesced, all four fields of 2 entries a thread before any test,
//     and compacts the live entries with a valid key, in entry order, into
//     shared memory as (krepr, ts) pairs (a ballot a load, one warp scans
//     the (load, warp) counts).  Each thread then tests its row against
//     the compacted tile: a 16-byte broadcast read and a key compare per
//     entry, the window only on an equal key.  No global load is in the
//     chain, and the ring is read once per row tile, not once per row.
//     512-entry tiles spread a ring's live stretch over more blocks than
//     1,024 (phase 2s's 6,144 live entries in ring order fill 12-13 of 33
//     chunks; scripts/torch_k10_k13_probe.py times both); two or four rows
//     a thread, one shared read serving them all, were slower (fewer
//     blocks) and are not kept.
//   * Count and scan in one launch.  Each block writes its rows' counts
//     into an n x chunks matrix (chunk-major: tcnt[u n + i]) and adds each
//     nonzero one into the row's total (an int32 a row, zeros between
//     calls).  The last block to finish, found by an atomic ticket, reads
//     the totals, writes cnt and row_matched, scans cnt into offsets,
//     writes the total and leaves the totals and the ticket zero.
//   * The write walks only where the matches are.  Lane k = offsets[i] +
//     the row's counts in earlier chunks + the rank inside the chunk:
//     exactly nonzero's row-major order, since chunks ascend within a row
//     and the compacted entries ascend within a chunk.  A block whose rows
//     have no count in its chunk loads nothing.  A row with matches is
//     walked by its whole warp, an entry a lane, a ballot ranking its
//     matches (a thread's own walk, one entry a step with few rows of a
//     block at work, was latency-bound), and it stops at its count;
//     its warp sums its earlier chunks' counts, a load a lane.  Every
//     matched entry, cut ones too, gets matched[j] = true; a lane k < oc
//     gets mi, mj, ts = max(ts[i], ots[j]), ord_b = seq[j], mvalid, the
//     own side's columns at i and the ring's at j.  Lanes total..oc-1
//     read row 0 and entry 0 with every valid bit false (fill_value=0).
//   * The write's outputs are lanes of one allocation; the ring half of
//     its descriptor (each ring column's arrays and element size) and
//     every lane's offset per output row live on the card, cached per
//     ring buffers (ops/ss_join.py: RingPlan), and a block copies them
//     into shared memory; the own side's column pointers change every
//     call and come as launch parameters, copied by constant index.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // rows a block: a thread a row
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;  // ring entries a shared-memory tile
constexpr int kPer = kTile / kThreads;
static_assert(kPer * kWarps <= 32, "one warp scans the (load, warp) counts");

// The write's descriptor: [own count, ring column count, lane offsets a
// row of mi, mj, ts, ord_b, mvalid, per own column (element bytes, value
// lane, valid lane), per ring column (values, element bytes, valid bits,
// value lane, valid lane)]; lane offsets are bytes per output row (a lane
// of `oc` rows starts at oc times it).
constexpr int kDescHead = 7;
constexpr int kDescWords = kDescHead + 3 * KSQL_MAX_COLS + 5 * KSQL_MAX_COLS;

struct Rows {
  const int64_t* krepr;
  const bool* kvalid;
  const bool* active;
  const int64_t* ts;
  int64_t n;
};

struct Ring {
  const int64_t* ts;
  const int64_t* krepr;
  const bool* kval;
  const bool* live;
  int64_t b1;  // entries, the dump entry included
};

// The own side's column pointers, by value: read only at constant indices.
struct OwnCols {
  const void* v[KSQL_MAX_COLS];
  const void* m[KSQL_MAX_COLS];
};

// The entry at `ot` lies in the window of a row at `t`; lo and hi are the
// left row's bounds t - before and t + after.
template <int kSide>
__device__ __forceinline__ bool in_window(int64_t t, int64_t lo, int64_t hi, int64_t ot,
                                          int64_t before, int64_t after) {
  if (kSide == 0) return lo <= ot && ot <= hi;
  return ksql::wsub(ot, before) <= t && t <= ksql::wadd(ot, after);
}

// Loads ring entries [j0, j0 + kTile) and compacts those live with a
// valid key, in entry order, into s_ent as (krepr, ts) and, when s_j is
// given, their entry numbers into s_j.  Returns how many.  Every thread of
// the block calls it; s_cnt holds 33 ints.
__device__ int load_tile(const Ring& r, int64_t j0, longlong2* s_ent, int* s_j, int* s_cnt) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  bool ok[kPer];
  int64_t kr[kPer], ts[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int64_t j = j0 + q * kThreads + t;
    const bool in = j < r.b1;
    const bool lv = in ? r.live[j] : false;
    const bool kv = in ? r.kval[j] : false;
    kr[q] = in ? r.krepr[j] : 0;
    ts[q] = in ? r.ts[j] : 0;
    ok[q] = lv & kv;
  }
  unsigned bal[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    bal[q] = __ballot_sync(kFull, ok[q]);
    if (lane == 0) s_cnt[q * kWarps + warp] = __popc(bal[q]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts in (load, warp) order
    const int c = lane < kPer * kWarps ? s_cnt[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane < kPer * kWarps) s_cnt[lane] = incl - c;
    if (lane == 31) s_cnt[32] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (ok[q]) {
      const int at = s_cnt[q * kWarps + warp] + __popc(bal[q] & below);
      s_ent[at] = make_longlong2(kr[q], ts[q]);
      if (s_j != nullptr) s_j[at] = static_cast<int>(j0 + q * kThreads + t);
    }
  }
  __syncthreads();
  return s_cnt[32];
}

template <int kSide>
__global__ void __launch_bounds__(kThreads) tile_count_kernel(
    Rows rows, Ring r, int64_t before, int64_t after, int64_t span, int64_t nchunks,
    int32_t* __restrict__ tcnt, int64_t* __restrict__ cnt, bool* __restrict__ row_matched,
    int64_t* __restrict__ offsets, int64_t* __restrict__ total, int32_t* ticket, int32_t* acc) {
  __shared__ longlong2 s_ent[kTile];
  __shared__ int s_cnt[33];
  __shared__ int64_t s_scan[kThreads];
  __shared__ bool s_last;
  const int64_t n = rows.n;
  const int64_t u = blockIdx.x % nchunks, rt = blockIdx.x / nchunks;
  const int64_t i = rt * kThreads + threadIdx.x;
  const bool on = i < n && rows.active[i] && rows.kvalid[i];
  const int64_t k = on ? rows.krepr[i] : 0, t = on ? rows.ts[i] : 0;
  const int64_t lo = ksql::wsub(t, before), hi = ksql::wadd(t, after);
  const bool any = __syncthreads_or(on);
  int c = 0;
  for (int64_t s = 0; s < span && any; ++s) {
    const int64_t j0 = (u * span + s) * kTile;
    if (j0 >= r.b1) break;  // the same for the whole block
    const int live = load_tile(r, j0, s_ent, nullptr, s_cnt);
    if (on) {
#pragma unroll 4
      for (int e = 0; e < live; ++e) {
        const longlong2 x = s_ent[e];
        if (x.x == k) c += in_window<kSide>(t, lo, hi, x.y, before, after);
      }
    }
    __syncthreads();  // s_ent and s_cnt are reloaded
  }
  if (i < n) {
    tcnt[u * n + i] = c;
    if (c > 0) atomicAdd(&acc[i], c);  // the row's total, over its chunks
  }
  // the last block to finish scans the totals and leaves acc and the
  // ticket 0 for the next call
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int64_t a, b;
  ksql::thread_chunk(n, &a, &b);
  int64_t sum = 0;
#pragma unroll 8
  for (int64_t row = a; row < b; ++row) sum += __ldcg(&acc[row]);
  int64_t run = ksql::block_inclusive_scan(sum, s_scan, ksql::AddOp()) - sum;
#pragma unroll 8
  for (int64_t row = a; row < b; ++row) {
    const int v = __ldcg(&acc[row]);
    acc[row] = 0;
    cnt[row] = v;
    row_matched[row] = v > 0;
    offsets[row] = run;
    run += v;
  }
  if (threadIdx.x == kThreads - 1) *total = s_scan[kThreads - 1];
  if (threadIdx.x == 0) *ticket = 0;
}

struct Lanes {
  const int64_t* d;  // the descriptor, in shared memory
  const void* const* own;  // the own columns' value and valid pointers, in shared memory
  char* out;
  int64_t oc;

  __device__ __forceinline__ char* lane(int64_t w) const { return out + oc * d[w]; }

  // Output lane k: row i of the batch, entry j of the ring.
  __device__ __forceinline__ void write(int64_t k, int64_t i, int64_t j, bool valid,
                                        const int64_t* ts, const int64_t* rts,
                                        const int64_t* seq) const {
    reinterpret_cast<int32_t*>(lane(2))[k] = static_cast<int32_t>(i);
    reinterpret_cast<int32_t*>(lane(3))[k] = static_cast<int32_t>(j);
    const int64_t a = ts[i], b = rts[j];
    reinterpret_cast<int64_t*>(lane(4))[k] = a > b ? a : b;
    reinterpret_cast<int64_t*>(lane(5))[k] = seq[j];
    reinterpret_cast<bool*>(lane(6))[k] = valid;
    const int64_t n_own = d[0], n_opp = d[1];
    for (int64_t c = 0; c < n_own; ++c) {
      const int64_t w = kDescHead + 3 * c;
      ksql::copy_elem(lane(w + 1), k, own[2 * c], i, d[w]);
      const bool m = static_cast<const bool*>(own[2 * c + 1])[i];
      reinterpret_cast<bool*>(lane(w + 2))[k] = valid && m;
    }
    for (int64_t c = 0; c < n_opp; ++c) {
      const int64_t w = kDescHead + 3 * n_own + 5 * c;
      ksql::copy_elem(lane(w + 3), k, reinterpret_cast<const void*>(d[w]), j, d[w + 1]);
      reinterpret_cast<bool*>(lane(w + 4))[k] = valid && reinterpret_cast<const bool*>(d[w + 2])[j];
    }
  }
};

template <int kSide>
__global__ void __launch_bounds__(kThreads) tile_write_kernel(
    Rows rows, Ring r, const int64_t* __restrict__ seq, bool* __restrict__ matched,
    int64_t before, int64_t after, int64_t span, int64_t nchunks,
    const int32_t* __restrict__ tcnt, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ total_p, int64_t oc, const int64_t* __restrict__ desc,
    int64_t words, OwnCols own, char* __restrict__ out) {
  __shared__ longlong2 s_ent[kTile];
  __shared__ int s_j[kTile];
  __shared__ int s_cnt[33];
  __shared__ int64_t s_desc[kDescWords];
  __shared__ const void* s_own[2 * KSQL_MAX_COLS];
  for (int64_t w = threadIdx.x; w < words; w += kThreads) s_desc[w] = desc[w];
#pragma unroll
  for (int c = 0; c < KSQL_MAX_COLS; ++c) {
    if (threadIdx.x == c) {  // a constant index: no copy of the parameters
      s_own[2 * c] = own.v[c];
      s_own[2 * c + 1] = own.m[c];
    }
  }
  __syncthreads();
  const Lanes lanes{s_desc, s_own, out, oc};
  const int64_t n = rows.n;
  // the fill lanes, over the whole grid
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = *total_p + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; k < oc;
       k += stride) {
    lanes.write(k, 0, 0, false, rows.ts, r.ts, seq);
  }
  const int64_t u = blockIdx.x % nchunks, rt = blockIdx.x / nchunks;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t i = rt * kThreads + threadIdx.x;
  const int want = i < n ? tcnt[u * n + i] : 0;
  if (!__syncthreads_or(want > 0)) return;  // no match of this row tile in this chunk
  // each row's first lane in this chunk: its offset plus its counts in
  // the chunks before, summed by its warp (a load a lane, not a chain)
  int64_t first = 0;
  for (unsigned todo = __ballot_sync(kFull, want > 0); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int64_t ri = __shfl_sync(kFull, i, src);
    int pre = 0;
    for (int64_t v = lane; v < u; v += 32) pre += tcnt[v * n + ri];
    pre = __reduce_add_sync(kFull, pre);
    if (lane == src) first = offsets[ri] + pre;
  }
  int seen = 0;
  for (int64_t s = 0; s < span; ++s) {
    const int64_t j0 = (u * span + s) * kTile;
    if (j0 >= r.b1) break;
    const int live = load_tile(r, j0, s_ent, s_j, s_cnt);
    // the warp walks the tile for each of its rows with matches left, an
    // entry a lane: a ballot ranks the row's matches in entry order
    for (unsigned todo = __ballot_sync(kFull, seen < want); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int64_t ri = __shfl_sync(kFull, i, src);
      const int64_t rk = rows.krepr[ri], rtime = rows.ts[ri];
      const int64_t rlo = ksql::wsub(rtime, before), rhi = ksql::wadd(rtime, after);
      const int64_t at0 = __shfl_sync(kFull, first + seen, src);
      const int left = __shfl_sync(kFull, want - seen, src);
      int got = 0;
      for (int e0 = 0; e0 < live && got < left; e0 += 32) {
        const int e = e0 + lane;
        bool hit = false;
        if (e < live) {
          const longlong2 x = s_ent[e];
          hit = x.x == rk && in_window<kSide>(rtime, rlo, rhi, x.y, before, after);
        }
        const unsigned bal = __ballot_sync(kFull, hit);
        if (hit) {
          const int j = s_j[e];
          matched[j] = true;
          const int64_t at = at0 + got + __popc(bal & below);
          if (at < oc) lanes.write(at, ri, j, true, rows.ts, r.ts, seq);
        }
        got += __popc(bal);
      }
      if (lane == src) seen += got;
    }
    if (!__syncthreads_or(seen < want)) break;  // also: s_ent is reloaded
  }
}

int chunks(int64_t b1, int64_t span) {
  return static_cast<int>((b1 + kTile * span - 1) / (kTile * span));
}

}  // namespace

// Count mode: tcnt (chunks x n int32, chunks = ceil(b1 / (512 span))),
// cnt, row_matched, offsets and total are written; ticket (one int32) and
// acc (n int32 at least) are zeros that the launch leaves zeros.
extern "C" int ksql_ss_match_count(int64_t side, const void* krepr, const void* kvalid,
                                   const void* active, const void* ts, int64_t n,
                                   const void* r_ts, const void* r_krepr, const void* r_kval,
                                   const void* r_live, int64_t b1, int64_t before,
                                   int64_t after, int64_t span, void* tcnt, void* cnt,
                                   void* row_matched, void* offsets, void* total, void* ticket,
                                   void* acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows rows{static_cast<const int64_t*>(krepr), static_cast<const bool*>(kvalid),
                  static_cast<const bool*>(active), static_cast<const int64_t*>(ts), n};
  const Ring r{static_cast<const int64_t*>(r_ts), static_cast<const int64_t*>(r_krepr),
               static_cast<const bool*>(r_kval), static_cast<const bool*>(r_live), b1};
  const int nchunks = chunks(b1, span);
  const int grid = ksql::blocks_for(n, kThreads) * nchunks;
  auto kernel = side == 0 ? tile_count_kernel<0> : tile_count_kernel<1>;
  kernel<<<grid, kThreads, 0, st>>>(rows, r, before, after, span, nchunks,
                                    static_cast<int32_t*>(tcnt), static_cast<int64_t*>(cnt),
                                    static_cast<bool*>(row_matched),
                                    static_cast<int64_t*>(offsets), static_cast<int64_t*>(total),
                                    static_cast<int32_t*>(ticket), static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// Write mode: `tcnt`, `offsets` and `total` are count mode's on the same
// inputs; `desc` (`words` int64) the device descriptor above, `own_ptrs`
// the own columns' (values, valid bits) pointers (2 n_own), `out` the
// output allocation of lanes of `oc` rows.
extern "C" int ksql_ss_match_write(int64_t side, const void* krepr, const void* kvalid,
                                   const void* active, const void* ts, int64_t n,
                                   const void* r_ts, const void* r_krepr, const void* r_kval,
                                   const void* r_live, const void* r_seq, void* r_matched,
                                   int64_t b1, int64_t before, int64_t after, int64_t span,
                                   const void* tcnt, const void* offsets, const void* total,
                                   int64_t oc, const void* desc, int64_t words,
                                   const int64_t* own_ptrs, int64_t n_own, void* out,
                                   void* stream) {
  if (words > kDescWords || n_own > KSQL_MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  OwnCols own{};
  for (int64_t c = 0; c < n_own; ++c) {
    own.v[c] = reinterpret_cast<const void*>(own_ptrs[2 * c]);
    own.m[c] = reinterpret_cast<const void*>(own_ptrs[2 * c + 1]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows rows{static_cast<const int64_t*>(krepr), static_cast<const bool*>(kvalid),
                  static_cast<const bool*>(active), static_cast<const int64_t*>(ts), n};
  const Ring r{static_cast<const int64_t*>(r_ts), static_cast<const int64_t*>(r_krepr),
               static_cast<const bool*>(r_kval), static_cast<const bool*>(r_live), b1};
  const int nchunks = chunks(b1, span);
  const int grid = ksql::blocks_for(n, kThreads) * nchunks;
  auto kernel = side == 0 ? tile_write_kernel<0> : tile_write_kernel<1>;
  kernel<<<grid, kThreads, 0, st>>>(
      rows, r, static_cast<const int64_t*>(r_seq), static_cast<bool*>(r_matched), before, after,
      span, nchunks, static_cast<const int32_t*>(tcnt), static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(total), oc, static_cast<const int64_t*>(desc), words, own,
      static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}
