// K10 ss_match: the WITHIN-window equi-match of a stream-stream join, one
// batch of one side against the other side's ring buffer.
//
// Replaces the match part of runtime/lowering.py:_trace_ss_step (B14): the
// n x (B+1) mask `active & live & key_eq & tw`, its sum and any(axis=1),
// the nonzero(size=oc, fill_value=0) compaction, the match lanes' gathers
// and the opposite ring's any(axis=0).  The mask is never built: three
// launches walk the ring instead.
//   1. count: one warp per incoming row walks the opposite ring in
//      32-entry chunks; each lane tests one entry, a ballot gathers the
//      chunk and popc counts it.  An entry matches when the row is active
//      with a valid key, the entry is live with a valid key, the key reprs
//      are equal and the entry lies in the row's window (bounds inclusive;
//      left row: ts-before <= ots <= ts+after, right row: ots-before <= ts
//      <= ots+after).  Writes cnt[i] and row_matched[i].
//   2. scan: one block, an exclusive scan of cnt (the row offsets) and the
//      total.
//   3. write: the same walk again for the rows with matches; the match
//      with rank r in its row goes to lane offsets[i] + r, which is its
//      rank in row-major (i, then j ascending) order, the order nonzero
//      gives.  A lane k < oc gets mi, mj, ts = max(ts[i], ots[j]), ord_b =
//      seq[j], mvalid, the own side's columns at i and the ring's at j.
//      Every matched entry gets matched[j] = true.  Lanes total..oc-1 read
//      row 0 and entry 0 with every valid bit false (fill_value=0).
// int64 window sums wrap, as XLA's do.
//
// Bound: operations.  n x (B+1) pair tests of a few integer ops each
// (2,048 x 16,385 = 33.5 M pairs at BASELINE #4's shapes), about 0.004 ms
// at the card's integer rate.  The bytes are small: the batch's columns
// and 18 bytes an entry of the ring (295 KB), read by every warp.  This
// first kernel reads the ring through L2 and L1 (each block's warps read
// the same chunks at about the same time); tiling it through shared
// memory, shared by a block's warps, is later work.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Ring {
  const int64_t* ts;
  const int64_t* krepr;
  const bool* kval;
  const bool* live;
  int64_t b1;  // entries, the dump entry included
};

__device__ __forceinline__ bool matches(const Ring& r, int64_t j, int side, int64_t k,
                                        int64_t t, int64_t before, int64_t after) {
  if (j >= r.b1 || !r.live[j] || !r.kval[j] || r.krepr[j] != k) return false;
  const int64_t ot = r.ts[j];
  if (side == 0) return ksql::wsub(t, before) <= ot && ot <= ksql::wadd(t, after);
  return ksql::wsub(ot, before) <= t && t <= ksql::wadd(ot, after);
}

__global__ void match_count_kernel(int side, const int64_t* __restrict__ krepr,
                                   const bool* __restrict__ kvalid,
                                   const bool* __restrict__ active,
                                   const int64_t* __restrict__ ts, int64_t n, Ring r,
                                   int64_t before, int64_t after, int64_t* __restrict__ cnt,
                                   bool* __restrict__ row_matched) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps: i is the warp's row
  int64_t c = 0;
  if (active[i] && kvalid[i]) {
    const int64_t k = krepr[i], t = ts[i];
    for (int64_t j0 = 0; j0 < r.b1; j0 += 32) {
      c += __popc(__ballot_sync(kFull, matches(r, j0 + lane, side, k, t, before, after)));
    }
  }
  if (lane == 0) {
    cnt[i] = c;
    row_matched[i] = c > 0;
  }
}

__global__ void match_scan_kernel(const int64_t* __restrict__ cnt, int64_t n,
                                  int64_t* __restrict__ offsets, int64_t* __restrict__ total) {
  __shared__ int64_t buf[1024];
  int64_t lo, hi;
  ksql::thread_chunk(n, &lo, &hi);
  int64_t s = 0;
  for (int64_t i = lo; i < hi; ++i) s += cnt[i];
  int64_t run = ksql::block_inclusive_scan(s, buf, ksql::AddOp()) - s;
  for (int64_t i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += cnt[i];
  }
  if (threadIdx.x == blockDim.x - 1) *total = buf[blockDim.x - 1];
}

__device__ __forceinline__ void write_lane(int64_t k, int64_t i, int64_t j, bool valid,
                                           const int64_t* ts, const Ring& r,
                                           const int64_t* seq, const ksql::Gather& own,
                                           const ksql::Gather& opp, int32_t* mi, int32_t* mj,
                                           int64_t* out_ts, int64_t* ord_b, bool* mvalid) {
  mi[k] = static_cast<int32_t>(i);
  mj[k] = static_cast<int32_t>(j);
  const int64_t a = ts[i], b = r.ts[j];
  out_ts[k] = a > b ? a : b;
  ord_b[k] = seq[j];
  mvalid[k] = valid;
  for (int64_t c = 0; c < own.count; ++c) {
    ksql::copy_elem(own.vdst[c], k, own.vsrc[c], i, own.size[c]);
    own.mdst[c][k] = valid && own.msrc[c][i];
  }
  for (int64_t c = 0; c < opp.count; ++c) {
    ksql::copy_elem(opp.vdst[c], k, opp.vsrc[c], j, opp.size[c]);
    opp.mdst[c][k] = valid && opp.msrc[c][j];
  }
}

__global__ void match_write_kernel(int side, const int64_t* __restrict__ krepr,
                                   const bool* __restrict__ kvalid,
                                   const bool* __restrict__ active,
                                   const int64_t* __restrict__ ts, int64_t n, Ring r,
                                   const int64_t* __restrict__ seq, bool* __restrict__ matched,
                                   int64_t before, int64_t after, const int64_t* __restrict__ cnt,
                                   const int64_t* __restrict__ offsets,
                                   const int64_t* __restrict__ total_p, int64_t oc,
                                   ksql::Gather own, ksql::Gather opp, int32_t* __restrict__ mi,
                                   int32_t* __restrict__ mj, int64_t* __restrict__ out_ts,
                                   int64_t* __restrict__ ord_b, bool* __restrict__ mvalid) {
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = *total_p + gt; k < oc; k += stride) {
    write_lane(k, 0, 0, false, ts, r, seq, own, opp, mi, mj, out_ts, ord_b, mvalid);
  }
  const int64_t i = gt / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t want = cnt[i];
  if (want == 0) return;
  const int64_t k = krepr[i], t = ts[i], base = offsets[i];
  int64_t seen = 0;
  for (int64_t j0 = 0; j0 < r.b1 && seen < want; j0 += 32) {
    const int64_t j = j0 + lane;
    const bool p = matches(r, j, side, k, t, before, after);
    const unsigned ballot = __ballot_sync(kFull, p);
    if (p) {
      matched[j] = true;
      const int64_t lane_k = base + seen + __popc(ballot & ((1u << lane) - 1u));
      if (lane_k < oc) {
        write_lane(lane_k, i, j, true, ts, r, seq, own, opp, mi, mj, out_ts, ord_b, mvalid);
      }
    }
    seen += __popc(ballot);
  }
}

}  // namespace

extern "C" int ksql_ss_match_count(int64_t side, const void* krepr, const void* kvalid,
                                   const void* active, const void* ts, int64_t n,
                                   const void* r_ts, const void* r_krepr, const void* r_kval,
                                   const void* r_live, int64_t b1, int64_t before,
                                   int64_t after, void* cnt, void* row_matched, void* offsets,
                                   void* total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Ring r{static_cast<const int64_t*>(r_ts), static_cast<const int64_t*>(r_krepr),
               static_cast<const bool*>(r_kval), static_cast<const bool*>(r_live), b1};
  const int threads = 256;
  match_count_kernel<<<ksql::blocks_for(n * 32, threads), threads, 0, st>>>(
      static_cast<int>(side), static_cast<const int64_t*>(krepr),
      static_cast<const bool*>(kvalid), static_cast<const bool*>(active),
      static_cast<const int64_t*>(ts), n, r, before, after, static_cast<int64_t*>(cnt),
      static_cast<bool*>(row_matched));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_scan_kernel<<<1, 1024, 0, st>>>(static_cast<const int64_t*>(cnt), n,
                                     static_cast<int64_t*>(offsets),
                                     static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_ss_match_write(int64_t side, const void* krepr, const void* kvalid,
                                   const void* active, const void* ts, int64_t n,
                                   const void* r_ts, const void* r_krepr, const void* r_kval,
                                   const void* r_live, const void* r_seq, void* r_matched,
                                   int64_t b1, int64_t before, int64_t after, const void* cnt,
                                   const void* offsets, const void* total, int64_t oc,
                                   const int64_t* own_desc, int64_t own_count,
                                   const int64_t* opp_desc, int64_t opp_count, void* mi,
                                   void* mj, void* out_ts, void* ord_b, void* mvalid,
                                   void* stream) {
  ksql::Gather own, opp;
  if (!ksql::gather_from_desc(own_desc, own_count, &own) ||
      !ksql::gather_from_desc(opp_desc, opp_count, &opp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Ring r{static_cast<const int64_t*>(r_ts), static_cast<const int64_t*>(r_krepr),
               static_cast<const bool*>(r_kval), static_cast<const bool*>(r_live), b1};
  const int threads = 256;
  match_write_kernel<<<ksql::blocks_for(n * 32, threads), threads, 0, st>>>(
      static_cast<int>(side), static_cast<const int64_t*>(krepr),
      static_cast<const bool*>(kvalid), static_cast<const bool*>(active),
      static_cast<const int64_t*>(ts), n, r, static_cast<const int64_t*>(r_seq),
      static_cast<bool*>(r_matched), before, after, static_cast<const int64_t*>(cnt),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(total), oc, own, opp,
      static_cast<int32_t*>(mi), static_cast<int32_t*>(mj), static_cast<int64_t*>(out_ts),
      static_cast<int64_t*>(ord_b), static_cast<bool*>(mvalid));
  return static_cast<int>(cudaGetLastError());
}
