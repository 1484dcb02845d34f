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
// Two calls from the wrapper, with the count read between them:
//   1. count, one thread a slot in blocks of 256: each block's matches
//      (__syncthreads_count) into counts[block]; then one block scans the
//      block counts into exclusive offsets and writes the total;
//   2. write, one thread a slot again: the block's offset plus the warp's
//      (a ballot per warp, the warp totals scanned in shared memory) plus
//      the thread's rank in its warp's ballot is its lane; a matching slot
//      writes its slot number, key0 and every column there.
// Both passes read the scanned columns (live, fkvalid, fkrepr); the second
// reads the matched rows' columns.
//
// Bound: memory, by the bytes the function needs: 10 bytes a slot read
// once (live, fkvalid, fkrepr), and per matched slot its key0 and columns
// read (8 + 9 bytes a 64-bit column) and its slot number, key0 and columns
// written (12 + 9 a column): at 2^18 + 1 slots about 2.6 MB (~0.78 us at
// 3.35 TB/s), with the hottest customer's orders on top.  The kernel reads
// the scanned columns twice (once a pass), so it moves about twice what
// the bound counts.  The count read between the passes is a host round
// trip: the per-record step makes one per right change anyway.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool matches(int64_t i, int64_t c1, const bool* __restrict__ live,
                                        const bool* __restrict__ fkvalid,
                                        const int64_t* __restrict__ fkrepr, int64_t krepr0,
                                        bool touched0) {
  return i < c1 && touched0 && live[i] && fkvalid[i] && fkrepr[i] == krepr0;
}

__global__ void fanout_count_kernel(const bool* __restrict__ live,
                                    const bool* __restrict__ fkvalid,
                                    const int64_t* __restrict__ fkrepr, int64_t c1,
                                    const int64_t* __restrict__ krepr,
                                    const bool* __restrict__ touched,
                                    int32_t* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int cnt = __syncthreads_count(matches(i, c1, live, fkvalid, fkrepr, krepr[0], touched[0]));
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

// One block: counts[0..nb) -> exclusive offsets in place; the total into
// *total.
__global__ void fanout_scan_kernel(int32_t* __restrict__ counts, int64_t nb,
                                   int64_t* __restrict__ total) {
  __shared__ int64_t buf[1024];
  int64_t lo, hi;
  ksql::thread_chunk(nb, &lo, &hi);
  int64_t sum = 0;
  for (int64_t b = lo; b < hi; ++b) sum += counts[b];
  const int64_t incl = ksql::block_inclusive_scan(sum, buf, ksql::AddOp());
  int64_t run = incl - sum;
  for (int64_t b = lo; b < hi; ++b) {
    const int32_t c = counts[b];
    counts[b] = static_cast<int32_t>(run);
    run += c;
  }
  if (threadIdx.x == blockDim.x - 1) *total = incl;
}

__global__ void fanout_write_kernel(const bool* __restrict__ live,
                                    const bool* __restrict__ fkvalid,
                                    const int64_t* __restrict__ fkrepr,
                                    const int64_t* __restrict__ key0, int64_t c1,
                                    const int64_t* __restrict__ krepr,
                                    const bool* __restrict__ touched,
                                    const int32_t* __restrict__ offsets, ksql::Gather g,
                                    int32_t* __restrict__ slot_out,
                                    int64_t* __restrict__ key_out) {
  __shared__ int warp_off[kWarps];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool m = matches(i, c1, live, fkvalid, fkrepr, krepr[0], touched[0]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, m);
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_off[w];
      warp_off[w] = run;
      run += c;
    }
  }
  __syncthreads();
  if (!m) return;
  const int64_t pos = offsets[blockIdx.x] + warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
  slot_out[pos] = static_cast<int32_t>(i);
  key_out[pos] = key0[i];
  for (int64_t j = 0; j < g.count; ++j) {
    ksql::copy_elem(g.vdst[j], pos, g.vsrc[j], i, g.size[j]);
    g.mdst[j][pos] = g.msrc[j][i];
  }
}

}  // namespace

// Pass 1: `counts` is int32 scratch of ceil(c1 / 256) entries,
// left holding each block's exclusive offset; `total` an int64 scalar.
extern "C" int ksql_fk_fanout_count(const void* live, const void* fkvalid, const void* fkrepr,
                                    int64_t c1, const void* krepr, const void* touched,
                                    void* counts, void* total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = ksql::blocks_for(c1, kThreads);
  fanout_count_kernel<<<nb, kThreads, 0, st>>>(
      static_cast<const bool*>(live), static_cast<const bool*>(fkvalid),
      static_cast<const int64_t*>(fkrepr), c1, static_cast<const int64_t*>(krepr),
      static_cast<const bool*>(touched), static_cast<int32_t*>(counts));
  fanout_scan_kernel<<<1, 1024, 0, st>>>(static_cast<int32_t*>(counts), nb,
                                         static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: `cols` holds 5 int64 per left column (store value, lane value,
// element bytes, store valid, lane valid); the lanes are the total long.
extern "C" int ksql_fk_fanout_write(const void* live, const void* fkvalid, const void* fkrepr,
                                    const void* key0, int64_t c1, const void* krepr,
                                    const void* touched, const void* offsets,
                                    const int64_t* cols, int64_t count, void* slot_out,
                                    void* key_out, void* stream) {
  ksql::Gather g;
  if (!ksql::gather_from_desc(cols, count, &g)) return static_cast<int>(cudaErrorInvalidValue);
  fanout_write_kernel<<<ksql::blocks_for(c1, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(live), static_cast<const bool*>(fkvalid),
      static_cast<const int64_t*>(fkrepr), static_cast<const int64_t*>(key0), c1,
      static_cast<const int64_t*>(krepr), static_cast<const bool*>(touched),
      static_cast<const int32_t*>(offsets), g, static_cast<int32_t*>(slot_out),
      static_cast<int64_t*>(key_out));
  return static_cast<int>(cudaGetLastError());
}
