// K19 having_verdict: HAVING retraction over an EMIT CHANGES aggregation.
//
// Replaces the hpass branch of runtime/lowering.py:_emit_agg (B6, :4164-4199
// of the reference), once per HAVING filter.  The predicate itself is
// evaluated before (torch ops); per emission lane:
//   prev = hpass[slot], pass = valid && data,
//   t = mask && prev && !pass (the slot passed before and fails now: a
//     retraction tombstone), mask' = mask && (pass || t), tombstone |= t,
// and hpass[where(mask, slot, C)] = pass.  Every lane outside the mask
// aims at the dump slot C, and XLA's duplicate-index set leaves the value
// of the highest lane aimed there.  Two launches: the lanes (a masked lane
// is its slot's one emission winner, so it alone writes its slot, after
// reading it; the lanes aimed at C take the highest index with an int32
// atomicMax and write nothing), then one thread that writes hpass[C] from
// that lane (or leaves it when no lane aims at C) and resets the index.
//
// Bound: bytes.  It reads slot, mask, data and valid (7 bytes) and hpass at
// the slot, and writes mask' and tombstone (2 bytes) per lane, plus one
// byte per masked lane: about 0.7 MB at 65,536 lanes, ~0.2 us at
// 3.35 TB/s.  One thread per lane, coalesced on the lane columns.
#include "common.cuh"

namespace {

__global__ void verdict_kernel(bool* __restrict__ hpass, const int32_t* __restrict__ slots,
                               const bool* __restrict__ mask, const bool* __restrict__ data,
                               const bool* __restrict__ valid, const bool* __restrict__ tomb_in,
                               int64_t lanes, int64_t capacity, bool* __restrict__ mask_out,
                               bool* __restrict__ tomb_out, int32_t* __restrict__ last) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const int64_t s = slots[i];
  const bool m = mask[i];
  const bool pass = valid[i] && data[i];
  const bool t = m && hpass[s] && !pass;
  mask_out[i] = m && (pass || t);
  tomb_out[i] = (tomb_in != nullptr && tomb_in[i]) || t;
  const int64_t touched = m ? s : capacity;
  if (touched == capacity) {
    atomicMax(last, static_cast<int32_t>(i));
  } else {
    hpass[touched] = pass;
  }
}

__global__ void dump_kernel(bool* __restrict__ hpass, const bool* __restrict__ data,
                            const bool* __restrict__ valid, int64_t capacity,
                            int32_t* __restrict__ last) {
  const int32_t i = *last;
  if (i >= 0) hpass[capacity] = valid[i] && data[i];
  *last = -1;
}

}  // namespace

extern "C" int ksql_having_verdict(void* hpass, const void* slots, const void* mask,
                                   const void* data, const void* valid, const void* tomb_in,
                                   int64_t lanes, int64_t capacity, void* mask_out,
                                   void* tomb_out, void* last, void* stream) {
  if (lanes >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  verdict_kernel<<<ksql::blocks_for(lanes, threads), threads, 0, st>>>(
      static_cast<bool*>(hpass), static_cast<const int32_t*>(slots),
      static_cast<const bool*>(mask), static_cast<const bool*>(data),
      static_cast<const bool*>(valid), static_cast<const bool*>(tomb_in), lanes, capacity,
      static_cast<bool*>(mask_out), static_cast<bool*>(tomb_out), static_cast<int32_t*>(last));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dump_kernel<<<1, 1, 0, st>>>(static_cast<bool*>(hpass), static_cast<const bool*>(data),
                               static_cast<const bool*>(valid), capacity,
                               static_cast<int32_t*>(last));
  return static_cast<int>(cudaGetLastError());
}
