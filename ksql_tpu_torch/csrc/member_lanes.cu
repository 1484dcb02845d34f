// K7 member_lanes: the window lanes a sliced hopping batch emits, one
// winner per distinct (slot, window).
//
// Replaces the lane expansion and dedupe of
// runtime/lowering.py:_sliced_member_emits (B10).  Lane l = h*n + i is row
// i's hop h (hop-major, as jnp.tile lays it out): window w = newest_i - h*A
// in slice units, newest_i = sidx_i - sidx_i mod A the newest
// advance-aligned window over the row's slice, A the advance in slices.  A
// lane is masked in when its row reached a store slot (active, slot != C),
// its window covers the row's slice (w + spw > sidx, w >= 0) and is still
// open at the stream time of batch start (w*width + size + grace > max_ts).
// Among the masked lanes of one (slot, w) the lowest lane index wins — what
// the reference's lexsort of (slot, w, lane) and first occurrence give.
//   launch 1, one thread per lane: write w_lane, slot_lane and the mask
//     (into winner), and atomicMin the lane into the claim cell
//     claims[slot * span + w mod span];
//   launch 2: a masked lane wins iff the claim is its own index; the winner
//     resets the cell to INT32_MAX, so the scratch is clean for the next
//     batch (a loser that reads after the reset sees INT32_MAX, not itself).
// Why span = ring + spw is exact: K1's horizon cut admits a row only while
// wstart + (ring - 1) * width > batch_max, so the admitted slice indices lie
// in [B - ring + 2, B] (B the batch's newest slice): ring - 1 values.  A
// masked lane's w lies in [sidx - spw + 1, sidx], so one slot's windows
// span at most ring + spw - 2 values, and distinct windows of one slot
// never share a claim cell.  The ring itself does not suffice: at the ring cap
// (slice_ring_max) the admitted slices plus spw - 1 exceed it.
//
// Bound: memory.  Per row it reads slot, active and wstart (13 bytes) and
// per lane writes w, slot and winner (13 bytes) plus an atomic on a claim
// cell: at BASELINE #2 (n = 16,384, k = 4) about 1.1 MB (~0.3 us at 3.35
// TB/s).  The claim scratch is (C + 1) * span int32s, 4/56 of the ring's
// own bytes at BASELINE #2's layout, kept clean by the winners.
#include "common.cuh"

namespace {

struct Lane {
  int64_t w;
  int32_t slot;
  bool mask;
};

__device__ __forceinline__ Lane lane_of(
    int64_t l, const int32_t* slots, const bool* active, const int64_t* wstart,
    int64_t n, int64_t spw, int64_t adv, int64_t width, int64_t size_ms,
    int64_t grace_ms, int64_t clock, int64_t capacity) {
  const int64_t i = l % n, hop = l / n;
  Lane r;
  r.slot = slots[i];
  const int64_t sidx = ksql::floor_div(wstart[i], width);
  const int64_t newest = sidx - ksql::floor_mod(sidx, adv);
  r.w = ksql::wadd(newest, -ksql::wmul(hop, adv));
  const bool covers = ksql::wadd(r.w, spw) > sidx && r.w >= 0;
  const bool open_w =
      ksql::wadd(ksql::wadd(ksql::wmul(r.w, width), size_ms), grace_ms) > clock;
  r.mask = active[i] && r.slot != capacity && covers && open_w;
  return r;
}

__global__ void lane_claim_kernel(const int32_t* __restrict__ slots,
                                  const bool* __restrict__ active,
                                  const int64_t* __restrict__ wstart, int64_t n,
                                  int64_t nn, int64_t spw, int64_t adv,
                                  int64_t width, int64_t size_ms, int64_t grace_ms,
                                  const int64_t* __restrict__ max_ts,
                                  int64_t capacity, int32_t* __restrict__ claims,
                                  int64_t span, int64_t* __restrict__ w_lane,
                                  int32_t* __restrict__ slot_lane,
                                  bool* __restrict__ mask) {
  int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= nn) return;
  const Lane r = lane_of(l, slots, active, wstart, n, spw, adv, width, size_ms,
                         grace_ms, *max_ts, capacity);
  w_lane[l] = r.w;
  slot_lane[l] = r.slot;
  mask[l] = r.mask;
  if (r.mask) {
    atomicMin(&claims[r.slot * span + ksql::floor_mod(r.w, span)],
              static_cast<int32_t>(l));
  }
}

__global__ void lane_winner_kernel(int64_t nn, int32_t* __restrict__ claims,
                                   int64_t span, const int64_t* __restrict__ w_lane,
                                   const int32_t* __restrict__ slot_lane,
                                   bool* __restrict__ winner) {
  int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= nn || !winner[l]) return;
  int32_t* cell = &claims[static_cast<int64_t>(slot_lane[l]) * span +
                          ksql::floor_mod(w_lane[l], span)];
  const bool win = *cell == static_cast<int32_t>(l);
  if (win) *cell = INT32_MAX;  // only the winner resets its cell
  winner[l] = win;
}

}  // namespace

extern "C" int ksql_member_lanes(
    const void* slots, const void* active, const void* wstart, int64_t n,
    int64_t hops, int64_t spw, int64_t adv, int64_t width, int64_t size_ms,
    int64_t grace_ms, const void* max_ts, int64_t capacity, void* claims,
    int64_t span, void* w_lane, void* slot_lane, void* winner, void* stream) {
  const int64_t nn = n * hops;
  if (nn >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = ksql::blocks_for(nn, threads);
  lane_claim_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const int32_t*>(slots), static_cast<const bool*>(active),
      static_cast<const int64_t*>(wstart), n, nn, spw, adv, width, size_ms,
      grace_ms, static_cast<const int64_t*>(max_ts), capacity,
      static_cast<int32_t*>(claims), span, static_cast<int64_t*>(w_lane),
      static_cast<int32_t*>(slot_lane), static_cast<bool*>(winner));
  lane_winner_kernel<<<blocks, threads, 0, st>>>(
      nn, static_cast<int32_t*>(claims), span,
      static_cast<const int64_t*>(w_lane), static_cast<const int32_t*>(slot_lane),
      static_cast<bool*>(winner));
  return static_cast<int>(cudaGetLastError());
}
