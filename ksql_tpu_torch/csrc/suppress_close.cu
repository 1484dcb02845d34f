// K18 suppress_close: which windows an EMIT FINAL batch closes.
//
// Replaces the suppress branch of runtime/lowering.py:post_exchange (B17,
// :3997-4041 of the reference), after K3 has folded the batch and marked
// its slots dirty.  Two launches on the stream:
//   born (one thread per lane): the first-touch order, born[slot] =
//     min(born[slot], row_clock + lane) for every active lane (an int64
//     atomicMin; an active lane whose insert overflowed aims at the dump
//     slot C, as the reference's slot_or_dump does; inactive lanes add
//     INT64_MAX there, which changes nothing);
//   close (one thread per slot of C + 1): close = wstart + size + grace,
//     horizon = wstart + retention; a binary search of cm_emit (K17's
//     per-row stream times, already non-decreasing, so the reference's
//     sort is the identity and is skipped) finds the first T >= close.
//     A candidate slot (occ, dirty, not yet emitted) emits when that T
//     exists and is at or before its horizon (reachable); it is evicted
//     unemitted when close <= the batch's last T and it is not reachable:
//     occ off, grave on, born INT64_MAX, each component back to its init.
//     Both clear dirty; an emit sets emitted and its bit of the
//     suppress_emit mask.  Thread 0 advances emit_clock to max(emit_clock,
//     cm_emit[n - 1]) and row_clock by the lane count.
//
// Bound: bytes.  The close pass reads occ, dirty and emitted (3 bytes) and
// writes the mask (1 byte) for every slot, and reads wstart and writes the
// flags, born and the components for the candidate slots only; the born
// pass reads 5 bytes a lane and reads and writes born at each touched
// slot: about 8.5 MB at 2^20 slots with 13% candidates and 65,536 lanes,
// ~2.5 us at 3.35 TB/s.  Each candidate's binary search (17 probes at
// n = 65,536) reads a 512 KB array that stays in L2.  Plain
// one-thread-per-element kernels, coalesced on the slot and lane columns.
#include "common.cuh"

namespace {

struct Comps {
  void* col[KSQL_MAX_COMPS];
  int64_t dtype[KSQL_MAX_COMPS];
  int64_t init_bits[KSQL_MAX_COMPS];
  int64_t count;
};

__global__ void born_kernel(const int32_t* __restrict__ slots, const bool* __restrict__ active,
                            int64_t lanes, const int64_t* __restrict__ row_clock,
                            int64_t* __restrict__ born) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= lanes || !active[i]) return;
  atomicMin(reinterpret_cast<long long*>(born + slots[i]),
            static_cast<long long>(ksql::wadd(*row_clock, i)));
}

__global__ void close_kernel(Comps c, bool* __restrict__ occ, bool* __restrict__ grave,
                             bool* __restrict__ dirty, bool* __restrict__ emitted,
                             int64_t* __restrict__ born, const int64_t* __restrict__ wstart,
                             const int64_t* __restrict__ cm, int64_t n, int64_t size_ms,
                             int64_t grace_ms, int64_t retention, int64_t lanes,
                             int64_t* __restrict__ emit_clock, int64_t* __restrict__ row_clock,
                             bool* __restrict__ emit_out, int64_t slots) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const int64_t final_t = cm[n - 1];
  if (s == 0) {
    if (final_t > *emit_clock) *emit_clock = final_t;
    *row_clock = ksql::wadd(*row_clock, lanes);
  }
  if (!(occ[s] && dirty[s] && !emitted[s])) {
    emit_out[s] = false;
    return;
  }
  const int64_t ws = wstart[s];
  const int64_t close = ksql::wadd(ksql::wadd(ws, size_ms), grace_ms);
  const int64_t horizon = ksql::wadd(ws, retention);
  int64_t lo = 0, hi = n;  // first position with cm[pos] >= close
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (cm[mid] < close) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool reachable = lo < n && cm[lo] <= horizon;
  const bool evict_now = !reachable && close <= final_t;
  emit_out[s] = reachable;
  if (reachable) {
    dirty[s] = false;
    emitted[s] = true;
  } else if (evict_now) {
    dirty[s] = false;
    occ[s] = false;
    grave[s] = true;
    born[s] = INT64_MAX;
    for (int64_t j = 0; j < c.count; ++j) {
      ksql::store_init(c.col[j], s, c.dtype[j], c.init_bits[j]);
    }
  }
}

}  // namespace

extern "C" int ksql_suppress_close(const int64_t* comps, int64_t count, const void* slots,
                                   const void* active, int64_t lanes, void* occ, void* grave,
                                   void* dirty, void* emitted, void* born, const void* wstart,
                                   const void* cm_emit, int64_t n, int64_t size_ms,
                                   int64_t grace_ms, int64_t retention, void* emit_clock,
                                   void* row_clock, void* emit_out, int64_t capacity,
                                   void* stream) {
  if (count > KSQL_MAX_COMPS || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Comps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<void*>(comps[3 * j]);
    c.dtype[j] = comps[3 * j + 1];
    c.init_bits[j] = comps[3 * j + 2];
  }
  c.count = count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  born_kernel<<<ksql::blocks_for(lanes, threads), threads, 0, st>>>(
      static_cast<const int32_t*>(slots), static_cast<const bool*>(active), lanes,
      static_cast<const int64_t*>(row_clock), static_cast<int64_t*>(born));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t slot_count = capacity + 1;
  close_kernel<<<ksql::blocks_for(slot_count, threads), threads, 0, st>>>(
      c, static_cast<bool*>(occ), static_cast<bool*>(grave), static_cast<bool*>(dirty),
      static_cast<bool*>(emitted), static_cast<int64_t*>(born),
      static_cast<const int64_t*>(wstart), static_cast<const int64_t*>(cm_emit), n, size_ms,
      grace_ms, retention, lanes, static_cast<int64_t*>(emit_clock),
      static_cast<int64_t*>(row_clock), static_cast<bool*>(emit_out), slot_count);
  return static_cast<int>(cudaGetLastError());
}
