// K18 suppress_close: which windows an EMIT FINAL batch closes.
//
// Replaces the suppress branch of runtime/lowering.py:post_exchange (B17,
// :3997-4041 of the reference), after K3 has folded the batch and marked
// its slots dirty.  Two phases:
//   born: the first-touch order, born[slot] = min(born[slot], row_clock +
//     lane) for every active lane (an active lane whose insert overflowed
//     aims at the dump slot C, as the reference's slot_or_dump does;
//     inactive lanes add INT64_MAX there, which changes nothing);
//   close: close = wstart + size + grace, horizon = wstart + retention; the
//     first T >= close in cm_emit (K17's per-row stream times, already
//     non-decreasing, so the reference's sort is the identity and is
//     skipped).  A candidate slot (occ, dirty, not yet emitted) emits when
//     that T exists and is at or before its horizon (reachable); it is
//     evicted unemitted when close <= the batch's last T and it is not
//     reachable: occ off, grave on, born INT64_MAX, each component back to
//     its init.  Both clear dirty; an emit sets emitted and its bit of the
//     suppress_emit mask.  emit_clock advances to max(emit_clock,
//     cm_emit[n - 1]) and row_clock by the lane count.
// The evict's born = INT64_MAX must follow every atomicMin into its slot:
// one cooperative launch (close_slots_kernel, a grid of at most the blocks
// the card holds at once) runs born, grid.sync(), close.
//   born: a warp's active lanes aimed at one slot (__match_any_sync) leave
//     the atomicMin to their lowest lane, whose order is the smallest (a
//     warp whose orders wrap past INT64_MAX makes one a lane); a group of
//     several lanes (a slot likely hot) reads born first: born only falls
//     within the pass, so a value already at or below the order is final.
//     Lanes aimed at C fold into one shared minimum a block, then one
//     atomicMin.  The born phase also writes the close phase's sample.
//   close: a warp takes 512 slots, a lane 16, read as 16-byte vectors of
//     occ, dirty and emitted; the warp lists its candidates in shared
//     memory (a prefix sum of the lanes' counts) and its lanes take them in
//     turn (an even share however they cluster), then each lane writes its
//     16 slots' flags and mask as 16-byte vectors.  The search: each block
//     keeps a sample of cm_emit in shared memory, the last entry of each of
//     up to kSample equal chunks; a binary search of the sample finds the
//     chunk, then rounds of kFan loads at once in L2 narrow it kFan-fold
//     (one round for phase 12's 65,536 entries).  Each lane reads its next
//     candidate's wstart while it searches for this one.
//
// Bound: bytes.  The close pass reads occ, dirty and emitted (3 bytes) and
// writes the mask (1 byte) for every slot, and reads wstart and writes the
// flags, born and the components for the candidate slots only; the born
// pass reads 5 bytes a lane and reads and writes born at each touched
// slot: about 8.5 MB at 2^20 slots with 13% candidates and 65,536 lanes,
// ~2.5 us at 3.35 TB/s.  The searches read a 512 KB array that stays in L2.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;             // slots a lane: one 16-byte vector of each flag
constexpr int kUnit = 32 * kSlots;     // slots a warp
constexpr int kSample = 4096;          // cm_emit entries a block keeps in shared memory
constexpr int kFan = 16;               // positions a search round reads at once
constexpr unsigned kFull = 0xffffffffu;

struct Comps {
  void* col[KSQL_MAX_COMPS];
  int64_t dtype[KSQL_MAX_COMPS];
  int64_t init_bits[KSQL_MAX_COMPS];
  int64_t count;
};

struct Args {
  Comps c;
  const int32_t* slots;
  const bool* active;
  int64_t lanes;
  bool* occ;
  bool* grave;
  bool* dirty;
  bool* emitted;
  int64_t* born;
  const int64_t* wstart;
  const int64_t* cm;
  int64_t n, size_ms, grace_ms, retention;
  int64_t* emit_clock;
  int64_t* row_clock;
  bool* emit_out;
  int64_t* sample;     // kSample words of scratch: the born phase writes the sample there
  int64_t slot_count;  // capacity + 1
  bool vec;            // the four flag columns are 16-byte aligned
};

// cm_emit cut into `chunks` chunks of `chunk` entries (the last may be short)
struct Chunks {
  int64_t chunk;
  int chunks;
  __device__ __forceinline__ explicit Chunks(int64_t n)
      : chunk((n + kSample - 1) / kSample), chunks(static_cast<int>((n + chunk - 1) / chunk)) {}
};

// kSlots flags from p[s0, s0 + cnt) as bits (one vector load where whole and aligned)
__device__ __forceinline__ uint32_t load16(const bool* p, int64_t s0, int cnt, bool vec) {
  uint32_t bits = 0;
  if (vec && cnt == kSlots) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + s0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < kSlots / 4; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) bits |= static_cast<uint32_t>(((w[q] >> (8 * j)) & 0xFFu) != 0) << (4 * q + j);
    }
  } else {
    for (int j = 0; j < cnt; ++j) bits |= static_cast<uint32_t>(p[s0 + j]) << j;
  }
  return bits;
}

// 4 bits as 4 bytes of 0/1
__device__ __forceinline__ uint32_t spread4(uint32_t nib) { return (nib * 0x00204081u) & 0x01010101u; }

__device__ __forceinline__ void store16(bool* p, int64_t s0, int cnt, bool vec, uint32_t bits) {
  if (vec && cnt == kSlots) {
    *reinterpret_cast<uint4*>(p + s0) = make_uint4(spread4(bits & 0xFu), spread4((bits >> 4) & 0xFu),
                                                   spread4((bits >> 8) & 0xFu), spread4((bits >> 12) & 0xFu));
  } else {
    for (int j = 0; j < cnt; ++j) p[s0 + j] = (bits >> j) & 1u;
  }
}

__device__ void born_phase(const Args& a, long long* c_min) {
  const int lane_id = threadIdx.x & 31;
  const int64_t rc = *a.row_clock;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int32_t dump = static_cast<int32_t>(a.slot_count - 1);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31); base < a.lanes;
       base += stride) {
    const int64_t i = base + lane_id;
    const bool act = i < a.lanes && a.active[i];
    const int32_t slot = act ? a.slots[i] : -1;
    const unsigned on = __ballot_sync(kFull, act);
    if (on == 0) continue;
    const unsigned peers = __match_any_sync(kFull, slot) & on;
    // the lowest lane of a group has the smallest order unless this
    // warp's orders wrap past INT64_MAX
    const bool ordered = ksql::wadd(rc, base + 31) >= ksql::wadd(rc, base);
    if (!act || (ordered && lane_id != __ffs(peers) - 1)) continue;
    const long long order = ksql::wadd(rc, i);
    if (slot == dump) {
      atomicMin(c_min, order);
    } else if (__popc(peers) == 1 || order < __ldcg(reinterpret_cast<const long long*>(a.born + slot))) {
      // a lone lane's atomic waits on nothing; a group's slot is likely hot
      atomicMin(reinterpret_cast<long long*>(a.born + slot), order);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && *c_min < __ldcg(reinterpret_cast<const long long*>(a.born + dump))) {
    atomicMin(reinterpret_cast<long long*>(a.born + dump), *c_min);
  }
  // the sample for the close phase: each chunk's last entry
  const Chunks ch(a.n);
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < ch.chunks; j += stride) {
    const int64_t end = (j + 1) * ch.chunk;
    a.sample[j] = a.cm[(end < a.n ? end : a.n) - 1];
  }
}

// The first position of cm with cm[pos] >= close and its value (pos == n:
// none): the chunk from the block's sample, then rounds of kFan loads at
// once that each narrow the range kFan-fold.
__device__ __forceinline__ int64_t first_at_or_past(const Args& a, const long long* sample,
                                                    const Chunks& ch, int64_t close, int64_t* at) {
  int lo = 0, hi = ch.chunks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sample[mid] < close) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo == ch.chunks) return a.n;
  // the answer lies in [l, end]; cm[end] = sample[lo] >= close
  int64_t l = lo * ch.chunk, end = (l + ch.chunk < a.n ? l + ch.chunk : a.n) - 1;
  int64_t v_end = sample[lo];
  while (l < end) {
    const int64_t len = end - l + 1, sub = (len + kFan - 1) / kFan;
    int64_t v[kFan];
#pragma unroll
    for (int q = 0; q < kFan; ++q) {
      const int64_t e = l + (q + 1) * sub - 1;
      v[q] = e < end ? __ldg(a.cm + e) : v_end;
    }
    // the first piece whose last entry reaches close (no indexing by a
    // runtime value: v stays in registers)
    int q = kFan - 1;
    int64_t vq = v[kFan - 1];
#pragma unroll
    for (int r = kFan - 2; r >= 0; --r) {
      if (v[r] >= close) {
        q = r;
        vq = v[r];
      }
    }
    const int64_t e = l + (q + 1) * sub - 1;
    l += q * sub;
    if (e < end) {
      end = e;
      v_end = vq;
    }
  }
  *at = v_end;
  return l;
}

__device__ void close_phase(const Args& a, long long* sample, uint16_t* list, uint8_t* res) {
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Chunks ch(a.n);
  for (int j = threadIdx.x; j < ch.chunks; j += kThreads) sample[j] = __ldcg(a.sample + j);
  __syncthreads();
  const int64_t final_t = sample[ch.chunks - 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (final_t > *a.emit_clock) *a.emit_clock = final_t;
    *a.row_clock = ksql::wadd(*a.row_clock, a.lanes);
  }
  uint16_t* my_list = list + warp * kUnit;
  uint8_t* my_res = res + warp * kUnit;
  const int64_t units = (a.slot_count + kUnit - 1) / kUnit;
  for (int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarps + warp; unit < units;
       unit += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t s0 = unit * kUnit + lane_id * kSlots;
    const int64_t left = a.slot_count - s0;
    const int cnt = left <= 0 ? 0 : (left < kSlots ? static_cast<int>(left) : kSlots);
    const uint32_t occm = load16(a.occ, s0, cnt, a.vec);
    const uint32_t dirtym = load16(a.dirty, s0, cnt, a.vec);
    const uint32_t emittedm = load16(a.emitted, s0, cnt, a.vec);
    const uint32_t cand = occm & dirtym & ~emittedm;
    // the warp's candidate list: a prefix sum of the lanes' counts
    const int mine = __popc(cand);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane_id >= d) incl += v;
    }
    const int off = incl - mine;
    const int total = __shfl_sync(kFull, incl, 31);
    for (uint32_t rest = cand, j = 0; rest != 0; rest &= rest - 1, ++j) {
      my_list[off + j] = static_cast<uint16_t>(lane_id * kSlots + __ffs(rest) - 1);
    }
    __syncwarp();
    // each lane's next candidate's wstart is read while it searches for this one
    int64_t ws_next = lane_id < total ? a.wstart[unit * kUnit + my_list[lane_id]] : 0;
    for (int r = lane_id; r < ((total + 31) & ~31); r += 32) {
      const bool has = r < total;
      const int64_t s = unit * kUnit + (has ? my_list[r] : 0);
      const int64_t ws = ws_next;
      if (r + 32 < total) ws_next = a.wstart[unit * kUnit + my_list[r + 32]];
      const int64_t close = ksql::wadd(ksql::wadd(ws, a.size_ms), a.grace_ms);
      const int64_t horizon = ksql::wadd(ws, a.retention);
      int64_t at = 0;
      const int64_t pos = has ? first_at_or_past(a, sample, ch, close, &at) : a.n;
      if (!has) continue;
      const bool reachable = pos < a.n && at <= horizon;
      const bool evict = !reachable && close <= final_t;
      if (evict) {
        a.grave[s] = true;
        a.born[s] = INT64_MAX;
        for (int64_t j = 0; j < a.c.count; ++j) ksql::store_init(a.c.col[j], s, a.c.dtype[j], a.c.init_bits[j]);
      }
      my_res[r] = reachable ? 1 : (evict ? 2 : 0);
    }
    __syncwarp();
    uint32_t emit = 0, evict = 0;
    int j = off;
#pragma unroll
    for (int b = 0; b < kSlots; ++b) {
      if ((cand >> b) & 1u) {
        const uint8_t code = my_res[j++];
        emit |= static_cast<uint32_t>(code == 1) << b;
        evict |= static_cast<uint32_t>(code == 2) << b;
      }
    }
    store16(a.emit_out, s0, cnt, a.vec, emit);
    if (emit | evict) {
      store16(a.occ, s0, cnt, a.vec, occm & ~evict);
      store16(a.dirty, s0, cnt, a.vec, dirtym & ~(emit | evict));
      store16(a.emitted, s0, cnt, a.vec, emittedm | emit);
    }
    __syncwarp();  // the list is read before the next unit writes it
  }
}

__global__ void __launch_bounds__(kThreads) close_slots_kernel(const __grid_constant__ Args a) {
  __shared__ long long sample[kSample];
  __shared__ uint16_t list[kWarps * kUnit];
  __shared__ uint8_t res[kWarps * kUnit];
  __shared__ long long c_min;
  if (threadIdx.x == 0) c_min = INT64_MAX;
  __syncthreads();
  born_phase(a, &c_min);
  cg::this_grid().sync();
  close_phase(a, sample, list, res);
}

// the cooperative grid's most blocks, per device (close_slots_kernel's
// occupancy times the SMs), asked once
int g_most[64];

}  // namespace

extern "C" int ksql_suppress_close(const int64_t* comps, int64_t count, const void* slots,
                                   const void* active, int64_t lanes, void* occ, void* grave,
                                   void* dirty, void* emitted, void* born, const void* wstart,
                                   const void* cm_emit, int64_t n, int64_t size_ms,
                                   int64_t grace_ms, int64_t retention, void* emit_clock,
                                   void* row_clock, void* emit_out, int64_t capacity,
                                   void* sample, int64_t sample_words, void* stream) {
  if (count > KSQL_MAX_COMPS || n < 1 || capacity >= INT32_MAX || sample_words < kSample) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  for (int64_t j = 0; j < count; ++j) {
    a.c.col[j] = reinterpret_cast<void*>(comps[3 * j]);
    a.c.dtype[j] = comps[3 * j + 1];
    a.c.init_bits[j] = comps[3 * j + 2];
  }
  a.c.count = count;
  a.slots = static_cast<const int32_t*>(slots);
  a.active = static_cast<const bool*>(active);
  a.lanes = lanes;
  a.occ = static_cast<bool*>(occ);
  a.grave = static_cast<bool*>(grave);
  a.dirty = static_cast<bool*>(dirty);
  a.emitted = static_cast<bool*>(emitted);
  a.born = static_cast<int64_t*>(born);
  a.wstart = static_cast<const int64_t*>(wstart);
  a.cm = static_cast<const int64_t*>(cm_emit);
  a.n = n;
  a.size_ms = size_ms;
  a.grace_ms = grace_ms;
  a.retention = retention;
  a.emit_clock = static_cast<int64_t*>(emit_clock);
  a.row_clock = static_cast<int64_t*>(row_clock);
  a.emit_out = static_cast<bool*>(emit_out);
  a.sample = static_cast<int64_t*>(sample);
  a.slot_count = capacity + 1;
  a.vec = ((reinterpret_cast<uintptr_t>(occ) | reinterpret_cast<uintptr_t>(dirty) |
            reinterpret_cast<uintptr_t>(emitted) | reinterpret_cast<uintptr_t>(emit_out)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t units = (a.slot_count + kUnit - 1) / kUnit;
  const int64_t close_blocks = (units + kWarps - 1) / kWarps;
  const int64_t born_blocks = (lanes + kThreads - 1) / kThreads;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_most[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, close_slots_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_most[dev] = per_sm * sms;
  }
  const int64_t need = close_blocks > born_blocks ? close_blocks : born_blocks;
  const unsigned blocks = static_cast<unsigned>(need < 1 ? 1 : (need < g_most[dev] ? need : g_most[dev]));
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(close_slots_kernel), dim3(blocks),
                                    dim3(kThreads), params, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
