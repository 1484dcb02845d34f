// K12 ss_expire: close, pad and evict the entries of both ring buffers of a
// stream-stream join, and write the expiry's emission lanes.
//
// Replaces runtime/lowering.py:_trace_ss_expire (B15).  One thread per
// entry of both rings (lane e < B+1: left entry e; lane B+1+x: right entry
// x), at stream time t = max_ts:
//   closed = live & (ts + win + grace < t), win = after (left) or before
//   (right); in deferred (GRACE) mode a closed entry of a padding side that
//   never matched emits a null-padded row (emit) and is marked matched,
//   and live keeps the entries within their own side's retention (ts +
//   retention >= smax of the side); in eager mode emit is false and live
//   becomes live & ~closed.  Both updates are in place.
// Lanes: mask = emit, ts, ord_b = side rank (0, or 1 << 40 for the right)
// + seq; per buffered column of the lane's own side its value and valid &
// emit, zeros and false for the other side's columns; per key column the
// entry's key decoded from krepr (8-byte types by their bits, int32 by its
// low 32 bits, bool as nonzero) with valid = kval & emit.  int64 sums wrap,
// as XLA's do.
//
// Bound: bytes.  Each entry reads about 27 bytes plus its columns and
// writes 18 bytes plus two lanes a column; at BASELINE #4's shapes (2 x
// 16,385 entries, one column a side, one key) about 3 MB in and out, 0.001
// ms at 3.35 TB/s.  A fused elementwise pass with coalesced accesses: it
// runs at the memory rate, and at this size launch latency is its limit.
#include "common.cuh"

namespace {

struct Side {
  const int64_t* ts;
  const int64_t* krepr;
  const bool* kval;
  bool* live;
  bool* matched;
  const int64_t* seq;
  const int64_t* smax;
  int64_t win;
  int pad;  // deferred mode and a padding side: closed entries emit
};

struct Keys {
  void* dst[KSQL_MAX_KEYS];
  int64_t size[KSQL_MAX_KEYS];
  int64_t count;
};

__device__ __forceinline__ void side_lanes(const ksql::Gather& g, bool own, int64_t e,
                                           int64_t x, bool emit) {
  for (int64_t c = 0; c < g.count; ++c) {
    if (own) {
      ksql::copy_elem(g.vdst[c], e, g.vsrc[c], x, g.size[c]);
      g.mdst[c][e] = emit && g.msrc[c][x];
    } else {
      ksql::zero_elem(g.vdst[c], e, g.size[c]);
      g.mdst[c][e] = false;
    }
  }
}

__global__ void expire_kernel(Side l, Side r, int64_t b1, const int64_t* __restrict__ max_ts,
                              int deferred, int64_t grace, int64_t retention, ksql::Gather lc,
                              ksql::Gather rc, Keys keys, bool* __restrict__ mask,
                              int64_t* __restrict__ out_ts, int64_t* __restrict__ ord_b,
                              bool* __restrict__ key_valid) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 2 * b1) return;
  const bool right = e >= b1;
  const int64_t x = right ? e - b1 : e;
  const Side& s = right ? r : l;
  const bool live = s.live[x];
  const int64_t ts = s.ts[x];
  const bool closed = live && ksql::wadd(ksql::wadd(ts, s.win), grace) < *max_ts;
  const bool emit = s.pad && closed && !s.matched[x];
  if (deferred) {
    if (emit) s.matched[x] = true;
    s.live[x] = live && ksql::wadd(ts, retention) >= *s.smax;
  } else {
    s.live[x] = live && !closed;
  }
  mask[e] = emit;
  out_ts[e] = ts;
  ord_b[e] = ksql::wadd(right ? (int64_t{1} << 40) : 0, s.seq[x]);
  side_lanes(lc, !right, e, x, emit);
  side_lanes(rc, right, e, x, emit);
  const int64_t k = s.krepr[x];
  for (int64_t c = 0; c < keys.count; ++c) {
    if (keys.size[c] == 8) {
      static_cast<int64_t*>(keys.dst[c])[e] = k;
    } else if (keys.size[c] == 4) {
      static_cast<int32_t*>(keys.dst[c])[e] = static_cast<int32_t>(static_cast<uint32_t>(k));
    } else {
      static_cast<bool*>(keys.dst[c])[e] = k != 0;
    }
  }
  key_valid[e] = emit && s.kval[x];
}

}  // namespace

extern "C" int ksql_ss_expire(
    const void* l_ts, const void* l_krepr, const void* l_kval, void* l_live, void* l_matched,
    const void* l_seq, const void* l_smax, int64_t l_win, int64_t l_pad, const void* r_ts,
    const void* r_krepr, const void* r_kval, void* r_live, void* r_matched, const void* r_seq,
    const void* r_smax, int64_t r_win, int64_t r_pad, int64_t b1, const void* max_ts,
    int64_t deferred, int64_t grace, int64_t retention, const int64_t* l_desc, int64_t l_count,
    const int64_t* r_desc, int64_t r_count, const int64_t* key_desc, int64_t key_count,
    void* mask, void* out_ts, void* ord_b, void* key_valid, void* stream) {
  ksql::Gather lc, rc;
  if (!ksql::gather_from_desc(l_desc, l_count, &lc) ||
      !ksql::gather_from_desc(r_desc, r_count, &rc) || key_count > KSQL_MAX_KEYS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Keys keys{};
  for (int64_t c = 0; c < key_count; ++c) {
    keys.dst[c] = reinterpret_cast<void*>(key_desc[2 * c]);
    keys.size[c] = key_desc[2 * c + 1];
  }
  keys.count = key_count;
  const Side l{static_cast<const int64_t*>(l_ts), static_cast<const int64_t*>(l_krepr),
               static_cast<const bool*>(l_kval), static_cast<bool*>(l_live),
               static_cast<bool*>(l_matched), static_cast<const int64_t*>(l_seq),
               static_cast<const int64_t*>(l_smax), l_win, static_cast<int>(l_pad)};
  const Side r{static_cast<const int64_t*>(r_ts), static_cast<const int64_t*>(r_krepr),
               static_cast<const bool*>(r_kval), static_cast<bool*>(r_live),
               static_cast<bool*>(r_matched), static_cast<const int64_t*>(r_seq),
               static_cast<const int64_t*>(r_smax), r_win, static_cast<int>(r_pad)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  expire_kernel<<<ksql::blocks_for(2 * b1, threads), threads, 0, st>>>(
      l, r, b1, static_cast<const int64_t*>(max_ts), static_cast<int>(deferred), grace,
      retention, lc, rc, keys, static_cast<bool*>(mask), static_cast<int64_t*>(out_ts),
      static_cast<int64_t*>(ord_b), static_cast<bool*>(key_valid));
  return static_cast<int>(cudaGetLastError());
}
