// K6 combine_windows: per emission lane, the store's state at the lane's
// slot, combined over the lane's window when the store is sliced.
//
// Replaces runtime/lowering.py:_combine_windows (B9) and the gather of
// runtime/lowering.py:_finalized_env (B6's gather; the finalize arithmetic
// and post-aggregation expressions stay torch ops).  One thread per lane:
//   ring > 0 (sliced): the lane is the window of `spw` slices starting at
//     slice w = w_lane[l]; each component reduces the ring cells
//     (slot, (w + t) % ring), t ascending, from the reduction's identity
//     (0 for add, the component's init for min/max), a cell whose slice_id
//     is not w + t reading as the init — which is how empty cells and
//     cells of an earlier ring wrap drop out.  float64 min/max keep XLA's
//     NaN and signed-zero order (common.cuh), int adds wrap.  wstart is
//     w * width.
//   ring == 0 (tumbling, unwindowed and expansion stores): the plain gather
//     of each component and of wstart at the slot (S = 1).
// Key reprs and the null-key bits are gathered at the slot in both modes.
// Every output is a fresh tensor, never a view of the store.
//
// Wide mode (the vector aggregates' width-K columns, ops/vector.py): each
// such column's row of `row_bytes` at the lane's slot is copied into the
// lane's row of its output, one warp a lane, 8-, 4-, 2- or 1-byte words as
// the row's size allows — only for lanes whose `mask` is set (K3's
// winners: the lanes that may emit; every lane without a mask).  The
// other lanes' rows are left unwritten: a 16,384-lane batch of COLLECT_LIST
// would otherwise move 16,384 x 9,000 bytes where ~2,300 lanes emit.
//
// Bound: memory.  Per lane it reads the slot (and w), spw * (8 + J*cell)
// bytes of ring cells and 12 + 8k bytes of keys, and writes J cells + 12 +
// 8k: at BASELINE #2 (65,536 lanes, S = 4, J = 8 at 7 bytes on average)
// about 19 MB (~5.7 us at 3.35 TB/s).  The cells of one lane's window are
// adjacent in a slot's ring row (wrapping once at most); lanes of one row
// share a slot, so the gathers are scattered across slots but reuse lines
// across hops.  Each thread re-reads slice_id per component from L1 rather
// than keeping S flags, so S is not bounded by registers.
#include <type_traits>

#include "common.cuh"

namespace {

struct Comps {
  const void* col[KSQL_MAX_COMPS];
  void* out[KSQL_MAX_COMPS];
  int64_t kind[KSQL_MAX_COMPS];  // combine * 3 + dtype
  int64_t init_bits[KSQL_MAX_COMPS];
  int64_t count;
};

struct Keys {
  const int64_t* col[KSQL_MAX_KEYS];
  int64_t* out[KSQL_MAX_KEYS];
  int64_t count;
};

template <typename T>
__device__ __forceinline__ T combine_int(int64_t combine, T acc, T v) {
  using U = typename std::make_unsigned<T>::type;
  if (combine == ksql::kAdd) return static_cast<T>(static_cast<U>(acc) + static_cast<U>(v));
  if (combine == ksql::kMin) return v < acc ? v : acc;
  return v > acc ? v : acc;
}

template <typename T>
__device__ __forceinline__ T reduce_int(const T* col, T init, int64_t combine,
                                        const int64_t* slice_id, int64_t row,
                                        int64_t ring, int64_t w, int64_t spw) {
  T acc = combine == ksql::kAdd ? T(0) : init;
  for (int64_t t = 0; t < spw; ++t) {
    const int64_t sid = ksql::wadd(w, t);
    const int64_t cell = row + ksql::floor_mod(sid, ring);
    acc = combine_int<T>(combine, acc, slice_id[cell] == sid ? col[cell] : init);
  }
  return acc;
}

__device__ __forceinline__ double reduce_f64(const double* col, double init,
                                             int64_t combine,
                                             const int64_t* slice_id,
                                             int64_t row, int64_t ring,
                                             int64_t w, int64_t spw) {
  double acc = combine == ksql::kAdd ? 0.0 : init;
  for (int64_t t = 0; t < spw; ++t) {
    const int64_t sid = ksql::wadd(w, t);
    const int64_t cell = row + ksql::floor_mod(sid, ring);
    const double v = slice_id[cell] == sid ? col[cell] : init;
    if (combine == ksql::kAdd) {
      acc = acc + v;
    } else if (combine == ksql::kMin) {
      acc = ksql::xla_min(acc, v);
    } else {
      acc = ksql::xla_max(acc, v);
    }
  }
  return acc;
}

__global__ void combine_kernel(Comps c, Keys keys,
                               const int32_t* __restrict__ knull_in,
                               int32_t* __restrict__ knull_out,
                               const int64_t* __restrict__ wstart_in,
                               int64_t* __restrict__ wstart_out,
                               const int64_t* __restrict__ slice_id,
                               const int32_t* __restrict__ slot_lane,
                               const int64_t* __restrict__ w_lane, int64_t nn,
                               int64_t ring, int64_t spw, int64_t width) {
  int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= nn) return;
  const int64_t slot = slot_lane[l];
  if (ring == 0) {
    for (int64_t j = 0; j < c.count; ++j) {
      if (c.kind[j] % 3 == ksql::kInt32) {
        static_cast<int32_t*>(c.out[j])[l] = static_cast<const int32_t*>(c.col[j])[slot];
      } else {
        static_cast<int64_t*>(c.out[j])[l] = static_cast<const int64_t*>(c.col[j])[slot];
      }
    }
    wstart_out[l] = wstart_in[slot];
  } else {
    const int64_t w = w_lane[l];
    const int64_t row = slot * ring;
    for (int64_t j = 0; j < c.count; ++j) {
      const int64_t combine = c.kind[j] / 3, dtype = c.kind[j] % 3;
      if (dtype == ksql::kInt32) {
        static_cast<int32_t*>(c.out[j])[l] = reduce_int<int32_t>(
            static_cast<const int32_t*>(c.col[j]), static_cast<int32_t>(c.init_bits[j]),
            combine, slice_id, row, ring, w, spw);
      } else if (dtype == ksql::kInt64) {
        static_cast<int64_t*>(c.out[j])[l] = reduce_int<int64_t>(
            static_cast<const int64_t*>(c.col[j]), c.init_bits[j], combine,
            slice_id, row, ring, w, spw);
      } else {
        static_cast<double*>(c.out[j])[l] = reduce_f64(
            static_cast<const double*>(c.col[j]),
            __longlong_as_double(static_cast<long long>(c.init_bits[j])), combine,
            slice_id, row, ring, w, spw);
      }
    }
    wstart_out[l] = ksql::wmul(w, width);
  }
  knull_out[l] = knull_in[slot];
  for (int64_t i = 0; i < keys.count; ++i) keys.out[i][l] = keys.col[i][slot];
}

struct Wide {
  const char* col[KSQL_MAX_COMPS];
  char* out[KSQL_MAX_COMPS];
  int64_t row_bytes[KSQL_MAX_COMPS];
  int64_t count;
};

template <typename W>
__device__ __forceinline__ void copy_row(const char* src, char* dst, int64_t words, int lane) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  for (int64_t t = lane; t < words; t += 32) d[t] = s[t];
}

__global__ void wide_gather_kernel(Wide w, const int32_t* __restrict__ slot_lane,
                                   const bool* __restrict__ mask, int64_t nn) {
  const int64_t l = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (l >= nn || (mask != nullptr && !mask[l])) return;
  const int64_t slot = slot_lane[l];
  for (int64_t j = 0; j < w.count; ++j) {
    const int64_t rb = w.row_bytes[j];
    const char* src = w.col[j] + slot * rb;
    char* dst = w.out[j] + l * rb;
    if (rb % 8 == 0) {
      copy_row<int64_t>(src, dst, rb / 8, lane);
    } else if (rb % 4 == 0) {
      copy_row<int32_t>(src, dst, rb / 4, lane);
    } else if (rb % 2 == 0) {
      copy_row<int16_t>(src, dst, rb / 2, lane);
    } else {
      copy_row<int8_t>(src, dst, rb, lane);
    }
  }
}

}  // namespace

extern "C" int ksql_combine_windows(
    const int64_t* comps, int64_t count, const int64_t* keys_in,
    const int64_t* keys_out, int64_t nkeys, const void* knull_in,
    void* knull_out, const void* wstart_in, void* wstart_out,
    const void* slice_id, const void* slot_lane, const void* w_lane,
    int64_t nn, int64_t ring, int64_t spw, int64_t width, const int64_t* wide,
    int64_t nwide, const void* mask, void* stream) {
  if (count > KSQL_MAX_COMPS || nkeys > KSQL_MAX_KEYS || nwide > KSQL_MAX_COMPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Comps c{};
  for (int64_t j = 0; j < count; ++j) {
    c.col[j] = reinterpret_cast<const void*>(comps[4 * j]);
    c.out[j] = reinterpret_cast<void*>(comps[4 * j + 1]);
    c.kind[j] = comps[4 * j + 2];
    c.init_bits[j] = comps[4 * j + 3];
  }
  c.count = count;
  Keys k{};
  for (int64_t i = 0; i < nkeys; ++i) {
    k.col[i] = reinterpret_cast<const int64_t*>(keys_in[i]);
    k.out[i] = reinterpret_cast<int64_t*>(keys_out[i]);
  }
  k.count = nkeys;
  const int threads = 256;
  combine_kernel<<<ksql::blocks_for(nn, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      c, k, static_cast<const int32_t*>(knull_in),
      static_cast<int32_t*>(knull_out), static_cast<const int64_t*>(wstart_in),
      static_cast<int64_t*>(wstart_out), static_cast<const int64_t*>(slice_id),
      static_cast<const int32_t*>(slot_lane), static_cast<const int64_t*>(w_lane),
      nn, ring, spw, width);
  if (nwide > 0) {
    Wide w{};
    for (int64_t j = 0; j < nwide; ++j) {
      w.col[j] = reinterpret_cast<const char*>(wide[3 * j]);
      w.out[j] = reinterpret_cast<char*>(wide[3 * j + 1]);
      w.row_bytes[j] = wide[3 * j + 2];
    }
    w.count = nwide;
    const int64_t lanes_per_block = threads / 32;
    const int64_t blocks = (nn + lanes_per_block - 1) / lanes_per_block;
    wide_gather_kernel<<<static_cast<int>(blocks < 1 ? 1 : blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        w, static_cast<const int32_t*>(slot_lane), static_cast<const bool*>(mask), nn);
  }
  return static_cast<int>(cudaGetLastError());
}
