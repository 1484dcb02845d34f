// K6 combine_windows: per emission lane, the store's state at the lane's
// slot, combined over the lane's window when the store is sliced.
//
// Replaces runtime/lowering.py:_combine_windows (B9) and the gather of
// runtime/lowering.py:_finalized_env (B6's gather; the finalize arithmetic
// and post-aggregation expressions stay torch ops).
//
// One launch a call (combine_kernel), its blocks split in two parts.
// Lane blocks, a thread a lane:
//   plain stores (tumbling, unwindowed, expansion): the thread reads the
//     lane's slot once and gathers every column at it (the components, key
//     reprs, knull and wstart), the column's width uniform over the block.
//     A thread per (lane, column) measured slower on the card at the
//     flagship's shape (PERF.md): it reads the slots once a column;
//   sliced stores: a thread per (lane, column), a column's blocks side by
//     side: key reprs and knull gathered; a component reduced over the
//     lane's window of `spw` slices starting at slice w = w_lane[l], the
//     ring cells (slot, (w + t) % ring), t ascending, from the reduction's
//     identity (0 for add, the component's init for min/max), a cell whose
//     slice_id is not w + t reading as the init, which is how empty cells
//     and cells of an earlier ring wrap drop out (float64 min/max keep
//     XLA's NaN and signed-zero order, common.cuh; int adds wrap); wstart
//     is w * width.
// Wide blocks (the vector aggregates' width-K columns, ops/vector.py): a
// block takes a tile of kTile lanes, finds the tile's emitting lanes
// (`mask`: K3's winners; every lane without a mask) with one warp ballot,
// and its warps take the (emitting lane, column) pairs, one a warp: each
// copies the row in the widest word that divides the row's bytes and the
// column's address (16 bytes for most rows), four words in flight a
// thread.  No thread waits on a lane that emits nothing; the other lanes'
// rows are left unwritten.
// The outputs are typed views of one fresh buffer (ops/slicing.py packs
// them at 16-byte-aligned offsets), never views of the store; the column
// descriptors come from a host block the wrapper builds once per store.
//
// Bound: memory.  Per lane a gather reads the slot and one value per
// column and writes it; a sliced lane reads spw * (8 + cell) bytes a
// component; a wide lane reads and writes its rows.  The gathers are
// scattered over the slots (a sector a value), which is what the bound's
// byte count does not see.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxCols = 64;   // components + keys + knull + wstart
constexpr int kThreads = 256;  // a block of combine_kernel
constexpr int kTile = 8;       // lanes a wide block takes
constexpr int64_t kOutAlign = 16;  // an output's first byte in the buffer

enum Kind : int64_t { kGather4 = 0, kGather8 = 1, kWindowStart = 2, kReduce = 3 };

struct Cols {
  const void* src[kMaxCols];
  void* out[kMaxCols];
  int64_t kind[kMaxCols];  // Kind, kReduce + combine * 3 + dtype for a reduce
  int64_t init_bits[kMaxCols];
};

struct Wide {
  const char* src[KSQL_MAX_COMPS];
  char* out[KSQL_MAX_COMPS];
  int64_t row_bytes[KSQL_MAX_COMPS];
  int64_t word[KSQL_MAX_COMPS];  // bytes a copied word: 16, 8, 4, 2 or 1
  int64_t count;
};

template <typename T>
__device__ __forceinline__ void gather(const T* __restrict__ src, T* __restrict__ out,
                                       int64_t l, int64_t slot) {
  out[l] = src[slot];
}

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

__device__ __forceinline__ double reduce_f64(const double* col, double init, int64_t combine,
                                             const int64_t* slice_id, int64_t row,
                                             int64_t ring, int64_t w, int64_t spw) {
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

// a plain store's lane (every column a gather): its slot read once, then
// each column's value, the kind uniform over the block
__device__ __forceinline__ void gather_lane(const Cols& c, int ncols, int64_t l,
                                            const int32_t* __restrict__ slot_lane, int64_t nn) {
  if (l >= nn) return;
  const int64_t slot = slot_lane[l];
  for (int j = 0; j < ncols; ++j) {
    if (c.kind[j] == kGather4) {
      static_cast<int32_t*>(c.out[j])[l] = static_cast<const int32_t*>(c.src[j])[slot];
    } else {
      static_cast<int64_t*>(c.out[j])[l] = static_cast<const int64_t*>(c.src[j])[slot];
    }
  }
}

// a sliced store's column for one lane: key reprs and knull gathered, the
// components reduced over the lane's window, wstart from it
__device__ __forceinline__ void sliced_lane(
    const Cols& c, int j, int64_t l, const int64_t* __restrict__ slice_id,
    const int32_t* __restrict__ slot_lane, const int64_t* __restrict__ w_lane, int64_t nn,
    int64_t ring, int64_t spw, int64_t width) {
  if (l >= nn) return;
  const int64_t kind = c.kind[j];
  if (kind == kWindowStart) {
    static_cast<int64_t*>(c.out[j])[l] = ksql::wmul(w_lane[l], width);
    return;
  }
  if (kind == kGather4) {
    static_cast<int32_t*>(c.out[j])[l] = static_cast<const int32_t*>(c.src[j])[slot_lane[l]];
    return;
  }
  if (kind == kGather8) {
    static_cast<int64_t*>(c.out[j])[l] = static_cast<const int64_t*>(c.src[j])[slot_lane[l]];
    return;
  }
  const int64_t slot = slot_lane[l];
  const int64_t combine = (kind - kReduce) / 3, dtype = (kind - kReduce) % 3;
  const int64_t w = w_lane[l];
  const int64_t row = slot * ring;
  if (dtype == ksql::kInt32) {
    static_cast<int32_t*>(c.out[j])[l] = reduce_int<int32_t>(
        static_cast<const int32_t*>(c.src[j]), static_cast<int32_t>(c.init_bits[j]), combine,
        slice_id, row, ring, w, spw);
  } else if (dtype == ksql::kInt64) {
    static_cast<int64_t*>(c.out[j])[l] = reduce_int<int64_t>(
        static_cast<const int64_t*>(c.src[j]), c.init_bits[j], combine, slice_id, row, ring, w,
        spw);
  } else {
    static_cast<double*>(c.out[j])[l] = reduce_f64(
        static_cast<const double*>(c.src[j]),
        __longlong_as_double(static_cast<long long>(c.init_bits[j])), combine, slice_id, row,
        ring, w, spw);
  }
}

// `words` words of W from src to dst by one warp, four in flight a lane
template <typename W>
__device__ __forceinline__ void warp_copy(const char* src, char* dst, int64_t words, int lane) {
  const W* __restrict__ s = reinterpret_cast<const W*>(src);
  W* __restrict__ d = reinterpret_cast<W*>(dst);
  int64_t v = lane;
  for (; v + 96 < words; v += 128) {
    const W a0 = s[v], a1 = s[v + 32], a2 = s[v + 64], a3 = s[v + 96];
    d[v] = a0;
    d[v + 32] = a1;
    d[v + 64] = a2;
    d[v + 96] = a3;
  }
  for (; v < words; v += 32) d[v] = s[v];
}

__device__ __forceinline__ void wide_block(const Wide& w, int64_t tile,
                                           const int32_t* __restrict__ slot_lane,
                                           const bool* __restrict__ mask, int64_t nn,
                                           int32_t* s_lane, int& s_count) {
  const int64_t first = tile * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    const int64_t l = first + lane;
    const bool emit = lane < kTile && l < nn && (mask == nullptr || mask[l]);
    const unsigned m = __ballot_sync(0xffffffffu, emit);
    if (emit) s_lane[__popc(m & ((1u << lane) - 1u))] = static_cast<int32_t>(l);
    if (lane == 0) s_count = __popc(m);
  }
  __syncthreads();
  // a warp per (emitting lane, column) pair of the tile
  const int pairs = s_count * static_cast<int>(w.count);
  for (int p = warp; p < pairs; p += kThreads / 32) {
    const int e = p / static_cast<int>(w.count), j = p % static_cast<int>(w.count);
    const int64_t l = s_lane[e];
    const int64_t slot = slot_lane[l];
    const int64_t rb = w.row_bytes[j];
    const char* src = w.src[j] + slot * rb;
    char* dst = w.out[j] + l * rb;
    switch (w.word[j]) {
      case 16:
        warp_copy<uint4>(src, dst, rb / 16, lane);
        break;
      case 8:
        warp_copy<uint2>(src, dst, rb / 8, lane);
        break;
      case 4:
        warp_copy<uint32_t>(src, dst, rb / 4, lane);
        break;
      case 2:
        warp_copy<uint16_t>(src, dst, rb / 2, lane);
        break;
      default:
        warp_copy<uint8_t>(src, dst, rb, lane);
    }
  }
}

// One launch a call: the first lane blocks (bx of them for a plain store,
// ncols * bx for a sliced one, a column's side by side) take kThreads lanes
// each, the rest a wide tile each.
template <bool kSliced>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    Cols c, Wide w, int64_t ncols, int64_t bx, const int64_t* __restrict__ slice_id,
    const int32_t* __restrict__ slot_lane, const int64_t* __restrict__ w_lane,
    const bool* __restrict__ mask, int64_t nn, int64_t ring, int64_t spw, int64_t width) {
  __shared__ int32_t s_lane[kTile];
  __shared__ int s_count;
  const int64_t b = blockIdx.x;
  const int64_t lane_blocks = kSliced ? ncols * bx : (ncols > 0 ? bx : 0);
  if (b < lane_blocks) {
    if (kSliced) {
      sliced_lane(c, static_cast<int>(b / bx), (b % bx) * kThreads + threadIdx.x, slice_id,
                  slot_lane, w_lane, nn, ring, spw, width);
    } else {
      gather_lane(c, static_cast<int>(ncols), b * kThreads + threadIdx.x, slot_lane, nn);
    }
  } else {
    wide_block(w, b - lane_blocks, slot_lane, mask, nn, s_lane, s_count);
  }
}

}  // namespace

// desc: [ncols, nwide, slice_id, nout, then the bytes a lane of each
// output by out index, then (src, out index, kind, init bits) a column,
// then (src, out index, row bytes) a wide column]; the outputs lie in
// `base` in out index order, each at the first multiple of 16 bytes past
// the one before (ops/slicing.py:GatherPlan.offsets places its views so)
extern "C" int ksql_combine_windows(const int64_t* desc, void* base, const void* slot_lane,
                                    const void* w_lane, const void* mask, int64_t nn,
                                    int64_t ring, int64_t spw, int64_t width, void* stream) {
  const int64_t ncols = desc[0], nwide = desc[1], nout = desc[3];
  if (ncols > kMaxCols || nwide > KSQL_MAX_COMPS || ncols < 0 || nwide < 0 ||
      nout != ncols + nwide || nn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* b = static_cast<char*>(base);
  int64_t offsets[kMaxCols + KSQL_MAX_COMPS];
  int64_t at = 0;
  for (int64_t k = 0; k < nout; ++k) {
    offsets[k] = at;
    at += (nn * desc[4 + k] + kOutAlign - 1) / kOutAlign * kOutAlign;
  }
  const int64_t* p = desc + 4 + nout;
  Cols c{};
  for (int64_t j = 0; j < ncols; ++j, p += 4) {
    c.src[j] = reinterpret_cast<const void*>(p[0]);
    c.out[j] = b + offsets[p[1]];
    c.kind[j] = p[2];
    c.init_bits[j] = p[3];
  }
  Wide w{};
  for (int64_t j = 0; j < nwide; ++j, p += 3) {
    w.src[j] = reinterpret_cast<const char*>(p[0]);
    w.out[j] = b + offsets[p[1]];
    w.row_bytes[j] = p[2];
    // the widest word that divides the row and the column's address (the
    // output rows start 16-byte aligned), so no row needs a head or tail
    int64_t word = 16;
    while (word > 1 && ((p[2] % word) != 0 || (p[0] % word) != 0)) word >>= 1;
    w.word[j] = word;
  }
  w.count = nwide;
  const auto* sid = reinterpret_cast<const int64_t*>(desc[2]);
  const auto* sl = static_cast<const int32_t*>(slot_lane);
  const auto* wl = static_cast<const int64_t*>(w_lane);
  const auto* mk = static_cast<const bool*>(mask);
  const int64_t bx = (nn + kThreads - 1) / kThreads;
  const int64_t lane_blocks = ncols == 0 ? 0 : ring == 0 ? bx : ncols * bx;
  int64_t blocks = lane_blocks + (nwide > 0 ? (nn + kTile - 1) / kTile : 0);
  if (blocks < 1) blocks = 1;  // a launch with no lanes does nothing
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (ring == 0) {
    combine_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        c, w, ncols, bx, sid, sl, wl, mk, nn, ring, spw, width);
  } else {
    combine_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        c, w, ncols, bx, sid, sl, wl, mk, nn, ring, spw, width);
  }
  return static_cast<int>(cudaGetLastError());
}
