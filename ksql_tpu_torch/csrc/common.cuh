// Shared device helpers for the port's state-store kernels.
//
// Hash arithmetic is done in uint64_t: signed overflow is undefined in C++,
// while the reference (XLA int64) wraps.  Shifts on uint64_t are logical,
// which is what mix64 needs (torch's and C++'s >> on int64 are arithmetic).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KSQL_MAX_PROBES 32
#define KSQL_MAX_KEYS 16
#define KSQL_MAX_COMPS 32
#define KSQL_MAX_COLS 32

namespace ksql {

constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;
constexpr uint64_t kGold = 0x9E3779B97F4A7C15ull;

// splitmix64 finalizer (ops/hash_store.py:mix64 of the reference)
__device__ __forceinline__ uint64_t mix64(uint64_t h) {
  h ^= h >> 30;
  h *= kM1;
  h ^= h >> 27;
  h *= kM2;
  h ^= h >> 31;
  return h;
}

// The find-only walk of ops/hash_store.py:probe_find from `base`: at most
// KSQL_MAX_PROBES candidates (base + off) & mask; a LIVE slot (occ) whose
// khash and wstart match ends it found; a truly empty slot (neither occ
// nor grave) ends it absent; graves and other keys are walked past.
// Returns the slot, or -1 when the key is absent or still unresolved after
// the last round.
__device__ __forceinline__ int64_t find_slot(const bool* __restrict__ occ,
                                             const bool* __restrict__ grave,
                                             const int64_t* __restrict__ kh,
                                             const int64_t* __restrict__ ws,
                                             int64_t mask, int64_t base,
                                             int64_t khash, int64_t wstart) {
  for (int64_t off = 0; off < KSQL_MAX_PROBES; ++off) {
    const int64_t cand = (base + off) & mask;
    const bool live = occ[cand];
    if (live && kh[cand] == khash && ws[cand] == wstart) return cand;
    if (!live && !grave[cand]) return -1;  // truly empty: the key is absent
  }
  return -1;
}

// store component dtype codes (ops/hash_store.py:_DTYPE_CODES); int8 is a
// vector element type (null bits, BOOLEAN values), never folded by K3
enum Dtype : int64_t { kInt32 = 0, kInt64 = 1, kFloat64 = 2, kInt8 = 3 };
// combine codes (ops/hash_store.py:_COMBINE_CODES)
enum Combine : int64_t { kAdd = 0, kMin = 1, kMax = 2 };

// int64 arithmetic that wraps like XLA's (signed overflow is undefined in C++)
__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}

// jnp.remainder / floor division for a positive divisor (C++ truncates)
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return r < 0 ? r + b : r;
}
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// XLA's float min/max: NaN wins, -0.0 is below +0.0 (fmin/fmax differ)
__device__ __forceinline__ double xla_min(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return signbit(a) ? a : b;
  return a < b ? a : b;
}
__device__ __forceinline__ double xla_max(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return signbit(a) ? b : a;
  return a > b ? a : b;
}

// float64 min/max fold into device memory: a CAS loop keeping XLA's order
__device__ __forceinline__ void atomic_fold_f64(double* p, double v, bool is_min) {
  auto* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    const double cur = __longlong_as_double(static_cast<long long>(assumed));
    const double nv = is_min ? xla_min(cur, v) : xla_max(cur, v);
    const unsigned long long bits =
        static_cast<unsigned long long>(__double_as_longlong(nv));
    if (bits == assumed) return;
    old = atomicCAS(a, assumed, bits);
  } while (old != assumed);
}

// Fold row `row` of a contribution column into cell `cell` of a store
// column, atomically; `kind` is combine * 3 + dtype.  int64 add wraps as
// two's complement (unsigned long long); int32/int64 min/max use the native
// atomics; float64 add is atomicAdd(double*), whose order is not fixed.
__device__ __forceinline__ void atomic_fold(void* col, int64_t cell,
                                            const void* contrib, int64_t row,
                                            int64_t kind) {
  const int64_t combine = kind / 3, dtype = kind % 3;
  if (dtype == kInt64) {
    const long long v = static_cast<const long long*>(contrib)[row];
    long long* p = static_cast<long long*>(col) + cell;
    if (combine == kAdd) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p),
                static_cast<unsigned long long>(v));
    } else if (combine == kMin) {
      atomicMin(p, v);
    } else {
      atomicMax(p, v);
    }
  } else if (dtype == kInt32) {
    const int v = static_cast<const int*>(contrib)[row];
    int* p = static_cast<int*>(col) + cell;
    if (combine == kAdd) {
      atomicAdd(p, v);
    } else if (combine == kMin) {
      atomicMin(p, v);
    } else {
      atomicMax(p, v);
    }
  } else {
    const double v = static_cast<const double*>(contrib)[row];
    double* p = static_cast<double*>(col) + cell;
    if (combine == kAdd) {
      atomicAdd(p, v);
    } else {
      atomic_fold_f64(p, v, combine == kMin);
    }
  }
}

// Write a component's init value (its bit pattern) into one cell.
__device__ __forceinline__ void store_init(void* col, int64_t cell,
                                           int64_t dtype, int64_t bits) {
  if (dtype == kInt32) {
    static_cast<int32_t*>(col)[cell] = static_cast<int32_t>(bits);
  } else if (dtype == kInt8) {
    static_cast<int8_t*>(col)[cell] = static_cast<int8_t>(bits);
  } else {
    static_cast<int64_t*>(col)[cell] = bits;  // int64 / float64 bits
  }
}

// Copy one element of `size` bytes (1, 4 or 8: bool, int32, int64/float64)
// from src[si] to dst[di].
__device__ __forceinline__ void copy_elem(void* dst, int64_t di, const void* src,
                                          int64_t si, int64_t size) {
  if (size == 8) {
    static_cast<int64_t*>(dst)[di] = static_cast<const int64_t*>(src)[si];
  } else if (size == 4) {
    static_cast<int32_t*>(dst)[di] = static_cast<const int32_t*>(src)[si];
  } else {
    static_cast<int8_t*>(dst)[di] = static_cast<const int8_t*>(src)[si];
  }
}

// Write a zero element of `size` bytes to dst[di].
__device__ __forceinline__ void zero_elem(void* dst, int64_t di, int64_t size) {
  if (size == 8) {
    static_cast<int64_t*>(dst)[di] = 0;
  } else if (size == 4) {
    static_cast<int32_t*>(dst)[di] = 0;
  } else {
    static_cast<int8_t*>(dst)[di] = 0;
  }
}

// Column gathers of one launch: per column a value source and destination
// (element bytes `size`) and a valid-bit source and destination.  Built on
// the host side from descriptors of 5 int64 per column: (value src, value
// dst, size, valid src, valid dst).
struct Gather {
  const void* vsrc[KSQL_MAX_COLS];
  void* vdst[KSQL_MAX_COLS];
  int64_t size[KSQL_MAX_COLS];
  const bool* msrc[KSQL_MAX_COLS];
  bool* mdst[KSQL_MAX_COLS];
  int64_t count;
};

inline bool gather_from_desc(const int64_t* desc, int64_t count, Gather* g) {
  if (count > KSQL_MAX_COLS) return false;
  *g = Gather{};
  for (int64_t j = 0; j < count; ++j) {
    g->vsrc[j] = reinterpret_cast<const void*>(desc[5 * j]);
    g->vdst[j] = reinterpret_cast<void*>(desc[5 * j + 1]);
    g->size[j] = desc[5 * j + 2];
    g->msrc[j] = reinterpret_cast<const bool*>(desc[5 * j + 3]);
    g->mdst[j] = reinterpret_cast<bool*>(desc[5 * j + 4]);
  }
  g->count = count;
  return true;
}

struct AddOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const { return wadd(a, b); }
};
struct MaxOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const { return a > b ? a : b; }
};

// Inclusive scan of one int64 per thread across the block (Hillis-Steele
// over `buf`, blockDim.x entries of shared memory).  Every thread must
// call it; on return buf[blockDim.x - 1] holds the block's total.
template <typename Op>
__device__ int64_t block_inclusive_scan(int64_t v, int64_t* buf, Op op) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int d = 1; d < static_cast<int>(blockDim.x); d <<= 1) {
    const int64_t w = t >= d ? buf[t - d] : 0;
    __syncthreads();
    if (t >= d) {
      v = op(w, v);
      buf[t] = v;
    }
    __syncthreads();
  }
  return v;
}

// The contiguous rows [lo, hi) of n that thread threadIdx.x of a one-block
// scan owns.
__device__ __forceinline__ void thread_chunk(int64_t n, int64_t* lo, int64_t* hi) {
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t a = static_cast<int64_t>(threadIdx.x) * per;
  *lo = a < n ? a : n;
  *hi = *lo + per < n ? *lo + per : n;
}

// ---- vector aggregate elements (ops/vector.py): values of 1, 4 or 8 bytes
// (int8, int32, int64 or float64) carried as int64 — ints sign-extended,
// doubles as their bits (`isfloat`).

__device__ __forceinline__ int64_t load_elem(const void* p, int64_t i, int64_t esize) {
  if (esize == 8) return static_cast<const int64_t*>(p)[i];
  if (esize == 4) return static_cast<const int32_t*>(p)[i];
  return static_cast<const int8_t*>(p)[i];
}

__device__ __forceinline__ void store_elem(void* p, int64_t i, int64_t esize, int64_t v) {
  if (esize == 8) {
    static_cast<int64_t*>(p)[i] = v;
  } else if (esize == 4) {
    static_cast<int32_t*>(p)[i] = static_cast<int32_t>(v);
  } else {
    static_cast<int8_t*>(p)[i] = static_cast<int8_t>(v);
  }
}

__device__ __forceinline__ double as_f64(int64_t bits) {
  return __longlong_as_double(static_cast<long long>(bits));
}

// The reference's `==` on two elements: IEEE for doubles (-0.0 == +0.0,
// NaN equals nothing), bitwise for ints.
__device__ __forceinline__ bool elem_eq(int64_t a, int64_t b, int64_t isfloat) {
  return isfloat ? as_f64(a) == as_f64(b) : a == b;
}

// An int64 key whose ascending order is XLA's sort order of the elements:
// the value for ints; for doubles the IEEE total order with -0.0 made +0.0
// and every NaN the largest key (lax.sort canonicalizes zeros and NaNs).
__device__ __forceinline__ int64_t sort_key(int64_t bits, int64_t isfloat) {
  if (!isfloat) return bits;
  const double v = as_f64(bits);
  if (v != v) return INT64_MAX;
  if (v == 0.0) return 0;
  return bits >= 0 ? bits : (bits ^ INT64_MAX);
}

// sort_key of the reference's `_desc_key` (~v for ints, -v for doubles).
__device__ __forceinline__ int64_t desc_key(int64_t bits, int64_t isfloat) {
  if (!isfloat) return ~bits;
  return sort_key(static_cast<int64_t>(static_cast<uint64_t>(bits) ^ (1ull << 63)), 1);
}

// ---- warp combines (K3's fold, K5): the rows of one warp that aim at one
// cell fold their values in shared memory and make one atomic a group.

// A lane's value as shared memory holds it: 8 bytes (an int32 in the low 4)
template <typename T>
__device__ __forceinline__ T lane_value(long long b);
template <>
__device__ __forceinline__ int lane_value<int>(long long b) { return static_cast<int>(b); }
template <>
__device__ __forceinline__ long long lane_value<long long>(long long b) { return b; }
template <>
__device__ __forceinline__ double lane_value<double>(long long b) { return __longlong_as_double(b); }

// A group's values (`vals`, the warp's 32 lanes' in shared memory) folded
// in lane order from the group's lowest lane's `acc` over the other lanes
// of `peers`.
template <typename T, typename Op>
__device__ __forceinline__ T fold_lanes(const long long* vals, unsigned peers, T acc, Op op) {
  for (unsigned rest = peers & (peers - 1); rest != 0; rest &= rest - 1) {
    acc = op(acc, lane_value<T>(vals[__ffs(rest) - 1]));
  }
  return acc;
}

struct AddI32 {
  __device__ int operator()(int a, int b) const {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
};
struct MinI32 {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct MaxI32 {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct WrapAdd {
  __device__ long long operator()(long long a, long long b) const { return wadd(a, b); }
};
struct MinI64 {
  __device__ long long operator()(long long a, long long b) const { return a < b ? a : b; }
};
struct MaxI64 {
  __device__ long long operator()(long long a, long long b) const { return a > b ? a : b; }
};
struct AddF64 {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct MinF64 {
  __device__ double operator()(double a, double b) const { return xla_min(a, b); }
};
struct MaxF64 {
  __device__ double operator()(double a, double b) const { return xla_max(a, b); }
};

// One component: the group's lowest lane (`lead`) folds the group's
// values (every lane's is in `vals`) in lane order and makes the one atomic
// into cell s (int64 adds wrap; float64 min/max keep XLA's order).  Every
// active lane of the warp (`live`) calls it.
__device__ __forceinline__ void fold_group(void* col, const void* contrib, int64_t kind, int64_t i,
                                          int64_t s, unsigned peers, unsigned live, bool lead,
                                          long long* vals, int lane) {
  const int64_t combine = kind / 3, dtype = kind % 3;
  if (dtype == kInt32) {
    const int v = static_cast<const int*>(contrib)[i];
    vals[lane] = v;
    __syncwarp(live);
    if (lead) {
      int* p = static_cast<int*>(col) + s;
      if (combine == kAdd) {
        atomicAdd(p, fold_lanes(vals, peers, v, AddI32()));
      } else if (combine == kMin) {
        atomicMin(p, fold_lanes(vals, peers, v, MinI32()));
      } else {
        atomicMax(p, fold_lanes(vals, peers, v, MaxI32()));
      }
    }
  } else if (dtype == kInt64) {
    const long long v = static_cast<const long long*>(contrib)[i];
    vals[lane] = v;
    __syncwarp(live);
    if (lead) {
      long long* p = static_cast<long long*>(col) + s;
      if (combine == kAdd) {
        atomicAdd(reinterpret_cast<unsigned long long*>(p),
                  static_cast<unsigned long long>(fold_lanes(vals, peers, v, WrapAdd())));
      } else if (combine == kMin) {
        atomicMin(p, fold_lanes(vals, peers, v, MinI64()));
      } else {
        atomicMax(p, fold_lanes(vals, peers, v, MaxI64()));
      }
    }
  } else {
    const double v = static_cast<const double*>(contrib)[i];
    vals[lane] = __double_as_longlong(v);
    __syncwarp(live);
    if (lead) {
      double* p = static_cast<double*>(col) + s;
      if (combine == kAdd) {
        atomicAdd(p, fold_lanes(vals, peers, v, AddF64()));
      } else if (combine == kMin) {
        atomic_fold_f64(p, fold_lanes(vals, peers, v, MinF64()), true);
      } else {
        atomic_fold_f64(p, fold_lanes(vals, peers, v, MaxF64()), false);
      }
    }
  }
  __syncwarp(live);  // the group's values are read before the next component's
}

inline int blocks_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1 ? 1 : b);
}

}  // namespace ksql
