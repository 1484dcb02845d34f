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

// store component dtype codes (ops/hash_store.py:_DTYPE_CODES)
enum Dtype : int64_t { kInt32 = 0, kInt64 = 1, kFloat64 = 2 };
// combine codes (ops/hash_store.py:_COMBINE_CODES)
enum Combine : int64_t { kAdd = 0, kMin = 1, kMax = 2 };

inline int blocks_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1 ? 1 : b);
}

}  // namespace ksql
