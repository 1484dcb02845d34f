// K1 row_prologue: the fixed per-row part of the aggregate step.
//
// Replaces, on the TPU side, ops/hash_store.py:mix64/combine_hash (B1), the
// window/key/grace part of runtime/lowering.py:pre_exchange (B5) and the
// base-slot hash at the top of ops/hash_store.py:probe_insert.  One thread
// per row: window start (floor remainder, like jnp.remainder), the null-key
// bitmask, the group hash folded over the key reprs and the bitmask, the
// grace cut against the stream time at batch start (read from device memory,
// so the host never syncs), the probe's base slot and the watermark
// contribution c0.
//
// Bound: memory.  Per row it reads 9k+9 bytes and writes 33, about 3.3 MB
// for k = 1 at 65,536 rows (~1 us at 3.35 TB/s); its ~30 integer ops per
// key column are far below the card's rate.  The design is the plain
// coalesced one: consecutive threads touch consecutive rows, and the key
// matrix is [k, n] so each column read is coalesced too.
#include "common.cuh"

namespace {

__global__ void row_prologue_kernel(
    const int64_t* __restrict__ reprs, const bool* __restrict__ valid,
    int64_t k, int64_t n, const int64_t* __restrict__ ts,
    const bool* __restrict__ active_in, int64_t size_ms, int64_t grace_ms,
    const int64_t* __restrict__ max_ts, int64_t mask,
    int64_t* __restrict__ wstart, int32_t* __restrict__ knull,
    bool* __restrict__ active_out, int64_t* __restrict__ khash,
    int32_t* __restrict__ base, int64_t* __restrict__ c0) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t t = ts[i];
  int64_t ws = 0;
  if (size_ms > 0) {
    int64_t r = t % size_ms;  // C++ truncates toward zero ...
    if (r < 0) r += size_ms;  // ... jnp.remainder floors
    ws = t - r;
  }
  int32_t kn = 0;
  for (int64_t j = 0; j < k; ++j) {
    if (!valid[j * n + i]) kn |= static_cast<int32_t>(1u << j);
  }
  bool act = active_in[i] && kn == 0;
  // combine_hash: h = mix64(h ^ (p + GOLD)) over the reprs, then knull
  uint64_t h = ksql::kGold;
  for (int64_t j = 0; j < k; ++j) {
    h = ksql::mix64(h ^ (static_cast<uint64_t>(reprs[j * n + i]) + ksql::kGold));
  }
  h = ksql::mix64(h ^ (static_cast<uint64_t>(static_cast<int64_t>(kn)) + ksql::kGold));
  if (size_ms > 0) {
    // wstart + size + grace > max_ts, wrapping like XLA's int64 add
    const int64_t end = static_cast<int64_t>(
        static_cast<uint64_t>(ws) + static_cast<uint64_t>(size_ms) +
        static_cast<uint64_t>(grace_ms));
    act = act && end > *max_ts;
  }
  const uint64_t probe = ksql::mix64(h ^ (static_cast<uint64_t>(ws) * ksql::kGold));
  wstart[i] = ws;
  knull[i] = kn;
  active_out[i] = act;
  khash[i] = static_cast<int64_t>(h);
  base[i] = static_cast<int32_t>(probe & static_cast<uint64_t>(mask));
  c0[i] = act ? t : INT64_MIN;
}

}  // namespace

extern "C" int ksql_row_prologue(
    const void* reprs, const void* valid, int64_t k, int64_t n, const void* ts,
    const void* active_in, int64_t size_ms, int64_t grace_ms,
    const void* max_ts, int64_t mask, void* wstart, void* knull,
    void* active_out, void* khash, void* base, void* c0, void* stream) {
  const int threads = 256;
  row_prologue_kernel<<<ksql::blocks_for(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(reprs), static_cast<const bool*>(valid), k, n,
      static_cast<const int64_t*>(ts), static_cast<const bool*>(active_in),
      size_ms, grace_ms, static_cast<const int64_t*>(max_ts), mask,
      static_cast<int64_t*>(wstart), static_cast<int32_t*>(knull),
      static_cast<bool*>(active_out), static_cast<int64_t*>(khash),
      static_cast<int32_t*>(base), static_cast<int64_t*>(c0));
  return static_cast<int>(cudaGetLastError());
}
