// K2 probe_insert: deterministic open-addressing insert into the keyed store.
//
// Replaces ops/hash_store.py:probe_insert (B2).  The slot layout must match
// the reference bit for bit (and ops/hash_store.py:host_insert, which
// rebuilds the table on grow), so the round semantics are kept exactly:
// KSQL_MAX_PROBES rounds; in each, every unresolved active row reads the
// round-start occ/grave/khash/wstart at its candidate, resolves on a match
// (a matching grave included), claims an empty non-grave candidate by
// atomicMin of its row index (the lowest row wins), and advances its probe
// offset when the candidate holds another key.  Claim losers re-examine the
// same slot next round.  Rows unresolved after the last round go to the
// dump slot C and are counted in `overflow`.
//
// Design: two launches per round.  Phase A examines and claims; phase B
// lets the winner (claim == its row) write occ/khash/wstart and reset its
// own claim cell, so the claim array (int32[C+1], INT32_MAX when clean) is
// clean again after every round and no loser can mistake a cleared cell for
// its own.  A per-round device counter of still-unresolved rows lets later
// rounds return at once.  After the rounds one pass writes key reprs and
// knull for resolved rows, and a one-thread fix-up reproduces what the
// reference's scatters leave in the dump slot (XLA applies duplicate
// scatter updates in row order, so the highest row that targets slot C
// wins): khash/wstart of the highest row that did not win in the final
// round, key reprs and knull of the highest unresolved row.
//
// Bound: memory, and latency of dependent random reads.  Each probe reads
// 18 bytes scattered over the store (occ, grave, khash, wstart), so at
// 65,536 rows the store traffic is about 1.2 MB per probe round plus the
// per-row inputs; most rows resolve in round 0, and the early exit skips
// the empty rounds.  Launch overhead of the 2 x 32 launches is the next
// limit; a cooperative single launch is the later speed-up.
#include "common.cuh"

namespace {

struct KeyPtrs {
  int64_t* col[KSQL_MAX_KEYS];
};

struct Scratch {
  int32_t* offset;     // [n] probe offset
  int32_t* want_cand;  // [n] candidate claimed this round, -1 if none
  int32_t* won_round;  // [n] round the row won a claim in, -1 if none
  int32_t* pending;    // [MAX_PROBES + 1] unresolved rows entering round r
  int32_t* dump_row;   // [1] highest unresolved row after the rounds
};

__global__ void init_kernel(int64_t n, int32_t capacity, int32_t* slots,
                            Scratch s) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    slots[i] = capacity;
    s.offset[i] = 0;
    s.want_cand[i] = -1;
    s.won_round[i] = -1;
  }
  if (i <= KSQL_MAX_PROBES) s.pending[i] = (i == 0) ? 1 : 0;
  if (i == 0) *s.dump_row = -1;
}

__global__ void round_a_kernel(
    int round, const bool* __restrict__ occ, const bool* __restrict__ grave,
    const int64_t* __restrict__ kh, const int64_t* __restrict__ ws,
    int32_t* __restrict__ claim, int32_t mask, int32_t capacity,
    const int32_t* __restrict__ base, const int64_t* __restrict__ khash,
    const int64_t* __restrict__ wstart, const bool* __restrict__ active,
    int64_t n, int32_t* __restrict__ slots, Scratch s) {
  if (s.pending[round] == 0) return;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !active[i] || slots[i] != capacity) return;
  const int32_t cand = (base[i] + s.offset[i]) & mask;
  const bool used = occ[cand] || grave[cand];
  const bool match = used && kh[cand] == khash[i] && ws[cand] == wstart[i];
  if (match) {
    slots[i] = cand;
    s.want_cand[i] = -1;
  } else if (!used) {
    atomicMin(&claim[cand], static_cast<int32_t>(i));
    s.want_cand[i] = cand;
  } else {
    s.offset[i] += 1;  // used by another key: advance along the sequence
    s.want_cand[i] = -1;
  }
}

__global__ void round_b_kernel(
    int round, bool* __restrict__ occ, int64_t* __restrict__ kh,
    int64_t* __restrict__ ws, int32_t* __restrict__ claim, int32_t capacity,
    const int64_t* __restrict__ khash, const int64_t* __restrict__ wstart,
    const bool* __restrict__ active, int64_t n, int32_t* __restrict__ slots,
    Scratch s) {
  if (s.pending[round] == 0) return;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !active[i] || slots[i] != capacity) return;
  const int32_t cand = s.want_cand[i];
  if (cand >= 0 && claim[cand] == static_cast<int32_t>(i)) {
    occ[cand] = true;
    kh[cand] = khash[i];
    ws[cand] = wstart[i];
    slots[i] = cand;
    s.won_round[i] = round;
    claim[cand] = INT32_MAX;  // only the winner resets its cell
    return;
  }
  atomicAdd(&s.pending[round + 1], 1);
}

__global__ void write_kernel(
    bool* __restrict__ occ, bool* __restrict__ grave, KeyPtrs keys, int64_t k,
    int32_t* __restrict__ knull_store, unsigned long long* overflow,
    int32_t capacity, const int64_t* __restrict__ reprs,
    const int32_t* __restrict__ knull, const bool* __restrict__ active,
    int64_t n, const int32_t* __restrict__ slots, Scratch s) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const int32_t slot = in ? slots[i] : capacity;
  const bool done = in && slot != capacity;
  // highest unresolved row per warp, then one atomic per warp
  const unsigned undone = __ballot_sync(0xffffffffu, in && !done);
  if (undone != 0 && (threadIdx.x & 31) == 31 - __clz(undone)) {
    atomicMax(s.dump_row, static_cast<int32_t>(i));
  }
  if (!in) return;
  if (done) {
    // idempotent writes: rows sharing a slot share their key
    occ[slot] = true;
    grave[slot] = false;
    for (int64_t j = 0; j < k; ++j) keys.col[j][slot] = reprs[j * n + i];
    knull_store[slot] = knull[i];
  } else if (active[i]) {
    atomicAdd(overflow, 1ull);
  }
}

__global__ void fixup_kernel(
    bool* __restrict__ occ, bool* __restrict__ grave, int64_t* __restrict__ kh,
    int64_t* __restrict__ ws, KeyPtrs keys, int64_t k,
    int32_t* __restrict__ knull_store, int32_t capacity,
    const int64_t* __restrict__ khash, const int64_t* __restrict__ wstart,
    const int64_t* __restrict__ reprs, const int32_t* __restrict__ knull,
    int64_t n, Scratch s) {
  // the last round's non-winners all scattered their khash/wstart into the
  // dump slot; the highest such row is the one that stays
  for (int r = KSQL_MAX_PROBES - 1; r >= 0; --r) {
    int64_t i = n - 1;
    while (i >= 0 && s.won_round[i] == r) --i;
    if (i >= 0) {
      kh[capacity] = khash[i];
      ws[capacity] = wstart[i];
      break;
    }
  }
  const int32_t d = *s.dump_row;
  if (d >= 0) {
    grave[capacity] = false;
    for (int64_t j = 0; j < k; ++j) keys.col[j][capacity] = reprs[j * n + d];
    knull_store[capacity] = knull[d];
  }
  occ[capacity] = false;
}

}  // namespace

extern "C" int ksql_probe_insert(
    void* occ, void* grave, void* kh, void* ws, const int64_t* key_ptrs,
    int64_t k, void* knull_store, void* overflow, void* claim,
    int64_t capacity, const void* base, const void* khash, const void* wstart,
    const void* reprs, const void* knull, const void* active, int64_t n,
    void* slots, void* scratch, void* stream) {
  if (k > KSQL_MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KeyPtrs keys{};
  for (int64_t j = 0; j < k; ++j) keys.col[j] = reinterpret_cast<int64_t*>(key_ptrs[j]);
  int32_t* sc = static_cast<int32_t*>(scratch);
  Scratch s{sc, sc + n, sc + 2 * n, sc + 3 * n, sc + 3 * n + KSQL_MAX_PROBES + 1};
  const int threads = 256;
  const int blocks = ksql::blocks_for(n > KSQL_MAX_PROBES + 1 ? n : KSQL_MAX_PROBES + 1, threads);
  const int32_t cap = static_cast<int32_t>(capacity);
  auto* occ_b = static_cast<bool*>(occ);
  auto* kh_p = static_cast<int64_t*>(kh);
  auto* ws_p = static_cast<int64_t*>(ws);
  auto* slots_p = static_cast<int32_t*>(slots);
  auto* claim_p = static_cast<int32_t*>(claim);
  const auto* base_p = static_cast<const int32_t*>(base);
  const auto* khash_p = static_cast<const int64_t*>(khash);
  const auto* wstart_p = static_cast<const int64_t*>(wstart);
  const auto* active_p = static_cast<const bool*>(active);
  init_kernel<<<blocks, threads, 0, st>>>(n, cap, slots_p, s);
  for (int r = 0; r < KSQL_MAX_PROBES; ++r) {
    round_a_kernel<<<blocks, threads, 0, st>>>(
        r, occ_b, static_cast<const bool*>(grave), kh_p, ws_p, claim_p, cap - 1,
        cap, base_p, khash_p, wstart_p, active_p, n, slots_p, s);
    round_b_kernel<<<blocks, threads, 0, st>>>(
        r, occ_b, kh_p, ws_p, claim_p, cap, khash_p, wstart_p, active_p, n,
        slots_p, s);
  }
  write_kernel<<<blocks, threads, 0, st>>>(
      occ_b, static_cast<bool*>(grave), keys, k,
      static_cast<int32_t*>(knull_store),
      static_cast<unsigned long long*>(overflow), cap,
      static_cast<const int64_t*>(reprs), static_cast<const int32_t*>(knull),
      active_p, n, slots_p, s);
  fixup_kernel<<<1, 1, 0, st>>>(
      occ_b, static_cast<bool*>(grave), kh_p, ws_p, keys, k,
      static_cast<int32_t*>(knull_store), cap, khash_p, wstart_p,
      static_cast<const int64_t*>(reprs), static_cast<const int32_t*>(knull),
      n, s);
  return static_cast<int>(cudaGetLastError());
}
