// K2 probe_insert: deterministic open-addressing insert into the keyed store.
//
// Replaces ops/hash_store.py:probe_insert (B2).  The slot layout must match
// the reference bit for bit (and ops/hash_store.py:host_insert, which
// rebuilds the table on grow), so the round semantics are kept exactly:
// KSQL_MAX_PROBES rounds; in each, every unresolved active row reads the
// round-start state of its candidate, resolves on a match (a matching grave
// included), claims an empty non-grave candidate (the lowest row wins), and
// advances its candidate when the slot holds another key; a claim loser
// re-examines the same slot next round.  Rows unresolved after the last
// round go to the dump slot C and are counted in `overflow`.  Then every
// resolved row writes its key reprs and knull, and a fix-up reproduces what
// the reference's scatters leave in the dump slot (XLA applies duplicate
// scatter updates in row order, so the highest row aimed at slot C wins):
// khash/wstart of the highest row that did not win in the last round (the
// highest row if every row did), key reprs and knull of the highest
// unresolved row.
//
// Bound: latency of dependent scattered reads.  A probe reads 22 bytes
// (occ, grave, khash, wstart, the claim cell) at a random slot; the bytes
// are few (about 1.5 MB a round at 65,536 rows) but each round waits on its
// reads and on a barrier, and the rounds are serial.  Most rows resolve in
// the first rounds; a tail walks long clusters of a well-filled store for
// up to 32 rounds.
//
// Design: one launch a call, one barrier a round.  A claim is an atomicMin
// of (round << 26 | row) into the slot's claim cell (int32[C+1], INT32_MAX
// when clean), and nothing else is written during the rounds: the next
// round reads the cell with the slot, so a cell claimed in an earlier round
// is a used slot holding its winner's key (khash/wstart of that row), the
// row that claimed it learns there whether it won, and a claim of the
// current round (a concurrent one) reads as no claim.  The winners write
// occ/khash/wstart and clean their cells in the write pass, after the
// rounds.  The reads of a round are issued together (all of a thread's
// rows, seven reads each), so a round costs one read latency and a barrier.
//   n <= kSolo (4,096): block_kernel, one block of kThreads (1,024); each
//     thread owns the rows threadIdx.x + q * kThreads, q < 4, and keeps
//     their candidate, key and state in registers; __syncthreads_or() ends
//     a round and tells every thread whether any row is still pending, so
//     the empty rounds are skipped.  The write pass and the fix-up's
//     "highest row" searches (block max-reductions) run in the same block.
//   n > kSolo: grid_kernel, a persistent cooperative launch
//     (cudaLaunchCooperativeKernel; the grid is the smaller of the blocks n
//     needs and what the card holds at once, from the occupancy query,
//     cached per device).  Rows are walked with a grid stride, their
//     candidates in the scratch (bit 31: a claim awaiting its result, bit
//     30: resolved as a winner), grid.sync() between rounds.  Each round
//     counts its still-pending rows; behind the barrier every block reads
//     the count, so all leave together when it is 0.  Once it is at most
//     kHandoff (1,024, a row a thread), the rows are listed and block 0
//     finishes the remaining rounds alone, in registers, with block
//     barriers only.  Then the write pass, one more grid sync, and block 0
//     does the fix-up from block-reduced maxima.
// Data written during the call by other threads (the claim cells, the rows'
// slots and candidates) is read with ld.global.cg, from L2, never from a
// stale L1 line.  A launch the card refuses (too many blocks for a
// cooperative grid) returns its error; there is no fallback.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 4;
// rows one block carries in registers (ksql_probe_insert_sizes tells
// ops/hash_store.py)
constexpr int kSolo = kThreads * kPerThread;
// pending rows the grid hands to block 0: one a thread (a block's round
// costs about as much as a grid round once its threads carry two rows each)
constexpr int kHandoff = kThreads;
constexpr int kRowBits = 26;  // a claim cell: round << 26 | row
constexpr int32_t kRowMask = (1 << kRowBits) - 1;
constexpr int32_t kClean = INT32_MAX;  // no claim (no row reaches 2^26 - 1)
constexpr int32_t kClaimBit = INT32_MIN;  // a grid row's candidate: claim awaiting its result
constexpr int32_t kWinBit = 1 << 30;      // a grid row's candidate: resolved as a winner
constexpr int32_t kCandMask = kWinBit - 1;
constexpr int32_t kWonLast = -1;  // a grid row's candidate: won in the last round

struct Args {
  bool* occ;
  bool* grave;
  int64_t* kh;
  int64_t* ws;
  int64_t* keys[KSQL_MAX_KEYS];
  int64_t k;
  int32_t* knull_store;
  unsigned long long* overflow;
  int32_t* claim;
  int32_t capacity;
  const int32_t* base;
  const int64_t* khash;
  const int64_t* wstart;
  const int64_t* reprs;
  const int32_t* knull;
  const bool* active;
  int64_t n;
  int32_t* slots;
  // the grid kernel's scratch
  int32_t* pending;  // [KSQL_MAX_PROBES + 1]: rows still unresolved after round r - 1
  int32_t* cells;    // [2]: highest unresolved row, highest row that did not win the last round
  int32_t* list;     // [kHandoff]: the rows pending after the last grid round
  int32_t* cand;     // [n]
};

__device__ __forceinline__ int32_t ld32(const int32_t* p) { return __ldcg(p); }

// a candidate slot's state at the start of a round and the row's key: the
// seven reads independent
struct Probe {
  bool occ, grave;
  int64_t kh, ws;
  int32_t claim;
  int64_t kr, wr;
};

__device__ __forceinline__ Probe probe(const Args& a, int32_t c, int32_t row) {
  return Probe{a.occ[c], a.grave[c], a.kh[c], a.ws[c], ld32(a.claim + c), a.khash[row],
               a.wstart[row]};
}

enum Step : int8_t { kAdvance = 0, kClaim = 1, kMatch = 2, kWin = 3 };

// Row `row` at candidate c in round r, from the round-start reads `pr`;
// `claimed`: it claimed c in round r - 1.  A claim is made here.
__device__ __forceinline__ Step step(const Args& a, const Probe& pr, int32_t c, int32_t row,
                                     bool claimed, int r) {
  const int64_t kr = pr.kr, wr = pr.wr;
  if (claimed && (pr.claim & kRowMask) == row) return kWin;
  const bool taken = pr.claim != kClean && (pr.claim >> kRowBits) < r;
  if (pr.occ || pr.grave || taken) {
    bool same;
    if (taken) {
      const int32_t w = pr.claim & kRowMask;  // the slot's winner this call
      same = a.khash[w] == kr && a.wstart[w] == wr;
    } else {
      same = pr.kh == kr && pr.ws == wr;
    }
    return same ? kMatch : kAdvance;
  }
  atomicMin(a.claim + c, (r << kRowBits) | row);
  return kClaim;
}

enum State : int8_t { kIdle = 0, kPending = 1, kClaimed = 2, kDone = 3, kWon = 4, kWonLastRound = 5 };

// the rows one thread of the solo block carries
struct Solo {
  int32_t row[kPerThread];
  int32_t cand[kPerThread];
  int8_t st[kPerThread];
};

// Rounds r0.. of the rows in `s`, by one block, then the result of the
// last round's claims.  In the grid kernel a row's slot and winner mark
// are written out as it resolves; the block kernel keeps them in `s`.
template <bool kGrid>
__device__ void solo_rounds(const Args& a, Solo& s, int r0) {
  const int32_t mask = a.capacity - 1;
  int r = r0;
  for (; r < KSQL_MAX_PROBES; ++r) {
    Probe pr[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (s.st[q] == kPending || s.st[q] == kClaimed) pr[q] = probe(a, s.cand[q], s.row[q]);
    }
    int pending = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (s.st[q] != kPending && s.st[q] != kClaimed) continue;
      const int32_t c = s.cand[q];
      const Step o = step(a, pr[q], c, s.row[q], s.st[q] == kClaimed, r);
      if (o == kAdvance) {
        s.cand[q] = (c + 1) & mask;
        s.st[q] = kPending;
      } else if (o == kClaim) {
        s.st[q] = kClaimed;
      } else {
        s.st[q] = o == kWin ? kWon : kDone;
        if (kGrid) {
          a.slots[s.row[q]] = c;
          a.cand[s.row[q]] = o == kWin ? (c | kWinBit) : c;
        }
      }
      pending |= s.st[q] == kPending || s.st[q] == kClaimed;
    }
    if (!__syncthreads_or(pending)) return;
  }
  // round 31's claims, behind its barrier
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    if (s.st[q] != kClaimed) continue;
    const int32_t c = s.cand[q];
    if ((ld32(a.claim + c) & kRowMask) == s.row[q]) {
      s.st[q] = kWonLastRound;
      if (kGrid) {
        a.slots[s.row[q]] = c;
        a.cand[s.row[q]] = kWonLast;
      }
    } else {
      s.st[q] = kPending;  // unresolved
    }
  }
}

// a resolved row's writes: key reprs and null bits (idempotent: rows
// sharing a slot share their key; a matched grave comes back alive) and,
// for the slot's winner, its probe identity and a clean claim cell
__device__ __forceinline__ void write_row(const Args& a, int64_t i, int32_t slot, bool winner) {
  a.occ[slot] = true;
  a.grave[slot] = false;
  for (int64_t j = 0; j < a.k; ++j) a.keys[j][slot] = a.reprs[j * a.n + i];
  a.knull_store[slot] = a.knull[i];
  if (winner) {
    a.kh[slot] = a.khash[i];
    a.ws[slot] = a.wstart[i];
    a.claim[slot] = kClean;
  }
}

// the block's maxima and overflow count into shared cells (all threads)
__device__ __forceinline__ void block_reduce(int dump, int keep, unsigned ovf, int* s_dump,
                                             int* s_keep, unsigned long long* s_ovf) {
  dump = __reduce_max_sync(0xffffffffu, dump);
  keep = __reduce_max_sync(0xffffffffu, keep);
  ovf = __reduce_add_sync(0xffffffffu, ovf);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(s_dump, dump);
    atomicMax(s_keep, keep);
    if (ovf != 0) atomicAdd(s_ovf, static_cast<unsigned long long>(ovf));
  }
}

// what the reference's scatters leave in the dump slot C (one thread)
__device__ void fixup(const Args& a, int dump, int keep) {
  const int32_t cap = a.capacity;
  if (a.n > 0) {
    const int64_t i = keep >= 0 ? keep : a.n - 1;
    a.kh[cap] = a.khash[i];
    a.ws[cap] = a.wstart[i];
  }
  if (dump >= 0) {
    a.grave[cap] = false;
    for (int64_t j = 0; j < a.k; ++j) a.keys[j][cap] = a.reprs[j * a.n + dump];
    a.knull_store[cap] = a.knull[dump];
  }
  a.occ[cap] = false;
}

__global__ void __launch_bounds__(kThreads) block_kernel(Args a) {
  __shared__ int s_dump, s_keep;
  __shared__ unsigned long long s_ovf;
  if (threadIdx.x == 0) {
    s_dump = -1;
    s_keep = -1;
    s_ovf = 0;
  }
  Solo s;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int32_t i = static_cast<int32_t>(threadIdx.x) + q * kThreads;
    s.row[q] = i;
    s.st[q] = kIdle;
    if (i < a.n && a.active[i]) {
      s.st[q] = kPending;
      s.cand[q] = a.base[i];
    }
  }
  __syncthreads();  // publishes the shared cells
  solo_rounds<false>(a, s, 0);
  int dump = -1, keep = -1;
  unsigned ovf = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int32_t i = s.row[q];
    if (i >= a.n) continue;
    const bool done = s.st[q] >= kDone;
    const int32_t slot = done ? s.cand[q] : a.capacity;
    a.slots[i] = slot;
    if (done) {
      write_row(a, i, slot, s.st[q] != kDone);
    } else {
      dump = i;
      if (s.st[q] != kIdle) ++ovf;  // active and unresolved
    }
    if (s.st[q] != kWonLastRound) keep = i;
  }
  block_reduce(dump, keep, ovf, &s_dump, &s_keep, &s_ovf);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_ovf != 0) *a.overflow += s_ovf;
    fixup(a, s_dump, s_keep);
  }
}

__global__ void __launch_bounds__(kThreads) grid_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_dump, s_keep, s_count, s_base;
  __shared__ unsigned long long s_ovf;
  const int32_t cap = a.capacity;
  const int32_t mask = cap - 1;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t0 = first + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_dump = -1;
    s_keep = -1;
    s_ovf = 0;
  }
  for (int64_t i = t0; i < a.n; i += stride) {
    a.slots[i] = cap;
    a.cand[i] = a.base[i];
  }
  if (t0 <= KSQL_MAX_PROBES) a.pending[t0] = 0;
  if (t0 < 2) a.cells[t0] = -1;
  grid.sync();
  int r = 0, handoff = 0;
  for (; r < KSQL_MAX_PROBES; ++r) {
    // block-uniform trip count, so each warp votes with all its lanes
    for (int64_t b = first; b < a.n; b += stride) {
      const int64_t i = b + threadIdx.x;
      bool still = false;
      if (i < a.n && a.active[i] && a.slots[i] == cap) {
        const int32_t cf = a.cand[i];
        const int32_t c = cf & kCandMask;
        const Step o = step(a, probe(a, c, static_cast<int32_t>(i)), c, static_cast<int32_t>(i),
                            cf < 0, r);
        if (o == kAdvance) {
          a.cand[i] = (c + 1) & mask;
          still = true;
        } else if (o == kClaim) {
          a.cand[i] = c | kClaimBit;
          still = true;
        } else {
          a.slots[i] = c;
          a.cand[i] = o == kWin ? (c | kWinBit) : c;
        }
      }
      // the pending rows counted: one atomic a block on the round's counter
      const int count = __syncthreads_count(still);
      if (threadIdx.x == 0 && count != 0) atomicAdd(a.pending + r + 1, count);
    }
    grid.sync();
    const int p = ld32(a.pending + r + 1);
    if (p == 0) break;
    if (p <= kHandoff && r + 1 < KSQL_MAX_PROBES) {
      // list them for block 0 (pending[0] counts the list): a shared-memory
      // count per warp, one atomic a block
      for (int64_t b = first; b < a.n; b += stride) {
        const int64_t i = b + threadIdx.x;
        const bool still = i < a.n && a.active[i] && a.slots[i] == cap;
        const unsigned m = __ballot_sync(0xffffffffu, still);
        if (threadIdx.x == 0) s_count = 0;
        __syncthreads();
        int at = 0;
        if (lane == 0 && m != 0) at = atomicAdd(&s_count, __popc(m));
        __syncthreads();
        if (threadIdx.x == 0 && s_count != 0) s_base = atomicAdd(a.pending, s_count);
        __syncthreads();
        at = __shfl_sync(0xffffffffu, at, 0);
        if (still) a.list[s_base + at + __popc(m & ((1u << lane) - 1u))] = static_cast<int32_t>(i);
      }
      grid.sync();
      handoff = p;
      ++r;
      break;
    }
  }
  if (handoff > 0 && blockIdx.x == 0) {
    Solo s;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int e = static_cast<int>(threadIdx.x) + q * kThreads;
      s.st[q] = kIdle;
      s.row[q] = -1;
      if (e < handoff) {
        const int32_t i = ld32(a.list + e);
        const int32_t cf = ld32(a.cand + i);
        s.row[q] = i;
        s.cand[q] = cf & kCandMask;
        s.st[q] = cf < 0 ? kClaimed : kPending;
      }
    }
    solo_rounds<true>(a, s, r);
  }
  grid.sync();
  int dump = -1, keep = -1;
  unsigned ovf = 0;
  for (int64_t i = t0; i < a.n; i += stride) {
    int32_t slot = ld32(a.slots + i);
    int32_t cf = ld32(a.cand + i);
    if (slot == cap && cf < 0 && cf != kWonLast) {
      // a claim of round 31 when no block finished the rounds alone
      const int32_t c = cf & kCandMask;
      if ((ld32(a.claim + c) & kRowMask) == static_cast<int32_t>(i)) {
        slot = c;
        cf = kWonLast;
        a.slots[i] = c;
      }
    }
    if (slot != cap) {
      write_row(a, i, slot, (cf & kWinBit) != 0);
    } else {
      a.slots[i] = cap;
      dump = static_cast<int>(i);
      if (a.active[i]) ++ovf;
    }
    if (cf != kWonLast) keep = static_cast<int>(i);
  }
  block_reduce(dump, keep, ovf, &s_dump, &s_keep, &s_ovf);
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(a.cells, s_dump);
    atomicMax(a.cells + 1, s_keep);
    if (s_ovf != 0) atomicAdd(a.overflow, s_ovf);
  }
  grid.sync();
  if (t0 == 0) fixup(a, ld32(a.cells), ld32(a.cells + 1));
}

// blocks of grid_kernel one SM holds at once, per device (0 until asked)
int g_blocks_per_sm[64];
int g_sms[64];

}  // namespace

// int32 words of the grid kernel's scratch besides one a row
constexpr int64_t kWorkFixed = KSQL_MAX_PROBES + 1 + 2 + kHandoff;

// out: [the most rows one block takes (kSolo), the grid scratch's words
// besides one a row (kWorkFixed)]
extern "C" int ksql_probe_insert_sizes(int64_t* out) {
  out[0] = kSolo;
  out[1] = kWorkFixed;
  return 0;
}

// scratch: int32[scratch_len], at least kWorkFixed + n past kSolo rows
// (the grid kernel's; the block kernel uses none of it); a shorter one is
// refused
extern "C" int ksql_probe_insert(
    void* occ, void* grave, void* kh, void* ws, const int64_t* key_ptrs,
    int64_t k, void* knull_store, void* overflow, void* claim,
    int64_t capacity, const void* base, const void* khash, const void* wstart,
    const void* reprs, const void* knull, const void* active, int64_t n,
    void* slots, void* scratch, int64_t scratch_len, void* stream) {
  if (k > KSQL_MAX_KEYS || n >= kRowMask || capacity > (1ll << 30) ||
      (n > kSolo && (scratch == nullptr || scratch_len < kWorkFixed + n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.occ = static_cast<bool*>(occ);
  a.grave = static_cast<bool*>(grave);
  a.kh = static_cast<int64_t*>(kh);
  a.ws = static_cast<int64_t*>(ws);
  for (int64_t j = 0; j < k; ++j) a.keys[j] = reinterpret_cast<int64_t*>(key_ptrs[j]);
  a.k = k;
  a.knull_store = static_cast<int32_t*>(knull_store);
  a.overflow = static_cast<unsigned long long*>(overflow);
  a.claim = static_cast<int32_t*>(claim);
  a.capacity = static_cast<int32_t>(capacity);
  a.base = static_cast<const int32_t*>(base);
  a.khash = static_cast<const int64_t*>(khash);
  a.wstart = static_cast<const int64_t*>(wstart);
  a.reprs = static_cast<const int64_t*>(reprs);
  a.knull = static_cast<const int32_t*>(knull);
  a.active = static_cast<const bool*>(active);
  a.n = n;
  a.slots = static_cast<int32_t*>(slots);
  if (n <= kSolo) {
    block_kernel<<<1, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int32_t* sc = static_cast<int32_t*>(scratch);
  a.pending = sc;
  a.cells = sc + KSQL_MAX_PROBES + 1;
  a.list = a.cells + 2;
  a.cand = a.list + kHandoff;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_blocks_per_sm[dev] = per_sm;
    g_sms[dev] = sms;
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(g_blocks_per_sm[dev]) * g_sms[dev];
  const unsigned blocks = static_cast<unsigned>(need < most ? need : most);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_kernel), dim3(blocks),
                                    dim3(kThreads), params, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
