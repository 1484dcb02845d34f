// K21 vec_topk: fold a micro-batch into a TOPK / TOPKDISTINCT column.
//
// Replaces ops/hash_store.py:_vec_topk, with its :_sort_desc and
// :_desc_key (B18).  State per slot: top[K] (int8/int32/int64/float64),
// descending, the dtype floor `sent` marking an empty entry.  Computes what
// the reference computes, not its steps (two or three sorts of the batch):
//   A row takes part (eff = its slot) when its value is not `sent` and its
//   slot is not the dump slot C, else eff = C.  A slot's candidates are its
//   first K rows in the order (XLA's key of _desc_key(value), row), found
//   as K successive minima over the slot's rows; in distinct mode a row
//   IEEE-equal to an earlier one of its slot (the same key, not NaN) is not
//   a candidate (the reference sends it to (C, sent)), so each minimum must
//   pass the last one's key.  The candidates and the stored K merge as
//   jnp.sort(...)[::-1] does: descending by XLA's key, equal keys in reverse
//   order of [candidates, stored], so a value's place is the count of
//   values above it plus the equal ones after it; distinct mode then makes
//   a value equal to the one before it `sent` and places again.
//   The dump row keeps XLA's last-write rule: it takes the merge of the
//   last sorted position that is not a run's first, whose window holds one
//   value: that of C's group when any row (or, distinct, any dropped
//   duplicate) is there, merged with the dump row; else the last value of
//   the highest slot with two candidates, merged with that slot's stored K
//   as it was before the slot's own write.
// One cooperative launch (topk_kernel), a grid of at most the blocks the
// card holds at once, and no sort:
//   1. each row takes a ticket in its group's count (slot_cnt, 0 between
//      calls; one atomicAdd a group of a warp's rows, __match_any_sync),
//      the group's first ticket lists the group (C is a group too);
//   -- grid.sync --
//   2. each listed group takes its range of the buckets (one atomicAdd a
//      warp on a cursor) and publishes it in slot_off (-1 between calls);
//      each row waits for its group's range and writes its key, value and
//      row at its ticket there (coalesced reads for the next phase);
//   -- grid.sync --
//   3. a group of more than kBig rows is taken by a block, every other by
//      a warp: it finds the candidates (a reduction over the group a
//      round), merges them with the stored K by rank counting in shared
//      memory (a value a lane) and writes the slot's K.  The group that
//      finishes last (a done count) merges the dump row, from what C's
//      group or the candidate slots left in the control words and the
//      stash, and resets the control words.
//
// Bound: bytes.  The least work reads the batch (value and slot: 12 bytes a
// row at int64) and each touched slot's stored K values, and writes them
// back.  The design adds the buckets (20 bytes a row, written once and
// read once or a few times) and two grid barriers.  The fixed costs (a
// launch, two barriers) dominate at phase 14's 4,096 rows; a hot slot's
// group is read once a round by a whole block.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kBig = 64;  // a group of more rows is taken by a whole block
constexpr unsigned kFull = 0xffffffffu;

// control words, 0 between calls (the last group's team leaves them so)
enum : int {
  kListed = 0,  // groups listed (touched slots, and C)
  kCursor,      // the buckets' next free position
  kNumBig,      // groups of more than kBig rows
  kNumSmall,    // the other groups
  kDone,        // groups finished
  kAnyC,        // some row's group is C
  kSentRow,     // some row holds the sentinel
  kDup,         // distinct: some slot holds two equal values
  kBest,        // (slot + 1) << 32 | work index: the highest slot with two candidates
  kCVal,        // C's group: the dump row's window value
  kCFinal,      // 1: kCVal is final; 2: it is unless kDup
  kCtrlWords
};

struct Args {
  const void* vals;
  int64_t esize, isfloat, sent;
  const int32_t* slots;
  int64_t n, cap;
  void* col;
  int64_t K, distinct;
  int32_t* slot_cnt;  // C + 1 ticket counts, 0 between calls
  int32_t* slot_off;  // C + 1 bucket offsets, -1 between calls
  unsigned long long* ctrl;
  int32_t* local;  // n: each row's ticket
  int32_t* work;   // n: the listed groups' slots
  int32_t* brow;   // n: the bucketed rows
  int64_t* bkey;   // n: their keys (XLA's key of _desc_key(value))
  int64_t* bval;   // n: their values (as int64: ints sign-extended, doubles' bits)
  int64_t* big;    // 2 n: the big groups, (work index << 32 | slot, rows << 32 | offset)
  int64_t* small;  // 2 n: the others, the same
  int64_t* stash;  // n (K + 1): a candidate slot's last value and stored K
};

// A row of a group: its key, its row index and its value.
struct KR {
  int64_t key;
  int32_t row;
  int64_t val;
};

__device__ __forceinline__ bool kr_less(const KR& a, const KR& b) {
  return a.key < b.key || (a.key == b.key && a.row < b.row);
}

__device__ __forceinline__ bool kr_found(const KR& a) { return a.row >= 0 && a.row != INT32_MAX; }

__device__ __forceinline__ KR kr_none(bool want_max) {
  return want_max ? KR{INT64_MIN, -1, 0} : KR{INT64_MAX, INT32_MAX, 0};
}

__device__ __forceinline__ bool is_nan_key(int64_t key, int64_t isfloat) {
  return isfloat && key == INT64_MAX;  // sort_key gives every NaN INT64_MAX
}

// The warp's least (or greatest) KR by (key, row), in every lane.
__device__ __forceinline__ KR warp_reduce(KR x, bool want_max) {
  for (int d = 16; d > 0; d >>= 1) {
    KR y;
    y.key = __shfl_xor_sync(kFull, static_cast<long long>(x.key), d);
    y.row = __shfl_xor_sync(kFull, x.row, d);
    y.val = __shfl_xor_sync(kFull, static_cast<long long>(x.val), d);
    if (want_max ? kr_less(x, y) : kr_less(y, x)) x = y;
  }
  return x;
}

// A warp or a block working on one group.  `cache`: the group's rows a
// thread keeps in registers (the rest are read again a round).
struct WarpTeam {
  int rank;
  static constexpr int size = 32;
  static constexpr int cache = 2;  // kBig rows
  __device__ KR reduce(KR x, bool want_max) { return warp_reduce(x, want_max); }
  __device__ bool any(bool p) { return __any_sync(kFull, p); }
  __device__ void sync() { __syncwarp(); }
};

struct BlockTeam {
  int rank;
  KR* red;  // kWarps entries of shared memory
  static constexpr int size = kThreads;
  static constexpr int cache = 8;
  __device__ KR reduce(KR x, bool want_max) {
    x = warp_reduce(x, want_max);
    if ((rank & 31) == 0) red[rank >> 5] = x;
    __syncthreads();
    KR r = red[0];
    for (int w = 1; w < kWarps; ++w) {
      const KR y = red[w];
      if (want_max ? kr_less(r, y) : kr_less(y, r)) r = y;
    }
    __syncthreads();  // red is read before the next reduction writes it
    return r;
  }
  __device__ bool any(bool p) { return __syncthreads_or(p) != 0; }
  __device__ void sync() { __syncthreads(); }
};

__device__ __forceinline__ KR bucket(const Args& a, int64_t pos) {
  KR e;
  e.key = __ldcg(reinterpret_cast<const long long*>(a.bkey) + pos);
  e.row = __ldcg(a.brow + pos);
  e.val = __ldcg(reinterpret_cast<const long long*>(a.bval) + pos);
  return e;
}

// The rows [off, off + m) of one group, the first Team::cache a thread in
// registers (read once, all at once).
template <class Team>
struct Rows {
  KR e[Team::cache];
  int64_t off, m;
  __device__ void load(const Args& a, const Team& t) {
#pragma unroll
    for (int q = 0; q < Team::cache; ++q) {
      const int64_t i = t.rank + static_cast<int64_t>(q) * Team::size;
      if (i < m) e[q] = bucket(a, off + i);
    }
  }
  // The least (or greatest) row that `pred` admits, in every thread of the
  // team (kr_found false when none).
  template <class Pred>
  __device__ KR best(const Args& a, Team& t, bool want_max, Pred pred) const {
    KR b = kr_none(want_max);
#pragma unroll
    for (int q = 0; q < Team::cache; ++q) {
      const int64_t i = t.rank + static_cast<int64_t>(q) * Team::size;
      if (i < m && pred(e[q]) && (want_max ? kr_less(b, e[q]) : kr_less(e[q], b))) b = e[q];
    }
    for (int64_t i = t.rank + static_cast<int64_t>(Team::cache) * Team::size; i < m; i += Team::size) {
      const KR x = bucket(a, off + i);
      if (pred(x) && (want_max ? kr_less(b, x) : kr_less(x, b))) b = x;
    }
    return t.reduce(b, want_max);
  }
};

// Whether two rows of the group hold equal values (the same key, not NaN):
// each chunk of H / 2 rows goes into a hash set of H cells of shared
// memory (`tab`, the team's), a later row is looked up in it.
constexpr unsigned long long kEmpty = 0x7fffffffffffffffull;  // a NaN's key: never inserted

template <class Team>
__device__ bool team_has_dup(Team& t, const Args& a, int64_t off, int64_t m, unsigned long long* tab, int64_t H) {
  const int64_t chunk = H / 2;
  const long long* keys = reinterpret_cast<const long long*>(a.bkey) + off;
  for (int64_t c0 = 0; c0 < m; c0 += chunk) {
    const int64_t c1 = c0 + chunk < m ? c0 + chunk : m;
    for (int64_t h = t.rank; h < H; h += Team::size) tab[h] = kEmpty;
    t.sync();
    bool dup = false;
    for (int64_t i = c0 + t.rank; i < c1; i += Team::size) {
      const unsigned long long k = static_cast<unsigned long long>(__ldcg(keys + i));
      if (k == kEmpty) continue;  // NaN (a key INT64_MAX is never an int's here: no sentinel row)
      for (uint64_t h = ksql::mix64(k) & static_cast<uint64_t>(H - 1);; h = (h + 1) & static_cast<uint64_t>(H - 1)) {
        const unsigned long long old = atomicCAS(tab + h, kEmpty, k);
        if (old == kEmpty) break;
        if (old == k) {
          dup = true;
          break;
        }
      }
    }
    t.sync();
    for (int64_t i = c1 + t.rank; i < m && !dup; i += Team::size) {
      const unsigned long long k = static_cast<unsigned long long>(__ldcg(keys + i));
      if (k == kEmpty) continue;
      for (uint64_t h = ksql::mix64(k) & static_cast<uint64_t>(H - 1);; h = (h + 1) & static_cast<uint64_t>(H - 1)) {
        const unsigned long long cur = tab[h];
        if (cur == kEmpty) break;
        if (cur == k) {
          dup = true;
          break;
        }
      }
    }
    if (t.any(dup)) return true;
  }
  return false;
}

// One warp places src[0, L) into dst as jnp.sort(src)[::-1] orders them:
// descending by XLA's key, equal keys in reverse order of src.
__device__ void rank_pass(const int64_t* src, int64_t* dst, int64_t L, int64_t isfloat, int lane) {
  for (int64_t i = lane; i < L; i += 32) {
    const int64_t v = src[i];
    const int64_t ki = ksql::sort_key(v, isfloat);
    int64_t r = 0;
    for (int64_t j = 0; j < L; ++j) {
      const int64_t kj = ksql::sort_key(src[j], isfloat);
      r += (kj > ki || (kj == ki && j > i)) ? 1 : 0;
    }
    dst[r] = v;
  }
  __syncwarp();
}

// One warp merges A[0, 2K) (the window, then the stored K) into B[0, K):
// the reference's sort, and in distinct mode its dedup and second sort.
__device__ void merge_top(const Args& a, int64_t* A, int64_t* B, int lane) {
  __syncwarp();
  const int64_t L = 2 * a.K;
  rank_pass(A, B, L, a.isfloat, lane);
  if (a.distinct) {
    for (int64_t p = lane; p < L; p += 32) {
      A[p] = (p > 0 && ksql::elem_eq(B[p], B[p - 1], a.isfloat)) ? a.sent : B[p];
    }
    __syncwarp();
    rank_pass(A, B, L, a.isfloat, lane);
  }
}

// The dump row's merge, by one warp of the team that finished last; then
// the control words are reset for the next call.
__device__ void dump_merge(const Args& a, int64_t* A, int64_t* B, int lane, bool c_present) {
  const int64_t K = a.K;
  const bool dup = __ldcg(&a.ctrl[kDup]) != 0;
  bool go = false;
  int64_t vlast = a.sent;
  const int64_t* stored = nullptr;  // null: the dump row itself
  if (c_present) {
    go = true;
    if (__ldcg(&a.ctrl[kCFinal]) == 1 || !dup) vlast = static_cast<int64_t>(__ldcg(&a.ctrl[kCVal]));
  } else if (a.distinct && dup) {
    go = true;  // the dropped duplicates alone in C's group
  } else {
    const unsigned long long best = __ldcg(&a.ctrl[kBest]);
    if (best != 0) {
      go = true;
      const int64_t* st = a.stash + static_cast<int64_t>(best & 0xffffffffull) * (K + 1);
      vlast = __ldcg(reinterpret_cast<const long long*>(st));
      stored = st + 1;
    }
  }
  if (go) {
    for (int64_t t = lane; t < K; t += 32) {
      A[t] = t == 0 ? vlast : a.sent;
      A[K + t] = stored == nullptr ? ksql::load_elem(a.col, a.cap * K + t, a.esize)
                                   : static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(stored) + t));
    }
    merge_top(a, A, B, lane);
    for (int64_t t = lane; t < K; t += 32) ksql::store_elem(a.col, a.cap * K + t, a.esize, B[t]);
  }
  __syncwarp();
  for (int i = lane; i < kCtrlWords; i += 32) a.ctrl[i] = 0;
}

// One listed group (`g`: its list entry) by a team; `merger`: this
// thread's warp merges (A, B: its 4K int64 of shared memory); `tab`, `H`:
// the team's hash set.
template <class Team>
__device__ void do_group(const Args& a, Team& t, const int64_t* g, int64_t* A, bool merger, int lane,
                         unsigned long long* tab, int64_t H, int64_t listed, bool c_present, bool sent_row) {
  const int64_t K = a.K;
  int64_t* B = A + 2 * K;
  const int64_t g0 = __ldcg(reinterpret_cast<const long long*>(g));
  const int64_t g1 = __ldcg(reinterpret_cast<const long long*>(g) + 1);
  const int32_t s = static_cast<int32_t>(g0 & 0xffffffff);
  const int64_t w = g0 >> 32;
  Rows<Team> rows;
  rows.off = g1 & 0xffffffff;
  rows.m = g1 >> 32;
  const int64_t m = rows.m;
  if (t.rank == 0) a.slot_off[s] = -1;  // clean for the next call
  if (s != a.cap) {
    for (int64_t i = t.rank; i < K; i += Team::size) A[K + i] = ksql::load_elem(a.col, s * K + i, a.esize);
  }
  rows.load(a, t);
  if (s == a.cap) {
    // C's group: the value the dump row's window holds when C is the last
    // run (its last row; distinct: the sentinel once a duplicate went
    // there, unless a NaN, the last of all, is)
    const KR hi = rows.best(a, t, true, [](const KR&) { return true; });
    int64_t val = hi.val;
    unsigned long long fin = 1;
    if (a.distinct && !is_nan_key(hi.key, a.isfloat)) {
      if (sent_row || team_has_dup(t, a, rows.off, m, tab, H)) {
        val = a.sent;
      } else {
        fin = 2;  // the sentinel if a slot dropped a duplicate
      }
    }
    if (t.rank == 0) {
      a.ctrl[kCVal] = static_cast<unsigned long long>(val);
      a.ctrl[kCFinal] = fin;
    }
  } else {
    // the candidates: K successive minima (two at least when the dump row
    // may need this slot's second)
    const int64_t rounds = (!c_present && K < 2) ? 2 : K;
    const bool distinct = a.distinct != 0;
    const int64_t isfloat = a.isfloat;
    int64_t found = 0;
    KR prev = kr_none(false);
    for (int64_t r = 0; r < rounds; ++r) {
      const KR best = rows.best(a, t, false, [&](const KR& e) {
        if (r == 0) return true;
        if (distinct && !is_nan_key(e.key, isfloat)) return e.key > prev.key;
        return kr_less(prev, e);
      });
      if (!kr_found(best)) break;
      if (r < K && t.rank == 0) A[r] = best.val;
      ++found;
      prev = best;
    }
    for (int64_t i = (found < K ? found : K) + t.rank; i < K; i += Team::size) A[i] = a.sent;
    if (distinct && !sent_row && m >= 2 && team_has_dup(t, a, rows.off, m, tab, H) && t.rank == 0) {
      a.ctrl[kDup] = 1;
    }
    if (!c_present && found >= 2) {
      // this slot's last value and stored K, for the dump row if it is the
      // highest such slot
      KR last = rows.best(a, t, true, [](const KR&) { return true; });
      if (distinct && !is_nan_key(last.key, isfloat)) {
        const int64_t kmax = last.key;
        last = rows.best(a, t, false, [&](const KR& e) { return e.key == kmax; });
      }
      int64_t* st = a.stash + w * (K + 1);
      if (t.rank == 0) st[0] = last.val;
      for (int64_t i = t.rank; i < K; i += Team::size) st[1 + i] = A[K + i];
      __threadfence();
      t.sync();
      if (t.rank == 0) {
        atomicMax(&a.ctrl[kBest], (static_cast<unsigned long long>(s) + 1ull) << 32 |
                                      static_cast<unsigned long long>(w));
      }
    }
    t.sync();
    if (merger) {
      merge_top(a, A, B, lane);
      for (int64_t i = lane; i < K; i += 32) ksql::store_elem(a.col, s * K + i, a.esize, B[i]);
    }
  }
  t.sync();
  bool last = false;
  if (t.rank == 0) {  // its control words and the stash are out before the count
    __threadfence();
    last = atomicAdd(&a.ctrl[kDone], 1ull) == static_cast<unsigned long long>(listed - 1);
  }
  if (t.any(last)) {
    __threadfence();
    if (merger) dump_merge(a, A, B, lane, c_present);
  }
  t.sync();  // the shared buffers are reused by the team's next group
}

// shared memory of a block: each warp's merge buffers (4K int64), then each
// warp's hash set (kSetCells cells; a block's group uses all of them)
constexpr int64_t kSetCells = 256;

__global__ void __launch_bounds__(kThreads) topk_kernel(Args a) {
  extern __shared__ int64_t s_dyn[];
  __shared__ KR red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int32_t cap = static_cast<int32_t>(a.cap);
  // 1. tickets and the list of groups
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + warp * 32; base < a.n; base += nthreads) {
    const int64_t i = base + lane;
    const bool live = i < a.n;
    int32_t eff = cap;
    bool sentv = false;
    if (live) {
      sentv = ksql::elem_eq(ksql::load_elem(a.vals, i, a.esize), a.sent, a.isfloat);
      const int32_t sl = a.slots[i];
      if (!sentv && sl != cap) eff = sl;
    }
    const unsigned peers = __match_any_sync(kFull, live ? eff : -1 - lane);
    const int leader = __ffs(peers) - 1;
    int32_t first = 0;
    if (live && lane == leader) first = atomicAdd(&a.slot_cnt[eff], __popc(peers));
    first = __shfl_sync(kFull, first, leader);
    if (live) a.local[i] = first + __popc(peers & lt);
    const bool opens = live && lane == leader && first == 0;
    const unsigned opened = __ballot_sync(kFull, opens);
    if (opened != 0u) {
      unsigned long long wb = 0;
      if (lane == 0) wb = atomicAdd(&a.ctrl[kListed], static_cast<unsigned long long>(__popc(opened)));
      wb = __shfl_sync(kFull, wb, 0);
      if (opens) a.work[wb + __popc(opened & lt)] = eff;
    }
    if (__any_sync(kFull, live && sentv) && lane == 0) a.ctrl[kSentRow] = 1;
    if (__any_sync(kFull, live && eff == cap) && lane == 0) a.ctrl[kAnyC] = 1;
  }
  grid.sync();
  const int64_t listed = static_cast<int64_t>(__ldcg(&a.ctrl[kListed]));
  const bool c_present = __ldcg(&a.ctrl[kAnyC]) != 0;
  const bool sent_row = __ldcg(&a.ctrl[kSentRow]) != 0;
  const int64_t warps_total = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  // 2. each group's range, published, and its list entry (big or small);
  // its ticket count is clean for the next call
  for (int64_t w0 = gwarp * 32; w0 < listed; w0 += warps_total * 32) {
    const int64_t w = w0 + lane;
    const bool ok = w < listed;
    const int32_t s = ok ? __ldcg(a.work + w) : 0;
    const int32_t cnt = ok ? __ldcg(a.slot_cnt + s) : 0;
    if (ok) a.slot_cnt[s] = 0;
    int32_t incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int32_t total = __shfl_sync(kFull, incl, 31);
    unsigned long long start = 0;
    if (lane == 0) start = atomicAdd(&a.ctrl[kCursor], static_cast<unsigned long long>(total));
    start = __shfl_sync(kFull, start, 0);
    const int32_t off = static_cast<int32_t>(start) + incl - cnt;
    if (ok) atomicExch(a.slot_off + s, off);
    const bool big = ok && cnt > kBig;
    const unsigned bm = __ballot_sync(kFull, big), sm = __ballot_sync(kFull, ok && !big);
    unsigned long long bb = 0, sb = 0;
    if (lane == 0) {
      if (bm != 0u) bb = atomicAdd(&a.ctrl[kNumBig], static_cast<unsigned long long>(__popc(bm)));
      if (sm != 0u) sb = atomicAdd(&a.ctrl[kNumSmall], static_cast<unsigned long long>(__popc(sm)));
    }
    bb = __shfl_sync(kFull, bb, 0);
    sb = __shfl_sync(kFull, sb, 0);
    if (ok) {
      int64_t* e = big ? a.big + 2 * (bb + __popc(bm & lt)) : a.small + 2 * (sb + __popc(sm & lt));
      e[0] = w << 32 | static_cast<uint32_t>(s);
      e[1] = static_cast<int64_t>(cnt) << 32 | static_cast<uint32_t>(off);
    }
  }
  // the rows into their groups' ranges (every range is published above
  // before any thread waits here, so the waits end)
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < a.n; i += nthreads) {
    const int64_t v = ksql::load_elem(a.vals, i, a.esize);
    const int32_t sl = a.slots[i];
    const int32_t eff = (!ksql::elem_eq(v, a.sent, a.isfloat) && sl != cap) ? sl : cap;
    int32_t off;
    while ((off = *reinterpret_cast<volatile int32_t*>(a.slot_off + eff)) < 0) __nanosleep(64);
    const int64_t pos = static_cast<int64_t>(off) + a.local[i];
    a.bkey[pos] = ksql::desc_key(v, a.isfloat);
    a.bval[pos] = v;
    a.brow[pos] = static_cast<int32_t>(i);
  }
  grid.sync();
  // 3. the groups: the big ones a block each, the others a warp each (the
  // warps numbered from the last block, away from the big groups' blocks)
  const int64_t nbig = static_cast<int64_t>(__ldcg(&a.ctrl[kNumBig]));
  const int64_t nsmall = static_cast<int64_t>(__ldcg(&a.ctrl[kNumSmall]));
  unsigned long long* sets = reinterpret_cast<unsigned long long*>(s_dyn + kWarps * 4 * a.K);
  BlockTeam bt{static_cast<int>(threadIdx.x), red};
  for (int64_t b = blockIdx.x; b < nbig; b += gridDim.x) {
    do_group(a, bt, a.big + 2 * b, s_dyn, warp == 0, lane, sets, kWarps * kSetCells, listed, c_present,
             sent_row);
  }
  WarpTeam wt{lane};
  int64_t* mine = s_dyn + warp * 4 * a.K;
  for (int64_t q = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kWarps + warp; q < nsmall; q += warps_total) {
    do_group(a, wt, a.small + 2 * q, mine, true, lane, sets + warp * kSetCells, kSetCells, listed, c_present,
             sent_row);
  }
}

// the cooperative grid's most blocks, per device and dynamic shared bytes
int g_most[64];
int64_t g_smem[64];

}  // namespace

// slot_buf: 2 (capacity + 1) int32 (the ticket counts, 0, then the bucket
// offsets, -1, between calls); ctrl: kCtrlWords uint64, 0 between calls
// (the kernel leaves both so); rows32: 3 n int32 and rows64: (K + 7) n
// int64 of scratch.
extern "C" int ksql_vec_topk(const void* vals, int64_t esize, int64_t isfloat, int64_t sent,
                             const void* slots, int64_t n, int64_t capacity, void* col, int64_t K,
                             int64_t distinct, void* slot_buf, void* ctrl, void* rows32, void* rows64,
                             void* stream) {
  if (K < 1 || K > 256 || n < 1 || n > INT32_MAX - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = kWarps * (4 * K + kSetCells) * static_cast<int64_t>(sizeof(int64_t));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_most[dev] == 0 || g_smem[dev] != smem) {
    err = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel, kThreads,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_most[dev] = per_sm * sms;
    g_smem[dev] = smem;
  }
  Args a;
  a.vals = vals;
  a.esize = esize;
  a.isfloat = isfloat;
  a.sent = sent;
  a.slots = static_cast<const int32_t*>(slots);
  a.n = n;
  a.cap = capacity;
  a.col = col;
  a.K = K;
  a.distinct = distinct;
  a.slot_cnt = static_cast<int32_t*>(slot_buf);
  a.slot_off = a.slot_cnt + capacity + 1;
  a.ctrl = static_cast<unsigned long long*>(ctrl);
  int32_t* r32 = static_cast<int32_t*>(rows32);
  a.local = r32;
  a.work = r32 + n;
  a.brow = r32 + 2 * n;
  int64_t* r64 = static_cast<int64_t*>(rows64);
  a.bkey = r64;
  a.bval = r64 + n;
  a.big = r64 + 2 * n;
  a.small = r64 + 4 * n;
  a.stash = r64 + 6 * n;
  // a block for every 32 rows: a warp for each group of a batch of ~4
  // rows a group; the grid.sync's cost grows with the blocks
  const int64_t want = (n + 31) / 32;
  const unsigned blocks = static_cast<unsigned>(want < g_most[dev] ? want : g_most[dev]);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(topk_kernel), dim3(blocks),
                                    dim3(kThreads), params, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
