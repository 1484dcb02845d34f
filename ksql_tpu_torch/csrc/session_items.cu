// K14 session_items: the per-row prologue, the first row of each key and
// the stored-session gather of the session step.
//
// Replaces, in runtime/lowering.py (B16): the late drop of
// pre_session_exchange and batch_stream_time; first_occ of
// post_session_exchange (:3557-3564 of the reference); and its item arrays
// with the probe_find loop over the S stored sessions of each key
// (:3566-3617).  Three entry points, one launch each:
//   prologue (one block of 1,024 threads, each owning a contiguous chunk
//     of the batch): cm = the running max of ts over row_valid rows in
//     arrival order, seeded with the store's max_ts; a row stays active
//     while ts + grace + gap >= cm (summed in uint64: XLA wraps);
//     scal = (batch stream time max(max_ts, cm), max ts over the rows
//     still active);
//   first (one thread per position of K13's order of the rows by
//     (where(active, khash, 0), 0)): a position whose key differs from the
//     one before it (or position 0) marks its row, if active, as its key's
//     first active row;
//   items (one thread per item of [rows | session i of row r at n + i n +
//     r]): a row item is the row; a store item of a first_occ row walks
//     ops/hash_store.py:probe_find's sequence for (khash, i) (a LIVE slot
//     with that key and window ends it found, a truly empty slot ends it
//     absent, graves and other keys are walked past, 32 candidates at
//     most; not found is the dump slot C), any other store item reads C.
//     The item gathers sess_start, sess_end, key<k> and a<j> at its slot
//     (C included, so masked items carry the dump slot's data as the
//     reference's do) and is alive when found and sess_end + gap + grace
//     reaches the batch stream time.  A dead item takes the key hash
//     2^62 + its index and start = end = 0; its reprs and components stay
//     as gathered.
//
// Bound: bytes and the latency of the dependent probe reads.  The items
// mode writes 33 + 8k + the component bytes per item (~6 MB at 139,264
// items, one key and two int64 components: ~2 us at 3.35 TB/s) and reads
// the store at the walked slots (18 bytes a probe, scattered) for the
// first rows only; the other store items all read the dump slot, which
// stays in L1/L2.  The prologue's one block is a few microseconds at
// 8,192 rows.
#include "common.cuh"

namespace {

constexpr int64_t kSentinel = int64_t{1} << 62;
constexpr int kScanThreads = 1024;

__global__ void prologue_kernel(const bool* __restrict__ row_valid, const int64_t* __restrict__ ts,
                                const bool* __restrict__ active_in, int64_t n,
                                const int64_t* __restrict__ max_ts_p, int64_t grace, int64_t gap,
                                bool* __restrict__ active_out, int64_t* __restrict__ scal) {
  __shared__ int64_t buf[kScanThreads];
  const int64_t max_ts = *max_ts_p;
  int64_t lo, hi;
  ksql::thread_chunk(n, &lo, &hi);
  int64_t cmax = INT64_MIN;
  for (int64_t i = lo; i < hi; ++i) {
    if (row_valid[i] && ts[i] > cmax) cmax = ts[i];
  }
  ksql::block_inclusive_scan(cmax, buf, ksql::MaxOp());
  int64_t run = threadIdx.x ? buf[threadIdx.x - 1] : INT64_MIN;
  const int64_t total = buf[blockDim.x - 1];
  if (max_ts > run) run = max_ts;
  int64_t bmax = INT64_MIN;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t t = ts[i];
    if (row_valid[i] && t > run) run = t;
    const bool a = active_in[i] && ksql::wadd(ksql::wadd(t, grace), gap) >= run;
    active_out[i] = a;
    if (a && t > bmax) bmax = t;
  }
  __syncthreads();  // every thread has read buf before the second scan
  ksql::block_inclusive_scan(bmax, buf, ksql::MaxOp());
  if (threadIdx.x == blockDim.x - 1) {
    scal[0] = total > max_ts ? total : max_ts;
    scal[1] = buf[blockDim.x - 1];
  }
}

__global__ void first_kernel(const int32_t* __restrict__ order0, const int64_t* __restrict__ khash,
                             const bool* __restrict__ active, int64_t n,
                             bool* __restrict__ first_occ) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int32_t r = order0[p];
  const bool a = active[r];
  bool starts = true;
  if (p > 0) {
    const int32_t q = order0[p - 1];
    starts = (a ? khash[r] : 0) != (active[q] ? khash[q] : 0);
  }
  first_occ[r] = starts && a;
}

// Per-column pointers of the items launch: the store's key and component
// columns, the rows' contributions, the item outputs, element bytes.
struct ItemCols {
  const int64_t* key[KSQL_MAX_KEYS];
  const void* col[KSQL_MAX_COMPS];
  const void* contrib[KSQL_MAX_COMPS];
  void* out[KSQL_MAX_COMPS];
  int64_t size[KSQL_MAX_COMPS];
};

__global__ void items_kernel(
    const bool* __restrict__ occ, const bool* __restrict__ grave, const int64_t* __restrict__ skh,
    const int64_t* __restrict__ sws, const int64_t* __restrict__ sess_start,
    const int64_t* __restrict__ sess_end, ItemCols c, int64_t k, int64_t ncomp,
    int64_t capacity, int64_t S, const int64_t* __restrict__ khash,
    const bool* __restrict__ active, const bool* __restrict__ first_occ,
    const int64_t* __restrict__ ts, const int64_t* __restrict__ reprs, int64_t n, int64_t gap,
    int64_t grace, const int64_t* __restrict__ scal, int64_t* __restrict__ kh_o,
    int64_t* __restrict__ start_o, int64_t* __restrict__ end_o, bool* __restrict__ alive_o,
    int32_t* __restrict__ slot_o, int64_t* __restrict__ reprs_o) {
  const int64_t m = n * (S + 1);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  if (j < n) {
    const bool a = active[j];
    kh_o[j] = a ? khash[j] : kSentinel + j;
    start_o[j] = a ? ts[j] : 0;
    end_o[j] = a ? ts[j] : 0;
    alive_o[j] = a;
    slot_o[j] = static_cast<int32_t>(capacity);
    for (int64_t q = 0; q < k; ++q) reprs_o[q * m + j] = reprs[q * n + j];
    for (int64_t q = 0; q < ncomp; ++q) ksql::copy_elem(c.out[q], j, c.contrib[q], j, c.size[q]);
    return;
  }
  const int64_t i = (j - n) / n;
  const int64_t r = (j - n) - i * n;
  int64_t slot = capacity;
  const int64_t h = khash[r];
  if (first_occ[r]) {
    const int64_t mask = capacity - 1;
    const int64_t base = static_cast<int64_t>(
        ksql::mix64(static_cast<uint64_t>(h) ^ (static_cast<uint64_t>(i) * ksql::kGold)) &
        static_cast<uint64_t>(mask));
    for (int64_t off = 0; off < KSQL_MAX_PROBES; ++off) {
      const int64_t cand = (base + off) & mask;
      const bool live = occ[cand];
      if (live && skh[cand] == h && sws[cand] == i) {
        slot = cand;
        break;
      }
      if (!live && !grave[cand]) break;  // truly empty: no such session
    }
  }
  const int64_t se = sess_end[slot];
  const bool alive =
      slot != capacity && ksql::wadd(ksql::wadd(se, gap), grace) >= scal[0];
  kh_o[j] = alive ? h : kSentinel + j;
  start_o[j] = alive ? sess_start[slot] : 0;
  end_o[j] = alive ? se : 0;
  alive_o[j] = alive;
  slot_o[j] = static_cast<int32_t>(slot);
  for (int64_t q = 0; q < k; ++q) reprs_o[q * m + j] = c.key[q][slot];
  for (int64_t q = 0; q < ncomp; ++q) ksql::copy_elem(c.out[q], j, c.col[q], slot, c.size[q]);
}

}  // namespace

extern "C" int ksql_session_prologue(const void* row_valid, const void* ts, const void* active_in,
                                     int64_t n, const void* max_ts, int64_t grace, int64_t gap,
                                     void* active_out, void* scal, void* stream) {
  prologue_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(row_valid), static_cast<const int64_t*>(ts),
      static_cast<const bool*>(active_in), n, static_cast<const int64_t*>(max_ts), grace, gap,
      static_cast<bool*>(active_out), static_cast<int64_t*>(scal));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_session_first(const void* order0, const void* khash, const void* active,
                                  int64_t n, void* first_occ, void* stream) {
  const int threads = 256;
  first_kernel<<<ksql::blocks_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(order0), static_cast<const int64_t*>(khash),
      static_cast<const bool*>(active), n, static_cast<bool*>(first_occ));
  return static_cast<int>(cudaGetLastError());
}

// keys: k store key<q> pointers; comps: ncomp x (store a<q>, contribution,
// item output, element bytes).
extern "C" int ksql_session_items(
    const void* occ, const void* grave, const void* skh, const void* sws, const void* sess_start,
    const void* sess_end, const int64_t* keys, int64_t k, const int64_t* comps, int64_t ncomp,
    int64_t capacity, int64_t S, const void* khash, const void* active, const void* first_occ,
    const void* ts, const void* reprs, int64_t n, int64_t gap, int64_t grace, const void* scal,
    void* kh_o, void* start_o, void* end_o, void* alive_o, void* slot_o, void* reprs_o,
    void* stream) {
  if (k > KSQL_MAX_KEYS || ncomp > KSQL_MAX_COMPS) return static_cast<int>(cudaErrorInvalidValue);
  ItemCols c{};
  for (int64_t q = 0; q < k; ++q) c.key[q] = reinterpret_cast<const int64_t*>(keys[q]);
  for (int64_t q = 0; q < ncomp; ++q) {
    c.col[q] = reinterpret_cast<const void*>(comps[4 * q]);
    c.contrib[q] = reinterpret_cast<const void*>(comps[4 * q + 1]);
    c.out[q] = reinterpret_cast<void*>(comps[4 * q + 2]);
    c.size[q] = comps[4 * q + 3];
  }
  const int64_t m = n * (S + 1);
  const int threads = 256;
  items_kernel<<<ksql::blocks_for(m, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(occ), static_cast<const bool*>(grave),
      static_cast<const int64_t*>(skh), static_cast<const int64_t*>(sws),
      static_cast<const int64_t*>(sess_start), static_cast<const int64_t*>(sess_end), c, k, ncomp,
      capacity, S, static_cast<const int64_t*>(khash), static_cast<const bool*>(active),
      static_cast<const bool*>(first_occ), static_cast<const int64_t*>(ts),
      static_cast<const int64_t*>(reprs), n, gap, grace, static_cast<const int64_t*>(scal),
      static_cast<int64_t*>(kh_o), static_cast<int64_t*>(start_o), static_cast<int64_t*>(end_o),
      static_cast<bool*>(alive_o), static_cast<int32_t*>(slot_o),
      static_cast<int64_t*>(reprs_o));
  return static_cast<int>(cudaGetLastError());
}
