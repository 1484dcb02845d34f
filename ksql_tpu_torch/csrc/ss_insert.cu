// K11 ss_insert: a stream-stream join batch's pads, admissions and ring
// insert into its own side's ring buffer.
//
// Replaces the rest of runtime/lowering.py:_trace_ss_step (B14): the
// running stream times, the eager/deferred pad mask, the admission mask,
// the sequence numbers and targets, ss_lost, the ring scatters and the
// clock updates.  Two launches, so that the caller can read the loss
// (and K10's match total) before any state is written:
//   1. prologue (one block of 1,024 threads; each owns a contiguous chunk
//      of the batch): the running max of ts over row_valid rows, seeded
//      with max_ts (cm_global, which times the pads) and with the side's
//      smax (cm_side, which decides admission); pad (a padding side's
//      active rows without a match, in deferred mode only those whose
//      window closed on arrival: ts + swin + grace < cm_global);
//      admitted (active, in deferred mode with ts >= cm_side - retention);
//      seqs = cursor + cumsum(admitted) - 1; tgt = seqs mod B for an
//      admitted row, else the dump entry B; and scal = (lost, admissions,
//      new max_ts, new smax, the highest row not admitted or -1).  The
//      loss counts admitted rows whose target is live and not expired
//      against the new clocks, judged on the ring before any write.
//   2. write (one thread a row): an admitted row writes ts, krepr, kval,
//      seq, matched = row_matched | pad, its columns and live = true at
//      its target.  The highest row not admitted writes the same fields to
//      the dump entry B, as the last of XLA's duplicate .at[B].set does,
//      and live[B] ends false.  Thread 0 advances the cursor by the
//      admissions and stores the new clocks.
// Admitted rows have distinct targets: a batch holds at most B rows.
// int64 sums wrap, as XLA's do (cm_side - retention with cm_side at
// INT64_MIN, ts + swin + grace).
//
// Bound: bytes, and launch latency.  Tens of bytes a row (2,048 rows at
// BASELINE #4's shapes: about 60 KB in all, 0.02 us at 3.35 TB/s); the
// one-block prologue runs its scans in shared memory.  Two launches of a
// few microseconds each are the real limit.
#include "common.cuh"

namespace {

__global__ void insert_prologue_kernel(const bool* __restrict__ row_valid,
                                       const int64_t* __restrict__ ts,
                                       const bool* __restrict__ active,
                                       const bool* __restrict__ row_matched, int64_t n,
                                       const int64_t* __restrict__ r_ts,
                                       const bool* __restrict__ r_live, int64_t B,
                                       const int64_t* __restrict__ max_ts_p,
                                       const int64_t* __restrict__ smax_p,
                                       const int64_t* __restrict__ cursor_p, int pad_side,
                                       int deferred, int64_t swin, int64_t grace, int64_t retention,
                                       bool* __restrict__ pad, bool* __restrict__ admitted,
                                       int64_t* __restrict__ seqs, int32_t* __restrict__ tgt,
                                       int64_t* __restrict__ scal) {
  __shared__ int64_t buf[1024];
  const int last = blockDim.x - 1;
  const int64_t max_ts = *max_ts_p, smax = *smax_p, cursor = *cursor_p;
  int64_t lo, hi;
  ksql::thread_chunk(n, &lo, &hi);
  // pass 1: the batch max of valid ts before each chunk, and in all
  int64_t cmax = INT64_MIN;
  for (int64_t i = lo; i < hi; ++i) {
    if (row_valid[i] && ts[i] > cmax) cmax = ts[i];
  }
  ksql::block_inclusive_scan(cmax, buf, ksql::MaxOp());
  const int64_t before_chunk = threadIdx.x > 0 ? buf[threadIdx.x - 1] : INT64_MIN;
  const int64_t batch_max = buf[last];
  __syncthreads();
  // pass 2: pads and admissions, from the running maxima
  int64_t run = before_chunk, n_adm = 0, last_out = -1;
  for (int64_t i = lo; i < hi; ++i) {
    if (row_valid[i] && ts[i] > run) run = ts[i];
    const int64_t cm_global = run > max_ts ? run : max_ts;
    const int64_t cm_side = run > smax ? run : smax;
    bool pd = false;
    if (pad_side && active[i] && !row_matched[i]) {
      pd = !deferred || ksql::wadd(ksql::wadd(ts[i], swin), grace) < cm_global;
    }
    const bool ad = active[i] && (!deferred || ts[i] >= ksql::wsub(cm_side, retention));
    pad[i] = pd;
    admitted[i] = ad;
    n_adm += ad;
    if (!ad) last_out = i;
  }
  const int64_t adm_before = ksql::block_inclusive_scan(n_adm, buf, ksql::AddOp()) - n_adm;
  const int64_t admissions = buf[last];
  __syncthreads();
  ksql::block_inclusive_scan(last_out, buf, ksql::MaxOp());
  const int64_t dump_row = buf[last];
  __syncthreads();
  // pass 3: sequence numbers, targets and the overwrite loss
  const int64_t new_max = batch_max > max_ts ? batch_max : max_ts;
  const int64_t new_smax = batch_max > smax ? batch_max : smax;
  int64_t c = adm_before, lost = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const bool ad = admitted[i];
    c += ad;
    const int64_t s = ksql::wsub(ksql::wadd(cursor, c), 1);
    seqs[i] = s;
    const int64_t e = ad ? ksql::floor_mod(s, B) : B;
    tgt[i] = static_cast<int32_t>(e);
    if (ad && r_live[e]) {
      const bool unexpired =
          deferred ? ksql::wadd(r_ts[e], retention) >= new_smax
                   : ksql::wadd(ksql::wadd(r_ts[e], swin), grace) >= new_max;
      lost += unexpired;
    }
  }
  ksql::block_inclusive_scan(lost, buf, ksql::AddOp());
  if (threadIdx.x == last) {
    scal[0] = buf[last];
    scal[1] = admissions;
    scal[2] = new_max;
    scal[3] = new_smax;
    scal[4] = dump_row;
  }
}

struct OwnRing {
  int64_t* ts;
  int64_t* krepr;
  bool* kval;
  bool* live;
  bool* matched;
  int64_t* seq;
};

__global__ void insert_write_kernel(const int64_t* __restrict__ ts,
                                    const int64_t* __restrict__ krepr,
                                    const bool* __restrict__ kvalid,
                                    const bool* __restrict__ row_matched,
                                    const bool* __restrict__ pad, const bool* __restrict__ admitted,
                                    const int64_t* __restrict__ seqs,
                                    const int32_t* __restrict__ tgt,
                                    const int64_t* __restrict__ scal, int64_t n, OwnRing r,
                                    int64_t B, ksql::Gather cols, int64_t* __restrict__ cursor,
                                    int64_t* __restrict__ max_ts, int64_t* __restrict__ smax) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) {
    *cursor = ksql::wadd(*cursor, scal[1]);
    *max_ts = scal[2];
    *smax = scal[3];
    r.live[B] = false;
  }
  if (i >= n) return;
  const bool ad = admitted[i];
  if (!ad && i != scal[4]) return;
  const int64_t e = ad ? tgt[i] : B;
  r.ts[e] = ts[i];
  r.krepr[e] = krepr[i];
  r.kval[e] = kvalid[i];
  r.seq[e] = seqs[i];
  r.matched[e] = row_matched[i] || pad[i];
  if (ad) r.live[e] = true;
  for (int64_t c = 0; c < cols.count; ++c) {
    ksql::copy_elem(cols.vdst[c], e, cols.vsrc[c], i, cols.size[c]);
    cols.mdst[c][e] = cols.msrc[c][i];
  }
}

}  // namespace

extern "C" int ksql_ss_insert_prologue(const void* row_valid, const void* ts, const void* active,
                                       const void* row_matched, int64_t n, const void* r_ts,
                                       const void* r_live, int64_t B, const void* max_ts,
                                       const void* smax, const void* cursor, int64_t pad_side,
                                       int64_t deferred, int64_t swin, int64_t grace,
                                       int64_t retention, void* pad, void* admitted, void* seqs,
                                       void* tgt, void* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  insert_prologue_kernel<<<1, 1024, 0, st>>>(
      static_cast<const bool*>(row_valid), static_cast<const int64_t*>(ts),
      static_cast<const bool*>(active), static_cast<const bool*>(row_matched), n,
      static_cast<const int64_t*>(r_ts), static_cast<const bool*>(r_live), B,
      static_cast<const int64_t*>(max_ts), static_cast<const int64_t*>(smax),
      static_cast<const int64_t*>(cursor), static_cast<int>(pad_side),
      static_cast<int>(deferred), swin, grace, retention, static_cast<bool*>(pad),
      static_cast<bool*>(admitted), static_cast<int64_t*>(seqs), static_cast<int32_t*>(tgt),
      static_cast<int64_t*>(scal));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ksql_ss_insert_write(const void* ts, const void* krepr, const void* kvalid,
                                    const void* row_matched, const void* pad,
                                    const void* admitted, const void* seqs, const void* tgt,
                                    const void* scal, int64_t n, void* r_ts, void* r_krepr,
                                    void* r_kval, void* r_live, void* r_matched, void* r_seq,
                                    int64_t B, const int64_t* desc, int64_t count, void* cursor,
                                    void* max_ts, void* smax, void* stream) {
  ksql::Gather cols;
  if (!ksql::gather_from_desc(desc, count, &cols)) return static_cast<int>(cudaErrorInvalidValue);
  const OwnRing r{static_cast<int64_t*>(r_ts), static_cast<int64_t*>(r_krepr),
                  static_cast<bool*>(r_kval), static_cast<bool*>(r_live),
                  static_cast<bool*>(r_matched), static_cast<int64_t*>(r_seq)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  insert_write_kernel<<<ksql::blocks_for(n, threads), threads, 0, st>>>(
      static_cast<const int64_t*>(ts), static_cast<const int64_t*>(krepr),
      static_cast<const bool*>(kvalid), static_cast<const bool*>(row_matched),
      static_cast<const bool*>(pad), static_cast<const bool*>(admitted),
      static_cast<const int64_t*>(seqs), static_cast<const int32_t*>(tgt),
      static_cast<const int64_t*>(scal), n, r, B, cols, static_cast<int64_t*>(cursor),
      static_cast<int64_t*>(max_ts), static_cast<int64_t*>(smax));
  return static_cast<int>(cudaGetLastError());
}
