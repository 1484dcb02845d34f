// K22 vec_hist: the histogram's count fold (HISTOGRAM, ATTR), after K20's
// hist mode has appended the batch's new distinct values.
//
// Replaces phase 2 of ops/hash_store.py:_vec_hist (B18).  State per slot:
// cnt (int64), data[K] (int64 value codes), vbit[K] (int8 null bits) and
// num[K] (int64 counts).  One warp a row whose signed head is not 0: a row
// contributes when its slot is not the dump slot C; it scans the prefix of
// min(cnt, K) entries of its slot (of the dump row when it does not
// contribute) for the first entry equal to its (code, bit) — ballots over
// 32 entries at a time, the lowest set lane first — and atomicAdds its head
// into num[slot, pos] when it contributes and found one, else into
// num[C, pos] (pos: the match in the dump row, or 0; the reference's argmax
// of an all-false row is 0).  int64 adds wrap (unsigned atomics) and are
// exact in any order, so the result is the reference's bit for bit.
//
// Bound: bytes.  The least work reads the batch (head, code, bit, slot: 21
// bytes a row) and each row's matched prefix (9 bytes an entry up to the
// match) and read-modify-writes one count; hot slots' prefixes stay in L2.
#include "common.cuh"

namespace {

__global__ void hist_count_kernel(const int64_t* __restrict__ cnt,
                                  const int64_t* __restrict__ data,
                                  const int8_t* __restrict__ vbit, int64_t* __restrict__ num,
                                  int64_t K, int64_t cap, const int64_t* __restrict__ head,
                                  const int64_t* __restrict__ vals,
                                  const int8_t* __restrict__ vbits,
                                  const int32_t* __restrict__ slots, int64_t n) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n) return;
  const int64_t h = head[r];
  if (h == 0) return;  // adds nothing
  const int64_t slot = slots[r];
  const bool contributing = slot != cap;
  const int64_t e = contributing ? slot : cap;
  const int64_t c = cnt[e];
  const int64_t m = c < K ? c : K;
  const int64_t v = vals[r];
  const int8_t b = vbits[r];
  int64_t pos = -1;
  for (int64_t base = 0; base < m && pos < 0; base += 32) {
    const int64_t p = base + lane;
    const bool eq = p < m && data[e * K + p] == v && vbit[e * K + p] == b;
    const unsigned mask = __ballot_sync(0xffffffffu, eq);
    if (mask != 0) pos = base + __ffs(mask) - 1;
  }
  if (lane != 0) return;
  const int64_t t_slot = (contributing && pos >= 0) ? e : cap;
  const int64_t t_pos = pos >= 0 ? pos : 0;
  atomicAdd(reinterpret_cast<unsigned long long*>(num + t_slot * K + t_pos),
            static_cast<unsigned long long>(h));
}

}  // namespace

extern "C" int ksql_vec_hist(const void* cnt, const void* data, const void* vbit, void* num,
                             int64_t K, int64_t capacity, const void* head, const void* vals,
                             const void* vbits, const void* slots, int64_t n, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  hist_count_kernel<<<static_cast<int>(blocks < 1 ? 1 : blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cnt), static_cast<const int64_t*>(data),
      static_cast<const int8_t*>(vbit), static_cast<int64_t*>(num), K, capacity,
      static_cast<const int64_t*>(head), static_cast<const int64_t*>(vals),
      static_cast<const int8_t*>(vbits), static_cast<const int32_t*>(slots), n);
  return static_cast<int>(cudaGetLastError());
}
