// K25 tap_residual: every lane of a push-tap predicate family over a span.
//
// Replaces server/tap_kernel.py:_lane_fn of the reference, vmapped over the
// lanes in _LaneGroup.fn (_trace_group, :414-433).  The family's WHERE chain
// is lowered once on the host (ops/tap_residual.py:build_program) to a flat
// postfix program of typed instructions (op, a, b, dt), then rewritten for
// this kernel (lower_for_kernel there); this one fixed kernel interprets it.  Per (lane l, row r):
//   masks[l, r] = active[l] && row_valid[r] && every FILTER of the program
//                 saw a valid, true value,
//   counts[l]   = min(sum_r masks[l, r], limits[l]).
// Values are (64-bit bits, valid) pairs on a stack: int32 values
// sign-extended, bools 0/1, doubles by their bits.  Integer arithmetic wraps
// (XLA's int32/int64), integer / and % truncate with a zero divisor making the
// value NULL and MIN / -1 wrapping to MIN (remainder 0); float / is IEEE and
// float % by 0 is NaN; a DECIMAL / or % by 0 is NULL.  A comparison is always
// valid: a NULL operand makes it false, except IS [NOT] DISTINCT FROM.  AND
// and OR are three-valued; NOT keeps the validity.  SELECT (CASE, its WHENs
// nested from the last) pops a condition, an else and a then value and keeps
// the then value where the condition is valid and true.  SQLCAST is a SQL
// CAST's own arithmetic: a double to an integer truncated toward zero,
// saturated at the type's range, NaN to 0 (XLA's conversion); a double to
// DECIMAL(p, s) rounded HALF_UP at scale s (floor(x 10^s + 0.5) / 10^s, or
// the ceil of x 10^s - 0.5 below 0, each operation rounded on its own, no
// fused multiply-add) and NULL where |result| >= 10^(p - s); epoch days to
// ms, and ms to epoch days and to time of day, both floored.
//
// One launch (tap_tile_kernel).  A block takes a tile of kTile = kThreads x
// kRows rows and a group of up to kMaxGroup lanes:
//   * it stages the columns the program reads (data widened to 64 bits and
//     validity) for its tile in shared memory once, and its lanes'
//     parameters, and reuses them for every lane of its group;
//   * a thread evaluates kRows consecutive rows, decoding each instruction
//     once for them; the tile is staged transposed (row i at i % kRows, i /
//     kRows), so a warp's loads of one of its rows, and its stack, are
//     conflict-free;
//   * the host annotates each instruction with its stack depth (static in a
//     postfix program), so the top two stack entries live in registers and
//     deeper ones at fixed shared-memory levels [depth][row][thread]; it
//     also drops the casts that keep a value's bits and fuses a parameter
//     pushed for the binary op right after it into that op (no push, no
//     pop: the mod family's 8 instructions run as 4), and numbers the
//     columns the program loads in the order it first loads them;
//   * the masks: each thread writes its rows' mask bytes as one word;
//   * the counts: a warp sum of the threads' popcounts, summed per lane in
//     the block; with one tile a block writes min(sum, limit) itself, else
//     it adds its sum into the lane's accumulator and the last block of the
//     lane (a ticket) clips it and resets both words to 0 for the next call;
//   * the grid: the fewest lanes a block that keep it within one wave of
//     resident blocks (a second, short wave doubled the small spans' time).
// The program and the staged column table are a __grid_constant__ parameter
// (constant memory).  Integer / and % take a 32-bit division where both
// operands fit in int32 (the same quotient), else the 64-bit one.
//
// Bound: bytes.  It reads once each column that the program loads (data and
// validity) and each parameter that it reads, active, row_valid and limits,
// and writes lanes x rows mask bytes and the counts: at 4,096 lanes x 8,192
// rows the masks alone are 33.5 MB, ~10 us at 3.35 TB/s, while the program's
// ~10 operations per (lane, row) are ~5 us at 67 TOP/s; the interpreter's
// decode and the 64-bit values cost several instructions per operation.
#include "common.cuh"

#define TAP_MAX_INSTR 128
#define TAP_MAX_COLS 16
#define TAP_MAX_DEPTH 16
#define TAP_MAX_PARAMS 64

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // consecutive rows a thread
constexpr int kTile = kThreads * kRows;
constexpr int kMaxGroup = 16;  // lanes a block at most
constexpr int kWaves = 1;  // lane groups shrink until the grid fills this many waves of blocks
// registers held to 64 a thread so that 8 blocks fit an SM (unbounded,
// ptxas took 72: 7 blocks, 3-8% slower; 12 blocks spill)
constexpr int kBlocksPerSm = 8;
constexpr uint32_t kAll = (1u << kRows) - 1;

// opcodes and dtype codes of ops/tap_residual.py
enum Op : int32_t {
  kCol = 0, kParamI = 1, kParamF = 2, kConst = 3, kCast = 4, kAdd = 5, kSub = 6, kMul = 7,
  kDiv = 8, kMod = 9, kNeg = 10, kCmp = 11, kAnd = 12, kOr = 13, kNot = 14, kIsNull = 15,
  kFilter = 16, kSelect = 17, kSqlCast = 18,
  // the host's rewrite (OP_FUSED): a parameter pushed (and cast) for the
  // binary op that takes it as its right operand, as one instruction: a =
  // the op, its code, decimal flag and dtype (a byte each); b = the push's
  // opcode, dtype and the cast's target (a byte each); dt = the parameter's
  // index
  kFused = 19
};
// SQLCAST kinds (ops/tap_residual.py SC_*)
enum CastKind : int32_t { kF2I = 0, kDecimal = 1, kDaysToMs = 2, kMsToDays = 3, kMsToTime = 4 };
constexpr int64_t kDayMs = 86400000;
// 10^0 .. 10^22, each exact in a double (DECIMAL casts take no other scale)
__constant__ double kPow10[23] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                                  1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                                  1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
enum Dt : int32_t { kI32 = 0, kI64 = 1, kF64 = 2, kBool = 3 };

struct TapProgram {
  int32_t code[TAP_MAX_INSTR * 4];  // (op, a, b, dt); a kCol's a is its staged column
  uint8_t depth[TAP_MAX_INSTR];     // the stack depth before each instruction
  const void* data[TAP_MAX_COLS];   // the staged columns: those the program loads
  const bool* valid[TAP_MAX_COLS];
  int32_t dt[TAP_MAX_COLS];
  int32_t n_instr, n_cols, levels;  // levels: the stack positions kept in shared memory
};

__device__ __forceinline__ double as_f(int64_t v) { return __longlong_as_double(v); }
__device__ __forceinline__ int64_t of_f(double d) { return __double_as_longlong(d); }
__device__ __forceinline__ int64_t wrap32(uint32_t v) {
  return static_cast<int64_t>(static_cast<int32_t>(v));
}
__device__ __forceinline__ bool fits32(int64_t v) {
  return v == static_cast<int64_t>(static_cast<int32_t>(v));
}

// a value of dtype `from` converted to `to` (only the casts build_program emits:
// widening and to-bool; a float to-bool is `!= 0`, so NaN is true)
__device__ __forceinline__ int64_t cast(int64_t v, int32_t from, int32_t to) {
  if (from == to) return v;
  if (to == kBool) return from == kF64 ? (as_f(v) != 0.0) : (v != 0);
  if (to == kF64) return of_f(static_cast<double>(v));
  if (to == kI32) return wrap32(static_cast<uint32_t>(static_cast<uint64_t>(v)));
  return v;  // int32 or bool to int64: already widened
}

// The heavy, rarer operations stay out of line: the interpreter's hot loop
// (a copy per row) stays small enough for the instruction cache.

// 64-bit integer / or % of operands already made safe
__device__ __noinline__ int64_t div64(bool mod, int64_t x, int64_t safe) {
  return mod ? x % safe : x / safe;
}

// integer / and %: truncating, a zero divisor is NULL, MIN / -1 wraps; a
// 32-bit division where both operands fit (x == INT32_MIN excluded: its
// quotient by -1 does not)
__device__ __forceinline__ int64_t int_div(bool mod, int32_t dt, int64_t x, int64_t y, bool& valid) {
  const int64_t lo = dt == kI32 ? INT32_MIN : INT64_MIN;
  const bool zero = y == 0;
  const int64_t safe = (zero || (x == lo && y == -1)) ? 1 : y;
  valid = valid && !zero;
  if (fits32(x) && fits32(safe) && x != INT32_MIN) {
    const int32_t a = static_cast<int32_t>(x), b = static_cast<int32_t>(safe);
    return mod ? a % b : a / b;
  }
  return div64(mod, x, safe);
}

// float / and % (DECIMAL ones: a zero divisor is NULL; others IEEE, % by 0 NaN)
__device__ __noinline__ int64_t float_div(bool mod, bool dec, int64_t x, int64_t y, bool& valid) {
  const double a = as_f(x), b = as_f(y);
  if (dec) {
    const bool zero = b == 0.0;
    const double safe = zero ? 1.0 : b;
    valid = valid && !zero;
    return of_f(mod ? fmod(a, safe) : a / safe);
  }
  if (!mod) return of_f(a / b);
  return of_f(b != 0.0 ? fmod(a, b) : __longlong_as_double(0x7ff8000000000000ll));
}

// a SQL CAST's arithmetic on value v (bits), its validity updated in place
__device__ __noinline__ int64_t sql_cast(int32_t kind, int32_t b, int32_t dt, int64_t v,
                                         bool& valid) {
  switch (kind) {
    case kF2I: {
      const double x = trunc(as_f(v));
      if (dt == kI32) {
        if (x != x) return 0;
        if (x >= 2147483648.0) return INT32_MAX;
        if (x <= -2147483649.0) return INT32_MIN;
        return static_cast<int64_t>(static_cast<int32_t>(x));
      }
      if (x != x) return 0;
      if (x >= 9223372036854775808.0) return INT64_MAX;
      if (x < -9223372036854775808.0) return INT64_MIN;
      return static_cast<int64_t>(x);
    }
    case kDecimal: {
      const double x = as_f(v), f = kPow10[b / 64], limit = kPow10[b % 64];
      const double scaled = __dmul_rn(x, f);
      const double r = x >= 0.0 ? floor(__dadd_rn(scaled, 0.5)) : ceil(__dsub_rn(scaled, 0.5));
      const double out = __ddiv_rn(r, f);
      valid = valid && fabs(out) < limit;
      return of_f(out);
    }
    case kDaysToMs:
      return ksql::wmul(v, kDayMs);
    default: {
      // floored division by a day (toward -inf for pre-epoch values)
      int64_t q = v / kDayMs;
      if (v % kDayMs != 0 && v < 0) --q;
      return kind == kMsToDays ? q : v - q * kDayMs;
    }
  }
}

__device__ __forceinline__ bool compare(int32_t code, int32_t dt, int64_t x, int64_t y) {
  if (dt == kF64) {
    const double a = as_f(x), b = as_f(y);
    switch (code) {
      case 0: case 7: return a == b;
      case 1: case 6: return a != b;
      case 2: return a < b;
      case 3: return a <= b;
      case 4: return a > b;
      default: return a >= b;
    }
  }
  switch (code) {
    case 0: case 7: return x == y;
    case 1: case 6: return x != y;
    case 2: return x < y;
    case 3: return x <= y;
    case 4: return x > y;
    default: return x >= y;
  }
}

// The stack levels kept in shared memory: level p (a stack position) holds
// a thread's kRows values at sv[(p * kRows + k) * kThreads + t] and their
// validity bits at sb[p * kThreads + t].
struct Levels {
  int64_t* sv;
  uint8_t* sb;
  __device__ __forceinline__ void put(int p, const int64_t (&v)[kRows], uint32_t bits) const {
#pragma unroll
    for (int k = 0; k < kRows; ++k) sv[(p * kRows + k) * kThreads + threadIdx.x] = v[k];
    sb[p * kThreads + threadIdx.x] = static_cast<uint8_t>(bits);
  }
  __device__ __forceinline__ uint32_t get(int p, int64_t (&v)[kRows]) const {
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = sv[(p * kRows + k) * kThreads + threadIdx.x];
    return sb[p * kThreads + threadIdx.x];
  }
};

__device__ __forceinline__ uint32_t nonzero(const int64_t (&v)[kRows]) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) bits |= static_cast<uint32_t>(v[k] != 0) << k;
  return bits;
}

// The program for one lane over this thread's kRows rows of the tile: the
// bits of the rows where every filter passed.  t/tb is the top of the stack
// (position d - 1 before an instruction of depth d), s/sb the one below.
__device__ uint32_t run(const TapProgram& p, const int64_t* __restrict__ cv,
                        const uint8_t* __restrict__ cb, const int64_t* __restrict__ pi,
                        const double* __restrict__ pf, const Levels& lv) {
  int64_t t[kRows], s[kRows];
  uint32_t tb = 0, nb = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) t[k] = s[k] = 0;
  uint32_t pass = kAll;
  for (int pc = 0; pc < p.n_instr; ++pc) {
    const int32_t op = p.code[4 * pc];
    const int32_t a = p.code[4 * pc + 1];
    const int32_t b = p.code[4 * pc + 2];
    const int32_t dt = p.code[4 * pc + 3];
    const int d = p.depth[pc];
    switch (op) {
      case kCol: case kParamI: case kParamF: case kConst: {
        if (d >= 2) lv.put(d - 2, s, nb);
#pragma unroll
        for (int k = 0; k < kRows; ++k) s[k] = t[k];
        nb = tb;
        if (op == kCol) {
          tb = 0;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            t[k] = cv[a * kTile + k * kThreads + threadIdx.x];
            tb |= static_cast<uint32_t>(cb[a * kTile + k * kThreads + threadIdx.x]) << k;
          }
        } else {
          const int64_t v = op == kParamI ? cast(pi[a], kI64, dt)
                            : op == kParamF ? cast(of_f(pf[a]), kF64, dt)
                                            : static_cast<int64_t>(a);
#pragma unroll
          for (int k = 0; k < kRows; ++k) t[k] = v;
          tb = (op == kConst && b == 0) ? 0 : kAll;
        }
        break;
      }
      case kCast:
#pragma unroll
        for (int k = 0; k < kRows; ++k) t[k] = cast(t[k], a, dt);
        break;
      case kNeg:
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int64_t v = t[k];
          t[k] = dt == kF64 ? of_f(-as_f(v))
                 : dt == kI32 ? wrap32(0u - static_cast<uint32_t>(v))
                              : ksql::wsub(0, v);
        }
        break;
      case kNot:
#pragma unroll
        for (int k = 0; k < kRows; ++k) t[k] = t[k] == 0;
        break;
      case kIsNull:
#pragma unroll
        for (int k = 0; k < kRows; ++k) t[k] = ((tb >> k) & 1u) == static_cast<uint32_t>(a != 0);
        tb = kAll;
        break;
      case kSqlCast:
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          bool v = (tb >> k) & 1u;
          t[k] = sql_cast(a, b, dt, t[k], v);
          tb = (tb & ~(1u << k)) | (static_cast<uint32_t>(v) << k);
        }
        break;
      case kFilter:
        pass &= tb & nonzero(t);
#pragma unroll
        for (int k = 0; k < kRows; ++k) t[k] = s[k];
        tb = nb;
        if (d >= 3) nb = lv.get(d - 3, s);
        break;
      case kSelect: {
        // stack: ..., then (position d - 3), else (s), condition (t)
        int64_t then[kRows];
        const uint32_t thb = lv.get(d - 3, then);
        const uint32_t fire = tb & nonzero(t);
#pragma unroll
        for (int k = 0; k < kRows; ++k) t[k] = ((fire >> k) & 1u) ? then[k] : s[k];
        tb = (fire & thb) | (~fire & nb & kAll);
        if (d >= 4) nb = lv.get(d - 4, s);
        break;
      }
      default: {  // binary: x op y, x = s and y = t; a fused parameter: x = t, y = the parameter
        const bool fused = op == kFused;
        int32_t bop = op, code = a, dec = b, bdt = dt;
        int64_t x[kRows], y[kRows];
        uint32_t xb = nb, yb = tb;
        if (fused) {
          bop = a & 0xFF, code = (a >> 8) & 0xFF, dec = (a >> 16) & 0xFF, bdt = (a >> 24) & 0xFF;
          const int32_t src = b & 0xFF, pdt = (b >> 8) & 0xFF, cdt = (b >> 16) & 0xFF;
          const int64_t pv = cast(src == kParamI ? cast(pi[dt], kI64, pdt) : cast(of_f(pf[dt]), kF64, pdt),
                                  pdt, cdt);
#pragma unroll
          for (int k = 0; k < kRows; ++k) x[k] = t[k], y[k] = pv;
          xb = tb, yb = kAll;
        } else {
#pragma unroll
          for (int k = 0; k < kRows; ++k) x[k] = s[k], y[k] = t[k];
        }
        uint32_t out = xb & yb;
        if (bop == kCmp) {
          uint32_t c = 0;
          if (bdt == kF64) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) c |= static_cast<uint32_t>(compare(code, kF64, x[k], y[k])) << k;
          } else {
            uint32_t lt = 0, eq = 0;
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              lt |= static_cast<uint32_t>(x[k] < y[k]) << k;
              eq |= static_cast<uint32_t>(x[k] == y[k]) << k;
            }
            c = (code == 0 || code == 7) ? eq : (code == 1 || code == 6) ? ~eq : code == 2 ? lt
                : code == 3 ? (lt | eq) : code == 4 ? ~(lt | eq) : ~lt;
          }
          // a NULL operand makes a comparison false, but IS [NOT] DISTINCT
          // FROM compares the validity bits then
          if (code == 6 || code == 7) {
            const uint32_t diff = xb ^ yb;
            c = (c & out) | (~out & (code == 6 ? diff : ~diff));
          } else {
            c &= out;
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) t[k] = (c >> k) & 1u;
          out = kAll;
        } else if (bop == kAdd || bop == kSub || bop == kMul) {
          if (bdt == kF64) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const double u = as_f(x[k]), v = as_f(y[k]);
              t[k] = of_f(bop == kAdd ? u + v : bop == kSub ? u - v : u * v);
            }
          } else if (bdt == kI32) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const uint32_t u = static_cast<uint32_t>(x[k]), v = static_cast<uint32_t>(y[k]);
              t[k] = wrap32(bop == kAdd ? u + v : bop == kSub ? u - v : u * v);
            }
          } else {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              t[k] = bop == kAdd ? ksql::wadd(x[k], y[k]) : bop == kSub ? ksql::wsub(x[k], y[k])
                                                                       : ksql::wmul(x[k], y[k]);
            }
          }
        } else if (bop == kDiv || bop == kMod) {
          uint32_t v = 0;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            bool valid = (out >> k) & 1u;
            t[k] = bdt == kF64 ? float_div(bop == kMod, dec != 0, x[k], y[k], valid)
                               : int_div(bop == kMod, bdt, x[k], y[k], valid);
            v |= static_cast<uint32_t>(valid) << k;
          }
          out = v;
        } else {  // AND, OR
          uint32_t v = 0;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const bool vx = (xb >> k) & 1u, vy = (yb >> k) & 1u;
            const bool av = vx && x[k] != 0, bv = vy && y[k] != 0;
            bool valid = vx && vy;
            if (bop == kAnd) {  // false AND NULL is false
              t[k] = av && bv;
              valid = valid || (vx && x[k] == 0) || (vy && y[k] == 0);
            } else {
              t[k] = av || bv;
              valid = valid || av || bv;
            }
            v |= static_cast<uint32_t>(valid) << k;
          }
          out = v;
        }
        tb = out & kAll;
        if (!fused && d >= 3) nb = lv.get(d - 3, s);
        break;
      }
    }
  }
  return pass;
}

// 4 mask bits as 4 bytes of 0/1
__device__ __forceinline__ uint32_t spread4(uint32_t nib) { return (nib * 0x00204081u) & 0x01010101u; }

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) tap_tile_kernel(
    const __grid_constant__ TapProgram prog, const int64_t* __restrict__ P_i, int64_t n_i,
    const double* __restrict__ P_f, int64_t n_f, const bool* __restrict__ active,
    const bool* __restrict__ row_valid, int64_t rows, int64_t lanes, int group,
    const int64_t* __restrict__ limits, bool* __restrict__ masks, int64_t* __restrict__ counts,
    unsigned long long* __restrict__ acc, unsigned long long* __restrict__ tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long lane_sum[kMaxGroup];
  int64_t* cv = reinterpret_cast<int64_t*>(smem);
  int64_t* pi = cv + prog.n_cols * kTile;
  double* pf = reinterpret_cast<double*>(pi + group * n_i);
  int64_t* sv = reinterpret_cast<int64_t*>(pf + group * n_f);
  uint8_t* cb = reinterpret_cast<uint8_t*>(sv + prog.levels * kTile);
  const Levels lv{sv, cb + prog.n_cols * kTile};
  const int tid = threadIdx.x, lane_id = tid & 31;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.y) * group;
  const int members = static_cast<int>(lanes - lane0 < group ? lanes - lane0 : group);
  for (int i = tid; i < prog.n_cols * kTile; i += kThreads) {
    const int c = i / kTile, w = i % kTile;
    const int64_t r = tile0 + w;
    int64_t v = 0;
    bool ok = false;
    if (r < rows) {
      const void* d = prog.data[c];
      switch (prog.dt[c]) {
        case kI32: v = static_cast<const int32_t*>(d)[r]; break;
        case kBool: v = static_cast<const bool*>(d)[r] ? 1 : 0; break;
        default: v = static_cast<const int64_t*>(d)[r]; break;  // int64, double bits
      }
      ok = prog.valid[c][r];
    }
    const int at = c * kTile + (w % kRows) * kThreads + w / kRows;  // transposed
    cv[at] = v;
    cb[at] = ok;
  }
  for (int i = tid; i < members * n_i; i += kThreads) pi[i] = P_i[lane0 * n_i + i];
  for (int i = tid; i < members * n_f; i += kThreads) pf[i] = P_f[lane0 * n_f + i];
  for (int g = tid; g < kMaxGroup; g += kThreads) lane_sum[g] = 0;
  const int64_t r0 = tile0 + static_cast<int64_t>(tid) * kRows;  // this thread's first row
  uint32_t live = 0;  // its rows that exist and are valid
#pragma unroll
  for (int k = 0; k < kRows; ++k) live |= static_cast<uint32_t>(r0 + k < rows && row_valid[r0 + k]) << k;
  __syncthreads();
  for (int g = 0; g < members; ++g) {
    const int64_t lane = lane0 + g;
    const uint32_t pass = active[lane] ? (run(prog, cv, cb, pi + g * n_i, pf + g * n_f, lv) & live) : 0;
    const unsigned n_pass = __reduce_add_sync(0xffffffffu, __popc(pass));
    if (lane_id == 0 && n_pass) atomicAdd(&lane_sum[g], static_cast<unsigned long long>(n_pass));
    bool* dst = masks + lane * rows + r0;
    if (r0 + kRows <= rows && kRows % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & (kRows - 1)) == 0) {
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) reinterpret_cast<uint32_t*>(dst)[q] = spread4((pass >> (4 * q)) & 0xFu);
    } else {
      for (int k = 0; k < kRows && r0 + k < rows; ++k) dst[k] = (pass >> k) & 1u;
    }
  }
  __syncthreads();
  for (int g = tid; g < members; g += kThreads) {
    const int64_t lane = lane0 + g;
    unsigned long long total = lane_sum[g];
    if (gridDim.x > 1) {
      atomicAdd(&acc[lane], total);
      __threadfence();
      if (atomicAdd(&tickets[lane], 1ull) != gridDim.x - 1) continue;
      __threadfence();
      total = atomicExch(&acc[lane], 0ull);
      tickets[lane] = 0;
    }
    const int64_t sum = static_cast<int64_t>(total);
    counts[lane] = sum < limits[lane] ? sum : limits[lane];
  }
}

int g_smem_max[64];  // the dynamic shared memory tap_tile_kernel was allowed, per device
int64_t g_wave[64];  // per device, the blocks of kWaves waves at the shared memory below
size_t g_wave_smem[64];

}  // namespace

// code: n_instr rows of (op, a, b, dt, depth before it), the program as the
// host rewrote it for this kernel, `depth` its deepest stack; cols: n_cols
// rows of (data pointer, validity pointer, dtype code), the columns it
// loads in its own numbering; both in host memory, copied into the launch's
// parameter struct.  scratch: 2 * lanes 64-bit words, 0 on entry and left 0
// (each lane's count accumulator, then its ticket).
extern "C" int ksql_tap_residual(const int64_t* code, int64_t n_instr, int64_t depth,
                                 const int64_t* cols, int64_t n_cols, const void* P_i, int64_t n_i,
                                 const void* P_f, int64_t n_f, const void* active,
                                 const void* row_valid, int64_t rows, int64_t lanes,
                                 const void* limits, void* masks, void* counts, void* scratch,
                                 void* stream) {
  if (n_instr > TAP_MAX_INSTR || n_cols > TAP_MAX_COLS || depth > TAP_MAX_DEPTH ||
      n_i > TAP_MAX_PARAMS || n_f > TAP_MAX_PARAMS || rows >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapProgram prog;
  for (int64_t i = 0; i < n_instr; ++i) {
    const int64_t* ins = code + 5 * i;
    if (ins[0] < 0 || ins[0] > kFused || ins[4] < 0 || ins[4] > depth ||
        (ins[0] == kCol && (ins[1] < 0 || ins[1] >= n_cols))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int q = 0; q < 4; ++q) prog.code[4 * i + q] = static_cast<int32_t>(ins[q]);
    prog.depth[i] = static_cast<uint8_t>(ins[4]);
  }
  for (int64_t c = 0; c < n_cols; ++c) {
    prog.data[c] = reinterpret_cast<const void*>(cols[3 * c]);
    prog.valid[c] = reinterpret_cast<const bool*>(cols[3 * c + 1]);
    prog.dt[c] = static_cast<int32_t>(cols[3 * c + 2]);
  }
  prog.n_instr = static_cast<int32_t>(n_instr);
  prog.n_cols = static_cast<int32_t>(n_cols);
  prog.levels = static_cast<int32_t>(depth > 2 ? depth - 2 : 0);
  if (lanes == 0) return 0;
  const int64_t tiles = rows > 0 ? (rows + kTile - 1) / kTile : 1;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  // the dynamic shared memory of a block of `group` lanes; the occupancy
  // is taken at kMaxGroup's (the most a block can need)
  auto smem_of = [&](int64_t group) {
    return static_cast<size_t>(prog.n_cols) * kTile * 9 + static_cast<size_t>(group) * (n_i + n_f) * 8 +
           static_cast<size_t>(prog.levels) * (kTile * 8 + kThreads);
  };
  const size_t smem_top = smem_of(kMaxGroup);
  if (smem_top > 48 * 1024 && static_cast<size_t>(g_smem_max[dev]) < smem_top) {
    int most_smem = 0;
    err = cudaDeviceGetAttribute(&most_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(tap_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most_smem - static_cast<int>(kMaxGroup * sizeof(unsigned long long)));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_max[dev] = most_smem - static_cast<int>(kMaxGroup * sizeof(unsigned long long));
  }
  // the fewest lanes a block that keep the grid within kWaves waves
  if (g_wave_smem[dev] != smem_top || g_wave[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tap_tile_kernel, kThreads, smem_top);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_wave[dev] = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms * kWaves;
    g_wave_smem[dev] = smem_top;
  }
  int64_t group = (tiles * lanes + g_wave[dev] - 1) / g_wave[dev];
  group = group < 1 ? 1 : (group > kMaxGroup ? kMaxGroup : group);
  const int64_t groups = (lanes + group - 1) / group;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of(group);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  auto* sc = static_cast<unsigned long long*>(scratch);
  tap_tile_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prog, static_cast<const int64_t*>(P_i), n_i, static_cast<const double*>(P_f), n_f,
      static_cast<const bool*>(active), static_cast<const bool*>(row_valid), rows, lanes,
      static_cast<int>(group), static_cast<const int64_t*>(limits), static_cast<bool*>(masks),
      static_cast<int64_t*>(counts), sc, sc + lanes);
  return static_cast<int>(cudaGetLastError());
}
