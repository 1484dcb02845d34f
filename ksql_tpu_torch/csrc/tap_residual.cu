// K25 tap_residual: every lane of a push-tap predicate family over a span.
//
// Replaces server/tap_kernel.py:_lane_fn of the reference, vmapped over the
// lanes in _LaneGroup.fn (_trace_group, :414-433).  The family's WHERE chain
// is lowered once on the host (ops/tap_residual.py:build_program) to a flat
// postfix program of typed instructions (op, a, b, dt); this one fixed kernel
// interprets it.  Per (lane l, row r):
//   masks[l, r] = active[l] && row_valid[r] && every FILTER of the program
//                 saw a valid, true value,
//   counts[l]   = min(sum_r masks[l, r], limits[l]).
// Values are (64-bit bits, valid) pairs on a per-thread stack: int32 values
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
// Layout: one thread per (lane, row), rows along threadIdx.x (column loads
// coalesce), lanes along blockIdx.y; the block reads its lane's parameters
// into shared memory once.  The program and the column table are a
// __grid_constant__ parameter (constant memory).  Counts: a warp ballot and
// popcount, one atomicAdd per warp into the lane's counter; a second launch
// clips them by the LIMIT budgets.
//
// Bound: bytes.  It reads once each column that the program loads (data and
// validity; ROWTIME only where the program reads it) and each parameter that
// it reads, active, row_valid and limits, and writes lanes x rows mask bytes
// and the counts: at 4,096 lanes x 8,192 rows the masks alone are 33.5 MB,
// ~10 us at 3.35 TB/s, while the program's ~10 operations per (lane, row) are
// ~5 us at 67 TOP/s.
#include "common.cuh"

#define TAP_MAX_INSTR 128
#define TAP_MAX_COLS 16
#define TAP_MAX_DEPTH 16
#define TAP_MAX_PARAMS 64

namespace {

// opcodes and dtype codes of ops/tap_residual.py
enum Op : int32_t {
  kCol = 0, kParamI = 1, kParamF = 2, kConst = 3, kCast = 4, kAdd = 5, kSub = 6, kMul = 7,
  kDiv = 8, kMod = 9, kNeg = 10, kCmp = 11, kAnd = 12, kOr = 13, kNot = 14, kIsNull = 15,
  kFilter = 16, kSelect = 17, kSqlCast = 18
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
  int32_t code[TAP_MAX_INSTR * 4];
  const void* data[TAP_MAX_COLS];
  const bool* valid[TAP_MAX_COLS];
  int32_t dt[TAP_MAX_COLS];
  int32_t n_instr;
};

__device__ __forceinline__ double as_f(int64_t v) { return __longlong_as_double(v); }
__device__ __forceinline__ int64_t of_f(double d) { return __double_as_longlong(d); }
__device__ __forceinline__ int64_t wrap32(uint32_t v) {
  return static_cast<int64_t>(static_cast<int32_t>(v));
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

__device__ __forceinline__ int64_t arith(int32_t op, int32_t dt, bool dec, int64_t x, int64_t y,
                                         bool& valid) {
  if (dt == kF64) {
    const double a = as_f(x), b = as_f(y);
    switch (op) {
      case kAdd: return of_f(a + b);
      case kSub: return of_f(a - b);
      case kMul: return of_f(a * b);
      default: break;
    }
    if (dec) {  // DECIMAL / DECIMAL: a zero divisor is NULL
      const bool zero = b == 0.0;
      const double safe = zero ? 1.0 : b;
      valid = valid && !zero;
      return of_f(op == kDiv ? a / safe : fmod(a, safe));
    }
    if (op == kDiv) return of_f(a / b);
    return of_f(b != 0.0 ? fmod(a, b) : __longlong_as_double(0x7ff8000000000000ll));
  }
  if (dt == kI32) {
    const uint32_t a = static_cast<uint32_t>(x), b = static_cast<uint32_t>(y);
    switch (op) {
      case kAdd: return wrap32(a + b);
      case kSub: return wrap32(a - b);
      case kMul: return wrap32(a * b);
      default: break;
    }
  } else if (dt == kI64) {
    switch (op) {
      case kAdd: return ksql::wadd(x, y);
      case kSub: return ksql::wsub(x, y);
      case kMul: return ksql::wmul(x, y);
      default: break;
    }
  }
  // integer / and %: truncating, a zero divisor is NULL, MIN / -1 wraps
  const int64_t lo = dt == kI32 ? INT32_MIN : INT64_MIN;
  const bool zero = y == 0;
  const int64_t safe = (zero || (x == lo && y == -1)) ? 1 : y;
  valid = valid && !zero;
  return op == kDiv ? x / safe : x % safe;
}

// a SQL CAST's arithmetic on value v (bits), its validity updated in place
__device__ __forceinline__ int64_t sql_cast(int32_t kind, int32_t b, int32_t dt, int64_t v,
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

// the program for one (lane, row): true when every filter passed
__device__ bool eval(const TapProgram& prog, const int64_t* __restrict__ pi,
                     const double* __restrict__ pf, int64_t r) {
  int64_t sv[TAP_MAX_DEPTH];
  bool sb[TAP_MAX_DEPTH];
  int sp = 0;
  bool pass = true;
  for (int pc = 0; pc < prog.n_instr; ++pc) {
    const int32_t op = prog.code[4 * pc];
    const int32_t a = prog.code[4 * pc + 1];
    const int32_t b = prog.code[4 * pc + 2];
    const int32_t dt = prog.code[4 * pc + 3];
    switch (op) {
      case kCol: {
        const void* d = prog.data[a];
        int64_t v;
        switch (prog.dt[a]) {
          case kI32: v = static_cast<const int32_t*>(d)[r]; break;
          case kBool: v = static_cast<const bool*>(d)[r] ? 1 : 0; break;
          default: v = static_cast<const int64_t*>(d)[r]; break;  // int64, double bits
        }
        sv[sp] = v;
        sb[sp] = prog.valid[a][r];
        ++sp;
        break;
      }
      case kParamI:
        sv[sp] = cast(pi[a], kI64, dt);
        sb[sp] = true;
        ++sp;
        break;
      case kParamF:
        sv[sp] = cast(of_f(pf[a]), kF64, dt);
        sb[sp] = true;
        ++sp;
        break;
      case kConst:
        sv[sp] = a;
        sb[sp] = b != 0;
        ++sp;
        break;
      case kCast:
        sv[sp - 1] = cast(sv[sp - 1], a, dt);
        break;
      case kNeg: {
        const int64_t v = sv[sp - 1];
        sv[sp - 1] = dt == kF64 ? of_f(-as_f(v))
                     : dt == kI32 ? wrap32(0u - static_cast<uint32_t>(v))
                                  : ksql::wsub(0, v);
        break;
      }
      case kNot:
        sv[sp - 1] = sv[sp - 1] == 0;
        break;
      case kIsNull:
        sv[sp - 1] = a ? sb[sp - 1] : !sb[sp - 1];
        sb[sp - 1] = true;
        break;
      case kFilter:
        --sp;
        pass = pass && sb[sp] && sv[sp] != 0;
        break;
      case kSelect: {
        // stack: ..., then, else, condition
        sp -= 2;
        const bool fire = sb[sp + 1] && sv[sp + 1] != 0;
        if (!fire) {
          sv[sp - 1] = sv[sp];
          sb[sp - 1] = sb[sp];
        }
        break;
      }
      case kSqlCast: {
        bool v = sb[sp - 1];
        sv[sp - 1] = sql_cast(a, b, dt, sv[sp - 1], v);
        sb[sp - 1] = v;
        break;
      }
      default: {  // binary
        --sp;
        const int64_t x = sv[sp - 1], y = sv[sp];
        const bool vx = sb[sp - 1], vy = sb[sp];
        bool valid = vx && vy;
        int64_t out;
        if (op == kCmp) {
          bool c = compare(a, dt, x, y);
          if (a == 6 || a == 7) {
            c = valid ? c : (a == 6 ? vx != vy : vx == vy);
          } else {
            c = c && valid;
          }
          out = c;
          valid = true;
        } else if (op == kAnd || op == kOr) {
          const bool av = vx && x != 0, bv = vy && y != 0;
          if (op == kAnd) {
            out = av && bv;
            valid = valid || (vx && x == 0) || (vy && y == 0);
          } else {
            out = av || bv;
            valid = valid || av || bv;
          }
        } else {
          out = arith(op, dt, b != 0, x, y, valid);
        }
        sv[sp - 1] = out;
        sb[sp - 1] = valid;
        break;
      }
    }
  }
  return pass;
}

__global__ void lanes_kernel(const __grid_constant__ TapProgram prog,
                             const int64_t* __restrict__ P_i, int64_t n_i,
                             const double* __restrict__ P_f, int64_t n_f,
                             const bool* __restrict__ active, const bool* __restrict__ row_valid,
                             int64_t rows, bool* __restrict__ masks,
                             unsigned long long* __restrict__ counts) {
  __shared__ int64_t pi[TAP_MAX_PARAMS];
  __shared__ double pf[TAP_MAX_PARAMS];
  const int64_t lane = blockIdx.y;
  for (int k = threadIdx.x; k < n_i; k += blockDim.x) pi[k] = P_i[lane * n_i + k];
  for (int k = threadIdx.x; k < n_f; k += blockDim.x) pf[k] = P_f[lane * n_f + k];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool pass = false;
  if (r < rows && active[lane] && row_valid[r]) pass = eval(prog, pi, pf, r);
  if (r < rows) masks[lane * rows + r] = pass;
  const unsigned ballot = __ballot_sync(0xffffffffu, pass);
  if ((threadIdx.x & 31) == 0 && ballot != 0) {
    atomicAdd(&counts[lane], static_cast<unsigned long long>(__popc(ballot)));
  }
}

__global__ void clip_kernel(int64_t* __restrict__ counts, const int64_t* __restrict__ limits,
                            int64_t lanes) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l < lanes && counts[l] > limits[l]) counts[l] = limits[l];
}

}  // namespace

// code: n_instr rows of (op, a, b, dt); cols: n_cols rows of (data pointer,
// validity pointer, dtype code); both in host memory, copied into the launch's
// parameter struct.  counts must be zero on entry.
extern "C" int ksql_tap_residual(const int64_t* code, int64_t n_instr, const int64_t* cols,
                                 int64_t n_cols, const void* P_i, int64_t n_i, const void* P_f,
                                 int64_t n_f, const void* active, const void* row_valid,
                                 int64_t rows, int64_t lanes, const void* limits, void* masks,
                                 void* counts, void* stream) {
  if (n_instr > TAP_MAX_INSTR || n_cols > TAP_MAX_COLS || n_i > TAP_MAX_PARAMS ||
      n_f > TAP_MAX_PARAMS || lanes > 65535 || rows >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapProgram prog;
  for (int64_t i = 0; i < 4 * n_instr; ++i) prog.code[i] = static_cast<int32_t>(code[i]);
  for (int64_t c = 0; c < n_cols; ++c) {
    prog.data[c] = reinterpret_cast<const void*>(cols[3 * c]);
    prog.valid[c] = reinterpret_cast<const bool*>(cols[3 * c + 1]);
    prog.dt[c] = static_cast<int32_t>(cols[3 * c + 2]);
  }
  prog.n_instr = static_cast<int32_t>(n_instr);
  if (lanes == 0 || rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>(ksql::blocks_for(rows, threads)),
                  static_cast<unsigned>(lanes));
  lanes_kernel<<<grid, threads, 0, st>>>(
      prog, static_cast<const int64_t*>(P_i), n_i, static_cast<const double*>(P_f), n_f,
      static_cast<const bool*>(active), static_cast<const bool*>(row_valid), rows,
      static_cast<bool*>(masks), static_cast<unsigned long long*>(counts));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  clip_kernel<<<ksql::blocks_for(lanes, threads), threads, 0, st>>>(
      static_cast<int64_t*>(counts), static_cast<const int64_t*>(limits), lanes);
  return static_cast<int>(cudaGetLastError());
}
