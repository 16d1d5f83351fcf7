// Dense panel LU with pivoting restricted to the diagonal block and pivot
// perturbation: the Hopper counterparts of the Pallas kernels
//
//   src/repro/kernels/panel/kernel.py:59  _panel_lu_bucketed_kernel
//       (panel_lu_bucketed_p :102, pallas_call :110)   -> K1:
//       hylu_bucket_panel_lu_* (the members of one panel bucket, read from
//       and written back to the value buffer in place) and
//       hylu_panel_lu_batched_* (contiguous column-reordered [block | U |
//       L] panels, the Pallas wrapper's own operands);
//   src/repro/kernels/panel/kernel.py:23  _panel_lu_kernel
//       (panel_lu_p :133, pallas_call :137)            -> K2:
//       hylu_node_panel_lu_* (node panels [L | block | U]).
//
// Panels of up to 256 rows run one kernel template, panel_lu_window_kernel
// below.  The Pallas kernels pad any nr; a supernode has up to max_super
// rows, which the options do not bound, so panels of more than 256 rows
// run the first kernel of this file, panel_lu_kernel (hylu_panel_lu_*):
// the design K1 and K2 ran before the window kernel, one block per panel
// on the whole panel in device memory (L2-resident at these sizes).  The
// wrappers choose it by shape (kernels/panel/ops.py); chip_smoke.py also
// times it at small nr as the parent design of the window kernel.
//
// panel_lu_kernel.  Per pivot step j the block (1) reduces the argmax of
// |P[i, c0+j]| over i >= j (the first maximum wins and NaN counts as the
// maximum, exactly as jnp.argmax), (2) swaps rows j and p across all
// columns and in perm, (3) replaces a pivot with |p| < eps by +-eps and
// counts it, (4) applies the rank-1 update to rows > j, columns (c0+j,
// wlim), and (5) stores the multipliers in column c0+j.  Columns outside
// [c0, wlim) are only swapped.  Each multiplier is a true quotient's bits
// (div_fast, csrc/div_fast.cuh).  The multipliers and the row map of a
// panel are nr values each in shared memory (nr <= 16,384), so any nr
// the options can produce is taken; the time is nr dependent steps of a
// block-wide sweep each.
//
// Non-finite steps.  The Pallas kernels subtract the masked rank-1 product
// l urow from the WHOLE panel, with l = q * [i > j] (q = P[:, c0+j] / piv)
// and urow = P[j] * [c0+j < c < wlim].  As they run (interpreted, under
// jit) XLA turns each mask product into a select, so l is q below row j and
// 0 elsewhere, urow the pivot row inside the window and 0 elsewhere.  With
// finite q below row j and a finite pivot row in the window, the terms
// outside (4)'s rows and columns are exact zeros, and (4)-(5) give the same
// panel.  A zero pivot under a zero threshold, or a non-finite entry, makes
// some term inf * 0 = NaN: a non-finite q_i turns all of row i > j NaN, a
// non-finite urow_c all of column c in rows <= j.  So each step sets a block
// flag when one of those is not finite, and only then runs the masked
// update of the whole panel (slow, and reached only by degenerate input).
//
// bfloat16 panels.  Both kernels are instantiated a third time, on bf16r:
// bfloat16 storage whose every operation computes in float32 and rounds its
// result to bfloat16 (round to nearest even), as PyTorch's bfloat16
// elementwise operations do and as the plain version runs.  So each pivot
// test compares bfloat16 magnitudes, each multiplier is a true float32
// quotient rounded once (div_fast, then the rounding), and each entry of the
// rank-1 update is a rounded product subtracted and rounded again: the
// kernel computes the plain version's function bit for bit, and picks the
// same pivots where bfloat16 magnitudes tie.  Two-byte elements have no
// cp.async, so they are staged by plain loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "div_fast.cuh"


namespace {

constexpr int kMaxRows = 256;        // the window kernel: a lane per row
constexpr int kMaxRowsWide = 16384;  // panel_lu_kernel: 12 bytes a row in
                                     // shared memory (f64)
constexpr int kThreads = 256;
constexpr size_t kMaxDynSmem = 220 * 1024;

// bfloat16 with float32 arithmetic rounded after every operation
struct bf16r {
  unsigned short bits;
  bf16r() = default;
  __device__ __forceinline__ explicit bf16r(float f)
      : bits(__bfloat16_as_ushort(__float2bfloat16_rn(f))) {}
  __device__ __forceinline__ explicit bf16r(int i) : bf16r((float)i) {}
  __device__ __forceinline__ explicit operator float() const {
    return __bfloat162float(__ushort_as_bfloat16(bits));
  }
  __device__ __forceinline__ explicit operator double() const {
    return (double)(float)*this;
  }
};

__device__ __forceinline__ bf16r bf_bits(unsigned short b) {
  bf16r r;
  r.bits = b;
  return r;
}
__device__ __forceinline__ bf16r operator-(bf16r a, bf16r b) {
  return bf16r(__fsub_rn((float)a, (float)b));
}
__device__ __forceinline__ bf16r operator*(bf16r a, bf16r b) {
  return bf16r(__fmul_rn((float)a, (float)b));
}
__device__ __forceinline__ bf16r operator/(bf16r a, bf16r b) {
  return bf16r(__fdiv_rn((float)a, (float)b));
}
__device__ __forceinline__ bf16r operator-(bf16r a) {
  return bf_bits(a.bits ^ 0x8000u);
}
__device__ __forceinline__ bf16r& operator-=(bf16r& a, bf16r b) {
  return a = a - b;
}
__device__ __forceinline__ bool operator<(bf16r a, bf16r b) {
  return (float)a < (float)b;
}
__device__ __forceinline__ bool operator>(bf16r a, bf16r b) {
  return (float)a > (float)b;
}
__device__ __forceinline__ bool operator>=(bf16r a, bf16r b) {
  return (float)a >= (float)b;
}
__device__ __forceinline__ bool operator==(bf16r a, bf16r b) {
  return (float)a == (float)b;
}
__device__ __forceinline__ bool operator!=(bf16r a, bf16r b) {
  return (float)a != (float)b;
}

// the float32 quotient (correctly rounded, as div_fast gives it) rounded
// to bfloat16
__device__ __forceinline__ bf16r div_fast(bf16r a, bf16r b, double rb,
                                          bool& ok) {
  return bf16r(div_fast((float)a, (float)b, rb, ok));
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

__device__ __forceinline__ double abs_val(double v) { return fabs(v); }
__device__ __forceinline__ float abs_val(float v) { return fabsf(v); }
__device__ __forceinline__ bf16r abs_val(bf16r v) {
  return bf_bits(v.bits & 0x7fffu);
}

template <typename T>
__device__ __forceinline__ bool is_fin(T v) { return isfinite(v); }
__device__ __forceinline__ bool is_fin(bf16r v) {
  return (v.bits & 0x7f80u) != 0x7f80u;
}

template <typename T>
__device__ __forceinline__ T shfl_val(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ bf16r shfl_val(bf16r v, int src) {
  return bf_bits((unsigned short)__shfl_sync(0xffffffffu, (unsigned)v.bits,
                                             src));
}
template <typename T>
__device__ __forceinline__ T shfl_down_val(T v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ bf16r shfl_down_val(bf16r v, int off) {
  return bf_bits((unsigned short)__shfl_down_sync(0xffffffffu,
                                                  (unsigned)v.bits, off));
}

template <typename T>
__device__ __forceinline__ T ldg_val(const T* p) { return __ldg(p); }
__device__ __forceinline__ bf16r ldg_val(const bf16r* p) {
  return bf_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// jnp.argmax order: NaN is the largest value; ties go to the lower index.
template <typename T>
__device__ __forceinline__ bool pivot_better(T a, int ia, T b, int ib) {
  const bool an = is_nan(a), bn = is_nan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The Pallas step on the whole panel, for a step whose flag is set:
// P[i, c] -= l_i urow_c with the selects above, then column pc of the rows
// below j holds q.  q is in lcol.  Row j is read by every other row, so it
// is updated after a barrier; column pc of the rows up to j is unchanged
// (l = 0 there, and urow_pc = 0).
template <typename T>
__device__ void masked_update(T* P, const T* lcol, int nr, int wt, int j,
                              int pc, int wlim) {
  T* rj = P + (long long)j * wt;
  const long long size = (long long)nr * wt;
  for (long long idx = threadIdx.x; idx < size; idx += blockDim.x) {
    const int i = (int)(idx / wt), c = (int)(idx % wt);
    const bool in = c > pc && c < wlim;
    if (i > j)
      P[idx] = c == pc ? lcol[i] : P[idx] - lcol[i] * (in ? rj[c] : T(0));
    else if (i < j && in)
      P[idx] -= T(0) * rj[c];
  }
  __syncthreads();
  for (int c = pc + 1 + threadIdx.x; c < wlim; c += blockDim.x)
    rj[c] -= T(0) * rj[c];
}

// Bytes of shared memory a launch of panel_lu_kernel takes: the panel
// (use_smem) and, per row, its multiplier and its entry of perm.
template <typename T>
size_t parent_smem(int nr, int wt, bool use_smem) {
  const size_t panel = use_smem ? ((size_t)nr * wt * sizeof(T) + 15) & ~15
                                : 0;
  return panel + (size_t)nr * (sizeof(T) + sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_lu_kernel(const T* __restrict__ in, long long sb, T* __restrict__ out,
                int* __restrict__ perm_out, int* __restrict__ nper_out,
                const T* __restrict__ eps, int nr, int wt, int c0, int wlim,
                int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int piv_row;
  __shared__ T piv_val;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long size = (long long)nr * wt;
  const T* src = in + blockIdx.x * sb;         // rows dense, wt apart
  T* dst = out + blockIdx.x * size;
  T* P = use_smem ? reinterpret_cast<T*>(smem_raw) : dst;
  T* lcol = reinterpret_cast<T*>(
      smem_raw + (use_smem ? ((size_t)size * sizeof(T) + 15) & ~15 : 0));
  int* perm = reinterpret_cast<int*>(lcol + nr);

  for (long long i = tid; i < size; i += blockDim.x) P[i] = src[i];
  for (int i = tid; i < nr; i += blockDim.x) perm[i] = i;
  const T e = eps[blockIdx.x];
  int nper = 0;                       // counted by thread 0 only
  __syncthreads();

  for (int j = 0; j < nr; ++j) {
    const int pc = c0 + j;
    // (1) pivot search over rows j..nr-1 by warp 0
    if (warp == 0) {
      T best = T(0);
      int bi = nr;                    // nr = "no candidate yet"
      for (int i = j + lane; i < nr; i += 32) {
        const T v = abs_val(P[(long long)i * wt + pc]);
        if (bi == nr || pivot_better(v, i, best, bi)) { best = v; bi = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = shfl_down_val(best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (oi < nr && (bi == nr || pivot_better(ov, oi, best, bi))) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) piv_row = bi;
    }
    __syncthreads();
    // (2) row swap across every column, and in perm
    const int p = piv_row;
    if (p != j) {
      T* rj = P + (long long)j * wt;
      T* rp = P + (long long)p * wt;
      for (int c = tid; c < wt; c += blockDim.x) {
        const T t = rj[c];
        rj[c] = rp[c];
        rp[c] = t;
      }
      if (tid == 0) {
        const int t = perm[j];
        perm[j] = perm[p];
        perm[p] = t;
      }
    }
    __syncthreads();
    // (3) pivot perturbation
    if (tid == 0) {
      T piv = P[(long long)j * wt + pc];
      if (abs_val(piv) < e) {
        piv = piv >= T(0) ? e : -e;
        P[(long long)j * wt + pc] = piv;
        ++nper;
      }
      piv_val = piv;
    }
    __syncthreads();
    const T piv = piv_val;
    const double rpiv = recip((double)piv);
    T* rj = P + (long long)j * wt;
    int bad = 0;
    for (int i = j + 1 + tid; i < nr; i += blockDim.x) {
      const T a = P[(long long)i * wt + pc];
      bool ok = true;
      T q = div_fast(a, piv, rpiv, ok);
      if (!ok) q = true_div(a, piv);
      lcol[i] = q;
      bad |= !is_fin(q);
    }
    for (int c = pc + 1 + tid; c < wlim; c += blockDim.x)
      bad |= !is_fin(rj[c]);
    if (!__syncthreads_or(bad)) {
      // (4) rank-1 update: one warp per row, lanes along the columns
      for (int i = j + 1 + warp; i < nr; i += nwarps) {
        T* ri = P + (long long)i * wt;
        const T li = lcol[i];
        for (int c = pc + 1 + lane; c < wlim; c += 32) ri[c] -= li * rj[c];
      }
      // (5) multipliers into the pivot column (disjoint from (4)'s columns)
      for (int i = j + 1 + tid; i < nr; i += blockDim.x)
        P[(long long)i * wt + pc] = lcol[i];
    } else {
      masked_update(P, lcol, nr, wt, j, pc, wlim);
    }
    __syncthreads();
  }

  if (use_smem)
    for (long long i = tid; i < size; i += blockDim.x) dst[i] = P[i];
  for (int i = tid; i < nr; i += blockDim.x)
    perm_out[(long long)blockIdx.x * nr + i] = perm[i];
  if (tid == 0) nper_out[blockIdx.x] = nper;
}

template <typename T>
int launch_panel_lu(const void* in, long long sb, void* out, void* perm,
                    void* nper, const void* eps, int npanels, int nr, int wt,
                    int c0, int wlim, void* stream) {
  if (nr < 1 || nr > kMaxRowsWide || wt < 1 || npanels < 1 || c0 < 0 ||
      c0 + nr > wt || wlim < c0 + nr || wlim > wt || sb < 0)
    return (int)cudaErrorInvalidValue;
  const int use_smem = parent_smem<T>(nr, wt, true) <= kMaxDynSmem;
  const size_t smem = parent_smem<T>(nr, wt, use_smem != 0);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        panel_lu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  panel_lu_kernel<T><<<npanels, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(in), sb, static_cast<T*>(out),
      static_cast<int*>(perm), static_cast<int*>(nper),
      static_cast<const T*>(eps), nr, wt, c0, wlim, use_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// K1 and K2 designed for Hopper: panel_lu_window_kernel
//
// A panel has nr <= 256 rows: eight warps of the pivot loop own one row a
// lane.  Its window -- the diagonal block and the U suffix -- is
// eliminated: the LU pivots inside the block (the first
// maximum of |.| wins, NaN counts as the largest, as jnp.argmax), perturbs
// a pivot with |p| < eps to +-eps and counts it, stores the multipliers in
// the pivot column and applies the rank-1 update to the window columns
// right of it.  The L prefix is only row-permuted.  Three layouts run the
// same code:
//
// * K2's node panels [L prefix | block | U suffix]: window [lsize, w),
//   prefix [0, lsize), read through a batch stride (strided views of the
//   value buffer) and written to a dense output.
// * K1's contiguous panels [block | U | L]: window [0, wu), prefix
//   [wu, wt).
// * K1 in place.  Member m of system k of a panel bucket is a node whose
//   panel [L | block | U] lies at its slot offset in row k of the value
//   buffer.  The kernel reads it there through the member's descriptor
//   (slot offset, nr, w, lsize, usize) and builds in shared memory the
//   padded window the Pallas kernel factors, [block | block pads | U | U
//   pads] of nrp rows: a pad reads the zero slot, and a padded row r >= nr
//   the one slot on its own diagonal.  Padded rows are eliminated too:
//   with finite values their steps are exact no-ops, but a pivot row that
//   is infinite in a real column turns that column NaN in every padded row
//   (0 * inf), and when every real candidate of a step is infinite a padded
//   row wins the pivot, so a kernel that skipped them would pivot
//   differently.  Rows at positions < nr are written back to their real
//   slots (block, U suffix and prefix) and nothing else is written; perm
//   covers all nrp rows.  One launch covers the K x B panels of a bucket;
//   panel (k, m) takes eps[k].
//
// What bounds it.  Each real slot is read once and written once, perm and
// the counts written once (PERF.md, section 6, gives the bytes and the
// bound of the calls one refactor makes).  The pivot loop is sequential,
// so the time goes to the nr dependent steps of each panel and, at a few
// panels a launch, to the launch itself.  The design keeps each step short
// and moves each byte once:
//
// * Only the window is staged in shared memory, by cp.async: 16 bytes a
//   copy where a row's source and its staged copy share their offset in 16
//   bytes (after a scalar head), one element a copy otherwise (node rows
//   in the value buffer are often not 16-byte aligned).  A window above the
//   opt-in limit (227 KB) lives in a device-memory scratch buffer that the
//   wrapper allocates, with the same code.
// * Rows are swapped virtually.  A row stays where it was staged; the lane
//   that owns a physical row keeps its logical position in a register, so
//   a swap is two register updates.  Window rows are written out once, in
//   pivot order, at the end.
// * The prefix is only permuted: its columns are staged by cp.async in
//   the shared memory the window leaves, while the pivot loop runs, and
//   written out once in pivot order.  When they do not fit: out of place
//   (K2, contiguous K1) the panel's prefix is split over up to (SMs /
//   panels) blocks, each of which factors the window again (the LU is
//   deterministic) and copies its share, only the first writing the
//   window, perm and the count; in place (K1) one block passes the rest
//   through shared memory chunk by chunk, each chunk read in full before
//   any of it is written, since another block could read a window that
//   the first had already overwritten.  No second launch.
// * In place, the padded steps are skipped when they are exact no-ops:
//   when the real steps left the padded rows as staged (no pivot zero or
//   non-finite, no pivot row non-finite in the window) and the pads and
//   the one slot are the engine's (zero; finite, nonzero and never
//   perturbed).  A quarter of the rows of fem2d_10k's buckets are padded.
// * One barrier per pivot step.  Each warp reduces the column-(j+1)
//   candidates of its rows as integer keys (__reduce_max_sync /
//   __reduce_min_sync) and publishes its best with its value; after the
//   barrier every warp reduces the published ones itself and perturbs
//   the pivot in registers.  A lone warp needs no barrier at all.
// * The rank-1 update has no branch: a warp takes its active rows four or
//   eight at a time from a list, issues every load of the batch before its
//   stores, and sends lanes past the window to a spare column and missing
//   rows to a spare row.
// * The block is sized to the panel: for nr <= 8 one warp runs the pivot
//   loop while three more stage the prefix; four warps for nr <= 64, eight
//   up to 256.  Rows are dealt to warps round-robin, so the active rows stay
//   spread over the warps whatever the pivots are.  (A lone warp up to
//   nr = 16 or 32, with or without the copying warps and with several
//   panels a block, measured slower at every size of fem2d_10k's node
//   panels: one warp's share of a step's update outlasts the barrier it
//   saves.)
//
// Non-finite steps.  The Pallas kernels subtract the masked rank-1 product
// l urow from the whole panel, l = q [i > j] and urow = P[j] [c > c0 + j]
// inside the window; XLA turns each mask product into a select.  So a
// non-finite q_i turns row i NaN in every column left of the pivot column
// (0 inf = NaN), and a non-finite urow_c turns column c NaN in the rows up
// to j.  Both are applied without a block-wide flag:
//
// * q_i is computed by the lane that owns row i: it sets the row's window
//   columns left of the pivot to NaN and marks the row poisoned, and the
//   row's prefix is written as NaN.
// * A finished row is never read again, and its entries right of its own
//   pivot are final when it is the pivot row, so the column rule is
//   deferred: at the end, column c is set NaN in every row above position
//   c if any of those rows is not finite there.  (Once urow_c is not
//   finite at step j, every active row turns non-finite in column c, so
//   every later pivot row carries it on up to step c - 1.)  A block-wide
//   test skips this pass when the window is finite.
//
namespace {
namespace node {

constexpr int kPrefixRegs = 16;   // prefix loads a thread keeps in flight
constexpr int kRowRegs = 4;       // 32-column chunks of the pivot row held
constexpr int kRowsOne = 8;       // rows a lone warp updates at once (its
                                  // panel has nr <= 8); several warps: 4
                                  // in float64, 8 in float32 (measured)
constexpr int kMaxDevices = 64;
constexpr int kDesc = 5;          // a bucket member: slot offset, nr, w,
                                  // lsize, usize
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T nan_val();
template <> __device__ __forceinline__ double nan_val<double>() {
  return CUDART_NAN;
}
template <> __device__ __forceinline__ float nan_val<float>() {
  return CUDART_NAN_F;
}
template <> __device__ __forceinline__ bf16r nan_val<bf16r>() {
  return bf_bits(0x7fc0u);
}

// jnp.argmax order on (|value|, logical row) as integer keys: the bits of
// |v| order like |v| (every NaN mapped to one NaN, above inf), plus one so
// that 0 means no candidate; ties go to the lower logical row.
__device__ __forceinline__ unsigned long long mag_key(double v) {
  unsigned long long b = __double_as_longlong(v) & 0x7fffffffffffffffULL;
  if (b > 0x7ff0000000000000ULL) b = 0x7ff8000000000000ULL;
  return b + 1;
}
__device__ __forceinline__ unsigned long long mag_key(float v) {
  unsigned b = __float_as_uint(v) & 0x7fffffffu;
  if (b > 0x7f800000u) b = 0x7fc00000u;
  return b + 1;
}
__device__ __forceinline__ unsigned long long mag_key(bf16r v) {
  unsigned b = v.bits & 0x7fffu;
  if (b > 0x7f80u) b = 0x7fc0u;
  return b + 1;
}

// The warp's best candidate (signed value v, logical row p, physical row r)
// among the lanes with `valid`, in every lane; p = -1 when there is none.
template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& p, int& r,
                                            bool valid) {
  const unsigned long long key = valid ? mag_key(v) : 0ULL;
  bool tie;
  if constexpr (sizeof(T) == 8) {
    const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
    const unsigned m1 = __reduce_max_sync(kFull, hi);
    const unsigned m2 = __reduce_max_sync(kFull, hi == m1 ? lo : 0u);
    tie = valid && hi == m1 && lo == m2;
  } else {
    const unsigned k32 = (unsigned)key;
    const unsigned m1 = __reduce_max_sync(kFull, k32);  // every lane
    tie = valid && k32 == m1;
  }
  const int pm = __reduce_min_sync(kFull, tie ? p : 0x7fffffff);
  const int src = __ffs(__ballot_sync(kFull, tie && p == pm)) - 1;
  v = shfl_val(v, src < 0 ? 0 : src);
  r = __shfl_sync(kFull, r, src < 0 ? 0 : src);
  p = src < 0 ? -1 : pm;
}

template <int NW>
__device__ __forceinline__ void group_sync() {
  if constexpr (NW == 1)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

template <int N>
__device__ __forceinline__ void cp_async_ca(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
               "l"(g), "n"(N));
}

// one element of g to s: by cp.async (4 and 8 bytes), by a plain load
// and store for a two-byte element, which cp.async does not copy
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* s, const T* g) {
  if constexpr (sizeof(T) == 2)
    *s = *g;
  else
    cp_async_ca<sizeof(T)>(s, g);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Row stride of the staged window: one spare column (where masked-off
// lanes store, so that the update has no branch), rounded up to 16 bytes.
// The window also has one spare row, standing in for missing rows.
template <typename T>
__host__ __device__ inline int window_ld(int ww) {
  constexpr int v = 16 / sizeof(T);
  return (ww + v) / v * v;
}

// Per panel, after the window (if staged): the candidates of two steps
// (value, logical row, physical row for each warp), each warp's verdict on
// the padded rows, the poisoned flags, the final row map and each warp's
// list of active rows; the staged prefix columns follow.
template <typename T>
__host__ __device__ inline size_t small_bytes(int nw) {
  return align16(2 * nw * sizeof(T)) + 2 * align16(2 * nw * sizeof(int)) +
         align16(nw * sizeof(int)) + (2 * kMaxRows + 32 * nw) * sizeof(int);
}

// The rank-1 update of kRows rows R[q] (the spare row where there is none)
// over NCH 32-column chunks right of column j: every load of the batch is
// issued before its stores, and lanes past the window use the spare column.
template <typename T, int NCH, int kRows>
__device__ __forceinline__ void update_chunks(T* const* R, const T* lq,
                                              const T* urow, int j, int lane,
                                              int ww) {
  int cc[NCH];
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int c = j + 1 + lane + 32 * m;
    cc[m] = c < ww ? c : ww;
  }
  T a[kRows][NCH];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int m = 0; m < NCH; ++m) a[q][m] = R[q][cc[m]];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int m = 0; m < NCH; ++m) R[q][cc[m]] = a[q][m] - lq[q] * urow[m];
}


// cp.async of g[0, n) to s[0, n) by one warp: 16 bytes a copy where s and g
// share their offset in 16 bytes (after a scalar head), one element a copy
// otherwise.
template <typename T>
__device__ __forceinline__ void stage_run(T* s, const T* g, int n, int lane) {
  constexpr int V = 16 / sizeof(T);
  const unsigned ga = (unsigned)(reinterpret_cast<uintptr_t>(g) & 15);
  const unsigned sa = (unsigned)(reinterpret_cast<uintptr_t>(s) & 15);
  int head = n, nv = 0;
  if (ga == sa) {
    head = min(n, (int)(((16u - ga) & 15u) / sizeof(T)));
    nv = (n - head) / V;
  }
  for (int c = lane; c < head; c += 32) cp_async_elem(s + c, g + c);
  for (int q = lane; q < nv; q += 32)
    cp_async16(s + head + q * V, g + head + q * V);
  for (int c = head + nv * V + lane; c < n; c += 32)
    cp_async_elem(s + c, g + c);
}

// One launch's panels.  Uniform panels (K2's node panels, K1's contiguous
// ones): panel b at in + b sb, rows ld apart, its window [wsrc, wsrc + ww)
// and its prefix [psrc, psrc + np) of each row, written to out + b sbo in
// the same layout.  Bucket members (K1 in place, out == in): panel b =
// k bper + m is member m of system k, described by desc[kDesc m ..] and
// read from and written to row k of the value buffer, in + k ldv; the
// window is padded to ww = nrp + usp columns and nr = nrp rows.
template <typename T>
struct Args {
  const T* in;
  T* out;
  long long sb, sbo;
  const int* desc;
  long long ldv;
  int bper, zero, one;
  int* perm;
  int* nper;
  const T* eps;
  T* scratch;
  int nr, ww, ld, wsrc, psrc, np;
  int ldw, cs, sw, scw;
};

// Warps of a block whose pivot loop runs on nwf warps: a lone pivot warp
// has three more that copy the prefix.
__host__ __device__ constexpr int block_warps(int nwf) {
  return nwf > 4 ? nwf : 4;
}

template <typename T, int NWF, bool SMEM, bool BUCKET>
__global__ void __launch_bounds__(32 * block_warps(NWF))
panel_lu_window_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NWB = block_warps(NWF);       // warps of the block
  constexpr int NTB = 32 * NWB;
  constexpr int NTF = 32 * NWF;                // threads of the pivot loop
  constexpr int kRows = NWF == 1 ? kRowsOne : sizeof(T) == 8 ? 4 : 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;
  const bool fw = warp < NWF;                  // a warp of the pivot loop
  const int nr = a.nr, ww = a.ww, ldw = a.ldw;
  const int b = blockIdx.x / a.cs;             // the panel
  const int share = blockIdx.x - b * a.cs;     // which prefix columns
  const bool lead = share == 0;                // writes window and perm

  // The panel: rows ld apart at src (written at dst); the window's real
  // block columns [0, nb) and U columns [nr, nr + us) start at wsrc and
  // wsrc + nb of a row, its prefix at psrc; rows >= nreal are padded.
  const T* src;
  T* dst;
  T e, zval = T(0), oval = T(0);
  int ld, wsrc, psrc, np, nreal, us;
  if constexpr (BUCKET) {
    const int k = b / a.bper;
    const int* d = a.desc + kDesc * (b - k * a.bper);
    const long long row = (long long)k * a.ldv;
    src = a.in + row + d[0];
    dst = a.out + row + d[0];
    nreal = d[1];
    ld = d[2];
    wsrc = d[3];
    us = d[4];
    psrc = 0;
    np = wsrc;
    zval = a.in[row + a.zero];
    oval = a.in[row + a.one];
    e = a.eps[k];
  } else {
    src = a.in + (long long)b * a.sb;
    dst = a.out + (long long)b * a.sbo;
    ld = a.ld;
    wsrc = a.wsrc;
    psrc = a.psrc;
    np = a.np;
    nreal = nr;
    us = ww - nr;
    e = a.eps[b];
  }
  const int nb = nreal;                        // real block columns
  const int col_lo = min(share * a.sw, np);
  const int col_hi = min(col_lo + a.sw, np);
  const int nst = min(a.scw, col_hi - col_lo); // prefix columns staged
  unsigned char* g = smem_raw;
  T* W;
  size_t off = 0;
  if constexpr (SMEM) {
    W = reinterpret_cast<T*>(g);
    off = align16((size_t)(nr + 1) * ldw * sizeof(T));
  } else {
    W = a.scratch + (long long)b * (nr + 1) * ldw;   // (nr + 1) ldw < 2^31
  }
  T* cval = reinterpret_cast<T*>(g + off);
  off += align16(2 * NWF * sizeof(T));
  int* cpos = reinterpret_cast<int*>(g + off);
  off += align16(2 * NWF * sizeof(int));
  int* crow = reinterpret_cast<int*>(g + off);
  off += align16(2 * NWF * sizeof(int));
  int* cclean = reinterpret_cast<int*>(g + off);
  off += align16(NWF * sizeof(int));
  int* poison = reinterpret_cast<int*>(g + off);
  int* rowmap = poison + kMaxRows;
  int* alist = rowmap + kMaxRows;
  off += (2 * kMaxRows + 32 * NWF) * sizeof(int);
  T* S = reinterpret_cast<T*>(g + off);        // staged prefix columns
  const T qnan = nan_val<T>();

  // ---- staging: the pivot warps copy the window (and write its pads) --
  // in place every warp of the block does, a lone pivot warp's staging
  // taking longer than its waiting for the copies; the prefix columns
  // (only permuted) are copied by the other warps when there are any, so
  // that their copy overlaps the elimination ----------------------------
  constexpr int NWS = BUCKET ? NWB : NWF;      // warps that stage the window
  if (warp < NWS) {
    for (int i = warp; i < nr; i += NWS) {
      T* sr = W + i * ldw;
      if (i >= nreal) {                        // a padded row
        for (int c = lane; c < ww; c += 32) sr[c] = c == i ? oval : zval;
        continue;
      }
      const T* gr = src + (long long)i * ld + wsrc;
      if constexpr (SMEM) {
        if (nb == nr) {                        // block and U adjoin
          stage_run(sr, gr, nr + us, lane);
        } else {
          stage_run(sr, gr, nb, lane);
          stage_run(sr + nr, gr + nb, us, lane);
        }
      } else {
        for (int c = lane; c < nb; c += 32) sr[c] = gr[c];
        for (int c = lane; c < us; c += 32) sr[nr + c] = gr[nb + c];
      }
      for (int c = nb + lane; c < nr; c += 32) sr[c] = zval;       // block pads
      for (int c = nr + us + lane; c < ww; c += 32) sr[c] = zval;  // U pads
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  {
    const int w0 = NWF == 1 ? 1 : 0;           // first warp that copies
    for (int i = warp - w0; i >= 0 && i < nreal; i += NWB - w0) {
      const T* gr = src + (long long)i * ld + psrc + col_lo;
      T* sr = S + i * nst;
      for (int c = lane; c < nst; c += 32)
        cp_async_elem(sr + c, gr + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int myrow = warp + lane * NWF;         // lane k owns row warp + k NWF
  const bool has = fw && myrow < nr;
  int pos = has ? myrow : -1;                  // its logical position
  int nper = 0;
  // Padded steps (bucket members with nr < nrp) are exact no-ops when the
  // real steps left every padded row as it was staged -- their pivots
  // finite and nonzero, their pivot rows finite in the window, so no
  // 0 * inf reached a padded row and none won a pivot -- and the pads are
  // zero and the one slot a finite, nonzero pivot that is not perturbed:
  // each padded row then pivots on itself, divides zeros by the one slot
  // and subtracts zeros (at most a zero's sign changes, in rows that are
  // never written).  The loop stops before them then.
  bool clean = true;
  const bool inert = BUCKET && is_fin(oval) && oval != T(0) &&
                     !(abs_val(oval) < e) && zval == T(0);
  if constexpr (NWS > NWF) {                   // the window from all warps
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
  }
  if (fw) {
    if constexpr (NWS == NWF)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    for (int i = tid; i < nr; i += NTF) poison[i] = 0;
    group_sync<NWF>();
    // the warp's best candidate, in every lane; with more than one warp
    // each publishes it and all reduce the published ones after a barrier
    T cv = has ? W[myrow * ldw] : T(0);
    int cpp = pos, cr = pos;
    warp_argmax(cv, cpp, cr, has);
    if (NWF > 1 && lane == 0) {
      cval[warp] = cv;
      cpos[warp] = cpp;
      crow[warp] = cr;
    }
    T* const spare = W + nr * ldw;
    for (int j = 0; j < nr; ++j) {
      T pv = cv;
      int lp = cpp, prow = cr;
      if constexpr (NWF > 1) {
        __syncthreads();                       // the step's one barrier
        const int s = (j & 1) * NWF + lane;
        T v = T(0);
        int p = -1, r = -1;
        if (lane < NWF) {
          v = cval[s];
          p = cpos[s];
          r = crow[s];
        }
        warp_argmax(v, p, r, p >= 0);
        pv = v;
        lp = p;
        prow = r;
      }
      if constexpr (BUCKET) {
        if (j == nreal) {                      // the first padded step
          bool ok = inert;
          if constexpr (NWF > 1) {
            for (int q = 0; q < NWF; ++q) ok = ok && cclean[q] != 0;
          } else {
            ok = __all_sync(kFull, clean) && ok;
          }
          if (ok) break;
        }
      }
      T piv = pv;
      const bool small = abs_val(pv) < e;
      if (small) {
        piv = pv >= T(0) ? e : -e;
        ++nper;
      }
      if constexpr (BUCKET)
        clean = clean && is_fin(piv) && piv != T(0) && prow < nreal;
      const bool act = has && myrow != prow && (pos == j ? lp : pos) > j;
      if (has) {                               // swap positions j and lp
        if (myrow == prow) {
          pos = j;
          if (small) W[myrow * ldw + j] = piv;
        } else if (pos == j) {
          pos = lp;
        }
      }
      T l = T(0);
      if (act) {                               // the row's multiplier
        T* R = W + myrow * ldw;
        l = R[j] / piv;
        R[j] = l;
        if (!is_fin(l)) {                    // 0 inf: the row turns NaN
          for (int c = 0; c < j; ++c) R[c] = qnan;
          poison[myrow] = 1;
        }
      }
      const T* U = W + prow * ldw;
      T urow[kRowRegs];
#pragma unroll
      for (int m = 0; m < kRowRegs; ++m) {
        const int c = j + 1 + lane + 32 * m;
        urow[m] = U[c < ww ? c : ww];
      }
      if constexpr (BUCKET) {
        if (j < nreal) {
#pragma unroll
          for (int m = 0; m < kRowRegs; ++m)
            if (j + 1 + lane + 32 * m < ww) clean = clean && is_fin(urow[m]);
          for (int c = j + 1 + lane + 32 * kRowRegs; c < ww; c += 32)
            clean = clean && is_fin(U[c]);
        }
      }
      // the rank-1 update of the warp's active rows, kRows at a time, from
      // a list of them; a row's multiplier comes from its lane by shuffle
      const unsigned todo = __ballot_sync(kFull, act);
      const int n_act = __popc(todo);
      if (NWF > 1 && act)
        alist[warp * 32 + __popc(todo & ((1u << lane) - 1))] = lane;
      __syncwarp();
      const int nch = min(kRowRegs, (ww - j + 30) >> 5);
      for (int t0 = 0; t0 < n_act; t0 += kRows) {
        T lq[kRows];
        T* R[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if constexpr (NWF == 1) {            // nr <= kRows: row q, lane q
            lq[q] = shfl_val(l, q);
            R[q] = (todo >> q) & 1 ? W + q * ldw : spare;
          } else {
            const bool okq = t0 + q < n_act;
            const int k = alist[warp * 32 + (okq ? t0 + q : 0)];
            lq[q] = shfl_val(l, k);
            R[q] = okq ? W + (warp + k * NWF) * ldw : spare;
          }
        }
        switch (nch) {
          case 1: update_chunks<T, 1, kRows>(R, lq, urow, j, lane, ww); break;
          case 2: update_chunks<T, 2, kRows>(R, lq, urow, j, lane, ww); break;
          case 3: update_chunks<T, 3, kRows>(R, lq, urow, j, lane, ww); break;
          default: update_chunks<T, kRowRegs, kRows>(R, lq, urow, j, lane, ww);
        }
        for (int c = j + 1 + lane + 32 * kRowRegs; c < ww; c += 32) {
          const T u = U[c];
#pragma unroll
          for (int q = 0; q < kRows; ++q) R[q][c] -= lq[q] * u;
        }
      }
      __syncwarp();
      cv = act ? W[myrow * ldw + j + 1] : T(0);  // candidates of step j + 1
      cpp = pos;
      cr = myrow;
      warp_argmax(cv, cpp, cr, act);
      if (NWF > 1 && lane == 0) {
        const int s1 = ((j + 1) & 1) * NWF + warp;
        cval[s1] = cv;
        cpos[s1] = cpp;
        crow[s1] = cr;
      }
      if constexpr (BUCKET && NWF > 1) {
        if (j + 1 == nreal) {                  // read after the next barrier
          const bool wc = __all_sync(kFull, clean);
          if (lane == 0) cclean[warp] = wc;
        }
      }
    }
  }


  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (has) rowmap[pos] = myrow;
  __syncthreads();
  // This block's prefix columns of the rows at positions < nreal, in pivot
  // order: the staged ones from shared memory; the rest straight from
  // device memory, or, in place, through shared memory chunk by chunk, each
  // chunk read in full before any of it is written.  A padded row's prefix
  // is the zero slot, a poisoned row's NaN.
  for (int i = warp; i < nreal; i += NWB) {
    const int r = rowmap[i];
    const bool pois = poison[r] != 0;
    const bool real = r < nreal;
    T* drow = dst + (long long)i * ld + psrc;
    const T* srow = S + r * nst;
    for (int c = lane; c < nst; c += 32)
      drow[col_lo + c] = pois ? qnan : real ? srow[c] : zval;
    if constexpr (!BUCKET) {
      const T* grow = src + (long long)r * ld + psrc;
      for (int c = col_lo + nst + lane; c < col_hi; c += 32 * kPrefixRegs) {
        T v[kPrefixRegs];
#pragma unroll
        for (int u = 0; u < kPrefixRegs; ++u) {
          const int cc = c + 32 * u;
          v[u] = (cc < col_hi && !pois) ? ldg_val(grow + cc) : qnan;
        }
#pragma unroll
        for (int u = 0; u < kPrefixRegs; ++u) {
          const int cc = c + 32 * u;
          if (cc < col_hi) drow[cc] = v[u];
        }
      }
    }
  }
  if constexpr (BUCKET) {
    for (int c0 = nst; c0 < np; c0 += a.scw) {
      const int cw = min(a.scw, np - c0);
      __syncthreads();                         // S is free again
      for (int i = warp; i < nreal; i += NWB) {
        const T* gr = src + (long long)i * ld + c0;
        T* sr = S + i * cw;
        for (int c = lane; c < cw; c += 32) sr[c] = gr[c];
      }
      __syncthreads();
      for (int i = warp; i < nreal; i += NWB) {
        const int r = rowmap[i];
        const bool pois = poison[r] != 0;
        const bool real = r < nreal;
        T* drow = dst + (long long)i * ld + c0;
        const T* srow = S + r * cw;
        for (int c = lane; c < cw; c += 32)
          drow[c] = pois ? qnan : real ? srow[c] : zval;
      }
    }
  }
  if (!lead) return;
  // the deferred column rule: column c of the rows above position c (only
  // when the window holds a non-finite value at all)
  bool any_nf = false;
  for (int i = warp; i < nr; i += NWB)
    for (int c = lane; c < ww; c += 32) any_nf |= !is_fin(W[i * ldw + c]);
  if (__syncthreads_or(any_nf)) {
    for (int c = tid; c < ww; c += NTB) {
      const int lim = c < nr ? c : nr;
      bool nf = false;
      for (int i = 0; i < lim; ++i)
        nf |= !is_fin(W[rowmap[i] * ldw + c]);
      if (nf)
        for (int i = 0; i < lim; ++i) W[rowmap[i] * ldw + c] = qnan;
    }
  }
  __syncthreads();
  // the window's real columns of the rows at positions < nreal
  for (int i = warp; i < nreal; i += NWB) {
    const T* wr = W + rowmap[i] * ldw;
    T* drow = dst + (long long)i * ld + wsrc;
    for (int c = lane; c < nb + us; c += 32)
      drow[c] = wr[c < nb ? c : c + nr - nb];
  }
  for (int i = tid; i < nr; i += NTB)
    a.perm[(long long)b * nr + i] = rowmap[i];
  if (tid == 0) a.nper[b] = nper;
}

struct Plan {
  int nwf, ldw, smem_route, cs, sw, scw;
  size_t smem;
};

struct DeviceLimits {
  int dev, smem_optin, sms;
};

// The current device's shared-memory opt-in limit and SM count, read once
// per device.
DeviceLimits device_limits() {
  static DeviceLimits cache[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  auto read = [](int d) {
    DeviceLimits r{d, 0, 0};
    cudaDeviceGetAttribute(&r.smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, d);
    cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, d);
    return r;
  };
  if (dev < 0 || dev >= kMaxDevices) return read(dev);
  std::call_once(once[dev], [&] { cache[dev] = read(dev); });
  return cache[dev];
}

// Block shape and shared-memory plan of a launch of npanels panels of nr
// rows, a window of ww columns and a prefix of at most np, one block per
// panel (and prefix share).  The window is staged when it fits; the prefix
// columns are staged in what is left.  Out of place, when they do not fit,
// the panel's prefix is split over cs blocks (each factors the window
// again: the LU is deterministic) as far as idle SMs allow.  In place the
// prefix passes through shared memory, so the window is staged only when
// it leaves room for a prefix column.
template <typename T>
Plan make_plan(int npanels, int nr, int ww, int np, bool inplace) {
  Plan p;
  const DeviceLimits d = device_limits();
  const size_t cap = (size_t)d.smem_optin;
  const size_t col = (size_t)nr * sizeof(T);
  p.nwf = nr <= 8 ? 1 : nr <= 64 ? 4 : 8;
  p.ldw = window_ld<T>(ww);
  const size_t small = small_bytes<T>(p.nwf);
  const size_t win = align16((size_t)(nr + 1) * p.ldw * sizeof(T));
  p.smem_route = win + small <= cap;
  if (inplace && np > 0 && p.smem_route && cap - win - small < 16 + col)
    p.smem_route = false;
  const size_t base = p.smem_route ? win + small : small;
  const size_t spare = cap - base;
  const int max_cols = spare > 16 ? (int)((spare - 16) / col) : 0;
  p.cs = 1;
  if (!inplace && np > max_cols && p.smem_route) {
    const int idle = d.sms / npanels;
    const int want = max_cols > 0 ? (np + max_cols - 1) / max_cols : idle;
    p.cs = std::max(1, std::min(want, idle));
  }
  p.sw = (np + p.cs - 1) / p.cs;
  p.scw = std::min(p.sw, max_cols);
  p.smem = base + align16((size_t)nr * p.scw * sizeof(T));
  return p;
}

template <typename T, int NWF, bool SMEM, bool BUCKET>
int launch_t(const Plan& p, Args<T> a, int npanels, cudaStream_t stream) {
  auto kern = panel_lu_window_kernel<T, NWF, SMEM, BUCKET>;
  if (p.smem > 48 * 1024) {        // opt in to the device's limit, once
    static std::once_flag once[kMaxDevices];
    static cudaError_t err[kMaxDevices];
    const DeviceLimits d = device_limits();
    if (d.dev < 0 || d.dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::call_once(once[d.dev], [&] {
      err[d.dev] = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_optin);
    });
    if (err[d.dev] != cudaSuccess) return (int)err[d.dev];
  }
  a.ldw = p.ldw;
  a.cs = p.cs;
  a.sw = p.sw;
  a.scw = p.scw;
  kern<<<npanels * p.cs, 32 * block_warps(NWF), p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool BUCKET>
int launch(const Plan& p, const Args<T>& a, int npanels, void* stream) {
  if (!p.smem_route && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define HYLU_PANEL_LAUNCH(NW_, SMEM_) \
  return launch_t<T, NW_, SMEM_, BUCKET>(p, a, npanels, st)
  if (p.nwf == 1) {
    if (p.smem_route) HYLU_PANEL_LAUNCH(1, true);
    HYLU_PANEL_LAUNCH(1, false);
  }
  if (p.nwf == 4) {
    if (p.smem_route) HYLU_PANEL_LAUNCH(4, true);
    HYLU_PANEL_LAUNCH(4, false);
  }
  if (p.smem_route) HYLU_PANEL_LAUNCH(8, true);
  HYLU_PANEL_LAUNCH(8, false);
#undef HYLU_PANEL_LAUNCH
}

template <typename T>
bool shape_ok(long long npanels, int nr, int ww, int np) {
  return nr >= 1 && nr <= kMaxRows && npanels >= 1 && npanels < (1LL << 31) &&
         ww >= nr && np >= 0 &&
         (long long)(nr + 1) * window_ld<T>(ww) < (1LL << 31);
}

template <typename T>
long long scratch_elems(int nr, int ww, int np, bool inplace) {
  if (!shape_ok<T>(1, nr, ww, np)) return -1;
  const Plan p = make_plan<T>(1, nr, ww, np, inplace);
  return p.smem_route ? 0 : (long long)(nr + 1) * p.ldw;
}

// K2: node panels, window [c0, w), prefix [0, c0), panel b at in + b sb.
template <typename T>
int launch_node(const void* in, long long sb, void* out, void* perm,
                void* nper, const void* eps, void* scratch, int npanels,
                int nr, int w, int c0, void* stream) {
  if (c0 < 0 || sb < 0 || !shape_ok<T>(npanels, nr, w - c0, c0))
    return (int)cudaErrorInvalidValue;
  Args<T> a{};
  a.in = static_cast<const T*>(in);
  a.out = static_cast<T*>(out);
  a.sb = sb;
  a.sbo = (long long)nr * w;
  a.perm = static_cast<int*>(perm);
  a.nper = static_cast<int*>(nper);
  a.eps = static_cast<const T*>(eps);
  a.scratch = static_cast<T*>(scratch);
  a.nr = nr;
  a.ww = w - c0;
  a.ld = w;
  a.wsrc = c0;
  a.psrc = 0;
  a.np = c0;
  const Plan p = make_plan<T>(npanels, nr, w - c0, c0, false);
  return launch<T, false>(p, a, npanels, stream);
}

// K1 on contiguous panels [window | prefix]: window [0, wu), prefix
// [wu, wt).
template <typename T>
int launch_batched(const void* in, void* out, void* perm, void* nper,
                   const void* eps, void* scratch, int npanels, int nr,
                   int wt, int wu, void* stream) {
  if (!shape_ok<T>(npanels, nr, wu, wt - wu))
    return (int)cudaErrorInvalidValue;
  Args<T> a{};
  a.in = static_cast<const T*>(in);
  a.out = static_cast<T*>(out);
  a.sb = a.sbo = (long long)nr * wt;
  a.perm = static_cast<int*>(perm);
  a.nper = static_cast<int*>(nper);
  a.eps = static_cast<const T*>(eps);
  a.scratch = static_cast<T*>(scratch);
  a.nr = nr;
  a.ww = wu;
  a.ld = wt;
  a.wsrc = 0;
  a.psrc = wu;
  a.np = wt - wu;
  const Plan p = make_plan<T>(npanels, nr, wu, wt - wu, false);
  return launch<T, false>(p, a, npanels, stream);
}

// K1 in place: the nsys x bper members of one panel bucket in the value
// buffer vals (nsys rows of ldv slots).
template <typename T>
int launch_bucket(void* vals, long long ldv, const void* desc, void* perm,
                  void* nper, const void* eps, void* scratch, int nsys,
                  int bper, int nrp, int wu, int lsp, int zero, int one,
                  void* stream) {
  if (nsys < 1 || bper < 1 || zero < 0 || one < 0 || zero >= ldv ||
      one >= ldv || !shape_ok<T>((long long)nsys * bper, nrp, wu, lsp))
    return (int)cudaErrorInvalidValue;
  const int npanels = nsys * bper;
  const Plan p = make_plan<T>(npanels, nrp, wu, lsp, true);
  if (lsp > 0 && p.scw < 1) return (int)cudaErrorInvalidValue;
  Args<T> a{};
  a.in = static_cast<const T*>(vals);
  a.out = static_cast<T*>(vals);
  a.desc = static_cast<const int*>(desc);
  a.ldv = ldv;
  a.bper = bper;
  a.zero = zero;
  a.one = one;
  a.perm = static_cast<int*>(perm);
  a.nper = static_cast<int*>(nper);
  a.eps = static_cast<const T*>(eps);
  a.scratch = static_cast<T*>(scratch);
  a.nr = nrp;
  a.ww = wu;
  a.np = lsp;
  return launch<T, true>(p, a, npanels, stream);
}

}  // namespace node
}  // namespace

// panel_lu_kernel.  in: npanels panels of nr x wt (rows dense, panel b at
// in + b * sb); out: (npanels, nr, wt) dense; perm (npanels, nr) and nper
// (npanels,) int32; eps (npanels,); eliminated over [c0, wlim), pivots in
// the block at column c0; nr <= 16,384.
extern "C" int hylu_panel_lu_f64(const void* in, long long sb, void* out,
                                 void* perm, void* nper, const void* eps,
                                 int npanels, int nr, int wt, int c0,
                                 int wlim, void* stream) {
  return launch_panel_lu<double>(in, sb, out, perm, nper, eps, npanels, nr,
                                 wt, c0, wlim, stream);
}

extern "C" int hylu_panel_lu_f32(const void* in, long long sb, void* out,
                                 void* perm, void* nper, const void* eps,
                                 int npanels, int nr, int wt, int c0,
                                 int wlim, void* stream) {
  return launch_panel_lu<float>(in, sb, out, perm, nper, eps, npanels, nr,
                                wt, c0, wlim, stream);
}

extern "C" int hylu_panel_lu_bf16(const void* in, long long sb, void* out,
                                  void* perm, void* nper, const void* eps,
                                  int npanels, int nr, int wt, int c0,
                                  int wlim, void* stream) {
  return launch_panel_lu<bf16r>(in, sb, out, perm, nper, eps, npanels, nr,
                                wt, c0, wlim, stream);
}

extern "C" const char* hylu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Elements of device-memory scratch a launch needs per panel of nr rows,
// a window of ww columns and a prefix of np (in place: at most np): 0 when
// the window is staged in shared memory, -1 for a shape it refuses.
extern "C" long long hylu_panel_lu_scratch(int nr, int ww, int np,
                                           int inplace, int elem_bytes) {
  return elem_bytes == 8
             ? node::scratch_elems<double>(nr, ww, np, inplace != 0)
         : elem_bytes == 4
             ? node::scratch_elems<float>(nr, ww, np, inplace != 0)
             : node::scratch_elems<bf16r>(nr, ww, np, inplace != 0);
}

// K2.  in: npanels panels of nr x w (rows dense, panel b at in + b * sb);
// out: (npanels, nr, w) dense; perm (npanels, nr) and nper (npanels,)
// int32; eps (npanels,); scratch: npanels times hylu_panel_lu_scratch(nr,
// w - c0, c0, 0) elements, or null when that is 0.
extern "C" int hylu_node_panel_lu_f64(const void* in, long long sb, void* out,
                                      void* perm, void* nper, const void* eps,
                                      void* scratch, int npanels, int nr,
                                      int w, int c0, void* stream) {
  return node::launch_node<double>(in, sb, out, perm, nper, eps, scratch,
                                   npanels, nr, w, c0, stream);
}

extern "C" int hylu_node_panel_lu_f32(const void* in, long long sb, void* out,
                                      void* perm, void* nper, const void* eps,
                                      void* scratch, int npanels, int nr,
                                      int w, int c0, void* stream) {
  return node::launch_node<float>(in, sb, out, perm, nper, eps, scratch,
                                  npanels, nr, w, c0, stream);
}

extern "C" int hylu_node_panel_lu_bf16(const void* in, long long sb,
                                       void* out, void* perm, void* nper,
                                       const void* eps, void* scratch,
                                       int npanels, int nr, int w, int c0,
                                       void* stream) {
  return node::launch_node<bf16r>(in, sb, out, perm, nper, eps, scratch,
                                  npanels, nr, w, c0, stream);
}

// K1 on contiguous panels.  in, out: (npanels, nr, wt) [window (wu) |
// prefix]; perm (npanels, nr), nper (npanels,) int32; eps (npanels,);
// scratch: npanels times hylu_panel_lu_scratch(nr, wu, wt - wu, 0).
extern "C" int hylu_panel_lu_batched_f64(const void* in, void* out,
                                         void* perm, void* nper,
                                         const void* eps, void* scratch,
                                         int npanels, int nr, int wt, int wu,
                                         void* stream) {
  return node::launch_batched<double>(in, out, perm, nper, eps, scratch,
                                      npanels, nr, wt, wu, stream);
}

extern "C" int hylu_panel_lu_batched_f32(const void* in, void* out,
                                         void* perm, void* nper,
                                         const void* eps, void* scratch,
                                         int npanels, int nr, int wt, int wu,
                                         void* stream) {
  return node::launch_batched<float>(in, out, perm, nper, eps, scratch,
                                     npanels, nr, wt, wu, stream);
}

extern "C" int hylu_panel_lu_batched_bf16(const void* in, void* out,
                                          void* perm, void* nper,
                                          const void* eps, void* scratch,
                                          int npanels, int nr, int wt, int wu,
                                          void* stream) {
  return node::launch_batched<bf16r>(in, out, perm, nper, eps, scratch,
                                     npanels, nr, wt, wu, stream);
}

// K1 in place.  vals: (nsys, ldv), read and written; desc: (bper, 5) int32
// per bucket member (slot offset, nr, w, lsize, usize), each with nr <=
// nrp, usize <= wu - nrp and lsize <= lsp; perm (nsys * bper, nrp) and
// nper (nsys * bper,) int32, panel k * bper + m for member m of system k;
// eps (nsys,); zero, one: the sentinel slots; scratch: nsys * bper times
// hylu_panel_lu_scratch(nrp, wu, lsp, 1) elements.
extern "C" int hylu_bucket_panel_lu_f64(void* vals, long long ldv,
                                        const void* desc, void* perm,
                                        void* nper, const void* eps,
                                        void* scratch, int nsys, int bper,
                                        int nrp, int wu, int lsp, int zero,
                                        int one, void* stream) {
  return node::launch_bucket<double>(vals, ldv, desc, perm, nper, eps,
                                     scratch, nsys, bper, nrp, wu, lsp, zero,
                                     one, stream);
}

extern "C" int hylu_bucket_panel_lu_f32(void* vals, long long ldv,
                                        const void* desc, void* perm,
                                        void* nper, const void* eps,
                                        void* scratch, int nsys, int bper,
                                        int nrp, int wu, int lsp, int zero,
                                        int one, void* stream) {
  return node::launch_bucket<float>(vals, ldv, desc, perm, nper, eps,
                                    scratch, nsys, bper, nrp, wu, lsp, zero,
                                    one, stream);
}

extern "C" int hylu_bucket_panel_lu_bf16(void* vals, long long ldv,
                                         const void* desc, void* perm,
                                         void* nper, const void* eps,
                                         void* scratch, int nsys, int bper,
                                         int nrp, int wu, int lsp, int zero,
                                         int one, void* stream) {
  return node::launch_bucket<bf16r>(vals, ldv, desc, perm, nper, eps,
                                    scratch, nsys, bper, nrp, wu, lsp, zero,
                                    one, stream);
}
