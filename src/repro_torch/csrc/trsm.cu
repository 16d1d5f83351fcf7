// Dense triangular solves against a supernode's diagonal block: the Hopper
// counterpart of the Pallas TRSM
//
//   src/repro/kernels/trisolve/kernel.py:21  _trsm_kernel
//       (trsm_upper :37, pallas_call :47), reached through trisolve/ops.py
//       trsm_batched (:48) and the left solves (:69, :81).
//
// Three solve entry points, each for k <= 128:
//   hylu_trsm_right_*             Y U = X per batch member (sup-sup edges);
//                                 U upper, optionally unit-diagonal, taken
//                                 with its batch and row strides (a view of
//                                 the gathered source rows); only U's upper
//                                 triangle is read.
//   hylu_trsm_left_unit_lower_*   L w = b with L = tril(blk, -1) + I;
//   hylu_trsm_left_upper_*        U w = b with U = triu(blk).
// The left solves read the diagonal block of the panel buffer in place:
// none of the triu / swapaxes / flip copies of trisolve/ops.py:69-90 is
// made, and k is not padded to a multiple of 8.  These kernels take any
// k <= 128 (the default supernode cap).  Supernodes may have up to
// max_super rows, which the options do not bound, so each entry has a wide
// instance for any k (hylu_trsm_right_wide_*,
// hylu_trsm_left_unit_lower_wide_*, hylu_trsm_left_upper_wide_*): one
// launch per call, as the Pallas kernel makes one call for any k (below,
// "Wide solves").  Every kernel has float64, float32 and bfloat16
// instances (below, "bfloat16").
//
// What bounds it on the card: neither bytes (k = 128 f64 is 64 KB of a
// triangle read once) nor operations, but the latency of the k-step
// recurrence: each step needs the one before it.  So the recurrence is
// blocked, and only the small diagonal solves stay sequential; each of
// their divisions is a product by the diagonal's reciprocal corrected to
// the true quotient's bits (div_fast, csrc/div_fast.cuh: two fma on the
// chain, no branch, and no slow path for a zero dividend, as a true
// division has).
//
// Right solve.  One block of 128 threads per (batch member, tile of 32
// rows of X).  cp.async stages the X tile and only U's upper triangle
// (16-byte copies where U's rows and X are 16-byte aligned, else 8 or 4),
// one commit group per block of 16 rows of U, all issued up front, so the
// first diagonal block starts while the rest is still landing.  Per column
// block of 16, right-looking: each row's thread solves the 16 x 16
// diagonal block in registers, then all four warps apply the trailing
// update Y[:, J+1:] -= Y[:, J] U[J, J+1:] from shared memory: float64 on
// the fp64 tensor cores (mma.sync m8n8k4, the fragments of csrc/bmm.cu),
// float32 on an 8 x 4 FMA register tile per thread (no TF32).  Two
// barriers per column block; the dependent chain per row is k quotients
// and FMAs.  Tiles of 16 or 64 rows and column blocks of 8 or 32 were no
// faster on the card.
//
// Left solves.  One block per (batch member, tile of right-hand-side
// columns: 1 for the path's single column, else 4), so m = 1 idles nothing
// of a tile; warp w owns rows 32w..32w+31 and keeps their w values in
// registers for the whole sweep.  cp.async stages only the triangle that
// is read, one commit group per 32-column block in the order the sweep
// needs them.  Per 32-column block the owning warp solves the diagonal
// block with w_j broadcast by __shfl_sync (no block barrier inside),
// publishes the 32 values, and after one barrier every warp with rows
// still to update applies the block's columns to its own rows: k / 32 + 1
// barriers per sweep (5 at k = 128).
//
// Wide solves (k > 128).  The Pallas kernel keeps U resident for any k; at k =
// 256 the float64 triangle alone is 263 KB, past the 227 KB of shared memory a
// block may have, so here it streams.  Right: the design above, with U read
// through a cp.async ring of two tiles of kB rows by 128 columns, in the order
// the sweep reads them (column block J's rows, from column Jb on, 128 columns
// at a time; chunks wholly below the diagonal are not copied).  A barrier per
// tile, one more after each diagonal block; the next tile's copy, issued by
// the warps that do not solve the diagonal block, runs under the current one's
// work.  The tile of Y stays in shared memory with 32, 16 or 8 rows of X per
// block, the most that fit (with fewer 8-row blocks than warps the warps split
// the update's columns); past k of some 2,400 in float64 even 8 do not, and a
// tile of 32 rows lives in a device-memory scratch that the wrapper allocates
// (L2-resident at such sizes).  float64 blocks have 256 threads, so that eight
// warps share the DMMA update: by graph replay at k = 140 / 256 / 600 on 32 x
// 256 rows of X, 0.030 / 0.069 / 0.43 ms, against 0.032 / 0.079 / 0.61 with
// 128 threads and 0.044 / 0.10 / 0.40 with 512 (tools/time_trsm_wide.py on an
// H100); a ring of three tiles left one block per SM at k = 256 (0.10). 
// float32 keeps 128 threads (its FMA tile takes 168 registers a thread). 
// Left: nt = min(k rounded up to 32, 256) threads, thread i owning rows i, i +
// nt, ... (rounds of nt rows); w is kept in shared memory, or in W itself
// where k x MC values do not fit beside the ring.  The triangle streams
// through a ring of two tiles of nt rows by 32 columns: for column block J the
// round holding the diagonal block first, whose warp solves the block by
// __shfl_sync as above, then the other rounds still to be updated.  A barrier
// per tile and one per column block.  The shared-memory limit of each wide
// kernel is raised to the device's opt-in maximum once per device.
//
// bfloat16 (hylu_trsm_*_bf16, hylu_trsm_*_wide_bf16).  The plain version's
// arithmetic in bfloat16 (trisolve/ref.py, as PyTorch runs it): storage is
// bfloat16, arithmetic float32.  For unknown j, S_j is the float32 sum of
// the products of the unknowns already solved with their coefficients
// (each product of two bfloat16 values is exact in float32), then
//     v = bf16(x_j - bf16(S_j)),   y_j = bf16(v / d_j)   (y_j = v for a
// unit diagonal; the quotient div_fast's, a true division's bits), and
// nothing is upcast past that.  Each bfloat16 kernel is the instance of the
// float32 design above on a bfloat16 storage type: the triangle and X (or
// b) are staged as bfloat16 by the same cp.async groups and rings, the
// float32 sums live beside them (a float32 tile of S next to the bfloat16
// tile of X in the right solves, registers or shared memory in the left
// ones), the diagonal blocks round as above, and the trailing updates are
// the float32 FMA updates on bfloat16 coefficients widened as they are
// read.  Every S_j is summed in the sweep's order (ascending j, descending
// for U w = b), one fma a product, so the results are those of a
// sequential solve that rounds at those points.  The right solves' tile of
// S holds, for each unknown already solved, -y_j, so that the float32
// update's Y[:, t] -= Y[:, J] U[J, t] adds y_j u to the sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "div_fast.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kRows = 32;          // rows of X per block (right solve)
constexpr int kB = 16;             // column block of the right solve
constexpr int kThreads = 128;      // right solve
constexpr int kLeftB = 32;         // column block of the left solves (a warp)

// shared-memory row length of the right solve: a multiple of 8 past k
// (the 8-wide DMMA column blocks stay inside the row) plus 4, so that the
// 8 rows of a DMMA fragment load fall in distinct bank pairs but for one
// repeat (two wavefronts, the least for 256 bytes)
__host__ __device__ constexpr int right_ld(int k) {
  return (k + 7) / 8 * 8 + 4;
}
// the left solves: rows 16-byte aligned for 16-byte copies, and 16 bytes
// past a multiple of 32, so that a column read across a warp's lanes (lane
// i owns row i) meets 8 distinct banks or bank pairs: 4 wavefronts, not 32
// (also the row length of the bfloat16 triangle and X of the right solves)
template <typename T>
__host__ __device__ constexpr int left_ld(int k) {
  return sizeof(T) == 8   ? (k + 3) / 4 * 4 + 2
         : sizeof(T) == 4 ? (k + 7) / 8 * 8 + 4
                          : (k + 15) / 16 * 16 + 8;
}

// bfloat16 instances: storage T, arithmetic arith_t<T> (float32); the
// float64 and float32 instances compute in their own type
using bf16 = __nv_bfloat16;
template <typename T>
constexpr bool kBf = std::is_same_v<T, bf16>;
template <typename T>
using arith_t = std::conditional_t<kBf<T>, float, T>;

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T>
__device__ __forceinline__ T narrow(arith_t<T> v) {
  if constexpr (kBf<T>)
    return __float2bfloat16_rn(v);
  else
    return v;
}

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a bfloat16 unknown before its division: bf16(x - bf16(S)), S its float32
// sum of products
__device__ __forceinline__ float bf_minus(float x, float S) {
  return bf_round(__fsub_rn(x, bf_round(S)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes, of which the first `src_bytes` are read and the
// rest zero-filled.  A 2-byte copy (bfloat16 rows that are not 4-byte
// aligned) has no cp.async and is a plain load and store.
template <int size>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (size == 2)
    *static_cast<uint16_t*>(dst) =
        src_bytes ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  else if constexpr (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(size), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n committed groups are in flight (n clamped to 7: a
// smaller n waits for more, never for less)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n < 7 ? n : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void dmma(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// ------------------------------------------------------------ right solve
// Trailing update of column block Jb.. (kB wide) on the columns t0..k-1:
// Ys[:, t0:] -= Ys[:, Jb:Jb+kB] Us[Jb:Jb+kB, t0:], rows below `rows` skipped
// by whole 8-row blocks.  float64: warp w takes 8-row blocks w, w+4, ...;
// DMMA fragments A[l/4][l%4], B[l%4][l/4], C[l/4][2(l%4) + {0,1}], A negated
// so the product subtracts.  Columns past k (up to the next multiple of 8)
// only carry garbage within themselves and are never stored.  U's rows are
// ld apart, as Y's.
__device__ __forceinline__ void right_update(double* Ys, int ld,
                                             const double* Us, int,
                                             int Jb, int t0, int k,
                                             int rows, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int nct = (k - t0 + 7) / 8;
  for (int rb = warp; rb * 8 < rows; rb += kThreads / 32) {
    const double* Ar = Ys + (rb * 8 + lane / 4) * ld + Jb + lane % 4;
    double a[kB / 4];
#pragma unroll
    for (int s = 0; s < kB / 4; ++s) a[s] = -Ar[4 * s];
    double* Cr = Ys + (rb * 8 + lane / 4) * ld + t0 + 2 * (lane % 4);
    const double* Br = Us + (Jb + lane % 4) * ld + t0 + lane / 4;
#pragma unroll 2
    for (int cb = 0; cb < nct; ++cb) {
      double2 c2 = *reinterpret_cast<double2*>(Cr + 8 * cb);
      double d[2] = {c2.x, c2.y};
#pragma unroll
      for (int s = 0; s < kB / 4; ++s) dmma(d, a[s], Br[4 * s * ld + 8 * cb]);
      *reinterpret_cast<double2*>(Cr + 8 * cb) = make_double2(d[0], d[1]);
    }
  }
}

// float32 (U float32, or bfloat16 widened as it is read, rows ldu apart):
// thread (lane, warp) owns rows 8 rb + (0..7) of its 8-row blocks and
// columns t0 + lane + 32 j, j < 4; per depth step 8 broadcast loads of Y
// and 4 consecutive loads of U feed 32 FMAs.
template <typename TU>
__device__ __forceinline__ void right_update(float* Ys, int ld, const TU* Us,
                                             int ldu, int Jb, int t0, int k,
                                             int rows, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  for (int rb = warp; rb * 8 < rows; rb += kThreads / 32) {
    float acc[8][4];
    float* Yr = Ys + rb * 8 * ld;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t0 + lane + 32 * j;
        acc[i][j] = c < k ? Yr[i * ld + c] : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kB; ++kk) {
      float u[4], y[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t0 + lane + 32 * j;
        u[j] = c < k ? widen(Us[(Jb + kk) * ldu + c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = Yr[i * ld + Jb + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(-y[i], u[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t0 + lane + 32 * j;
        if (c < k) Yr[i * ld + c] = acc[i][j];
      }
  }
}

// One row's kB x kB diagonal block, right-looking in registers: y (bj
// entries at yr, this row of the tile) times U's block (Ud, row length ld)
// equals the tile's entries; Dg, Rd: the block's diagonal and reciprocals.
// FULL (bj == kB): no guard at all, so the loads of U leave the dependent
// chain.  Where div_fast cannot vouch for a quotient, the block is solved
// again from yr by true division.
template <bool FULL, typename T>
__device__ __forceinline__ void right_diag(T* yr, const T* Ud, const T* Dg,
                                           const double* Rd, int ld, int bj) {
  T y[kB];
  bool ok = true;
#pragma unroll
  for (int q = 0; q < kB; ++q)
    if (FULL || q < bj) y[q] = yr[q];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    if (FULL || j < bj) {
      y[j] = div_fast(y[j], Dg[j], Rd[j], ok);
#pragma unroll
      for (int q = j + 1; q < kB; ++q)
        if (FULL || q < bj) y[q] -= y[j] * Ud[j * ld + q];
    }
  }
  if (ok) {
#pragma unroll
    for (int q = 0; q < kB; ++q)
      if (FULL || q < bj) yr[q] = y[q];
  } else {
    for (int j = 0; j < bj; ++j) {
      const T yj = true_div(yr[j], Dg[j]);
      yr[j] = yj;
      for (int q = j + 1; q < bj; ++q) yr[q] -= yj * Ud[j * ld + q];
    }
  }
}

// The bfloat16 diagonal block, as right_diag: sr holds this row's float32
// sums S of the block's unknowns and gets -y back (the tile's convention),
// xr the row's bfloat16 X; U's block is bfloat16, rows ld apart.
template <bool FULL>
__device__ __forceinline__ void right_diag_bf(float* sr, const bf16* xr,
                                              const bf16* Ud, const float* Dg,
                                              const double* Rd, int ld,
                                              int bj) {
  float s[kB], x[kB];
  bool ok = true;
#pragma unroll
  for (int q = 0; q < kB; ++q)
    if (FULL || q < bj) {
      s[q] = sr[q];
      x[q] = widen(xr[q]);
    }
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    if (FULL || j < bj) {
      const float y = bf_round(div_fast(bf_minus(x[j], s[j]), Dg[j], Rd[j],
                                        ok));
      s[j] = -y;
#pragma unroll
      for (int q = j + 1; q < kB; ++q)
        if (FULL || q < bj) s[q] = fmaf(y, widen(Ud[j * ld + q]), s[q]);
    }
  }
  if (ok) {
#pragma unroll
    for (int q = 0; q < kB; ++q)
      if (FULL || q < bj) sr[q] = s[q];
  } else {
    for (int j = 0; j < bj; ++j) {
      const float y = bf_round(true_div(bf_minus(widen(xr[j]), sr[j]),
                                        Dg[j]));
      sr[j] = -y;
      for (int q = j + 1; q < bj; ++q)
        sr[q] = fmaf(y, widen(Ud[j * ld + q]), sr[q]);
    }
  }
}

// Shared memory of the right solve: U's triangle (k x ldu of T), the tile
// of Y (kRows x right_ld(k) of the arithmetic type; bfloat16: the float32
// sums), bfloat16 only the tile of X (kRows x ldu), U's diagonal's
// reciprocals (k double) and the diagonal (k).  ldu is right_ld(k) but in
// bfloat16, whose rows must be 16-byte aligned for 16-byte copies.
template <typename T>
__host__ __device__ constexpr int right_ldu(int k) {
  return kBf<T> ? left_ld<T>(k) : right_ld(k);
}

template <typename T>
constexpr size_t right_smem(int k) {
  using A = arith_t<T>;
  return (size_t)k * right_ldu<T>(k) * sizeof(T) +
         (size_t)kRows * right_ld(k) * sizeof(A) +
         (kBf<T> ? (size_t)kRows * right_ldu<T>(k) * sizeof(T) : 0) +
         (size_t)k * (8 + sizeof(A));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
trsm_right_kernel(const T* __restrict__ U, long long su_b, long long su_r,
                  const T* __restrict__ X, T* __restrict__ Y, int nr, int k,
                  int unit_diag, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = arith_t<T>;
  const int ld = right_ld(k), ldu = right_ldu<T>(k);
  T* Us = reinterpret_cast<T*>(smem_raw);      // k x ldu, upper triangle
  A* Ys = reinterpret_cast<A*>(Us + k * ldu);   // kRows x ld
  T* Xs = kBf<T> ? reinterpret_cast<T*>(Ys + kRows * ld)   // kRows x ldu
                 : reinterpret_cast<T*>(Ys);
  double* Rd = reinterpret_cast<double*>(
      kBf<T> ? static_cast<void*>(Xs + kRows * ldu)
             : static_cast<void*>(Ys + kRows * ld));        // k
  A* Dg = reinterpret_cast<A*>(Rd + k);         // U's diagonal, k
  const int ldx = kBf<T> ? ldu : ld;
  const long long e = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kRows;
  const int rows = min(kRows, nr - r0);
  const int tid = threadIdx.x;
  const T* Ue = U + e * su_b;
  const T* Xe = X + (e * nr + r0) * k;
  const int nb = (k + kB - 1) / kB;
  const int nch = (k + V - 1) / V;              // V-element chunks per row
  constexpr int S = (int)sizeof(T);

  // group 0: the X tile and U's rows 0..kB-1; group J: U's rows of block J.
  // Chunks wholly left of the diagonal are not copied.
  for (int i = tid; i < rows * nch; i += kThreads) {
    const int r = i / nch, c = (i % nch) * V;
    cp_async<V * S>(Xs + r * ldx + c, Xe + (long long)r * k + c,
                    min(V, k - c) * S);
  }
  for (int J = 0; J < nb; ++J) {
    const int Jb = J * kB, nrow = min(kB, k - Jb);
    for (int i = tid; i < nrow * nch; i += kThreads) {
      const int r = Jb + i / nch, c = (i % nch) * V;
      if (c + V > r)
        cp_async<V * S>(Us + r * ldu + c, Ue + r * su_r + c,
                        min(V, k - c) * S);
    }
    cp_commit();
  }
  if constexpr (kBf<T>)           // the sums start at zero
    for (int i = tid; i < rows * ld; i += kThreads) Ys[i] = 0.f;
  // the diagonal and its reciprocals (ones for a unit diagonal), read apart
  // from the copies and visible after the first barrier
  for (int t = tid; t < k; t += kThreads) {
    const A d = unit_diag ? A(1) : widen(Ue[t * su_r + t]);
    Dg[t] = d;
    Rd[t] = recip(d);
  }

  for (int J = 0; J < nb; ++J) {
    const int Jb = J * kB, bj = min(kB, k - Jb);
    cp_wait(nb - 1 - J);          // block J's rows of U (and X) have landed
    __syncthreads();              // for every thread; last update done
    if (tid < rows) {
      A* yr = Ys + tid * ld + Jb;
      const T* Ud = Us + Jb * ldu + Jb;
      if constexpr (kBf<T>) {
        const T* xr = Xs + tid * ldx + Jb;
        if (bj == kB)
          right_diag_bf<true>(yr, xr, Ud, Dg + Jb, Rd + Jb, ldu, bj);
        else
          right_diag_bf<false>(yr, xr, Ud, Dg + Jb, Rd + Jb, ldu, bj);
      } else {
        if (bj == kB)
          right_diag<true>(yr, Ud, Dg + Jb, Rd + Jb, ld, bj);
        else
          right_diag<false>(yr, Ud, Dg + Jb, Rd + Jb, ld, bj);
      }
    }
    if (J + 1 < nb) {
      __syncthreads();            // block J of every row is final
      right_update(Ys, ld, Us, ldu, Jb, Jb + kB, k, rows, tid);
    }
  }
  __syncthreads();

  T* Ye = Y + (e * nr + r0) * k;
  for (int i = tid; i < rows * k; i += kThreads) {
    const A y = Ys[(i / k) * ld + i % k];
    Ye[i] = narrow<T>(kBf<T> ? -y : y);
  }
}

// ------------------------------------------------------------- left solves
// The diagonal blocks of the left solves, one warp each: lane i holds row
// Jb + i (w, its MC right-hand-side entries) and Ar its row of the block;
// w_j goes to the other lanes by __shfl_sync.  Every step runs for every
// lane under a predicate (no branch, so the block's loads leave the chain);
// lanes at or past bj are rows past k and change nothing.
template <typename T, int MC>
__device__ __forceinline__ void lower_diag(T (&w)[MC], const T* Ar, int lane,
                                           int bj) {
#pragma unroll
  for (int j = 0; j < kLeftB - 1; ++j) {
    const bool upd = lane > j && lane < bj;
    const T l = upd ? Ar[j] : T(0);
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      const T wj = __shfl_sync(0xffffffffu, w[c], j);
      if (upd) w[c] -= l * wj;
    }
  }
}

// Backward: lane j divides by its diagonal d (reciprocal rd), then the lanes
// above take w_j.  EXACT: by true division (the rare second pass); else by
// div_fast, returning false where it cannot vouch for a quotient.
template <bool EXACT, typename T, int MC>
__device__ __forceinline__ bool upper_diag(T (&w)[MC], const T* Ar, T d,
                                           double rd, int lane, int bj) {
  bool ok = true;
#pragma unroll
  for (int j = kLeftB - 1; j >= 0; --j) {
    if (EXACT) {
      if (lane == j) {
#pragma unroll
        for (int c = 0; c < MC; ++c) w[c] = true_div(w[c], d);
      }
    } else {
      bool okj = true;
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        const T q = div_fast(w[c], d, rd, okj);
        if (lane == j) w[c] = q;
      }
      ok &= lane != j || okj;
    }
    const bool upd = lane < j && j < bj;
    const T u = upd ? Ar[j] : T(0);
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      const T wj = __shfl_sync(0xffffffffu, w[c], j);
      if (upd) w[c] -= u * wj;
    }
  }
  return ok;
}

// The bfloat16 diagonal blocks, as lower_diag and upper_diag: w holds lane
// i's float32 sums S and comes back holding its y, x its right-hand side;
// lane j's unknown is rounded from them (bf_minus) when its step comes.
template <int MC>
__device__ __forceinline__ void lower_diag_bf(float (&w)[MC],
                                              const float (&x)[MC],
                                              const bf16* Ar, int lane,
                                              int bj) {
#pragma unroll
  for (int j = 0; j < kLeftB - 1; ++j) {
    const bool upd = lane > j && lane < bj;
    const float l = upd ? widen(Ar[j]) : 0.f;
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      const float yj = __shfl_sync(0xffffffffu, bf_minus(x[c], w[c]), j);
      if (upd) w[c] = fmaf(l, yj, w[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < MC; ++c) w[c] = bf_minus(x[c], w[c]);
}

template <bool EXACT, int MC>
__device__ __forceinline__ bool upper_diag_bf(float (&w)[MC],
                                              const float (&x)[MC],
                                              const bf16* Ar, float d,
                                              double rd, int lane, int bj) {
  bool ok = true;
#pragma unroll
  for (int j = kLeftB - 1; j >= 0; --j) {
    if (EXACT) {
      if (lane == j) {
#pragma unroll
        for (int c = 0; c < MC; ++c)
          w[c] = bf_round(true_div(bf_minus(x[c], w[c]), d));
      }
    } else {
      bool okj = true;
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        const float q = bf_round(div_fast(bf_minus(x[c], w[c]), d, rd, okj));
        if (lane == j) w[c] = q;
      }
      ok &= lane != j || okj;
    }
    const bool upd = lane < j && j < bj;
    const float u = upd ? widen(Ar[j]) : 0.f;
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      const float wj = __shfl_sync(0xffffffffu, w[c], j);
      if (upd) w[c] = fmaf(u, wj, w[c]);
    }
  }
  return ok;
}

// MC right-hand-side columns per block: 1 on the solver's path (m = 1), 4
// otherwise; V elements per copy.
template <typename T, bool UPPER, int MC, int V>
__global__ void __launch_bounds__(kMaxK)
trsm_left_kernel(const T* __restrict__ blk, const T* __restrict__ B,
                 T* __restrict__ W, int k, int m, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = arith_t<T>;
  const int lda = left_ld<T>(k);
  T* As = reinterpret_cast<T*>(smem_raw);      // k x lda, one triangle
  A* Ws = reinterpret_cast<A*>(As + k * lda);   // published w, kMaxK x MC
  const long long e = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * MC;
  const int mc = min(MC, m - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = tid;                          // warp w: rows 32w..32w+31
  const int nb = (k + kLeftB - 1) / kLeftB;
  const T* Ae = blk + e * k * k;
  const T* Be = B + e * k * m + c0;
  constexpr int S = (int)sizeof(T);

  // step s works on column block J = s (forward) or nb - 1 - s (backward);
  // group s holds that block's columns of the triangle the sweep reads, in
  // chunks of V elements (16 bytes where rows are 16-byte aligned)
  constexpr int NCH = kLeftB / V;
  for (int s = 0; s < nb; ++s) {
    const int Jb = (UPPER ? nb - 1 - s : s) * kLeftB;
    const int lo = UPPER ? 0 : Jb + 1;
    const int hi = UPPER ? min(Jb + kLeftB, k) : k;
    for (int i = tid; i < (hi - lo) * NCH; i += blockDim.x) {
      const int r = lo + i / NCH, c = Jb + (i % NCH) * V;
      if (c < k && (UPPER ? c + V > r : c < r))
        cp_async<V * S>(As + r * lda + c, Ae + (long long)r * k + c,
                        min(V, k - c) * S);
    }
    cp_commit();
  }
  // w: the right-hand side, then the solution; bfloat16: the float32 sums,
  // then the solution, the right-hand side in x
  A w[MC] = {}, x[MC] = {};
  A d = A(1);                         // this row's diagonal
  double rd = 1.0;                    // and its reciprocal
  if (row < k) {
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < mc) (kBf<T> ? x[c] : w[c]) = widen(Be[(long long)row * m + c]);
    if (UPPER) {
      d = widen(Ae[(long long)row * k + row]);
      rd = recip(d);
    }
  }
  cp_wait(nb - 1);
  __syncthreads();

  const T* Ar = As + row * lda;
  for (int s = 0; s < nb; ++s) {
    const int J = UPPER ? nb - 1 - s : s, Jb = J * kLeftB;
    const int bj = min(kLeftB, k - Jb);
    if (warp == J) {
      // the diagonal block: lane i holds row Jb + i
      if (!UPPER) {
        if constexpr (kBf<T>)
          lower_diag_bf(w, x, Ar + Jb, lane, bj);
        else
          lower_diag(w, Ar + Jb, lane, bj);
      } else {
        A w0[MC];
#pragma unroll
        for (int c = 0; c < MC; ++c) w0[c] = w[c];
        bool ok;
        if constexpr (kBf<T>)
          ok = upper_diag_bf<false>(w, x, Ar + Jb, d, rd, lane, bj);
        else
          ok = upper_diag<false>(w, Ar + Jb, d, rd, lane, bj);
        if (!__all_sync(0xffffffffu, ok)) {
#pragma unroll
          for (int c = 0; c < MC; ++c) w[c] = w0[c];
          if constexpr (kBf<T>)
            upper_diag_bf<true>(w, x, Ar + Jb, d, rd, lane, bj);
          else
            upper_diag<true>(w, Ar + Jb, d, rd, lane, bj);
        }
      }
      if (lane < bj) {
#pragma unroll
        for (int c = 0; c < MC; ++c) Ws[row * MC + c] = w[c];
      }
    }
    if (s + 1 < nb) {
      cp_wait(nb - 2 - s);        // the next step's columns have landed
      __syncthreads();            // and block J's w is published
      // the rows still to be solved take block J's columns
      if (UPPER ? warp < J : (warp > J && row < k)) {
        const A* Wj = Ws + Jb * MC;
        if constexpr (kBf<T>) {   // into the sums, in the sweep's order
          for (int i = 0; i < bj; ++i) {
            const int j = UPPER ? bj - 1 - i : i;
            const float a = widen(Ar[Jb + j]);
#pragma unroll
            for (int c = 0; c < MC; ++c) w[c] = fmaf(a, Wj[j * MC + c], w[c]);
          }
        } else {
          for (int j = 0; j < bj; ++j) {
            const T a = Ar[Jb + j];
#pragma unroll
            for (int c = 0; c < MC; ++c) w[c] -= a * Wj[j * MC + c];
          }
        }
      }
    }
  }

  if (row < k) {
    T* We = W + e * k * m + c0;
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < mc) We[(long long)row * m + c] = narrow<T>(w[c]);
  }
}

// The shared-memory limit is raised once per device and kernel to what the
// largest k needs (a CUDA API call on every launch would add to the host's
// cost per launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool* sized) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && sized[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) sized[dev] = true;
  return err;
}

template <typename T>
constexpr size_t left_smem(int k, int mc) {
  return (size_t)k * left_ld<T>(k) * sizeof(T) +
         (size_t)kMaxK * mc * sizeof(arith_t<T>);
}

template <typename T, int V>
int launch_right_v(const T* U, long long su_b, long long su_r, const T* X,
                   T* Y, int batch, int nr, int k, int unit_diag,
                   cudaStream_t stream) {
  static bool sized[64] = {};
  cudaError_t err = allow_smem(trsm_right_kernel<T, V>, right_smem<T>(kMaxK),
                               sized);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (nr + kRows - 1) / kRows;
  trsm_right_kernel<T, V><<<(unsigned)((long long)batch * tiles), kThreads,
                            right_smem<T>(k), stream>>>(
      U, su_b, su_r, X, Y, nr, k, unit_diag, tiles);
  return (int)cudaGetLastError();
}

// The widest copy (elements, at most 16 bytes) that every row start of U
// and of X allows.
template <typename T>
int right_vec(const void* U, const void* X, int k, long long su_b,
              long long su_r) {
  auto fits = [&](int v) {
    const uintptr_t bytes = (uintptr_t)v * sizeof(T);
    return k % v == 0 && su_r % v == 0 && su_b % v == 0 &&
           (reinterpret_cast<uintptr_t>(U) | reinterpret_cast<uintptr_t>(X)) %
                   bytes == 0;
  };
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2)
    if (fits(v)) return v;
  return 1;
}

// f(std::integral_constant<int, v>{}): v as a constant of the instances
// a T has (8, 4, 2, 1 for bfloat16; 4, 2, 1 for float32; 2, 1 for float64)
template <typename T, typename F>
int with_vec(int v, F&& f) {
  if constexpr (sizeof(T) == 2)
    if (v == 8) return f(std::integral_constant<int, 8>{});
  if constexpr (sizeof(T) <= 4)
    if (v == 4) return f(std::integral_constant<int, 4>{});
  if (v == 2) return f(std::integral_constant<int, 2>{});
  return f(std::integral_constant<int, 1>{});
}

template <typename T>
int launch_right(const void* U, const void* X, void* Y, int batch, int nr,
                 int k, int unit_diag, long long su_b, long long su_r,
                 void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || k > kMaxK || su_r < k)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * ((nr + kRows - 1) / kRows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return with_vec<T>(right_vec<T>(U, X, k, su_b, su_r), [&](auto v) {
    return launch_right_v<T, decltype(v)::value>(
        static_cast<const T*>(U), su_b, su_r, static_cast<const T*>(X),
        static_cast<T*>(Y), batch, nr, k, unit_diag, (cudaStream_t)stream);
  });
}

template <typename T, bool UPPER, int MC, int V>
int launch_left_v(const T* blk, const T* B, T* W, int batch, int k, int m,
                  cudaStream_t stream) {
  const int tiles = (m + MC - 1) / MC;
  if ((long long)batch * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool sized[64] = {};
  cudaError_t err = allow_smem(trsm_left_kernel<T, UPPER, MC, V>,
                               left_smem<T>(kMaxK, MC), sized);
  if (err != cudaSuccess) return (int)err;
  const int threads = (k + kLeftB - 1) / kLeftB * kLeftB;
  trsm_left_kernel<T, UPPER, MC, V><<<(unsigned)((long long)batch * tiles),
                                      threads, left_smem<T>(k, MC), stream>>>(
      blk, B, W, k, m, tiles);
  return (int)cudaGetLastError();
}

template <typename T, bool UPPER, int MC>
int launch_left_mc(const T* blk, const T* B, T* W, int batch, int k, int m,
                   cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);
  if (k % V16 == 0 && reinterpret_cast<uintptr_t>(blk) % 16 == 0)
    return launch_left_v<T, UPPER, MC, V16>(blk, B, W, batch, k, m, stream);
  return launch_left_v<T, UPPER, MC, 1>(blk, B, W, batch, k, m, stream);
}

template <typename T, bool UPPER>
int launch_left(const void* blk, const void* B, void* W, int batch, int k,
                int m, void* stream) {
  if (batch < 1 || m < 1 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(blk);
  const T* b = static_cast<const T*>(B);
  T* w = static_cast<T*>(W);
  cudaStream_t st = (cudaStream_t)stream;
  return m == 1 ? launch_left_mc<T, UPPER, 1>(a, b, w, batch, k, m, st)
                : launch_left_mc<T, UPPER, 4>(a, b, w, batch, k, m, st);
}

// ------------------------------------------------------------ wide solves
// (k > 128, any k; the header comment says how they differ from the above)
constexpr int kWideC = 128;                   // columns of a streamed U tile
constexpr int kWideLdt = right_ld(kWideC);    // its shared-memory row length
constexpr int kWideSlots = 2;                 // tiles of U in the ring
constexpr int kLeftT = 256;                   // most threads of a left solve

// threads of a wide right solve's block
template <typename T>
__host__ __device__ constexpr int wide_threads() {
  return sizeof(T) == 8 ? 256 : 128;
}

// The current device's shared-memory opt-in limit per block, read once.
int smem_optin() {
  static std::atomic<int> cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64 && cache[dev].load() > 0) return cache[dev].load();
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev >= 0 && dev < 64) cache[dev].store(v);
  return v;
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

// the row length of a streamed U tile (bfloat16 rows 16-byte aligned)
template <typename T>
__host__ __device__ constexpr int wide_ldt() {
  return kBf<T> ? left_ld<T>(kWideC) : kWideLdt;
}

// the ring of the right solve: kWideSlots tiles of kB rows of U by kWideC
// columns
template <typename T>
__host__ __device__ constexpr size_t right_ring_bytes() {
  return kWideSlots * (size_t)kB * wide_ldt<T>() * sizeof(T);
}

// the right solve's working tile: R rows of Y (row length right_ld(k), the
// arithmetic type: in bfloat16 the float32 sums), bfloat16 only R rows of X
// (row length right_ldu(k)), then U's diagonal's reciprocals (double) and
// the diagonal: k (4 + 2) bytes a row in bfloat16
template <typename T>
__host__ __device__ constexpr size_t right_tile_bytes(int k, int R) {
  using A = arith_t<T>;
  return round16(((size_t)R * right_ld(k) + k) * sizeof(A) +
                 (kBf<T> ? (size_t)R * right_ldu<T>(k) * sizeof(T) : 0) +
                 (size_t)k * 8);
}

// Rows of X per block of a wide right solve: the most of 32, 16, 8 whose
// tile fits shared memory beside the ring; 0 when none does (the tile of 32
// rows then lives in a device-memory scratch).
template <typename T>
int right_wide_rows(int k, int optin) {
  for (int R = kRows; R >= 8; R /= 2)
    if (right_ring_bytes<T>() + right_tile_bytes<T>(k, R) <= (size_t)optin)
      return R;
  return 0;
}

// Trailing update of the wide right solve on the columns [t0, t1) of one
// streamed tile, Ut pointing at U[Jb][t0] (row length kWideLdt):
// Y[:, t0:t1] -= Y[:, Jb:Jb+kB] U[Jb:Jb+kB, t0:t1].  Work items are (8-row
// block, part of the columns): with fewer than four 8-row blocks the warps
// split the columns, so that a tile of 8 or 16 rows idles no warp.
// float64 on the fp64 tensor cores, as right_update (LDT = kWideLdt).
template <int LDT>
__device__ __forceinline__ void wide_update(double* Ys, int ldy,
                                            const double* Ut, int Jb, int t0,
                                            int t1, int rows, int tid) {
  const int warp = tid / 32, lane = tid % 32, nw = blockDim.x / 32;
  const int nrb = (rows + 7) / 8, parts = nrb >= nw ? 1 : nw / nrb;
  const int nct = (t1 - t0 + 7) / 8;
  for (int it = warp; it < nrb * parts; it += nw) {
    const int rb = it % nrb, p = it / nrb;
    const double* Ar = Ys + (rb * 8 + lane / 4) * ldy + Jb + lane % 4;
    double a[kB / 4];
#pragma unroll
    for (int s = 0; s < kB / 4; ++s) a[s] = -Ar[4 * s];
    double* Cr = Ys + (rb * 8 + lane / 4) * ldy + t0 + 2 * (lane % 4);
    const double* Br = Ut + (lane % 4) * LDT + lane / 4;
#pragma unroll 4
    for (int cb = p; cb < nct; cb += parts) {
      double2 c2 = *reinterpret_cast<double2*>(Cr + 8 * cb);
      double d[2] = {c2.x, c2.y};
#pragma unroll
      for (int s = 0; s < kB / 4; ++s)
        dmma(d, a[s], Br[4 * s * LDT + 8 * cb]);
      *reinterpret_cast<double2*>(Cr + 8 * cb) = make_double2(d[0], d[1]);
    }
  }
}

// float32 on an 8 x 4 FMA register tile, as right_update (U float32, or
// bfloat16 widened as it is read; LDT its tile's row length): columns
// t0 + lane + 32 j of the part's j.
template <int LDT, typename TU>
__device__ __forceinline__ void wide_update(float* Ys, int ldy,
                                            const TU* Ut, int Jb, int t0,
                                            int t1, int rows, int tid) {
  const int warp = tid / 32, lane = tid % 32, nw = blockDim.x / 32;
  const int nrb = (rows + 7) / 8, parts = nrb >= nw ? 1 : nw / nrb;
  for (int it = warp; it < nrb * parts; it += nw) {
    const int rb = it % nrb, p = it / nrb;
    float* Yr = Ys + rb * 8 * ldy;
    bool on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      on[j] = j % parts == p && t0 + lane + 32 * j < t1;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = on[j] ? Yr[i * ldy + t0 + lane + 32 * j] : 0.f;
#pragma unroll
    for (int kk = 0; kk < kB; ++kk) {
      float u[4], y[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        u[j] = on[j] ? widen(Ut[kk * LDT + lane + 32 * j]) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = Yr[i * ldy + Jb + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(-y[i], u[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (on[j]) Yr[i * ldy + t0 + lane + 32 * j] = acc[i][j];
  }
}

// Y U = X for any k: one block of wide_threads<T>() threads per (batch
// member, tile of R rows of X).  The tile of Y (and U's diagonal with its
// reciprocals) is in shared memory, or, with scratch non-null, in the
// block's share of it.  U streams through a ring of kWideSlots tiles in
// the order the sweep reads it:
// for column block J (kB wide), its kB rows by kWideC columns from Jb on,
// then the next kWideC, and so on; only chunks that reach the diagonal are
// copied.
template <typename T, int V>
__global__ void __launch_bounds__(wide_threads<T>())
trsm_right_wide_kernel(const T* __restrict__ U, long long su_b,
                       long long su_r, const T* __restrict__ X,
                       T* __restrict__ Y, int nr, int k, int unit_diag,
                       int tiles, int R, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = arith_t<T>;
  constexpr int NT = wide_threads<T>();
  constexpr int D = kWideSlots;
  constexpr int LDT = wide_ldt<T>();
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int kSlot = kB * LDT;
  const int ldy = right_ld(k);
  unsigned char* work =
      scratch == nullptr
          ? smem_raw + right_ring_bytes<T>()
          : scratch + (long long)blockIdx.x * right_tile_bytes<T>(k, R);
  A* Ys = reinterpret_cast<A*>(work);                   // R x ldy
  // bfloat16: X apart from the sums, R x ldx; else X is staged into Ys
  const int ldx = kBf<T> ? right_ldu<T>(k) : ldy;
  T* Xs = kBf<T> ? reinterpret_cast<T*>(Ys + (size_t)R * ldy)
                 : reinterpret_cast<T*>(Ys);
  double* Rd = reinterpret_cast<double*>(
      kBf<T> ? static_cast<void*>(Xs + (size_t)R * ldx)
             : static_cast<void*>(Ys + (size_t)R * ldy));  // k
  A* Dg = reinterpret_cast<A*>(Rd + k);                 // k
  const long long e = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, nr - r0);
  const int tid = threadIdx.x;
  const T* Ue = U + e * su_b;
  const T* Xe = X + (e * nr + r0) * k;
  const int nb = (k + kB - 1) / kB;
  constexpr int S = (int)sizeof(T);

  // the X tile: cp.async into shared memory (in the first tile's group),
  // or copied into the scratch
  if (scratch == nullptr) {
    const int nch = (k + V - 1) / V;
    for (int i = tid; i < rows * nch; i += NT) {
      const int r = i / nch, c = (i % nch) * V;
      cp_async<V * S>(Xs + r * ldx + c, Xe + (long long)r * k + c,
                      min(V, k - c) * S);
    }
  } else {
    for (long long i = tid; i < (long long)rows * k; i += NT)
      Xs[(i / k) * ldx + i % k] = Xe[i];
  }
  if constexpr (kBf<T>)               // the sums start at zero
    for (long long i = tid; i < (long long)rows * ldy; i += NT) Ys[i] = 0.f;
  // tile (J, q): U's rows Jb.. of block J, columns from Jb + q kWideC, by
  // the threads from `lo` on
  auto issue = [&](int J, int q, T* slot, int lo) {
    if (tid < lo) return;
    const int Jb = J * kB, cs = Jb + q * kWideC;
    const int nrow = min(kB, k - Jb), nch = (min(kWideC, k - cs) + V - 1) / V;
    for (int i = tid - lo; i < nrow * nch; i += NT - lo) {
      const int r = i / nch, c = cs + (i % nch) * V;
      if (c + V > Jb + r)
        cp_async<V * S>(slot + r * LDT + (c - cs),
                        Ue + (long long)(Jb + r) * su_r + c,
                        min(V, k - c) * S);
    }
  };
  int pJ = 0, pq = 0;                 // the next tile to issue
  auto advance = [&]() {
    if (++pq * kWideC >= k - pJ * kB) {
      ++pJ;
      pq = 0;
    }
  };
  for (int t = 0; t < D - 1; ++t) {   // the first D - 1 tiles, a group each
    if (pJ < nb) {
      issue(pJ, pq, ring + t * kSlot, 0);
      advance();
    }
    cp_commit();
  }
  for (int t = tid; t < k; t += NT) {
    const A d = unit_diag ? A(1) : widen(Ue[(long long)t * su_r + t]);
    Dg[t] = d;
    Rd[t] = recip(d);
  }

  int tile = 0;                       // the tile being consumed
  for (int J = 0; J < nb; ++J) {
    const int Jb = J * kB, bj = min(kB, k - Jb);
    for (int q = 0; q * kWideC < k - Jb; ++q, ++tile) {
      cp_wait(D - 2);
      __syncthreads();                // tile landed; the previous one done
      // the next tile into the previous one's slot, by the warps that do
      // not solve the diagonal block
      if (pJ < nb) {
        issue(pJ, pq, ring + ((tile + D - 1) % D) * kSlot, 32);
        advance();
      }
      cp_commit();
      const T* Ut = ring + (tile % D) * kSlot;
      const int cs = Jb + q * kWideC, t1 = min(cs + kWideC, k);
      int t0 = cs;
      if (q == 0) {
        if (tid < rows) {
          A* yr = Ys + tid * ldy + Jb;
          if constexpr (kBf<T>) {
            const T* xr = Xs + tid * ldx + Jb;
            if (bj == kB)
              right_diag_bf<true>(yr, xr, Ut, Dg + Jb, Rd + Jb, LDT, bj);
            else
              right_diag_bf<false>(yr, xr, Ut, Dg + Jb, Rd + Jb, LDT, bj);
          } else {
            if (bj == kB)
              right_diag<true>(yr, Ut, Dg + Jb, Rd + Jb, kWideLdt, bj);
            else
              right_diag<false>(yr, Ut, Dg + Jb, Rd + Jb, kWideLdt, bj);
          }
        }
        t0 = Jb + kB;
        __syncthreads();              // block J of every row is final
      }
      if (t0 < t1)
        wide_update<LDT>(Ys, ldy, Ut + (t0 - cs), Jb, t0, t1, rows, tid);
    }
  }
  __syncthreads();

  T* Ye = Y + (e * nr + r0) * k;
  for (long long i = tid; i < (long long)rows * k; i += NT) {
    const A y = Ys[(i / k) * ldy + i % k];
    Ye[i] = narrow<T>(kBf<T> ? -y : y);
  }
}

// L w = b or U w = b for any k: one block of nt = min(k rounded up to 32,
// kLeftT) threads per (batch member, MC right-hand-side columns); thread i
// owns rows i, i + nt, ... (rounds of nt rows).  w is kept in shared
// memory, or in W itself (row stride m) where k x MC does not fit beside
// the ring; in bfloat16 wv holds the float32 sums, then the solution, in
// shared memory or in `sums` (float32, W's layout).  The triangle streams
// through a ring of two tiles of nt rows by 32 columns, in the order the
// sweep reads it: for column block J, the round holding the diagonal block
// first, then the rounds below it (above it, for U w = b); only chunks
// that reach the triangle are copied.
template <typename T, bool UPPER, int MC, int V>
__global__ void __launch_bounds__(kLeftT)
trsm_left_wide_kernel(const T* __restrict__ blk, const T* __restrict__ B,
                      T* W, int k, int m, int tiles, int w_in_smem,
                      arith_t<T>* sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = arith_t<T>;
  constexpr int ldt = left_ld<T>(kLeftB);
  constexpr int S = (int)sizeof(T);
  const int nt = blockDim.x;
  const int slot = nt * ldt;
  T* ring = reinterpret_cast<T*>(smem_raw);
  const long long e = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * MC;
  const int mc = min(MC, m - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nb = (k + kLeftB - 1) / kLeftB, rounds = (k + nt - 1) / nt;
  const T* Ae = blk + e * k * k;
  const T* Be = B + e * k * m + c0;
  T* We = W + e * k * m + c0;
  A* wv = w_in_smem ? reinterpret_cast<A*>(ring + 2 * slot)
                    : kBf<T> ? sums + e * k * m + c0
                             : reinterpret_cast<A*>(We);
  const long long ws = w_in_smem ? MC : m;

  for (int r = tid; r < k; r += nt)
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < mc)
        wv[r * ws + c] = kBf<T> ? A(0) : widen(Be[(long long)r * m + c]);

  auto block_of = [&](int s) { return UPPER ? nb - 1 - s : s; };
  // tile (s, q): column block J = block_of(s), round iJ -+ q, where iJ
  // holds the diagonal block
  auto issue = [&](int s, int q, T* dst) {
    const int Jb = block_of(s) * kLeftB, iJ = Jb / nt;
    const int i = UPPER ? iJ - q : iJ + q;
    const int lo = UPPER ? i * nt : max(i * nt, Jb + 1);
    const int hi = min(UPPER ? min((i + 1) * nt, Jb + kLeftB) : (i + 1) * nt,
                       k);
    constexpr int NCH = kLeftB / V;
    for (int x = tid; x < (hi - lo) * NCH; x += nt) {
      const int r = lo + x / NCH, c = Jb + (x % NCH) * V;
      if (c < k && (UPPER ? c + V > r : c < r))
        cp_async<V * S>(dst + (r - i * nt) * ldt + (c - Jb),
                        Ae + (long long)r * k + c, min(V, k - c) * S);
    }
  };
  auto count = [&](int s) {
    const int iJ = block_of(s) * kLeftB / nt;
    return UPPER ? iJ + 1 : rounds - iJ;
  };
  int ps = 0, pq = 0;                 // the next tile to issue
  auto advance = [&]() {
    if (++pq == count(ps)) {
      ++ps;
      pq = 0;
    }
  };
  issue(0, 0, ring);
  cp_commit();
  advance();

  int tile = 0;                       // the tile being consumed
  for (int s = 0; s < nb; ++s) {
    const int Jb = block_of(s) * kLeftB, bj = min(kLeftB, k - Jb);
    const int iJ = Jb / nt;
    for (int q = 0; q < count(s); ++q, ++tile) {
      cp_wait(0);
      __syncthreads();                // tile landed; the previous one done
      if (ps < nb) {
        issue(ps, pq, ring + ((tile + 1) & 1) * slot);
        advance();
      }
      cp_commit();
      const T* At = ring + (tile & 1) * slot;
      const int i = UPPER ? iJ - q : iJ + q;
      if (q == 0) {
        if (warp == (Jb - iJ * nt) / kLeftB) {
          // the diagonal block: lane l holds row Jb + l, the thread that
          // owns it in every round
          const int row = Jb + lane;
          const T* Ar = At + tid * ldt;           // from column Jb
          A w[MC], x[MC];
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            const bool in = lane < bj && c < mc;
            w[c] = in ? wv[row * ws + c] : A(0);
            if constexpr (kBf<T>)
              x[c] = in ? widen(Be[(long long)row * m + c]) : 0.f;
          }
          if (!UPPER) {
            if constexpr (kBf<T>)
              lower_diag_bf(w, x, Ar, lane, bj);
            else
              lower_diag(w, Ar, lane, bj);
          } else {
            const A d = lane < bj ? widen(Ar[lane]) : A(1);
            const double rd = lane < bj ? recip(d) : 1.0;
            A w0[MC];
#pragma unroll
            for (int c = 0; c < MC; ++c) w0[c] = w[c];
            bool ok;
            if constexpr (kBf<T>)
              ok = upper_diag_bf<false>(w, x, Ar, d, rd, lane, bj);
            else
              ok = upper_diag<false>(w, Ar, d, rd, lane, bj);
            if (!__all_sync(0xffffffffu, ok)) {
#pragma unroll
              for (int c = 0; c < MC; ++c) w[c] = w0[c];
              if constexpr (kBf<T>)
                upper_diag_bf<true>(w, x, Ar, d, rd, lane, bj);
              else
                upper_diag<true>(w, Ar, d, rd, lane, bj);
            }
          }
          if (lane < bj) {
#pragma unroll
            for (int c = 0; c < MC; ++c)
              if (c < mc) wv[row * ws + c] = w[c];
          }
        }
        __syncthreads();              // block J's w is published
      }
      // this round's rows still to be solved take block J's columns
      const int row = i * nt + tid;
      if (UPPER ? row < Jb : (row >= Jb + kLeftB && row < k)) {
        const T* Ar = At + tid * ldt;
        A acc[MC];
#pragma unroll
        for (int c = 0; c < MC; ++c) acc[c] = c < mc ? wv[row * ws + c] : A(0);
        if constexpr (kBf<T>) {       // into the sums, in the sweep's order
          for (int i2 = 0; i2 < bj; ++i2) {
            const int j = UPPER ? bj - 1 - i2 : i2;
            const float a = widen(Ar[j]);
#pragma unroll
            for (int c = 0; c < MC; ++c)
              if (c < mc) acc[c] = fmaf(a, wv[(Jb + j) * ws + c], acc[c]);
          }
        } else {
          for (int j = 0; j < bj; ++j) {
            const T a = Ar[j];
#pragma unroll
            for (int c = 0; c < MC; ++c)
              if (c < mc) acc[c] -= a * wv[(Jb + j) * ws + c];
          }
        }
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (c < mc) wv[row * ws + c] = acc[c];
      }
    }
  }

  if (w_in_smem || kBf<T>) {
    __syncthreads();
    for (int r = tid; r < k; r += nt)
#pragma unroll
      for (int c = 0; c < MC; ++c)
        if (c < mc) We[(long long)r * m + c] = narrow<T>(wv[r * ws + c]);
  }
}

template <typename T>
long long right_wide_scratch(int batch, int nr, int k) {
  if (right_wide_rows<T>(k, smem_optin()) > 0) return 0;
  return (long long)batch * ((nr + kRows - 1) / kRows) *
         (long long)right_tile_bytes<T>(k, kRows);
}

template <typename T>
int launch_right_wide(const void* U, const void* X, void* Y, int batch,
                      int nr, int k, int unit_diag, long long su_b,
                      long long su_r, void* scratch, void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || su_r < k)
    return (int)cudaErrorInvalidValue;
  const int optin = smem_optin();
  int R = right_wide_rows<T>(k, optin);
  if (R == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    R = kRows;
  } else {
    scratch = nullptr;
  }
  const long long tiles = (nr + R - 1) / R;
  if ((long long)batch * tiles > 0x7fffffffLL ||
      (long long)R * right_ld(k) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      right_ring_bytes<T>() + (scratch ? 0 : right_tile_bytes<T>(k, R));
  return with_vec<T>(right_vec<T>(U, X, k, su_b, su_r), [&](auto v) {
    auto kern = trsm_right_wide_kernel<T, decltype(v)::value>;
    static bool sized[64] = {};
    cudaError_t err = allow_smem(kern, optin, sized);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)(batch * tiles), wide_threads<T>(), smem,
           (cudaStream_t)stream>>>(
        static_cast<const T*>(U), su_b, su_r, static_cast<const T*>(X),
        static_cast<T*>(Y), nr, k, unit_diag, (int)tiles, R,
        static_cast<unsigned char*>(scratch));
    return (int)cudaGetLastError();
  });
}

// threads of a wide left solve's block, its ring's bytes, and whether the
// k x MC values of w fit shared memory beside the ring
int left_wide_threads(int k) {
  const int nt = (k + kLeftB - 1) / kLeftB * kLeftB;
  return nt > kLeftT ? kLeftT : nt;
}

template <typename T>
size_t left_wide_ring_bytes(int k) {
  return 2 * (size_t)left_wide_threads(k) * left_ld<T>(kLeftB) * sizeof(T);
}

template <typename T>
bool left_wide_w_smem(int k, int mc, int optin) {
  return left_wide_ring_bytes<T>(k) + (size_t)k * mc * sizeof(arith_t<T>) <=
         (size_t)optin;
}

template <typename T, bool UPPER, int MC>
int launch_left_wide_mc(const T* blk, const T* B, T* W, int batch, int k,
                        int m, arith_t<T>* sums, cudaStream_t stream) {
  const long long tiles = (m + MC - 1) / MC;
  if ((long long)batch * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nt = left_wide_threads(k);
  const int optin = smem_optin();
  const size_t ring = left_wide_ring_bytes<T>(k);
  const size_t wbytes = (size_t)k * MC * sizeof(arith_t<T>);
  const bool w_smem = left_wide_w_smem<T>(k, MC, optin);
  if (kBf<T> && !w_smem && sums == nullptr) return (int)cudaErrorInvalidValue;
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = k % V16 == 0 && reinterpret_cast<uintptr_t>(blk) % 16 == 0;
  auto kern = vec ? trsm_left_wide_kernel<T, UPPER, MC, V16>
                  : trsm_left_wide_kernel<T, UPPER, MC, 1>;
  static bool sized[2][64] = {};
  cudaError_t err = allow_smem(kern, optin, sized[vec]);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(batch * tiles), nt, ring + (w_smem ? wbytes : 0),
         stream>>>(blk, B, W, k, m, (int)tiles, (int)w_smem, sums);
  return (int)cudaGetLastError();
}

template <typename T, bool UPPER>
int launch_left_wide(const void* blk, const void* B, void* W, int batch,
                     int k, int m, void* sums, void* stream) {
  if (batch < 1 || m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(blk);
  const T* b = static_cast<const T*>(B);
  T* w = static_cast<T*>(W);
  auto* s = static_cast<arith_t<T>*>(sums);
  cudaStream_t st = (cudaStream_t)stream;
  return m == 1
             ? launch_left_wide_mc<T, UPPER, 1>(a, b, w, batch, k, m, s, st)
             : launch_left_wide_mc<T, UPPER, 4>(a, b, w, batch, k, m, s, st);
}

// bytes of the float32 sums a bfloat16 wide left solve keeps in device
// memory (W's layout) where they do not fit shared memory, else 0
long long left_wide_sums_bytes(int batch, int k, int m) {
  if (left_wide_w_smem<bf16>(k, m == 1 ? 1 : 4, smem_optin())) return 0;
  return (long long)batch * k * m * (long long)sizeof(float);
}

}  // namespace

// The entries of each solve: _f64, _f32 and _bf16 instances of one design.
#define HYLU_TRSM_ENTRIES(sfx, T)                                            \
  extern "C" int hylu_trsm_right_##sfx(                                      \
      const void* U, const void* X, void* Y, int batch, int nr, int k,       \
      int unit_diag, long long su_b, long long su_r, void* stream) {         \
    return launch_right<T>(U, X, Y, batch, nr, k, unit_diag, su_b, su_r,     \
                           stream);                                          \
  }                                                                          \
  extern "C" int hylu_trsm_left_unit_lower_##sfx(                            \
      const void* blk, const void* B, void* W, int batch, int k, int m,      \
      void* stream) {                                                        \
    return launch_left<T, false>(blk, B, W, batch, k, m, stream);            \
  }                                                                          \
  extern "C" int hylu_trsm_left_upper_##sfx(                                 \
      const void* blk, const void* B, void* W, int batch, int k, int m,      \
      void* stream) {                                                        \
    return launch_left<T, true>(blk, B, W, batch, k, m, stream);             \
  }                                                                          \
  extern "C" int hylu_trsm_right_wide_##sfx(                                 \
      const void* U, const void* X, void* Y, int batch, int nr, int k,       \
      int unit_diag, long long su_b, long long su_r, void* scratch,          \
      void* stream) {                                                        \
    return launch_right_wide<T>(U, X, Y, batch, nr, k, unit_diag, su_b,      \
                                su_r, scratch, stream);                      \
  }

HYLU_TRSM_ENTRIES(f64, double)
HYLU_TRSM_ENTRIES(f32, float)
HYLU_TRSM_ENTRIES(bf16, bf16)
#undef HYLU_TRSM_ENTRIES

// Wide solves (k > 128, any k) take the arguments of the entries above;
// the right solve also takes a device-memory scratch of
// hylu_trsm_right_wide_scratch(batch, nr, k, elem_bytes) bytes (null when
// that is 0: its tile then fits shared memory), and the bfloat16 left
// solves one of hylu_trsm_left_wide_scratch(batch, k, m) bytes for their
// float32 sums (null when that is 0).
extern "C" long long hylu_trsm_right_wide_scratch(int batch, int nr, int k,
                                                  int elem_bytes) {
  return elem_bytes == 8   ? right_wide_scratch<double>(batch, nr, k)
         : elem_bytes == 4 ? right_wide_scratch<float>(batch, nr, k)
                           : right_wide_scratch<bf16>(batch, nr, k);
}

extern "C" long long hylu_trsm_left_wide_scratch(int batch, int k, int m) {
  return left_wide_sums_bytes(batch, k, m);
}

extern "C" int hylu_trsm_left_unit_lower_wide_f64(const void* blk,
                                                  const void* B, void* W,
                                                  int batch, int k, int m,
                                                  void* stream) {
  return launch_left_wide<double, false>(blk, B, W, batch, k, m, nullptr,
                                         stream);
}

extern "C" int hylu_trsm_left_unit_lower_wide_f32(const void* blk,
                                                  const void* B, void* W,
                                                  int batch, int k, int m,
                                                  void* stream) {
  return launch_left_wide<float, false>(blk, B, W, batch, k, m, nullptr,
                                        stream);
}

extern "C" int hylu_trsm_left_unit_lower_wide_bf16(const void* blk,
                                                   const void* B, void* W,
                                                   int batch, int k, int m,
                                                   void* sums, void* stream) {
  return launch_left_wide<bf16, false>(blk, B, W, batch, k, m, sums, stream);
}

extern "C" int hylu_trsm_left_upper_wide_f64(const void* blk, const void* B,
                                             void* W, int batch, int k,
                                             int m, void* stream) {
  return launch_left_wide<double, true>(blk, B, W, batch, k, m, nullptr,
                                        stream);
}

extern "C" int hylu_trsm_left_upper_wide_f32(const void* blk, const void* B,
                                             void* W, int batch, int k,
                                             int m, void* stream) {
  return launch_left_wide<float, true>(blk, B, W, batch, k, m, nullptr,
                                       stream);
}

extern "C" int hylu_trsm_left_upper_wide_bf16(const void* blk, const void* B,
                                              void* W, int batch, int k,
                                              int m, void* sums,
                                              void* stream) {
  return launch_left_wide<bf16, true>(blk, B, W, batch, k, m, sums, stream);
}
