// K6, the fused sup-row update of one target row against a source
// supernode: the Hopper counterpart of the Pallas
//
//   src/repro/kernels/suprow/kernel.py:21  _suprow_kernel
//       (suprow_update_p :41, pallas_call :48), reached through
//       suprow/ops.py:11 suprow_update.
//
// For each row, with x (k+m) the gathered row slice and src (k, k+m) the
// source rows (U = triu(src[:, :k]) with its diagonal, B = src[:, k:]):
//
//     y  = x[:k] U^-1          (TRSV, row vector)
//     xr = x[k:] - y B         (GEMV)
//
// 1 <= k <= 128, any m >= 0, float64 or float32.  Two entry points share
// one kernel: hylu_suprow_* runs E rows of one (k, m) shape, and
// hylu_suprow_grouped_* runs the rows of many groups of different (k, m)
// in one launch, from a device table the wrapper makes once: per group
// its x, src, y and xr addresses, k, m, E and its first block, then per
// block its group.  A block belongs to one group, so a block's warps read
// one table entry and nothing else decides their work.
//
// What bounds it on the card: per row 2 k m + k^2 operations on
// (k + m) + k (k + 1) / 2 + k m elements read and k + m written, one
// operation per element moved, so bytes.  One row is a few KB (at
// fem2d_10k k <= 6 and m <= 35) and a dependent chain of k steps, so what
// a launch of a few thousand rows costs is its latency: one round of
// loads, the chain, one round of stores, and the launch itself.  Hence:
//
// * A warp per row, several rows per block, no block barrier: rows are
//   independent, and a warp solves its row alone.
// * Every operand of the row is loaded once, up front, coalesced with
//   lanes over columns.  For k <= 8 (kSmallK) lane c holds x_c and column
//   c of U in registers, and the first 64 columns of B and x[k:] too, all
//   loaded before the solve starts; for larger k the upper triangle of U
//   goes to the warp's own slice of shared memory (packed, row j from its
//   diagonal on) and B is read by the GEMV as it goes, each element once.
//   Step j of the solve then reads nothing from device memory.
// * The TRSV stays in the warp, in the column form: step j divides x_j by
//   U's diagonal on the lane that owns column j, broadcasts y_j by
//   __shfl_sync, and every lane applies x_c -= y_j U[j][c] to its columns
//   c > j with fused multiply-adds.  The division is K3's and K5's
//   (csrc/div_fast.cuh): a product by the divisor's reciprocal, taken once
//   per lane before the chain, corrected to a true division's bits (true
//   division where that cannot vouch for the quotient), so the quotients
//   are the plain version's bits; on fem2d_10k's sup-row edges it cut the
//   grouped launch by a quarter in float64 against `/` (PERF.md).  Each
//   x_c gathers the terms y_i U[i][c], i < c, that the plain version's
//   dot over U[:c, c] gathers (src/repro/core/jax_engine.py:53
//   _trsm_upper_jax sums the same ones), in another order; no term is
//   skipped, so a zero divisor gives the plain version's NaN and inf
//   positions.
// * The GEMV runs in the same warp after the solve, lanes over the m
//   columns, y in registers (k <= 8) or in the warp's shared memory: each
//   row's TRSV is solved once, whatever m is.
// * The grouped entry runs every group in one launch, so a set of small
//   groups (fem2d_10k's 340 sup-row edges fall into 31 (k, m) groups)
//   costs one launch latency, not one per group.
#include <cuda_runtime.h>

#include "div_fast.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kSmallK = 8;              // k <= 8: U and y in registers
constexpr int kWarps = 8;               // rows per block, at most
constexpr int kTile = 2;                // GEMV columns per lane and pass (k <= 8)
constexpr int kCols = 4;                // the same for k > 8
constexpr int kSmemBytes = 200 * 1024;  // shared memory of a block, k > 8
constexpr unsigned kFull = 0xffffffffu;

// one group of rows of one (k, m), as the grouped table holds it
struct Group {
  const void* x;        // (rows, k + m)
  const void* src;      // (rows, k, k + m)
  void* y;              // (rows, k)
  void* xr;             // (rows, m)
  long long k, m, rows;
  long long block0;     // the group's first block
};
static_assert(sizeof(Group) == 64, "the wrapper writes 8 int64 per group");

__host__ __device__ constexpr long long tri_elems(int k) {
  return (long long)k * (k + 1) / 2;
}

// a warp's shared elements for k > 8: U's upper triangle and y
__host__ __device__ constexpr long long warp_elems(int kmax) {
  return tri_elems(kmax) + kMaxK;
}

// row j of the packed triangle starts at its diagonal entry
__device__ __forceinline__ int tri_off(int j, int k) {
  return j * k - j * (j - 1) / 2;
}

int warps_for(int kmax, int elem) {
  if (kmax < 1 || kmax > kMaxK || (elem != 4 && elem != 8)) return 0;
  if (kmax <= kSmallK) return kWarps;
  const long long w = kSmemBytes / (warp_elems(kmax) * elem);
  return (int)(w < kWarps ? w : kWarps);
}

// k <= 8: everything of the row in registers
template <typename T>
__device__ __forceinline__ void row_small(const T* __restrict__ xe,
                                          const T* __restrict__ se,
                                          T* __restrict__ ye,
                                          T* __restrict__ xre, int k, int m,
                                          int lane) {
  const long long ld = k + m;
  const bool own = lane < k;
  T r = own ? xe[lane] : T(0);
  T uc[kSmallK];                        // lane c: U[j][c], j <= c
#pragma unroll
  for (int j = 0; j < kSmallK; ++j)
    uc[j] = (own && j <= lane) ? se[j * ld + lane] : T(0);
  T xm[kTile], b[kTile][kSmallK];       // the first GEMV tile
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    const int c = lane + 32 * s;
    const bool in = c < m;
    xm[s] = in ? xe[k + c] : T(0);
#pragma unroll
    for (int j = 0; j < kSmallK; ++j)
      b[s][j] = (in && j < k) ? se[j * ld + k + c] : T(0);
  }

  T dg = T(1);                          // lane c's divisor, U[c][c], and
#pragma unroll                          // its reciprocal, off the chain
  for (int j = 0; j < kSmallK; ++j)
    if (j == lane) dg = uc[j];
  const double rd = recip((double)dg);

  T y[kSmallK];
  T mine = T(0);
#pragma unroll
  for (int j = 0; j < kSmallK; ++j) {
    y[j] = T(0);
    if (j < k) {                                   // uniform in the warp
      bool ok = true;                              // the owner's quotient
      T q = div_fast(r, dg, rd, ok);
      if (lane == j && !ok) q = true_div(r, dg);
      y[j] = __shfl_sync(kFull, q, j);
      if (lane == j) mine = y[j];
      if (lane > j) r = fma(-y[j], uc[j], r);
    }
  }
  if (own) ye[lane] = mine;

  for (int c0 = 0; c0 < m; c0 += 32 * kTile) {
    if (c0) {
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const int c = c0 + lane + 32 * s;
        const bool in = c < m;
        xm[s] = in ? xe[k + c] : T(0);
#pragma unroll
        for (int j = 0; j < kSmallK; ++j)
          b[s][j] = (in && j < k) ? se[j * ld + k + c] : T(0);
      }
    }
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const int c = c0 + lane + 32 * s;
      T acc = xm[s];
#pragma unroll
      for (int j = 0; j < kSmallK; ++j)
        if (j < k) acc = fma(-y[j], b[s][j], acc);
      if (c < m) xre[c] = acc;
    }
  }
}

// 8 < k <= 128: U's triangle and y in the warp's shared memory
template <typename T>
__device__ __forceinline__ void row_large(const T* __restrict__ xe,
                                          const T* __restrict__ se,
                                          T* __restrict__ ye,
                                          T* __restrict__ xre, int k, int m,
                                          int lane, T* tri, T* ys) {
  constexpr int kPer = kMaxK / 32;
  const long long ld = k + m;
  for (int j = 0; j < k; ++j) {
    T* tj = tri + tri_off(j, k);
    for (int c = j + lane; c < k; c += 32) tj[c - j] = se[j * ld + c];
  }
  T r[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int c = lane + 32 * t;
    r[t] = c < k ? xe[c] : T(0);
  }
  __syncwarp();
  T dg[kPer];                           // lane's divisors U[c][c] and their
  double rd[kPer];                      // reciprocals, off the chain
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int c = lane + 32 * t;
    dg[t] = c < k ? tri[tri_off(c, k)] : T(1);
    rd[t] = recip((double)dg[t]);
  }

  for (int j = 0; j < k; ++j) {
    const T* tj = tri + tri_off(j, k);
    const int owner = j & 31;
    T rj = T(0), dj = T(1);
    double rdj = 1.0;
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      if (t == (j >> 5)) rj = r[t], dj = dg[t], rdj = rd[t];
    bool ok = true;                     // the owner's quotient
    T q = div_fast(rj, dj, rdj, ok);
    if (lane == owner && !ok) q = true_div(rj, dj);
    const T yj = __shfl_sync(kFull, q, owner);
    if (lane == owner) ys[j] = yj;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      if (c > j && c < k) r[t] = fma(-yj, tj[c - j], r[t]);
    }
  }
  __syncwarp();
  for (int c = lane; c < k; c += 32) ye[c] = ys[c];

  for (int c0 = 0; c0 < m; c0 += 32 * kCols) {   // kCols loads per step
    T acc[kCols];
#pragma unroll
    for (int s = 0; s < kCols; ++s) {
      const int c = c0 + lane + 32 * s;
      acc[s] = c < m ? xe[k + c] : T(0);
    }
    const T* bc = se + k + c0 + lane;
#pragma unroll 4
    for (int i = 0; i < k; ++i) {
      const T yi = ys[i];
#pragma unroll
      for (int s = 0; s < kCols; ++s)
        if (c0 + lane + 32 * s < m) acc[s] = fma(-yi, bc[i * ld + 32 * s],
                                                 acc[s]);
    }
#pragma unroll
    for (int s = 0; s < kCols; ++s) {
      const int c = c0 + lane + 32 * s;
      if (c < m) xre[c] = acc[s];
    }
  }
}

template <typename T, bool kSmall>
__global__ void __launch_bounds__(32 * kWarps)
suprow_kernel(const Group* __restrict__ table,
              const long long* __restrict__ block_group, Group one,
              int warps, int kmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const Group g = table ? table[block_group[blockIdx.x]] : one;
  const long long row = ((long long)blockIdx.x - g.block0) * warps + wid;
  if (row >= g.rows) return;                       // the whole warp
  const int k = (int)g.k, m = (int)g.m;
  const long long ld = k + m;
  const T* xe = static_cast<const T*>(g.x) + row * ld;
  const T* se = static_cast<const T*>(g.src) + row * k * ld;
  T* ye = static_cast<T*>(g.y) + row * k;
  T* xre = static_cast<T*>(g.xr) + row * m;
  if constexpr (kSmall) {
    row_small<T>(xe, se, ye, xre, k, m, lane);
  } else {
    T* tri = reinterpret_cast<T*>(smem) + wid * warp_elems(kmax);
    row_large<T>(xe, se, ye, xre, k, m, lane, tri, tri + tri_elems(kmax));
  }
}

template <typename T>
int launch(const Group* table, const long long* block_group, Group one,
           long long blocks, int kmax, int warps, cudaStream_t stream) {
  if (warps < 1 || warps != warps_for(kmax, (int)sizeof(T)) || blocks < 1
      || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (kmax <= kSmallK) {
    suprow_kernel<T, true><<<(unsigned)blocks, 32 * warps, 0, stream>>>(
        table, block_group, one, warps, kmax);
  } else {
    const size_t smem = (size_t)warps * warp_elems(kmax) * sizeof(T);
    if (smem > 48 * 1024) {             // per launch: set for this device
      const cudaError_t err = cudaFuncSetAttribute(
          suprow_kernel<T, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    suprow_kernel<T, false><<<(unsigned)blocks, 32 * warps, smem, stream>>>(
        table, block_group, one, warps, kmax);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_one(const void* x, const void* src, void* y, void* xr, int batch,
               int k, int m, void* stream) {
  if (batch < 1 || k < 1 || k > kMaxK || m < 0)
    return (int)cudaErrorInvalidValue;
  const int warps = warps_for(k, (int)sizeof(T));
  const Group one{x, src, y, xr, k, m, batch, 0};
  return launch<T>(nullptr, nullptr, one, (batch + warps - 1) / warps, k,
                   warps, (cudaStream_t)stream);
}

template <typename T>
int launch_grouped(const void* table, int groups, int blocks, int kmax,
                   int warps, void* stream) {
  if (groups < 1) return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  return launch<T>(reinterpret_cast<const Group*>(t), t + 8LL * groups,
                   Group{}, blocks, kmax, warps, (cudaStream_t)stream);
}

}  // namespace

// rows per block of a launch whose largest k is kmax, for elements of
// elem bytes (the grouped table's blocks are laid out by it); 0 if the
// kernel does not take kmax
extern "C" int hylu_suprow_warps(int kmax, int elem) {
  return warps_for(kmax, elem);
}

extern "C" int hylu_suprow_f64(const void* x, const void* src, void* y,
                               void* xr, int batch, int k, int m,
                               void* stream) {
  return launch_one<double>(x, src, y, xr, batch, k, m, stream);
}

extern "C" int hylu_suprow_f32(const void* x, const void* src, void* y,
                               void* xr, int batch, int k, int m,
                               void* stream) {
  return launch_one<float>(x, src, y, xr, batch, k, m, stream);
}

extern "C" int hylu_suprow_grouped_f64(const void* table, int groups,
                                       int blocks, int kmax, int warps,
                                       void* stream) {
  return launch_grouped<double>(table, groups, blocks, kmax, warps, stream);
}

extern "C" int hylu_suprow_grouped_f32(const void* table, int groups,
                                       int blocks, int kmax, int warps,
                                       void* stream) {
  return launch_grouped<float>(table, groups, blocks, kmax, warps, stream);
}
