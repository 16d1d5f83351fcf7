// Fused sup-row update of one target row against a source supernode: the
// Hopper counterpart of the Pallas
//
//   src/repro/kernels/suprow/kernel.py:21  _suprow_kernel
//       (suprow_update_p :41, pallas_call :48), reached through
//       suprow/ops.py:11 suprow_update.
//
// For each of `batch` systems, with x (batch, k+m) the gathered row slice
// and src (batch, k, k+m) the source rows (U = src[:, :k] upper triangular
// with its diagonal, B = src[:, k:]):
//
//     y  = x[:k] U^-1          (TRSV, row vector)
//     xr = x[k:] - y B         (GEMV)
//
// k <= 128, any m, float64 or float32.  The Pallas grid tiles m and solves
// the TRSV once, on its first grid step, into scratch that later steps
// read.  Blocks on the card run in no order, so every block of a system
// solves the TRSV itself (k^2 operations, next to k*256 for its GEMV tile)
// and block 0 of the system writes y.  The TRSV runs in one warp, in the
// column (axpy) form: lane l holds the partial sums of columns l, l+32,
// l+64 and l+96, each step broadcasts y_j with a shuffle, and no block
// barrier is needed until y goes to shared memory.  Then each thread owns
// one column of the 256-column tile and sums y_i B[i][c] over i with FMAs:
// neighbouring threads read neighbouring addresses of each row of B.
//
// What bounds it on the card: the work is 2*k*m + k^2 operations on
// (k*(k+m) + 2*(k+m)) elements, one operation per element read, so it is
// bound by bytes; one row is too little work to fill the card, so a launch
// of one system is bound by its latency.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kCols = 256;                 // GEMV columns per block
constexpr int kPerLane = kMaxK / 32;

template <typename T>
__global__ void __launch_bounds__(kCols)
suprow_kernel(const T* __restrict__ x, const T* __restrict__ src,
              T* __restrict__ y, T* __restrict__ xr, int k, int m,
              int tiles) {
  __shared__ T ys[kMaxK];
  const long long e = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int ld = k + m;
  const T* xe = x + e * ld;
  const T* se = src + e * k * ld;
  const int tid = threadIdx.x;

  if (tid < 32) {                           // TRSV in warp 0
    T r[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int c = tid + 32 * t;
      r[t] = c < k ? xe[c] : T(0);
    }
    for (int j = 0; j < k; ++j) {
      T rj = T(0);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t)
        if (t == (j >> 5)) rj = r[t];
      rj = __shfl_sync(0xffffffffu, rj, j & 31);
      const T yj = rj / se[(long long)j * ld + j];
      if (tid == 0) ys[j] = yj;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int c = tid + 32 * t;
        if (c > j && c < k) r[t] = fma(-yj, se[(long long)j * ld + c], r[t]);
      }
    }
  }
  __syncthreads();
  if (tile == 0)
    for (int i = tid; i < k; i += blockDim.x) y[e * k + i] = ys[i];
  const int c = tile * kCols + tid;
  if (c < m) {
    T acc = T(0);
    for (int i = 0; i < k; ++i)
      acc = fma(ys[i], se[(long long)i * ld + k + c], acc);
    xr[e * m + c] = xe[k + c] - acc;
  }
}

template <typename T>
int launch_suprow(const void* x, const void* src, void* y, void* xr,
                  int batch, int k, int m, void* stream) {
  if (batch < 1 || k < 1 || k > kMaxK || m < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = m > 0 ? (m + kCols - 1) / kCols : 1;
  suprow_kernel<T><<<(unsigned)batch * tiles, kCols, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(src),
      static_cast<T*>(y), static_cast<T*>(xr), k, m, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hylu_suprow_f64(const void* x, const void* src, void* y,
                               void* xr, int batch, int k, int m,
                               void* stream) {
  return launch_suprow<double>(x, src, y, xr, batch, k, m, stream);
}

extern "C" int hylu_suprow_f32(const void* x, const void* src, void* y,
                               void* xr, int batch, int k, int m,
                               void* stream) {
  return launch_suprow<float>(x, src, y, xr, batch, k, m, stream);
}
