// Batched GEMM C[e] = A[e] @ B[e]: the Hopper counterpart of the Pallas
//
//   src/repro/kernels/supsup/kernel.py:34  _bmm_kernel
//       (bmm :48, pallas_call :59), reached through supsup/ops.py:26
//       gemm_batched — the trailing update of a sup-sup edge bucket.
//
// A is (batch, nr, k), B (batch, k, m), C (batch, nr, m), all row-major.
// It accumulates in the input type with fused multiply-adds: float32 sums
// in float32 as the Pallas scratch accumulator does (supsup/kernel.py:69-70),
// float64 in float64.  No TF32 anywhere.
//
// What bounds it on the card: at the sup-sup shapes (nr, k, m <= 128) each
// product does 2*nr*k*m operations on (nr*k + k*m + nr*m) elements: at
// 128^3 that is about 11 operations per f64 byte, below the card's f64
// ridge (67 TFLOP/s over 3.35 TB/s, 20 per byte), so even a full-size
// product is bound by bytes, and the small ones by latency.
// The design is the plain shared-memory tiled GEMM: a 32x32 output tile per
// block, 16x16 threads with a 2x2 register tile each, 32-deep K slabs of A
// and B staged through shared memory.  fp64 tensor-core MMA, wgmma and TMA
// are left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreadsDim = 16;

template <typename T>
__global__ void __launch_bounds__(kThreadsDim * kThreadsDim)
bmm_kernel(const T* __restrict__ A, const T* __restrict__ B,
           T* __restrict__ C, int nr, int k, int m, int tiles_r,
           int tiles_c) {
  __shared__ T As[kTile][kTile + 1];
  __shared__ T Bs[kTile][kTile + 1];
  const int per = tiles_r * tiles_c;
  const long long e = blockIdx.x / per;
  const int rem = blockIdx.x % per;
  const int row0 = (rem / tiles_c) * kTile;
  const int col0 = (rem % tiles_c) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsDim + tx;
  const T* Ae = A + e * nr * k;
  const T* Be = B + e * k * m;

  T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  for (int k0 = 0; k0 < k; k0 += kTile) {
    for (int t = tid; t < kTile * kTile; t += kThreadsDim * kThreadsDim) {
      const int r = t / kTile, c = t % kTile;
      const int ar = row0 + r, ac = k0 + c;
      As[r][c] = (ar < nr && ac < k) ? Ae[(long long)ar * k + ac] : T(0);
      const int br = k0 + r, bc = col0 + c;
      Bs[r][c] = (br < k && bc < m) ? Be[(long long)br * m + bc] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const T a0 = As[ty][kk], a1 = As[ty + kThreadsDim][kk];
      const T b0 = Bs[kk][tx], b1 = Bs[kk][tx + kThreadsDim];
      acc[0][0] = fma(a0, b0, acc[0][0]);
      acc[0][1] = fma(a0, b1, acc[0][1]);
      acc[1][0] = fma(a1, b0, acc[1][0]);
      acc[1][1] = fma(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  T* Ce = C + e * nr * m;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + i * kThreadsDim;
      const int c = col0 + tx + j * kThreadsDim;
      if (r < nr && c < m) Ce[(long long)r * m + c] = acc[i][j];
    }
}

template <typename T>
int launch_bmm(const void* A, const void* B, void* C, int batch, int nr,
               int k, int m, void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_r = (nr + kTile - 1) / kTile;
  const int tiles_c = (m + kTile - 1) / kTile;
  const dim3 block(kThreadsDim, kThreadsDim);
  bmm_kernel<T><<<(unsigned)batch * tiles_r * tiles_c, block, 0,
                  (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      nr, k, m, tiles_r, tiles_c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hylu_bmm_f64(const void* A, const void* B, void* C, int batch,
                            int nr, int k, int m, void* stream) {
  return launch_bmm<double>(A, B, C, batch, nr, k, m, stream);
}

extern "C" int hylu_bmm_f32(const void* A, const void* B, void* C, int batch,
                            int nr, int k, int m, void* stream) {
  return launch_bmm<float>(A, B, C, batch, nr, k, m, stream);
}
