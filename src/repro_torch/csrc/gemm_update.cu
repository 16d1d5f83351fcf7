// Batched trailing update OUT[e] = C[e] - A[e] @ B[e]: the Hopper counterpart
// of the Pallas
//
//   src/repro/kernels/supsup/kernel.py:21  _gemm_update_kernel
//       (gemm_update :77, pallas_call :85), reached through supsup/ops.py:50
//       gemm and :15 supsup_update — the per-edge sup-sup update of the
//       unrolled factor schedule (src/repro/core/jax_engine.py:152-158).
//
// C and OUT are (batch, nr, m), A (batch, nr, k), B (batch, k, m), all
// row-major and contiguous; batch runs over the K systems of one edge.  It
// sums A @ B with fused multiply-adds in the input type and then subtracts
// it from C, as the Pallas kernel does for its one k-tile (k <= 128): float32
// in float32, float64 in float64, no TF32.  The JAX wrapper pads nr, k and m
// to multiples of 8 or 128 with exact zeros; this kernel masks the ragged
// tile edges instead, so it takes the exact shapes.
//
// What bounds it on the card: one edge is at most nr = k = 128, m ~ 100 (at
// fem2d_10k), 2*nr*k*m operations on (2*nr*m + nr*k + k*m) elements, about
// 13 operations per f64 byte at 128^3, below the f64 ridge (67 TFLOP/s over
// 3.35 TB/s, 20 per byte): bound by bytes, and at one system per launch by
// launch latency.  The design is a plain shared-memory tiled GEMM: a 64x64
// tile of OUT per block, 16x16 threads with a 4x4 register tile each,
// 16-deep slabs of A and B staged through shared memory.  wgmma, TMA and
// fp64 tensor-core MMA are left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSlab = 16;
constexpr int kThreadsDim = 16;
constexpr int kPer = kTile / kThreadsDim;   // 4 outputs per thread per dim

template <typename T>
__global__ void __launch_bounds__(kThreadsDim * kThreadsDim)
gemm_update_kernel(const T* __restrict__ C, const T* __restrict__ A,
                   const T* __restrict__ B, T* __restrict__ OUT, int nr,
                   int k, int m, int tiles_r, int tiles_c) {
  __shared__ T As[kSlab][kTile + 1];   // A slab, transposed: As[kk][row]
  __shared__ T Bs[kSlab][kTile + 1];
  const int per = tiles_r * tiles_c;
  const long long e = blockIdx.x / per;
  const int rem = blockIdx.x % per;
  const int row0 = (rem / tiles_c) * kTile;
  const int col0 = (rem % tiles_c) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsDim + tx;
  const T* Ae = A + e * nr * k;
  const T* Be = B + e * k * m;

  T acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += kSlab) {
    for (int t = tid; t < kTile * kSlab; t += kThreadsDim * kThreadsDim) {
      const int r = t / kSlab, kk = t % kSlab;      // A: along its rows' k
      const int ar = row0 + r, ac = k0 + kk;
      As[kk][r] = (ar < nr && ac < k) ? Ae[(long long)ar * k + ac] : T(0);
      const int br = k0 + t / kTile, bc = col0 + t % kTile;   // B: along m
      Bs[t / kTile][t % kTile] =
          (br < k && bc < m) ? Be[(long long)br * m + bc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      T a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = As[kk][ty + i * kThreadsDim];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = Bs[kk][tx + j * kThreadsDim];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const T* Ce = C + e * nr * m;
  T* Oe = OUT + e * nr * m;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = row0 + ty + i * kThreadsDim;
      const int c = col0 + tx + j * kThreadsDim;
      if (r < nr && c < m) {
        const long long o = (long long)r * m + c;
        Oe[o] = Ce[o] - acc[i][j];
      }
    }
}

template <typename T>
int launch_gemm_update(const void* C, const void* A, const void* B, void* OUT,
                       int batch, int nr, int k, int m, void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_r = (nr + kTile - 1) / kTile;
  const int tiles_c = (m + kTile - 1) / kTile;
  const dim3 block(kThreadsDim, kThreadsDim);
  gemm_update_kernel<T><<<(unsigned)batch * tiles_r * tiles_c, block, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const T*>(C), static_cast<const T*>(A),
      static_cast<const T*>(B), static_cast<T*>(OUT), nr, k, m, tiles_r,
      tiles_c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hylu_gemm_update_f64(const void* C, const void* A,
                                    const void* B, void* OUT, int batch,
                                    int nr, int k, int m, void* stream) {
  return launch_gemm_update<double>(C, A, B, OUT, batch, nr, k, m, stream);
}

extern "C" int hylu_gemm_update_f32(const void* C, const void* A,
                                    const void* B, void* OUT, int batch,
                                    int nr, int k, int m, void* stream) {
  return launch_gemm_update<float>(C, A, B, OUT, batch, nr, k, m, stream);
}
