// Dense triangular solves against a supernode's diagonal block: the Hopper
// counterpart of the Pallas TRSM
//
//   src/repro/kernels/trisolve/kernel.py:21  _trsm_kernel
//       (trsm_upper :37, pallas_call :47), reached through trisolve/ops.py
//       trsm_batched (:48) and the left solves (:69, :81).
//
// Three entry points:
//   hylu_trsm_right_*             Y U = X per batch member (sup-sup edges);
//                                 U upper, optionally unit-diagonal; only
//                                 U's upper triangle is read.
//   hylu_trsm_left_unit_lower_*   L w = b with L = tril(blk, -1) + I;
//   hylu_trsm_left_upper_*        U w = b with U = triu(blk).
// The left solves read the diagonal block of the panel buffer in place:
// none of the triu / swapaxes / flip copies of trisolve/ops.py:69-90 is
// made, and k is not padded to a multiple of 8 (any k <= 128 is taken).
//
// What bounds it on the card: the k-step recurrence is sequential, so a
// solve is latency bound, not bound by bytes (k = 128 f64 is 128 KB of U
// read once) or by operations.  The right solve keeps U and a 64-row tile of
// X in shared memory (k = 128 f64 needs 197 KB, above the 48 KB default, so
// the limit is raised) and gives each thread one row: the recurrence runs
// on shared memory with U's column entries broadcast to the warp.  The left
// solves hold the block and a tile of up to 16 right-hand-side columns in
// shared memory and run the column-oriented (axpy) form, parallel over the
// rows still to be updated, with one barrier per step.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kRowTile = 64;       // rows of X per block (right solve)
constexpr int kColTile = 16;       // right-hand-side columns per block
constexpr int kLeftThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kRowTile)
trsm_right_kernel(const T* __restrict__ U, const T* __restrict__ X,
                  T* __restrict__ Y, int nr, int k, int unit_diag,
                  int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Us = reinterpret_cast<T*>(smem_raw);      // k x k
  T* Ys = Us + k * k;                           // kRowTile x (k + 1)
  const int ld = k + 1;
  const long long e = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kRowTile;
  const int rows = min(kRowTile, nr - r0);
  const int tid = threadIdx.x;

  const T* Ue = U + e * k * k;
  for (int i = tid; i < k * k; i += blockDim.x) Us[i] = Ue[i];
  const T* Xe = X + (e * nr + r0) * k;
  for (int i = tid; i < rows * k; i += blockDim.x)
    Ys[(i / k) * ld + i % k] = Xe[i];
  __syncthreads();

  if (tid < rows) {
    T* y = Ys + tid * ld;
    for (int j = 0; j < k; ++j) {
      T acc = y[j];
      for (int i = 0; i < j; ++i) acc -= y[i] * Us[i * k + j];
      if (!unit_diag) acc /= Us[j * k + j];
      y[j] = acc;
    }
  }
  __syncthreads();

  T* Ye = Y + (e * nr + r0) * k;
  for (int i = tid; i < rows * k; i += blockDim.x)
    Ye[i] = Ys[(i / k) * ld + i % k];
}

template <typename T>
__global__ void __launch_bounds__(kLeftThreads)
trsm_left_kernel(const T* __restrict__ blk, const T* __restrict__ B,
                 T* __restrict__ W, int k, int m, int tiles, int upper) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);      // k x (k + 1)
  const int lda = k + 1;
  T* Ws = As + k * lda;                         // k x kColTile
  const long long e = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kColTile;
  const int mc = min(kColTile, m - c0);
  const int tid = threadIdx.x;

  const T* Ae = blk + e * k * k;
  for (int i = tid; i < k * k; i += blockDim.x)
    As[(i / k) * lda + i % k] = Ae[i];
  const T* Be = B + e * k * m + c0;
  for (int i = tid; i < k * mc; i += blockDim.x)
    Ws[(i / mc) * kColTile + i % mc] = Be[(i / mc) * m + i % mc];
  __syncthreads();

  if (!upper) {
    // forward: w[j] is final at step j; rows below it take its update
    for (int j = 0; j < k - 1; ++j) {
      const int n_upd = (k - 1 - j) * mc;
      for (int t = tid; t < n_upd; t += blockDim.x) {
        const int i = j + 1 + t / mc, c = t % mc;
        Ws[i * kColTile + c] -= As[i * lda + j] * Ws[j * kColTile + c];
      }
      __syncthreads();
    }
  } else {
    // backward: divide w[j] by the diagonal, then update the rows above it
    for (int j = k - 1; j >= 0; --j) {
      for (int c = tid; c < mc; c += blockDim.x)
        Ws[j * kColTile + c] /= As[j * lda + j];
      __syncthreads();
      const int n_upd = j * mc;
      for (int t = tid; t < n_upd; t += blockDim.x) {
        const int i = t / mc, c = t % mc;
        Ws[i * kColTile + c] -= As[i * lda + j] * Ws[j * kColTile + c];
      }
      __syncthreads();
    }
  }

  T* We = W + e * k * m + c0;
  for (int i = tid; i < k * mc; i += blockDim.x)
    We[(i / mc) * m + i % mc] = Ws[(i / mc) * kColTile + i % mc];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch_right(const void* U, const void* X, void* Y, int batch, int nr,
                 int k, int unit_diag, void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int tiles = (nr + kRowTile - 1) / kRowTile;
  const size_t smem = ((size_t)k * k + (size_t)kRowTile * (k + 1)) * sizeof(T);
  cudaError_t err = allow_smem(trsm_right_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_right_kernel<T><<<batch * tiles, kRowTile, smem,
                         (cudaStream_t)stream>>>(
      static_cast<const T*>(U), static_cast<const T*>(X), static_cast<T*>(Y),
      nr, k, unit_diag, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_left(const void* blk, const void* B, void* W, int batch, int k,
                int m, int upper, void* stream) {
  if (batch < 1 || m < 1 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int tiles = (m + kColTile - 1) / kColTile;
  const size_t smem = ((size_t)k * (k + 1) + (size_t)k * kColTile) * sizeof(T);
  cudaError_t err = allow_smem(trsm_left_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_left_kernel<T><<<batch * tiles, kLeftThreads, smem,
                        (cudaStream_t)stream>>>(
      static_cast<const T*>(blk), static_cast<const T*>(B),
      static_cast<T*>(W), k, m, tiles, upper);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hylu_trsm_right_f64(const void* U, const void* X, void* Y,
                                   int batch, int nr, int k, int unit_diag,
                                   void* stream) {
  return launch_right<double>(U, X, Y, batch, nr, k, unit_diag, stream);
}

extern "C" int hylu_trsm_right_f32(const void* U, const void* X, void* Y,
                                   int batch, int nr, int k, int unit_diag,
                                   void* stream) {
  return launch_right<float>(U, X, Y, batch, nr, k, unit_diag, stream);
}

extern "C" int hylu_trsm_left_unit_lower_f64(const void* blk, const void* B,
                                             void* W, int batch, int k, int m,
                                             void* stream) {
  return launch_left<double>(blk, B, W, batch, k, m, 0, stream);
}

extern "C" int hylu_trsm_left_unit_lower_f32(const void* blk, const void* B,
                                             void* W, int batch, int k, int m,
                                             void* stream) {
  return launch_left<float>(blk, B, W, batch, k, m, 0, stream);
}

extern "C" int hylu_trsm_left_upper_f64(const void* blk, const void* B,
                                        void* W, int batch, int k, int m,
                                        void* stream) {
  return launch_left<double>(blk, B, W, batch, k, m, 1, stream);
}

extern "C" int hylu_trsm_left_upper_f32(const void* blk, const void* B,
                                        void* W, int batch, int k, int m,
                                        void* stream) {
  return launch_left<float>(blk, B, W, batch, k, m, 1, stream);
}
