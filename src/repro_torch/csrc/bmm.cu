// Batched GEMM C[e] = A[e] @ B[e]: the Hopper counterpart of the Pallas
//
//   src/repro/kernels/supsup/kernel.py:34  _bmm_kernel
//       (bmm :48, pallas_call :59), reached through supsup/ops.py:26
//       gemm_batched — the trailing update of a sup-sup edge bucket.
//
// A is (batch, nr, k), B (batch, k, m), C (batch, nr, m), all row-major,
// nr and k at most 128 on the solver's path, m any.  It accumulates in the
// input type: float32 sums in float32 as the Pallas scratch accumulator
// does (supsup/kernel.py:69-70), float64 in float64.  No TF32 anywhere: the
// float32 factors' 1e-4 parity and the mixed-precision refinement need
// full float32 products.
//
// What bounds it on the card: each product does 2*nr*k*m operations on
// (nr*k + k*m + nr*m) elements.  At the main path's largest bucket, 64
// products of (128 x 64) @ (64 x 104), that is 1.09e8 operations on 14.4 MB
// in float64: 0.0043 ms of bytes at 3.35 TB/s against 0.0016 ms of fp64
// tensor-core operations at 67 TFLOP/s, so bound by bytes (and, at these
// sizes, by the latency of one launch).
//
// The first design (a 32 x 32 output tile per block, 16 x 16 threads with
// a 2 x 2 register tile, so one FMA per shared-memory load; 32-deep slabs
// staged synchronously; float64 on the FMA pipes) lost to torch.bmm by
// 1.8x.  Now:
//   - one block of 128 threads per (product, 64 x 64 output tile);
//   - A and B are staged by cp.async in slabs of 128 bytes per row (16
//     float64 or 32 float32 deep), double-buffered over k, so the next
//     slab's copy overlaps this slab's products; ragged rows and columns
//     are zero-filled by the copy's source size, with no branch in the
//     inner loop.  Rows that are 16-byte aligned (k and m multiples of 2
//     in float64, of 4 in float32) move 16 bytes per copy, others one
//     element per copy;
//   - float64 runs on the fp64 tensor cores, mma.sync m8n8k4 (DMMA): each
//     warp owns a 32 x 32 quarter of the tile, 4 x 4 DMMAs per k4 step fed
//     by 8 fragment loads from padded shared memory (rows 20 and 68
//     doubles apart, so each warp's loads take two wavefronts, the least
//     for 256 bytes);
//   - float32 runs on FMA with a 4 x 8 register tile per thread; A and B
//     are read from shared memory as float4, so one 16-byte load feeds 8
//     or 16 FMAs.
//   - bfloat16 (the Pallas kernel's bf16 operands with a float32 scratch
//     accumulator, preferred_element_type, and one rounding at the store)
//     runs on the bf16 tensor cores by mma.sync m16n8k16 with float32
//     accumulators: each warp owns a 32 x 32 quarter, 2 x 4 MMAs per k16
//     step, A's fragments read as 32-bit pairs from rows 72 elements
//     apart, B's packed from two 16-bit loads; slabs 64 deep.  Two-byte
//     rows that are not 16-byte aligned are staged by plain loads, which
//     cp.async does not copy.  wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64, kBN = 64;   // output tile
constexpr int kThreads = 128;
constexpr int kStages = 4;          // cp.async ring: k = 64 is in flight at once

// slab depth BK (128 bytes of a row) and the padded row lengths of the A
// and B slabs in shared memory
template <typename T>
struct Cfg;
template <>
struct Cfg<double> {
  static constexpr int BK = 16, LDA = 20, LDB = kBN + 4;
};
// float32 A rows are 36 floats (144 B) apart: the four rows a warp reads
// as float4 land in four different 16-byte bank groups
template <>
struct Cfg<float> {
  static constexpr int BK = 32, LDA = 36, LDB = kBN + 4;
};
// bfloat16 rows 72 elements (144 B) apart
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 64, LDA = 72, LDB = kBN + 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes, of which the first `src_bytes` are read and the
// rest zero-filled.
template <int size>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(size), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kStages - 2 committed groups are still in flight
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// BYTES of src to dst, or zeros when !ok: by cp.async, or, for a two-byte
// element (which cp.async does not copy), by a plain load and store
template <int BYTES, typename T>
__device__ __forceinline__ void copy_or_zero(T* dst, const T* src, bool ok) {
  if constexpr (BYTES == 2)
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
  else
    cp_async<BYTES>(smem_u32(dst), src, ok ? BYTES : 0);
}

// Stage the k-slab starting at k0: A rows row0.. (kBM x BK) and B rows
// k0.. (BK x kBN), V elements per copy.
template <typename T, int V>
__device__ __forceinline__ void load_slab(T* As, T* Bs, const T* Ae,
                                          const T* Be, int row0, int col0,
                                          int k0, int nr, int k, int m,
                                          int tid) {
  constexpr int BK = Cfg<T>::BK, LDA = Cfg<T>::LDA, LDB = Cfg<T>::LDB;
  constexpr int BYTES = V * sizeof(T);
#pragma unroll
  for (int i = tid; i < kBM * BK / V; i += kThreads) {
    const int r = i / (BK / V), c = (i % (BK / V)) * V;
    const int gr = row0 + r, gc = k0 + c;
    const bool ok = gr < nr && gc < k;
    copy_or_zero<BYTES>(As + r * LDA + c,
                        ok ? Ae + (long long)gr * k + gc : Ae, ok);
  }
#pragma unroll
  for (int i = tid; i < BK * kBN / V; i += kThreads) {
    const int r = i / (kBN / V), c = (i % (kBN / V)) * V;
    const int gr = k0 + r, gc = col0 + c;
    const bool ok = gr < k && gc < m;
    copy_or_zero<BYTES>(Bs + r * LDB + c,
                        ok ? Be + (long long)gr * m + gc : Be, ok);
  }
}

__device__ __forceinline__ void dmma(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// One slab's products.  float64: warp (wm, wn) owns rows wm*32.. and
// columns wn*32.. of the tile; DMMA fragments: A[l/4][l%4], B[l%4][l/4],
// C[l/4][2(l%4) + {0,1}].  The 8 x 8 blocks wholly past nr or m (ni, nj:
// how many are not) are skipped, a branch that is uniform over the warp.
__device__ __forceinline__ void slab_products(const double* As,
                                              const double* Bs,
                                              double (&acc)[4][4][2],
                                              int tid, int ni, int nj) {
  constexpr int LDA = Cfg<double>::LDA, LDB = Cfg<double>::LDB;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const double* Aw = As + (wm * 32 + lane / 4) * LDA + lane % 4;
  const double* Bw = Bs + (lane % 4) * LDB + wn * 32 + lane / 4;
#pragma unroll
  for (int kk = 0; kk < Cfg<double>::BK; kk += 4) {
    double a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Aw[i * 8 * LDA + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bw[kk * LDB + j * 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i < ni && j < nj) dmma(acc[i][j], a[i], b[j]);
  }
}

// float32: thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 i and
// columns 4 tx + 32 j + (0..3), i < 4, j < 2.
__device__ __forceinline__ void slab_products(const float* As,
                                              const float* Bs,
                                              float (&acc)[4][8], int tid,
                                              int, int) {
  constexpr int LDA = Cfg<float>::LDA, LDB = Cfg<float>::LDB;
  const int ty = tid / 8, tx = tid % 8;
#pragma unroll
  for (int kk = 0; kk < Cfg<float>::BK; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDA + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(Bs + (kk + u) * LDB + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + (kk + u) * LDB + 32 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z
                                                                    : a[i].w;
        acc[i][0] = fmaf(av, b0.x, acc[i][0]);
        acc[i][1] = fmaf(av, b0.y, acc[i][1]);
        acc[i][2] = fmaf(av, b0.z, acc[i][2]);
        acc[i][3] = fmaf(av, b0.w, acc[i][3]);
        acc[i][4] = fmaf(av, b1.x, acc[i][4]);
        acc[i][5] = fmaf(av, b1.y, acc[i][5]);
        acc[i][6] = fmaf(av, b1.z, acc[i][6]);
        acc[i][7] = fmaf(av, b1.w, acc[i][7]);
      }
    }
  }
}

// bfloat16: warp (wm, wn) owns rows wm*32.. and columns wn*32.. of the
// tile as 2 x 4 tiles of 16 x 8; fragments of m16n8k16 (g = lane / 4,
// t = lane % 4): A {row g | g + 8} x {k 2t, 2t + 1 | 2t + 8, 2t + 9}, B
// {k 2t, 2t + 1 | 2t + 8, 2t + 9} x col g, C {row g | g + 8} x {col 2t,
// 2t + 1}.  Tiles wholly past nr or m (ni 8-row blocks, nj 8-column ones
// hold any of the product) are skipped.
__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(lo) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(hi) << 16);
}

__device__ __forceinline__ void slab_products(const __nv_bfloat16* As,
                                              const __nv_bfloat16* Bs,
                                              float (&acc)[2][4][4], int tid,
                                              int ni, int nj) {
  constexpr int LDA = Cfg<__nv_bfloat16>::LDA, LDB = Cfg<__nv_bfloat16>::LDB;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < Cfg<__nv_bfloat16>::BK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* Ar = As + (wm * 32 + i * 16 + g) * LDA + kk + 2 * t;
      a[i][0] = *reinterpret_cast<const uint32_t*>(Ar);
      a[i][1] = *reinterpret_cast<const uint32_t*>(Ar + 8 * LDA);
      a[i][2] = *reinterpret_cast<const uint32_t*>(Ar + 8);
      a[i][3] = *reinterpret_cast<const uint32_t*>(Ar + 8 * LDA + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* Bc = Bs + (kk + 2 * t) * LDB + wn * 32 + j * 8 + g;
      b[j][0] = pack_bf16(Bc, Bc + LDB);
      b[j][1] = pack_bf16(Bc + 8 * LDB, Bc + 9 * LDB);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (2 * i < ni && j < nj)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                "+f"(acc[i][j][3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
                "r"(b[j][0]), "r"(b[j][1]));
  }
}

__device__ __forceinline__ void store_tile(__nv_bfloat16* Ce,
                                           const float (&acc)[2][4][4],
                                           int row0, int col0, int nr, int m,
                                           int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
  const bool vec = m % 2 == 0;       // pairs start 4-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * 32 + i * 16 + g + 8 * h;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + wn * 32 + j * 8 + 2 * t;
        __nv_bfloat16* dst = Ce + (long long)r * m + c;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (vec && c < m) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < m) dst[0] = __float2bfloat16_rn(v0);
          if (c + 1 < m) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

__device__ __forceinline__ void store_tile(double* Ce, const double (&acc)[4][4][2],
                                           int row0, int col0, int nr, int m,
                                           int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const bool vec = m % 2 == 0;       // pairs start 16-byte aligned
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + wm * 32 + i * 8 + lane / 4;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + wn * 32 + j * 8 + 2 * (lane % 4);
      double* dst = Ce + (long long)r * m + c;
      if (vec && c < m) {
        *reinterpret_cast<double2*>(dst) = make_double2(acc[i][j][0],
                                                        acc[i][j][1]);
      } else {
        if (c < m) dst[0] = acc[i][j][0];
        if (c + 1 < m) dst[1] = acc[i][j][1];
      }
    }
  }
}

__device__ __forceinline__ void store_tile(float* Ce, const float (&acc)[4][8],
                                           int row0, int col0, int nr, int m,
                                           int tid) {
  const int ty = tid / 8, tx = tid % 8;
  const bool vec = m % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + 4 * tx + 32 * j;
      float* dst = Ce + (long long)r * m + c;
      if (vec && c < m) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < m) dst[u] = acc[i][4 * j + u];
      }
    }
  }
}

template <typename T>
struct Acc;
template <>
struct Acc<double> { using type = double[4][4][2]; };
template <>
struct Acc<float> { using type = float[4][8]; };
template <>
struct Acc<__nv_bfloat16> { using type = float[2][4][4]; };

template <typename T>
constexpr int smem_bytes() {
  return kStages * (kBM * Cfg<T>::LDA + Cfg<T>::BK * Cfg<T>::LDB) *
         (int)sizeof(T);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bmm_kernel(const T* __restrict__ A, const T* __restrict__ B,
           T* __restrict__ C, int nr, int k, int m, int tiles_r,
           int tiles_c) {
  constexpr int BK = Cfg<T>::BK;
  constexpr int A_SZ = kBM * Cfg<T>::LDA, STAGE = A_SZ + BK * Cfg<T>::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);  // stage i: A at i * STAGE, B after
  const int per = tiles_r * tiles_c;
  const long long e = blockIdx.x / per;
  const int rem = blockIdx.x % per;
  const int row0 = (rem / tiles_c) * kBM;
  const int col0 = (rem % tiles_c) * kBN;
  const int tid = threadIdx.x;
  const T* Ae = A + e * nr * k;
  const T* Be = B + e * k * m;

  typename Acc<T>::type acc = {};
  // float64 and bfloat16: the 8-row and 8-column blocks of this warp's
  // 32 x 32 quarter that hold any of the product
  const int wm = tid / 64, wn = (tid / 32) % 2;
  const int ni = min(4, max(0, (nr - row0 - 32 * wm + 7) / 8));
  const int nj = min(4, max(0, (m - col0 - 32 * wn + 7) / 8));
  const int n_slabs = (k + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_slabs)
      load_slab<T, V>(smem + i * STAGE, smem + i * STAGE + A_SZ, Ae, Be, row0,
                      col0, i * BK, nr, k, m, tid);
    cp_commit();
  }
  for (int sl = 0; sl < n_slabs; ++sl) {
    cp_wait_ring();             // slab sl has landed
    __syncthreads();            // and slab sl - 1 has been read by all
    const int nx = sl + kStages - 1;
    if (nx < n_slabs) {
      T* st = smem + (nx % kStages) * STAGE;
      load_slab<T, V>(st, st + A_SZ, Ae, Be, row0, col0, nx * BK, nr, k, m,
                      tid);
    }
    cp_commit();
    const T* st = smem + (sl % kStages) * STAGE;
    slab_products(st, st + A_SZ, acc, tid, ni, nj);
  }
  store_tile(C + e * nr * m, acc, row0, col0, nr, m, tid);
}

template <typename T>
int launch_bmm(const void* A, const void* B, void* C, int batch, int nr,
               int k, int m, void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_r = (nr + kBM - 1) / kBM;
  const int tiles_c = (m + kBN - 1) / kBN;
  const long long blocks = (long long)batch * tiles_r * tiles_c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte copies when every row of A and B starts 16-byte aligned
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = k % V16 == 0 && m % V16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) |
                     reinterpret_cast<uintptr_t>(B)) % 16) == 0;
  auto kern = vec ? bmm_kernel<T, V16> : bmm_kernel<T, 1>;
  constexpr int bytes = smem_bytes<T>();
  // the shared-memory limit is raised once per device and kernel (a CUDA
  // API call on every launch would add to the host's cost per launch)
  static bool sized[2][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !sized[vec][dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sized[vec][dev] = true;
  }
  kern<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
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

extern "C" int hylu_bmm_bf16(const void* A, const void* B, void* C, int batch,
                             int nr, int k, int m, void* stream) {
  return launch_bmm<__nv_bfloat16>(A, B, C, batch, nr, k, m, stream);
}
