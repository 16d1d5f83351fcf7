// Dense panel LU with pivoting restricted to the diagonal block and pivot
// perturbation: the Hopper counterpart of two Pallas kernels,
//
//   src/repro/kernels/panel/kernel.py:59  _panel_lu_bucketed_kernel
//       (panel_lu_bucketed_p :102, pallas_call :110)   -> hylu_panel_lu_* with
//       c0 = 0 and wlim = wu (the column-reordered [block | U | L] panels of
//       one panel bucket);
//   src/repro/kernels/panel/kernel.py:23  _panel_lu_kernel
//       (panel_lu_p :133, pallas_call :137)            -> hylu_panel_lu_* with
//       c0 = lsize and wlim = w (one node panel [L | block | U]).
//
// Per pivot step j the block (1) reduces the argmax of |P[i, c0+j]| over
// i >= j (the first maximum wins and NaN counts as the maximum, exactly as
// jnp.argmax), (2) swaps rows j and p across all columns and in perm,
// (3) replaces a pivot with |p| < eps by +-eps and counts it, (4) applies the
// rank-1 update to rows > j, columns (c0+j, wlim), and (5) stores the
// multipliers in column c0+j.  Columns outside [c0, wlim) are only swapped.
//
// What bounds it on the card: the pivot loop is sequential in j, with five
// block-wide barriers per step, so one panel is latency bound; the card is
// filled by running one thread block per panel (K*B panels per launch for
// a bucket, K for a node).  The design keeps the panel in shared memory when
// nr*wt*sizeof(T) fits (fem2d_10k's largest bucket, 32 x 448 f64, is 114,688
// bytes, so the dynamic shared-memory limit is raised above 48 KB), and
// otherwise works in place in the output in device memory.  Each panel is
// then read once and written once; the rank-1 updates never leave the SM.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 128;
constexpr int kThreads = 256;
constexpr size_t kMaxDynSmem = 220 * 1024;

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

__device__ __forceinline__ double abs_val(double v) { return fabs(v); }
__device__ __forceinline__ float abs_val(float v) { return fabsf(v); }

// jnp.argmax order: NaN is the largest value; ties go to the lower index.
template <typename T>
__device__ __forceinline__ bool pivot_better(T a, int ia, T b, int ib) {
  const bool an = is_nan(a), bn = is_nan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_lu_kernel(const T* __restrict__ in, T* __restrict__ out,
                int* __restrict__ perm_out, int* __restrict__ nper_out,
                const T* __restrict__ eps, int nr, int wt, int c0, int wlim,
                int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T lcol[kMaxRows];
  __shared__ int perm[kMaxRows];
  __shared__ int piv_row;
  __shared__ T piv_val;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long size = (long long)nr * wt;
  const T* src = in + blockIdx.x * size;
  T* dst = out + blockIdx.x * size;
  T* P = use_smem ? reinterpret_cast<T*>(smem_raw) : dst;

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
        const T ov = __shfl_down_sync(0xffffffffu, best, off);
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
    for (int i = j + 1 + tid; i < nr; i += blockDim.x)
      lcol[i] = P[(long long)i * wt + pc] / piv;
    __syncthreads();
    // (4) rank-1 update: one warp per row, lanes along the columns
    const T* rj = P + (long long)j * wt;
    for (int i = j + 1 + warp; i < nr; i += nwarps) {
      T* ri = P + (long long)i * wt;
      const T li = lcol[i];
      for (int c = pc + 1 + lane; c < wlim; c += 32) ri[c] -= li * rj[c];
    }
    // (5) multipliers into the pivot column (disjoint from (4)'s columns)
    for (int i = j + 1 + tid; i < nr; i += blockDim.x)
      P[(long long)i * wt + pc] = lcol[i];
    __syncthreads();
  }

  if (use_smem)
    for (long long i = tid; i < size; i += blockDim.x) dst[i] = P[i];
  for (int i = tid; i < nr; i += blockDim.x)
    perm_out[(long long)blockIdx.x * nr + i] = perm[i];
  if (tid == 0) nper_out[blockIdx.x] = nper;
}

template <typename T>
int launch_panel_lu(const void* in, void* out, void* perm, void* nper,
                    const void* eps, int npanels, int nr, int wt, int c0,
                    int wlim, void* stream) {
  if (nr < 1 || nr > kMaxRows || wt < 1 || npanels < 1 || c0 < 0 ||
      c0 + nr > wt || wlim < c0 + nr || wlim > wt)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)nr * wt * sizeof(T);
  const int use_smem = bytes <= kMaxDynSmem;
  const size_t smem = use_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        panel_lu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  panel_lu_kernel<T><<<npanels, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<int*>(perm), static_cast<int*>(nper),
      static_cast<const T*>(eps), nr, wt, c0, wlim, use_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hylu_panel_lu_f64(const void* in, void* out, void* perm,
                                 void* nper, const void* eps, int npanels,
                                 int nr, int wt, int c0, int wlim,
                                 void* stream) {
  return launch_panel_lu<double>(in, out, perm, nper, eps, npanels, nr, wt,
                                 c0, wlim, stream);
}

extern "C" int hylu_panel_lu_f32(const void* in, void* out, void* perm,
                                 void* nper, const void* eps, int npanels,
                                 int nr, int wt, int c0, int wlim,
                                 void* stream) {
  return launch_panel_lu<float>(in, out, perm, nper, eps, npanels, nr, wt,
                                c0, wlim, stream);
}

extern "C" const char* hylu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
