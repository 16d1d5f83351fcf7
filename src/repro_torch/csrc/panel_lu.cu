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
    T* rj = P + (long long)j * wt;
    int bad = 0;
    for (int i = j + 1 + tid; i < nr; i += blockDim.x) {
      const T q = P[(long long)i * wt + pc] / piv;
      lcol[i] = q;
      bad |= !isfinite(q);
    }
    for (int c = pc + 1 + tid; c < wlim; c += blockDim.x)
      bad |= !isfinite(rj[c]);
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
