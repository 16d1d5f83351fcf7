// Causal / non-causal attention with an online softmax (forward): the Hopper
// counterpart of the Pallas
//
//   src/repro/kernels/flashattn/kernel.py:28  _flash_kernel
//       (flash_attention :78, pallas_call :105), reached through
//       src/repro/models/layers.py:202-206 (attention_seq, use_flash_kernel)
//
// q is (B, Hq, T, D) and k, v are (B, Hkv, S, D), each read through its
// (batch, head, row) strides with D contiguous, so the model's (B, T, H, D)
// projections are read in place; o is written through its own strides.  Query
// head h reads KV head h / (Hq / Hkv) (GQA).  What it computes is what the
// Pallas kernel computes, in the same arithmetic:
//   - logits q.k summed in float32, then times the float32 scale 1/sqrt(D);
//   - masked to -1e30 where the KV column is past S and, when causal, where
//     row < column (no offset, as in the Pallas kernel, so T == S there);
//   - a running (m, l, acc) in float32 over KV tiles, m starting at -1e30;
//   - p = exp(logit - m) rounded to v's type before P.V (bfloat16 rounds
//     here, as p.astype(v.dtype) does), l summed from the unrounded p;
//   - rows with l == 0 divided by 1, the output rounded to q's type.
// float32 runs in float32 FMA (no TF32), bfloat16 is widened to float32 on
// load.  Causal KV tiles wholly above the diagonal are skipped, as the Pallas
// kernel skips them; ragged row and column tiles are masked, nothing padded.
//
// What bounds it on the card: at phi3-medium's prefill (B 4, T = S 2048,
// Hq 40, Hkv 10, D 128) the work is 4*B*Hq*D*T(T+1)/2 operations on about
// 0.21 GB, about 830 operations per byte: bound by operations, on the tensor
// cores in bfloat16.  This first design does not use them: one block of
// 16 x 16 threads per (batch*head, 64-row query tile), the query tile and
// each 64-row K tile staged (transposed) in shared memory as float32, each
// thread holding a 4 x 4 block of logits and a 4 x (D/16) block of the
// output in registers; P goes through shared memory, and the V tile reuses
// the K tile's buffer.  mma.sync / wgmma and TMA are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // KV rows per tile
constexpr int kT = 16;           // threads per dimension: 16 x 16 = 256
constexpr int kRows = kBQ / kT;  // logit rows (and output rows) per thread
constexpr int kCols = kBK / kT;  // logit columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q^T [D][kBQ + 1], K^T [D][kBK + 1] (then V [kBK][D]), P^T [kBK][kBQ + 1]
  return sizeof(float) * (size_t(D) * (kBQ + 1) + size_t(D) * (kBK + 1) +
                          size_t(kBK) * (kBQ + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kT * kT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int group,
             int t, int s, float scale, int causal, long long q_sb,
             long long q_sh, long long q_st, long long kv_sb, long long kv_sh,
             long long kv_st, long long o_sb, long long o_sh, long long o_st) {
  constexpr int kDp = D / kT;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // Qs[d * (kBQ + 1) + r]
  float* KVs = Qs + D * (kBQ + 1);           // K^T, then V
  float* Ps = KVs + D * (kBK + 1);           // Ps[c * (kBQ + 1) + r]
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * kv_sb + hk * kv_sh;
  const T* vb = v + b * kv_sb + hk * kv_sh;

  for (int i = tid; i < kBQ * D; i += kT * kT) {
    const int r = i / D, d = i % D;
    Qs[d * (kBQ + 1) + r] = (q0 + r < t) ? widen(qb[(q0 + r) * q_st + d]) : 0.f;
  }
  float m[kRows], l[kRows], acc[kRows][kDp];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDp; ++j) acc[i][j] = 0.f;
  }
  int n_k = (s + kBK - 1) / kBK;
  if (causal) n_k = min(n_k, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // Q staged; the last tile's V and P read
    for (int i = tid; i < kBK * D; i += kT * kT) {
      const int c = i / D, d = i % D;
      KVs[d * (kBK + 1) + c] =
          (k0 + c < s) ? widen(kb[(k0 + c) * kv_st + d]) : 0.f;
    }
    __syncthreads();
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], bb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[d * (kBQ + 1) + ty + kT * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bb[j] = KVs[d * (kBK + 1) + tx + kT * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }
    // mask, online softmax; a row's 16 threads are 16 consecutive lanes
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kT * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + kT * j;
        const bool ok = col < s && (!causal || row >= col);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = kT / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        Ps[(tx + kT * j) * (kBQ + 1) + ty + kT * i] = widen(narrow<T>(p));
      }
#pragma unroll
      for (int off = kT / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDp; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();             // K read, P written
    for (int i = tid; i < kBK * D; i += kT * kT) {
      const int c = i / D, d = i % D;
      KVs[c * D + d] = (k0 + c < s) ? widen(vb[(k0 + c) * kv_st + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kRows], vv[kDp];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[c * (kBQ + 1) + ty + kT * i];
#pragma unroll
      for (int j = 0; j < kDp; ++j) vv[j] = KVs[c * D + tx + kT * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDp; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kT * i;
    if (row >= t) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kDp; ++j)
      ob[row * o_st + tx + kT * j] = narrow<T>(acc[i][j] / li);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int t, int s, float scale, int causal,
             const long long* st, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kern = flash_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((t + kBQ - 1) / kBQ, b * hq);
  kern<<<grid, kT * kT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hq / hkv, t, s, scale,
      causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int t, int s, int d, int causal,
                 float scale, long long q_sb, long long q_sh, long long q_st,
                 long long kv_sb, long long kv_sh, long long kv_st,
                 long long o_sb, long long o_sh, long long o_st,
                 void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || t < 1 || s < 1 ||
      (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_st, kv_sb, kv_sh,
                           kv_st, o_sb, o_sh, o_st};
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 32: return launch_d<T, 32>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 64: return launch_d<T, 64>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 128: return launch_d<T, 128>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 256: return launch_d<T, 256>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hylu_flash_attn_f32(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int t, int s, int d, int causal, float scale, long long q_sb,
    long long q_sh, long long q_st, long long kv_sb, long long kv_sh,
    long long kv_st, long long o_sb, long long o_sh, long long o_st,
    void* stream) {
  return launch_flash<float>(q, k, v, o, b, hq, hkv, t, s, d, causal, scale,
                             q_sb, q_sh, q_st, kv_sb, kv_sh, kv_st, o_sb,
                             o_sh, o_st, stream);
}

extern "C" int hylu_flash_attn_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int t, int s, int d, int causal, float scale, long long q_sb,
    long long q_sh, long long q_st, long long kv_sb, long long kv_sh,
    long long kv_st, long long o_sb, long long o_sh, long long o_st,
    void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, o, b, hq, hkv, t, s, d, causal,
                                     scale, q_sb, q_sh, q_st, kv_sb, kv_sh,
                                     kv_st, o_sb, o_sh, o_st, stream);
}
