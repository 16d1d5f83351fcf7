// The RWKV6 WKV recurrence with the state kept on chip: the Hopper
// counterpart of the Pallas
//
//   src/repro/kernels/wkv/kernel.py:26  _wkv_kernel
//       (wkv :48, pallas_call :55), wrapper wkv_padded (wkv/ops.py:11),
//       reached through src/repro/models/layers.py:557-565
//       (rwkv_time_mix_seq, use_wkv_kernel)
//
// For each (batch, head), from a zero state S (hs x hs, float32):
//     y_t = r_t . (S + (u * k_t) v_t^T)
//     S   = diag(w_t) S + k_t v_t^T
// r, k, v, w are (B, H, T, hs) float32 read through one set of (batch, head,
// time) strides with hs contiguous, so the model's (B, T, H, hs) projections
// are read in place; u is (B, H, hs) through its own strides (stride 0 over
// the batch when one u is shared, as the model's is); y is written through
// its strides.  The kernel also writes the final state S (B*H, hs, hs): the
// Pallas kernel keeps S in VMEM and drops it, but S is what the oracle
// wkv_ref returns beside y and what a prefill's decode cache needs, so the
// port returns the function the oracle returns.  T is not padded: the loop
// runs to T (the JAX wrapper pads w with 1.0 to a tile multiple instead).
//
// What bounds it on the card: per step and head 7 hs^2 operations on 5 hs
// floats moved, about 22 operations per byte at hs = 64 - near the float32
// ridge (67 TFLOP/s over 3.35 TB/s, 20 per byte) - but the recurrence is
// sequential in T, so one (batch, head) is a chain of T dependent steps: it
// is bound by the latency of one step.  The design keeps that step short:
// one block per (batch, head), 4 threads per column v of S, each holding
// hs/4 rows of that column in registers (rows kc, kc + 4, ...), so a step is
// hs/4 dependent FMAs and two warp shuffles with no block barrier; r, k, v,
// w of 32 steps are staged in shared memory, and y of those steps is written
// back from shared memory, with three barriers per 32 steps.
#include <cuda_runtime.h>

namespace {

constexpr int kKC = 4;    // threads per column of S (k is split over them)
constexpr int kBT = 32;   // time steps staged per tile

template <int HS>
__global__ void __launch_bounds__(HS * kKC)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int nh, int t, long long sb,
           long long sh, long long st, long long u_sb, long long u_sh,
           long long y_sb, long long y_sh, long long y_st) {
  constexpr int kP = HS / kKC;          // rows of S per thread
  constexpr int kThreads = HS * kKC;
  __shared__ float rs[kBT][HS], ks[kBT][HS], vs[kBT][HS], ws[kBT][HS],
      ys[kBT][HS];
  const int bh = blockIdx.x;
  const int b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x;
  const int col = tid / kKC, kc = tid % kKC;
  const long long in0 = b * sb + h * sh;
  const float* rb = r + in0;
  const float* kb = k + in0;
  const float* vb = v + in0;
  const float* wb = w + in0;
  float* yb = y + b * y_sb + h * y_sh;
  const float* ub = u + b * u_sb + h * u_sh;
  float S[kP], uk[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    S[i] = 0.f;
    uk[i] = ub[kc + kKC * i];
  }
  for (int t0 = 0; t0 < t; t0 += kBT) {
    const int nt = min(kBT, t - t0);
    __syncthreads();               // the last tile's y written out
    for (int i = tid; i < nt * HS; i += kThreads) {
      const int tt = i / HS, c = i % HS;
      const long long off = (t0 + tt) * st + c;
      rs[tt][c] = rb[off];
      ks[tt][c] = kb[off];
      vs[tt][c] = vb[off];
      ws[tt][c] = wb[off];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vt = vs[tt][col];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const int kk = kc + kKC * i;
        const float kv = ks[tt][kk] * vt;
        acc = fmaf(rs[tt][kk], fmaf(uk[i], kv, S[i]), acc);
        S[i] = fmaf(ws[tt][kk], S[i], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (kc == 0) ys[tt][col] = acc;
    }
    __syncthreads();
    for (int i = tid; i < nt * HS; i += kThreads) {
      const int tt = i / HS, c = i % HS;
      yb[(t0 + tt) * y_st + c] = ys[tt][c];
    }
  }
  float* so = s_out + (long long)bh * HS * HS;
#pragma unroll
  for (int i = 0; i < kP; ++i) so[(kc + kKC * i) * HS + col] = S[i];
}

template <int HS>
int launch_hs(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* y, void* s_out, int b, int nh, int t,
              const long long* st, cudaStream_t stream) {
  wkv_kernel<HS><<<b * nh, HS * kKC, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_out), nh, t, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hylu_wkv_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* y,
                            void* s_out, int b, int nh, int t, int hs,
                            long long sb, long long sh, long long st,
                            long long u_sb, long long u_sh, long long y_sb,
                            long long y_sh, long long y_st, void* stream) {
  if (b < 1 || nh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const long long strides[8] = {sb, sh, st, u_sb, u_sh, y_sb, y_sh, y_st};
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (hs) {
    case 8: return launch_hs<8>(r, k, v, w, u, y, s_out, b, nh, t, strides, cs);
    case 16: return launch_hs<16>(r, k, v, w, u, y, s_out, b, nh, t, strides, cs);
    case 32: return launch_hs<32>(r, k, v, w, u, y, s_out, b, nh, t, strides, cs);
    case 64: return launch_hs<64>(r, k, v, w, u, y, s_out, b, nh, t, strides, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
