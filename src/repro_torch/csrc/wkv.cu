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
// What bounds it on the card.  Per step and head the work is 7 hs^2
// operations on 5 hs floats moved (about 22 operations per byte at hs = 64,
// near the float32 ridge of 20), and the recurrence is sequential in T, but
// it carries only one FMA per element from step to step, so the chain of
// steps is not what sets the pace: the instructions each step issues are.
// rwkv6 has B*H = 128 heads for 132 SMs, so each SM runs one head and each
// of its four schedulers one warp, with no other warp to hide a stall
// behind.  A step costs a warp 3 FP instructions per element of S it holds
// (k.v, the y FMA, the S FMA) plus its shared loads, the reduction of y
// over rows, the staging of the inputs and the barriers; the shared loads
// and shuffles of all four warps go through the one shared-memory pipe of
// the SM.  The design cuts everything but the FP work:
//   - each thread holds an R x C register tile of S (rows contiguous), so a
//     step loads r, k, w of its R rows as float4 (each value serving C
//     FMAs) and v of its C columns; at hs = 64, R = 8 and C = 4: 11 shared
//     loads for 96 FP instructions (against 49 for 64 before), loaded a
//     step ahead of their use into registers;
//   - the G = hs/R threads of a column group are lanes of one warp and
//     reduce y's partial sums by shuffles with no block barrier, halving
//     the values exchanged at each step (C - 1 + log2(G/C) shuffles a
//     step).  A lane keeps its columns in the order i ^ sigma, sigma a
//     function of its row group, so that every exchange uses the same
//     register indices on every lane; only the addresses of v and of the
//     final state's columns depend on sigma.  The partial sums run in two
//     chains (even and odd rows), which halves their dependent FMAs;
//   - the bonus term is taken out of the step: y_t = r_t . S_{t-1} + b_t v_t
//     with b_t = sum_k r_t[k] u[k] k_t[k], which does not depend on S, is
//     computed for all steps of a tile before the tile runs, once a block,
//     by the threads that staged each step's row, from their own copies
//     (visible to them once landed, so with no barrier of its own).  It
//     rounds differently from the plain r . (S + u k v^T), within the 2e-4
//     the kernel is held to;
//   - r, k, v, w of BT steps are staged in shared memory by cp.async, double
//     buffered: tile n+1 is in flight while tile n runs, with one barrier a
//     tile, and y is written by the lanes that hold it, once per step, with
//     no barrier;
//   - one block holds a whole head: splitting a head's columns over 2 or 4
//     blocks (each loading r, k, w again) measured slower on the card.
// The design per head size is the table Design<HS> below; the one kept for
// hs = 64 is the fastest of the variants timed on the card (PERF.md), which
// also shows what is left: a step of a warp issues 96 FP instructions, 8
// adds, 11 shared loads and 4 shuffles in about 208 cycles, and leaving out
// either the k.v products or two thirds of the shared loads saves only 9%
// or 8%, so neither the FP pipe nor the shared-memory pipe alone sets the
// pace.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// R x C register tile per thread, BT steps per staged tile
template <int HS>
struct Design;
template <>
struct Design<64> {
  static constexpr int R = 8, C = 4, BT = 64;
};
template <>
struct Design<32> {
  static constexpr int R = 4, C = 4, BT = 32;
};
template <>
struct Design<16> {
  static constexpr int R = 2, C = 4, BT = 32;
};
template <>
struct Design<8> {
  static constexpr int R = 1, C = 2, BT = 32;
};

template <int HS>
struct Shape {
  using D = Design<HS>;
  static constexpr int R = D::R, C = D::C, BT = D::BT;
  static constexpr int G = HS / R;     // row groups: the lanes of one column
  static constexpr int CG = HS / C;    // column groups of one block
  static constexpr int NT = G * CG;    // threads of one block
  static constexpr int CGW = 32 / G;   // column groups of one warp
  static constexpr int LOG_C = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3;
  // floats of shared memory: r, k, w, v tiles and the bonus of each step,
  // twice
  static constexpr int SMEM = 2 * BT * (4 * HS + 1);
  static_assert(G <= 32 && 32 % G == 0, "a column's row groups in one warp");
  static_assert(NT % 32 == 0 && NT <= 1024, "whole warps");
  static_assert(C <= G && (C & (C - 1)) == 0 && C <= 8, "C halvings");
  static_assert(HS % 4 == 0 && BT % 32 == 0, "16-byte rows, whole tiles");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N contiguous floats of shared memory, in the widest loads their
// alignment (a multiple of N floats) allows
template <int N>
__device__ __forceinline__ void lds(float (&out)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      out[i] = a.x, out[i + 1] = a.y, out[i + 2] = a.z, out[i + 3] = a.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 a = *reinterpret_cast<const float2*>(p + i);
      out[i] = a.x, out[i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// Stage rows [t0, t0 + nt) of one (T, N) array, N a multiple of 4, into
// dst[tt * N ...]: thread tid copies granule tid % Q (4 floats) of rows
// tid / Q + j * NT / Q, as one 16-byte cp.async (VEC) or four 4-byte ones.
// The rows a thread copies are fixed, so it may read them back after its
// own cp.async.wait_group without a barrier.
template <int BT, int NT, int N, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long st, int t0, int nt,
                                           int tid) {
  constexpr int Q = N / 4;             // granules a row
  static_assert((BT * Q) % NT == 0 && NT % Q == 0, "whole passes");
  constexpr int ROWS = NT / Q;         // rows one pass covers
  const int tt0 = tid / Q, c = (tid % Q) * 4;
  const float* s = src + (t0 + tt0) * st + c;
  float* d = dst + tt0 * N + c;
#pragma unroll
  for (int j = 0; j < BT * Q / NT; ++j) {
    if (tt0 + j * ROWS < nt) {
      if constexpr (VEC) {
        cp_async<16>(d + j * ROWS * N, s);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async<4>(d + j * ROWS * N + e, s + e);
      }
    }
    s += ROWS * st;
  }
}

template <int HS>
__global__ void __launch_bounds__(Shape<HS>::NT, 1)  // one block an SM
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int nh, int t, long long sb,
           long long sh, long long st, long long u_sb, long long u_sh,
           long long y_sb, long long y_sh, long long y_st, bool vec) {
  using S_ = Shape<HS>;
  constexpr int R = S_::R, C = S_::C, BT = S_::BT, G = S_::G, NT = S_::NT,
                CGW = S_::CGW, LOG_C = S_::LOG_C;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float4 smem4[];
  // [buffer][array r, k, w, v][BT][HS], [buffer][BT] of the bonus
  float* const rkwv = reinterpret_cast<float*>(smem4);
  float* const bsm = rkwv + 2 * 4 * BT * HS;

  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / CGW;                          // row group
  const int c0 = (warp * CGW + lane % CGW) * C;      // first column
  int sigma = 0;                                     // column order of a lane
#pragma unroll
  for (int kk = 0; kk < LOG_C; ++kk)
    sigma |= ((g >> kk) & 1) * (C >> (kk + 1));
  const long long in0 = b * sb + h * sh;
  const float* const src[4] = {r + in0, k + in0, w + in0, v + in0};
  float* const yb = y + b * y_sb + h * y_sh + c0 + sigma;
  // the bonus: this thread's granule of u, r and k in each row it stages
  constexpr int QB = HS / 4, JB = BT * QB / NT, RB = NT / QB;
  const int cb = (tid % QB) * 4;
  float ug[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ug[e] = u[b * u_sb + h * u_sh + cb + e];

  auto stage = [&](int buf, int t0, int nt) {
    float* const base = rkwv + buf * 4 * BT * HS;
    if (vec) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        stage_tile<BT, NT, HS, true>(base + a * BT * HS, src[a], st, t0, nt,
                                     tid);
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        stage_tile<BT, NT, HS, false>(base + a * BT * HS, src[a], st, t0, nt,
                                      tid);
    }
    cp_commit();
  };

  float S[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) S[i][j] = 0.f;

  stage(0, 0, min(BT, t));
  for (int t0 = 0, buf = 0; t0 < t; t0 += BT, buf ^= 1) {
    const int nt = min(BT, t - t0);
    const float* const rs = rkwv + buf * 4 * BT * HS;
    const float* const ks = rs + BT * HS;
    const float* const ws = ks + BT * HS;
    const float* const vs = ws + BT * HS + c0;
    float* const bt = bsm + buf * BT;
    cp_wait_all();
    {
      // the bonus b_t of the steps whose rows this thread staged, before
      // the barrier: its own copies are visible to it once they have
      // landed, and the QB threads that staged a row are neighbouring lanes
      float p[JB];
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int e = (tid / QB + j * RB) * HS + cb;
        const float4 a = *reinterpret_cast<const float4*>(rs + e);
        const float4 c = *reinterpret_cast<const float4*>(ks + e);
        p[j] = fmaf(a.x * ug[0], c.x, a.y * ug[1] * c.y) +
               fmaf(a.z * ug[2], c.z, a.w * ug[3] * c.w);
      }
#pragma unroll
      for (int m = 1; m < QB; m *= 2)
#pragma unroll
        for (int j = 0; j < JB; ++j) p[j] += __shfl_xor_sync(kFull, p[j], m);
      if (tid % QB == 0)
#pragma unroll
        for (int j = 0; j < JB; ++j)
          if (tid / QB + j * RB < nt) bt[tid / QB + j * RB] = p[j];
    }
    __syncthreads();       // tile `buf` and its bonus visible; every thread
                           // past the last tile, whose buffer is free
    if (t0 + BT < t) stage(buf ^ 1, t0 + BT, min(BT, t - t0 - BT));
    // a step's operands, loaded one step ahead of their use so that the
    // shared loads' latency hides behind the step before
    struct Ops {
      float r[R], k[R], w[R], v[C], b;
    };
    auto load = [&](Ops& o, int tt) {
      lds<R>(o.r, rs + tt * HS + g * R);
      lds<R>(o.k, ks + tt * HS + g * R);
      lds<R>(o.w, ws + tt * HS + g * R);
#pragma unroll
      for (int j = 0; j < C; ++j) o.v[j] = vs[tt * HS + (j ^ sigma)];
      o.b = bt[tt];
    };
    float* yp = yb + t0 * y_st;
    auto step = [&](const Ops& o) {
      // y's partial sum over this lane's rows, in two chains (even and odd
      // rows) to halve the dependent FMAs
      float acc[C], acc2[C];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = acc2[j] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          if (i % 2) acc2[j] = fmaf(o.r[i], S[i][j], acc2[j]);
          else acc[j] = fmaf(o.r[i], S[i][j], acc[j]);
          S[i][j] = fmaf(o.w[i], S[i][j], o.k[i] * o.v[j]);
        }
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] += acc2[j];
      // y over the G row groups: exchange the upper half of the columns
      // still held with the lane whose row group differs in bit kk; a
      // lane's register j is column j ^ sigma, so the partner's register
      // j + h is this lane's column j
#pragma unroll
      for (int kk = 0, hh = C / 2; hh >= 1; ++kk, hh /= 2)
#pragma unroll
        for (int j = 0; j < hh; ++j)
          acc[j] += __shfl_xor_sync(kFull, acc[j + hh], CGW << kk);
#pragma unroll
      for (int kk = LOG_C; (1 << kk) < G; ++kk)
        acc[0] += __shfl_xor_sync(kFull, acc[0], CGW << kk);
      if (g < C) *yp = fmaf(o.b, o.v[0], acc[0]);
      yp += y_st;
    };
    Ops o[2];
    load(o[0], 0);
    if (nt == BT) {
#pragma unroll 4
      for (int tt = 0; tt < BT; tt += 2) {
        load(o[1], tt + 1);
        step(o[0]);
        load(o[0], min(tt + 2, BT - 1));  // (the last one unused)
        step(o[1]);
      }
    } else {                 // the last tile, stopped at nt (static indices
                             // keep o in registers)
      for (int tt = 0; tt < nt; tt += 2) {
        if (tt + 1 < nt) load(o[1], tt + 1);
        step(o[0]);
        if (tt + 1 < nt) {
          if (tt + 2 < nt) load(o[0], tt + 2);
          step(o[1]);
        }
      }
    }
  }
  float* const so = s_out + (long long)bh * HS * HS + c0;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) so[(g * R + i) * HS + (j ^ sigma)] = S[i][j];
}

template <int HS>
int launch_hs(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* y, void* s_out, int b, int nh, int t,
              const long long* st, cudaStream_t stream) {
  using S_ = Shape<HS>;
  constexpr int bytes = S_::SMEM * 4;
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};  // devices whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(wkv_kernel<HS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  // 16-byte copies when every base and stride allows them
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = al(r) && al(k) && al(v) && al(w) && st[0] % 4 == 0 &&
                   st[1] % 4 == 0 && st[2] % 4 == 0;
  wkv_kernel<HS><<<b * nh, S_::NT, bytes, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_out), nh, t, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], vec);
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
