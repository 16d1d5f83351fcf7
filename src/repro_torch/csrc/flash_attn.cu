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
// Pallas kernel computes (kernel.py:44-72), in the same arithmetic:
//   - logits q.k summed in float32, then times the float32 scale 1/sqrt(D);
//   - masked to -1e30 where the KV column is past S and, when causal, where
//     row < column (no offset, as in the Pallas kernel, so T == S there);
//   - a running (m, l, acc) in float32 over KV tiles, m starting at -1e30;
//   - p = exp(logit - m) in float32, rounded to v's type before P.V
//     (bfloat16 rounds here, as p.astype(v.dtype) does), l summed from the
//     unrounded p;
//   - rows with l == 0 divided by 1, the output rounded to q's type.
// The bfloat16 route takes the exponent in base 2 with the scale folded in,
// p = 2^(q.k c - m c), c = scale log2(e), on the special-function unit
// (m then runs over the unscaled logits); it differs from exp() in the last
// bits of p, inside the route's limits.  Causal KV tiles wholly above the
// diagonal are skipped, as the Pallas kernel skips them; ragged row and
// column tiles are masked, nothing padded.
//
// What bounds it on the card: at phi3-medium's prefill (B 4, T = S 2048,
// Hq 40, Hkv 10, D 128, causal) the work is 4*B*Hq*D*T(T+1)/2 = 1.72e11
// operations on about 0.21 GB, some 800 operations per byte: bound by
// operations, 0.174 ms on the bfloat16 tensor cores (989 TFLOP/s), 2.6 ms
// in float32 FMA (67 TFLOP/s).
//
// Two routes, one per type:
//
// bfloat16 (flash_tc_kernel), on the tensor cores.  The first design (a
// SIMT kernel that widened bf16 to f32 in shared memory, multiplied on the
// FMA pipes with 16 products per thread per shared-memory pass, sent P
// through shared memory, paid four __syncthreads per KV tile and loaded
// synchronously) ran at 2.3% of its bound, 7.7 ms.  Now one block of 384
// threads takes 128 query rows of one (batch, head): a producer warpgroup
// and two consumer warpgroups of 64 rows.
//   - One producer thread loads Q once and K, V tile by tile with TMA, in
//     bfloat16 with the hardware's 32/64/128-byte swizzle, into a ring of
//     two stages guarded by mbarriers (full: bytes landed; empty: both
//     warpgroups done).  The tensor maps describe the strided operands as
//     they lie (encoded on the host per call; rows past T or S read as 0).
//     The producer warpgroup hands its registers to the consumers
//     (setmaxnreg 24 / 240), so D = 256 keeps its accumulators unspilled.
//   - S = Q.K^T by wgmma m64 x nBK x k16, both operands in shared memory,
//     float32 accumulators in registers.
//   - The mask and the online softmax run on those registers; a row's max
//     and sum are taken by two quad shuffles.
//   - P is rounded to bfloat16 in registers and is the A operand of
//     O += P.V (wgmma, V from shared memory read MN-major).
//   - The epilogue divides by l and writes bfloat16 pairs through o's
//     strides.
//   - Query tiles are issued heaviest first (blockIdx.y reversed, heads
//     along x), so the causal triangle balances over the SMs.
// BK (KV rows per tile) is 128, or 64 at D = 256 to fit the registers.
//
// float32 (flash_kernel): exact FMA, since TF32 keeps too few bits for the
// 2e-5 limit.  One block of 16 x 16 threads per (batch*head, 64-row query
// tile), the query tile and each 64-row K tile staged (transposed) in
// shared memory, each thread holding a 4 x 4 block of logits and a
// 4 x (D/16) block of the output in registers; P goes through shared
// memory, and the V tile reuses the K tile's buffer.  It is already about
// twice as fast as PyTorch's float32 attention, and stays as it is.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ float32 route
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // KV rows per tile
constexpr int kT = 16;           // threads per dimension: 16 x 16 = 256
constexpr int kRows = kBQ / kT;  // logit rows (and output rows) per thread
constexpr int kCols = kBK / kT;  // logit columns per thread

template <int D>
constexpr size_t smem_bytes() {
  // Q^T [D][kBQ + 1], K^T [D][kBK + 1] (then V [kBK][D]), P^T [kBK][kBQ + 1]
  return sizeof(float) * (size_t(D) * (kBQ + 1) + size_t(D) * (kBK + 1) +
                          size_t(kBK) * (kBQ + 1));
}

template <int D>
__global__ void __launch_bounds__(kT * kT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int hq,
             int group, int t, int s, float scale, int causal, long long q_sb,
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
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * kv_sb + hk * kv_sh;
  const float* vb = v + b * kv_sb + hk * kv_sh;

  for (int i = tid; i < kBQ * D; i += kT * kT) {
    const int r = i / D, d = i % D;
    Qs[d * (kBQ + 1) + r] = (q0 + r < t) ? qb[(q0 + r) * q_st + d] : 0.f;
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
      KVs[d * (kBK + 1) + c] = (k0 + c < s) ? kb[(k0 + c) * kv_st + d] : 0.f;
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
        Ps[(tx + kT * j) * (kBQ + 1) + ty + kT * i] = p;
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
      KVs[c * D + d] = (k0 + c < s) ? vb[(k0 + c) * kv_st + d] : 0.f;
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
  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kT * i;
    if (row >= t) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kDp; ++j) ob[row * o_st + tx + kT * j] = acc[i][j] / li;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int t, int s, float scale, int causal,
               const long long* st, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kern = flash_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long long)b * hq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((t + kBQ - 1) / kBQ, b * hq);
  kern<<<grid, kT * kT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hq / hkv, t,
      s, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- bfloat16 route
namespace tc {

constexpr int kBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1-2 consume
// registers per thread after the producer hands its own to the consumers:
// 128 * 24 + 256 * 240 = 384 * 168, the launch's pool
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 2;     // K/V ring depth
// an mbarrier wait that outlasts this many cycles (about 35 s, far past
// any load) traps instead of hanging the card
constexpr long long kWaitCycles = 1LL << 36;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;     // KV rows per tile
  static constexpr int SW = (D < 64 ? D : 64) * 2;   // bytes per swizzled row
  static constexpr int CH = D * 2 / SW;              // SW-byte column chunks
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr int LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  // 1,024 bytes of slack to align the tiles for the swizzle, then Q, the K
  // ring, the V ring and 1 + 2 * kStages mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One TMA tile load of a 4-d tensor map into shared memory, completing on
// the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The tensor maps order the row, head and batch dimensions by stride; pos
// packs the coordinate index (1-3) of each in 2-bit fields.
__device__ __forceinline__ int coord(int pos, int i, int row, int head,
                                     int batch) {
  return (pos & 3) == i ? row : (((pos >> 2) & 3) == i ? head : batch);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers written by an asynchronous wgmma: keep the compiler from
// moving their reads above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit (flush to zero below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// wgmma m64nNk16, bfloat16 in, float32 accumulators: ss takes A and B from
// shared memory (both K-major), rs takes A from registers and B MN-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, 1);
  else wgmma_ss_n128(d, da, db, 1);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, 1);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int hq, int group, int t,
                int s, float scale, int causal, int qpos, int kvpos,
                long long o_sb, long long o_sh, long long o_st) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, SW = C::SW;
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + kStages * C::KV_BYTES;
  // mbarriers: Q landed; K/V stage i landed (full); stage i read (empty)
  const uint32_t q_full = sV + kStages * C::KV_BYTES;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  int n_k = (s + BK - 1) / BK;
  if (causal) n_k = min(n_k, (q0 + kBQ - 1) / BK + 1);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 256);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp < 4) {                            // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CH; ++c)
        tma_load(sQ + c * kBQ * SW, &tq, q_full, c * (SW / 2),
                 coord(qpos, 1, q0, h, b), coord(qpos, 2, q0, h, b),
                 coord(qpos, 3, q0, h, b));
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty0 + 8 * st, ((kt / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        const int r = kt * BK;
        const int c1 = coord(kvpos, 1, r, hk, b);
        const int c2 = coord(kvpos, 2, r, hk, b);
        const int c3 = coord(kvpos, 3, r, hk, b);
#pragma unroll
        for (int c = 0; c < C::CH; ++c) {
          tma_load(sK + st * C::KV_BYTES + c * BK * SW, &tk, full,
                   c * (SW / 2), c1, c2, c3);
          tma_load(sV + st * C::KV_BYTES + c * BK * SW, &tv, full,
                   c * (SW / 2), c1, c2, c3);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows q0 + 64 * cw .. + 63; the two roles
    // never reconverge, so each keeps the registers setmaxnreg gave it
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = warp / 4 - 1, w = warp % 4;
    // exp(x * scale) = 2^(x * c): the scale folded into the base-2 exponent
    const float c = scale * 1.4426950408889634f;
    const int r0 = q0 + 64 * cw + 16 * w + lane / 4, r1 = r0 + 8;
    const int cq = 2 * (lane % 4);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      mbar_wait(full0 + 8 * st, (kt / kStages) & 1);
      const uint32_t k_tile = sK + st * C::KV_BYTES;
      const uint32_t v_tile = sV + st * C::KV_BYTES;

      // S = Q K^T: D / 16 steps of k16, each 32 bytes into a swizzled row
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 32 / SW, off = kk * 32 % SW;
        const uint64_t da = desc(sQ + c * kBQ * SW + cw * 64 * SW + off, 16,
                                 8 * SW, C::LAYOUT);
        const uint64_t db = desc(k_tile + c * BK * SW + off, 16, 8 * SW,
                                 C::LAYOUT);
        wgmma_ss<BK>(sc, da, db);
      }
      wg_commit();
      wg_wait0();
      fence_regs<BK / 2>(sc);

      // mask, online softmax in base 2.  Register 4 nb + e holds (r0, col)
      // and 4 nb + 2 + e holds (r1, col), col = k0 + 8 nb + cq + e; m is the
      // running maximum of the unscaled logits.
      const int k0 = kt * BK;
      const bool edge = k0 + BK > s || (causal && k0 + BK - 1 > q0 + 64 * cw);
      if (edge) {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * nb + cq + e;
            if (col >= s || (causal && r0 < col)) sc[4 * nb + e] = kNegInf;
            if (col >= s || (causal && r1 < col)) sc[4 * nb + 2 + e] = kNegInf;
          }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nb], sc[4 * nb + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = ex2((m0 - mn0) * c), a1 = ex2((m1 - mn1) * c);
      const float b0 = mn0 * c, b1 = mn1 * c;
      // p rounded to bf16 into wgmma's A fragment: k-chunk nb / 2 takes
      // columns 16 (nb / 2) .. + 15, registers {r0 lo, r1 lo, r0 hi, r1 hi}
      uint32_t pa[BK / 16][4];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        const float p00 = ex2(fmaf(sc[4 * nb], c, -b0));
        const float p01 = ex2(fmaf(sc[4 * nb + 1], c, -b0));
        const float p10 = ex2(fmaf(sc[4 * nb + 2], c, -b1));
        const float p11 = ex2(fmaf(sc[4 * nb + 3], c, -b1));
        s0 += p00 + p01;
        s1 += p10 + p11;
        pa[nb / 2][2 * (nb % 2)] = pack_bf16(p00, p01);
        pa[nb / 2][2 * (nb % 2) + 1] = pack_bf16(p10, p11);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      l0 = a0 * l0 + s0;
      l1 = a1 * l1 + s1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        acc[4 * nb] *= a0;
        acc[4 * nb + 1] *= a0;
        acc[4 * nb + 2] *= a1;
        acc[4 * nb + 3] *= a1;
      }

      // O += P V: BK / 16 steps of k16 = 16 rows of the V tile; V is
      // MN-major, its SW-byte column chunks BK * SW bytes apart
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<D>(acc, pa[kc],
                    desc(v_tile + kc * 16 * SW, BK * SW, 8 * SW, C::LAYOUT));
      wg_commit();
      wg_wait0();
      fence_regs<D / 2>(acc);
      mbar_arrive(empty0 + 8 * st);
    }

    const float i0 = l0 == 0.f ? 1.f : l0, i1 = l1 == 0.f ? 1.f : l1;
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = 8 * nb + cq;
      if (r0 < t)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_st + col) =
            __floats2bfloat162_rn(acc[4 * nb] / i0, acc[4 * nb + 1] / i0);
      if (r1 < t)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_st + col) =
            __floats2bfloat162_rn(acc[4 * nb + 2] / i1, acc[4 * nb + 3] / i1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links against nothing but the CUDA runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-d bfloat16 tensor map of (D, row, head, batch) with the row, head and
// batch dimensions ordered by stride (extent-1 dimensions last), a box of
// (sw / 2, box_rows) and the swizzle of sw bytes.  ext and st are the row,
// head and batch extents and element strides; *pos receives the coordinate
// index of each, packed as coord() reads it.
int make_map(CUtensorMap* map, const void* ptr, int d, const long long* ext,
             const long long* st, int box_rows, int sw, int* pos) {
  const EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) {
    fprintf(stderr, "flash_attn: cuTensorMapEncodeTiled not found\n");
    return (int)cudaErrorNotSupported;
  }
  long long span = d, key[3];
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && st[i] * ext[i] > span) span = st[i] * ext[i];
  for (int i = 0; i < 3; ++i) key[i] = ext[i] > 1 ? st[i] : (span + 7) / 8 * 8;
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key[order[j]] < key[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)d, 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)(sw / 2), 1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  *pos = 0;
  for (int j = 0; j < 3; ++j) {
    const int role = order[j];
    dims[j + 1] = (cuuint64_t)ext[role];
    strides[j] = (cuuint64_t)key[role] * 2;
    if (role == 0) box[j + 1] = (cuuint32_t)box_rows;
    *pos |= (j + 1) << (2 * role);
  }
  const CUtensorMapSwizzle swz =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "flash_attn: cuTensorMapEncodeTiled failed (%d): dims %llu %llu "
            "%llu %llu strides %llu %llu %llu box %u %u %u %u\n",
            (int)r, (unsigned long long)dims[0], (unsigned long long)dims[1],
            (unsigned long long)dims[2], (unsigned long long)dims[3],
            (unsigned long long)strides[0], (unsigned long long)strides[1],
            (unsigned long long)strides[2], box[0], box[1], box[2], box[3]);
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int hq, int hkv, int t, int s, float scale, int causal,
              const long long* st, cudaStream_t stream) {
  using C = Cfg<D>;
  const int n_qt = (t + kBQ - 1) / kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int qpos = 0, kvpos = 0, vpos = 0;
  const long long qext[3] = {t, hq, b}, kext[3] = {s, hkv, b};
  const long long qst[3] = {st[2], st[1], st[0]};
  const long long kst[3] = {st[5], st[4], st[3]};
  int rc = make_map(&mq, q, D, qext, qst, kBQ, C::SW, &qpos);
  if (rc == 0) rc = make_map(&mk, k, D, kext, kst, C::BK, C::SW, &kvpos);
  if (rc == 0) rc = make_map(&mv, v, D, kext, kst, C::BK, C::SW, &vpos);
  if (rc != 0) return rc;
  auto kern = flash_tc_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * hq, n_qt);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), hq, hq / hkv, t, s, scale,
      causal, qpos, kvpos, st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

}  // namespace tc

bool bad_sizes(int b, int hq, int hkv, int t, int s) {
  return b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || t < 1 || s < 1;
}

}  // namespace

extern "C" int hylu_flash_attn_f32(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int t, int s, int d, int causal, float scale, long long q_sb,
    long long q_sh, long long q_st, long long kv_sb, long long kv_sh,
    long long kv_st, long long o_sb, long long o_sh, long long o_st,
    void* stream) {
  if (bad_sizes(b, hq, hkv, t, s)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_st, kv_sb, kv_sh,
                           kv_st, o_sb, o_sh, o_st};
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_f32<16>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 32: return launch_f32<32>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 64: return launch_f32<64>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 128: return launch_f32<128>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 256: return launch_f32<256>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bfloat16 route: q, k, v 16-byte aligned with strides that are
// multiples of 8 elements (what TMA reads); the wrapper checks both.
extern "C" int hylu_flash_attn_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int t, int s, int d, int causal, float scale, long long q_sb,
    long long q_sh, long long q_st, long long kv_sb, long long kv_sh,
    long long kv_st, long long o_sb, long long o_sh, long long o_st,
    void* stream) {
  if (bad_sizes(b, hq, hkv, t, s)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_st, kv_sb, kv_sh,
                           kv_st, o_sb, o_sh, o_st};
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (d) {
    case 16: return tc::launch_tc<16>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 32: return tc::launch_tc<32>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 64: return tc::launch_tc<64>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 128: return tc::launch_tc<128>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    case 256: return tc::launch_tc<256>(q, k, v, o, b, hq, hkv, t, s, scale, causal, st, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
