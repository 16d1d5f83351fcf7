// K5, the sup-sup update C - A.B of the unrolled factor schedule: the Hopper
// counterparts of the Pallas
//
//   src/repro/kernels/supsup/kernel.py:21  _gemm_update_kernel
//       (gemm_update :77, pallas_call :85), reached through supsup/ops.py:50
//       gemm and :15 supsup_update -- the per-edge sup-sup update of the
//       unrolled factor schedule (src/repro/core/jax_engine.py:152-158).
//
// Two kernels.
//
// hylu_node_edges_* (the engine's): one node step of the unrolled schedule,
// the whole left-looking edge loop of one node (jax_engine.py:132-161) in
// one launch, reading and writing the value buffer in place.  Each edge
// updates the node's panel through its col_map cm (no duplicates) from the
// finished rows src (k, k + m) of an earlier node:
//
//     x = panel[:, cm];  lts = x[:, :k] U^-1  (U = triu(src[:, :k]));
//     panel[:, cm] = [lts, x[:, k:] - lts src[:, k:]],
//
// for k = 1 a true division by src[0, 0] (jax_engine.py:150); then a
// width-1 node perturbs its pivot against eps (|d| < eps -> +-eps by d's
// sign, NaN left, counted in nper; jax_engine.py:103-108).  Row r of the
// panel is updated from row r and from finished rows only, so the edge loop
// of one row needs no other row: a warp owns one row of one system (grid:
// the node's rows x the K systems) and runs every edge of the node in
// order, with no block barrier.  The row lives in shared memory for the
// whole loop when it fits (w * sizeof(T) <= kRowSmemBytes), else it is read
// and written in device memory.  Per edge, lane l holds the columns
// c = l + 32 s (s < 4, c < len(cm)) in registers and the edge runs
// right-looking in the column form of K6 (csrc/suprow.cu): step j < k
// broadcasts x_j and U's diagonal by shuffles, divides, and every lane
// applies x_c -= lts_j src[j, c] to its columns c > j with fused
// multiply-adds in the input type (no TF32): the triangular solve and the
// product in one sweep.  Columns past 128 (len(cm) > 128) take a second
// sweep over the stored lts.  Each division is K3's (csrc/div_fast.cuh): a
// product by the reciprocal corrected to a true division's bits, by true
// division where that cannot vouch for the quotient.  A node with an edge
// source of more than 128 rows runs the WIDE instance, which blocks that
// edge's solve over k by 128, as K3 does: block 0 is the sweep above; each
// later block of 128 columns first takes the lts of the blocks before it
// from shared memory (a GEMV against U's rows, the form of the sweep past
// 128), then sweeps its own j on the lanes' registers and publishes its
// lts, whose buffer is dynamic shared memory sized to the node's widest
// source.  Per column the subtractions keep the order j = 0, 1, ... of the
// unblocked sweep.  Every other node runs the instance without the flag.
//
// What bounds it on the card: per edge 2 nr k (k + m) operations on the
// panel's touched columns and the source rows, so bytes; but the edges of
// one node form a dependent chain (up to 1,085 at fem2d_10k), so per edge
// it is latency.  So the node's descriptors are copied to shared memory in
// windows of kWindow edges, and each edge is staged kRing - 1 edges ahead
// by cp.async into a ring of kRing slots (per lane, its columns' col_map
// entries, source row 0 and U's diagonal), U's next row is loaded a step
// ahead, and the row's values are read from shared memory.  At fem2d_10k
// most edges have k = 1 and the launches (one per node) set the pace: a
// ring of 2, 3, 4 or 6 slots measured the same, and registers staged one
// edge ahead (the first design) 13% slower over a refactor.
//
// hylu_gemm_update_* (the parent design of the node step, kept as
// chip_smoke.py's yardstick for it; no path of the system launches it): OUT[e]
// = C[e] - A[e] @ B[e] over a batch, C and OUT (batch, nr, m), A (batch, nr,
// k), B (batch, k, m), each row-major with its own batch and row stride
// (views), OUT either its own buffer or C itself (in place: each entry is read
// and then written by one thread).  It sums A @ B with fused multiply-adds in
// the input type and then subtracts it from C, as the Pallas kernel does for
// its one k-tile (k <= 128; any k here).  The JAX wrapper pads nr, k and m to
// multiples of 8 or 128 with exact zeros; this kernel masks the ragged tile
// edges instead.  One edge is at most nr = k = 128, m ~ 100 (at fem2d_10k):
// bound by bytes, and at one system per launch by launch latency.  A plain
// shared-memory tiled GEMM: a 64x64 tile of OUT per block, 16x16 threads with a
// 4x4 register tile each, 16-deep slabs of A and B staged through shared
// memory; it is not tuned.
//
// bfloat16 (hylu_gemm_update_bf16, hylu_node_edges[_wide]_bf16): values
// stored in bfloat16, arithmetic in float32.  The GEMM update stages A and B
// as float32, sums A @ B in float32 and rounds C - A @ B once at the store,
// as the Pallas kernel's float32 scratch accumulator does.  The node step
// rounds as the JAX package's unrolled node step: the register sweep keeps
// per column the float32 sum a of lts_j src[j, c] over the solved j.  A
// solve column (c < k) rounds a, subtracts it from the entry, rounds the
// difference and divides by its diagonal (the true float32 quotient,
// rounded), as K3 does (csrc/trsm.cu).  A trailing column (c >= k) of a
// sup-sup edge (k > 1) of a node of more than one row is C - A.B rounded
// once, as the Pallas GEMM update; for k == 1 or a one-row node, where the
// reference runs plain bfloat16 ops, a is rounded, then the difference.
// cp.async copies no two-byte element, so an edge's ring slot holds, per
// column, the aligned 4-byte word around its source row 0 and diagonal
// entries, and the lane takes the half it needs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "div_fast.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kSlab = 16;
constexpr int kThreadsDim = 16;
constexpr int kPer = kTile / kThreadsDim;   // 4 outputs per thread per dim

// The sum's type: the input type, float32 for bfloat16.
template <typename T>
struct AccOf { using type = T; };
template <>
struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_acc(typename AccOf<T>::type v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// Strides are in elements; columns are unit-stride.  C and OUT may alias,
// so neither is __restrict__.
template <typename T>
__global__ void __launch_bounds__(kThreadsDim * kThreadsDim)
gemm_update_kernel(const T* C, long long sc_b, long long sc_r,
                   const T* __restrict__ A, long long sa_b, long long sa_r,
                   const T* __restrict__ B, long long sb_b, long long sb_r,
                   T* OUT, long long so_b, long long so_r, int nr, int k,
                   int m, int tiles_r, int tiles_c) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc As[kSlab][kTile + 1];   // A slab, transposed: As[kk][row]
  __shared__ Acc Bs[kSlab][kTile + 1];
  const int per = tiles_r * tiles_c;
  const long long e = blockIdx.x / per;
  const int rem = blockIdx.x % per;
  const int row0 = (rem / tiles_c) * kTile;
  const int col0 = (rem % tiles_c) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsDim + tx;
  const T* Ae = A + e * sa_b;
  const T* Be = B + e * sb_b;

  Acc acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < k; k0 += kSlab) {
    for (int t = tid; t < kTile * kSlab; t += kThreadsDim * kThreadsDim) {
      const int r = t / kSlab, kk = t % kSlab;      // A: along its rows' k
      const int ar = row0 + r, ac = k0 + kk;
      As[kk][r] = (ar < nr && ac < k) ? to_acc(Ae[ar * sa_r + ac]) : Acc(0);
      const int br = k0 + t / kTile, bc = col0 + t % kTile;   // B: along m
      Bs[t / kTile][t % kTile] =
          (br < k && bc < m) ? to_acc(Be[br * sb_r + bc]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      Acc a[kPer], b[kPer];
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
  const T* Ce = C + e * sc_b;
  T* Oe = OUT + e * so_b;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = row0 + ty + i * kThreadsDim;
      const int c = col0 + tx + j * kThreadsDim;
      if (r < nr && c < m)
        Oe[r * so_r + c] = from_acc<T>(to_acc(Ce[r * sc_r + c]) - acc[i][j]);
    }
}

template <typename T>
int launch_gemm_update(const void* C, long long sc_b, long long sc_r,
                       const void* A, long long sa_b, long long sa_r,
                       const void* B, long long sb_b, long long sb_r,
                       void* OUT, long long so_b, long long so_r, int batch,
                       int nr, int k, int m, void* stream) {
  if (batch < 1 || nr < 1 || k < 1 || m < 1 || sc_r < m || sa_r < k ||
      sb_r < m || so_r < m)
    return (int)cudaErrorInvalidValue;
  const int tiles_r = (nr + kTile - 1) / kTile;
  const int tiles_c = (m + kTile - 1) / kTile;
  if ((long long)batch * tiles_r * tiles_c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kThreadsDim, kThreadsDim);
  gemm_update_kernel<T><<<(unsigned)((long long)batch * tiles_r * tiles_c),
                          block, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(C), sc_b, sc_r, static_cast<const T*>(A), sa_b,
      sa_r, static_cast<const T*>(B), sb_b, sb_r, static_cast<T*>(OUT), so_b,
      so_r, nr, k, m, tiles_r, tiles_c);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ node step
constexpr int kMaxK = 128;             // supernode cap: k <= 128
constexpr int kSlots = kMaxK / 32;     // register columns per lane
constexpr int kDescFields = 5;         // src offset, cm offset, k, sw, len
constexpr int kRing = 4;               // edges staged ahead, ring slots
constexpr int kWindow = 256;           // descriptors in shared at a time
// a row up to this stays in shared memory: with the static buffers
// (desc_s 10 KB, the ring 4 / 8 KB, lts_s 0.5 / 1 KB) under 48 KB
constexpr int kRowSmemBytes = 24576;
// the WIDE instance's lts buffer (dynamic shared memory, beside the row)
constexpr int kMaxWideLtsBytes = 131072;
// the most dynamic shared memory a WIDE launch asks for: the row, then lts
constexpr int kMaxWideDynBytes = kRowSmemBytes + kMaxWideLtsBytes;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes (4 or 8), of which the first src_bytes are read
// and the rest zero-filled.
template <int size>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(size), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// One edge's descriptor in shared memory: source row offset, col_map
// offset, k, source width, len(col_map).
struct EdgeDesc {
  long long src, cm;
  int k, sw, len;
};

__device__ __forceinline__ EdgeDesc read_desc(const long long* d) {
  return {d[0], d[1], (int)d[2], (int)d[3], (int)d[4]};
}

// Stage one edge into a ring slot by cp.async: for lane l's columns
// c = l + 32 s, c < 128, the col_map entry, source row 0 and U's diagonal
// (zero past len and past k); each lane copies and later reads its own.
template <typename T>
__device__ __forceinline__ void stage_edge(const T* vs, const long long* cm,
                                           const EdgeDesc& d, long long* col,
                                           T* u0, T* dg, int lane) {
  const T* src = vs + d.src;
  const long long* cme = cm + d.cm;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane + 32 * s;
    const bool in = c < d.len, diag = c < d.k;
    cp_async<8>(col + c, in ? cme + c : cm, in ? 8 : 0);
    cp_async<(int)sizeof(T)>(u0 + c, in ? src + c : vs,
                             in ? (int)sizeof(T) : 0);
    cp_async<(int)sizeof(T)>(dg + c, diag ? src + (long long)c * d.sw + c : vs,
                             diag ? (int)sizeof(T) : 0);
  }
}

// The WIDE instance's solve blocks past the first (an edge with k > 128):
// block [b0, b0 + 128) of the edge's columns is read from the row, takes
// the lts of the blocks before it from shared memory as a GEMV against U's
// rows j < b0, then runs the column-form sweep of its own j on the lanes'
// registers (U's diagonal and rows read from the source, K3's division),
// publishes its lts and is written back.  Returns the first column past
// the solve's blocks.
template <typename T>
__device__ __forceinline__ int wide_blocks(T* row, const T* src,
                                           const long long* cme,
                                           const EdgeDesc& d, T* lts_s,
                                           int lane) {
  const int k = d.k, len = d.len;
  int b0 = kMaxK;
  for (; b0 < k; b0 += kMaxK) {
    int cc[kSlots];
    T y[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = b0 + lane + 32 * s;
      cc[s] = c < len ? (int)__ldg(cme + c) : 0;
      y[s] = c < len ? row[cc[s]] : T(0);
    }
#pragma unroll 4
    for (int j = 0; j < b0; ++j) {          // the blocks before: a GEMV
      const T l = lts_s[j];
      const T* uj = src + (long long)j * d.sw;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = b0 + lane + 32 * s;
        if (c < len) y[s] = fma(-l, __ldg(uj + c), y[s]);
      }
    }
    const int be = min(k, b0 + kMaxK);
    for (int j = b0; j < be; ++j) {         // the block's own sweep
      const int js = (j - b0) >> 5, jl = (j - b0) & 31;
      T xo = y[0];
#pragma unroll
      for (int s = 1; s < kSlots; ++s)
        if (js == s) xo = y[s];
      const T xj = __shfl_sync(kFull, xo, jl);
      const T* uj = src + (long long)j * d.sw;
      const T dj = __ldg(uj + j);
      bool ok = true;
      T l = div_fast(xj, dj, recip(dj), ok);
      if (!ok) l = true_div(xj, dj);
      if (lane == 0) lts_s[j] = l;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = b0 + lane + 32 * s;
        if (c == j)
          y[s] = l;
        else if (c > j && c < len)
          y[s] = fma(-l, __ldg(uj + c), y[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (b0 + lane + 32 * s < len) row[cc[s]] = y[s];
    __syncwarp();             // the block's lts and columns for every lane
  }
  return b0;
}

// One edge on one row (in shared or device memory): the column-form sweep
// over j < k (j < 128 in the WIDE instance, whose later blocks follow in
// wide_blocks) on the lane's registers, then the columns past the solve,
// if any, from the lts published in shared memory.
template <typename T, bool WIDE>
__device__ __forceinline__ void edge_step(T* row, const T* vs,
                                          const long long* cm,
                                          const EdgeDesc& d,
                                          const long long* col_s,
                                          const T* u0_s, const T* dg_s,
                                          T* lts_s, int lane) {
  const int k = WIDE ? min(d.k, kMaxK) : d.k, len = d.len;
  const T* src = vs + d.src;
  int col[kSlots];
  T x[kSlots], u[kSlots], dg[kSlots];
  double rd[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane + 32 * s;
    col[s] = (int)col_s[c];
    x[s] = c < len ? row[col[s]] : T(0);
    u[s] = u0_s[c];
    dg[s] = dg_s[c];
    rd[s] = 32 * s < k ? recip(dg[s]) : 1.0;
  }
  for (int j = 0; j < k; ++j) {
    T un[kSlots];                         // U's row j + 1, a step ahead
    const T* next = src + (long long)(j + 1) * d.sw;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      un[s] = (j + 1 < k && c > j + 1 && c < len) ? __ldg(next + c) : T(0);
    }
    const int js = j >> 5, jl = j & 31;
    T xo = x[0], dd = dg[0];
    double rr = rd[0];
#pragma unroll
    for (int s = 1; s < kSlots; ++s)
      if (js == s) {
        xo = x[s];
        dd = dg[s];
        rr = rd[s];
      }
    const T xj = __shfl_sync(kFull, xo, jl);
    const T dj = __shfl_sync(kFull, dd, jl);
    const double rj = __shfl_sync(kFull, rr, jl);
    bool ok = true;
    T l = div_fast(xj, dj, rj, ok);
    if (!ok) l = true_div(xj, dj);
    if (len > kMaxK && lane == 0) lts_s[j] = l;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      if (c == j)
        x[s] = l;
      else if (c > j && c < len)
        x[s] = fma(-l, u[s], x[s]);
      u[s] = un[s];
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (lane + 32 * s < len) row[col[s]] = x[s];
  if (len > kMaxK) {                      // the columns past 128
    __syncwarp();
    const long long* cme = cm + d.cm;
    for (int c0 = WIDE ? wide_blocks<T>(row, src, cme, d, lts_s, lane)
                       : kMaxK;
         c0 < len; c0 += kMaxK) {
      int cc[kSlots];
      T y[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = c0 + lane + 32 * s;
        cc[s] = c < len ? (int)__ldg(cme + c) : 0;
        y[s] = c < len ? row[cc[s]] : T(0);
      }
#pragma unroll 4
      for (int j = 0; j < d.k; ++j) {
        const T l = lts_s[j];
        const T* uj = src + (long long)j * d.sw;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = c0 + lane + 32 * s;
          if (c < len) y[s] = fma(-l, __ldg(uj + c), y[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (c0 + lane + 32 * s < len) row[cc[s]] = y[s];
    }
  }
  __syncwarp();               // the next edge reads what other lanes wrote
}

// ------------------------------------------------- node step, bfloat16
__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float ldg_bf(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
// the 4-byte aligned word around a two-byte element, and the element's half
// of that word once staged
__device__ __forceinline__ const void* word_of(const void* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                       ~uintptr_t(3));
}
__device__ __forceinline__ float staged_bf(unsigned w,
                                           const __nv_bfloat16* p) {
  const unsigned b = (reinterpret_cast<uintptr_t>(p) & 2) ? w >> 16
                                                           : w & 0xffffu;
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)b));
}

// A ring slot of a bfloat16 edge: stage_edge's copies, each element as its
// aligned word.
__device__ __forceinline__ void stage_edge_bf16(const __nv_bfloat16* vs,
                                                const long long* cm,
                                                const EdgeDesc& d,
                                                long long* col, unsigned* u0,
                                                unsigned* dg, int lane) {
  const __nv_bfloat16* src = vs + d.src;
  const long long* cme = cm + d.cm;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane + 32 * s;
    const bool in = c < d.len, diag = c < d.k;
    cp_async<8>(col + c, in ? cme + c : cm, in ? 8 : 0);
    cp_async<4>(u0 + c, word_of(in ? src + c : vs), in ? 4 : 0);
    cp_async<4>(dg + c, word_of(diag ? src + (long long)c * d.sw + c : vs),
                diag ? 4 : 0);
  }
}

// A column's entry x less the float32 sum a of its products, each rounded
// to bfloat16
__device__ __forceinline__ float less_sum(float x, float a) {
  return bf_round(__fsub_rn(x, bf_round(a)));
}

// A trailing column's entry x less the sum a: rounded once when ``once``
// (a sup-sup edge of a node of more than one row), else as less_sum.
__device__ __forceinline__ float trail(float x, float a, bool once) {
  return once ? bf_round(__fsub_rn(x, a)) : less_sum(x, a);
}

// Unknown j of an edge's solve from its column's entry x, the sum a of the
// products of the lts before it and its divisor dj; every lane computes and
// lane jl's value is taken.
__device__ __forceinline__ float lts_bf16(float x, float a, float dj,
                                          int jl) {
  return __shfl_sync(kFull, bf_round(__fdiv_rn(less_sum(x, a), dj)), jl);
}

// The WIDE instance's solve blocks past the first, bfloat16: wide_blocks
// with per column the float32 sum of its products.
__device__ __forceinline__ int wide_blocks_bf16(__nv_bfloat16* row,
                                                const __nv_bfloat16* src,
                                                const long long* cme,
                                                const EdgeDesc& d,
                                                __nv_bfloat16* lts_s,
                                                bool once, int lane) {
  const int k = d.k, len = d.len;
  int b0 = kMaxK;
  for (; b0 < k; b0 += kMaxK) {
    int cc[kSlots];
    float xv[kSlots], acc[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = b0 + lane + 32 * s;
      cc[s] = c < len ? (int)__ldg(cme + c) : 0;
      xv[s] = c < len ? bf2f(row[cc[s]]) : 0.f;
      acc[s] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < b0; ++j) {          // the blocks before: a GEMV
      const float l = bf2f(lts_s[j]);
      const __nv_bfloat16* uj = src + (long long)j * d.sw;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = b0 + lane + 32 * s;
        if (c < len) acc[s] = fmaf(l, ldg_bf(uj + c), acc[s]);
      }
    }
    const int be = min(k, b0 + kMaxK);
    for (int j = b0; j < be; ++j) {         // the block's own sweep
      const int js = (j - b0) >> 5, jl = (j - b0) & 31;
      float xo = xv[0], ao = acc[0];
#pragma unroll
      for (int s = 1; s < kSlots; ++s)
        if (js == s) {
          xo = xv[s];
          ao = acc[s];
        }
      const __nv_bfloat16* uj = src + (long long)j * d.sw;
      const float l = lts_bf16(xo, ao, ldg_bf(uj + j), jl);
      if (lane == 0) lts_s[j] = __float2bfloat16_rn(l);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = b0 + lane + 32 * s;
        if (c == j)
          xv[s] = l;
        else if (c > j && c < len)
          acc[s] = fmaf(l, ldg_bf(uj + c), acc[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = b0 + lane + 32 * s;
      if (c < len)
        row[cc[s]] = __float2bfloat16_rn(c < k ? xv[s]
                                               : trail(xv[s], acc[s], once));
    }
    __syncwarp();             // the block's lts and columns for every lane
  }
  return b0;
}

// edge_step in bfloat16: the same sweep, with the roundings above.
template <bool WIDE>
__device__ __forceinline__ void edge_step_bf16(__nv_bfloat16* row,
                                               const __nv_bfloat16* vs,
                                               const long long* cm,
                                               const EdgeDesc& d,
                                               const long long* col_s,
                                               const unsigned* u0_s,
                                               const unsigned* dg_s,
                                               __nv_bfloat16* lts_s,
                                               int lane) {
  const int k = WIDE ? min(d.k, kMaxK) : d.k, len = d.len;
  const bool once = d.k > 1 && gridDim.x > 1;   // grid (nr, K)
  const __nv_bfloat16* src = vs + d.src;
  int col[kSlots];
  float xv[kSlots], acc[kSlots], u[kSlots], dg[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane + 32 * s;
    col[s] = (int)col_s[c];
    xv[s] = c < len ? bf2f(row[col[s]]) : 0.f;
    acc[s] = 0.f;
    u[s] = staged_bf(u0_s[c], src + c);
    dg[s] = staged_bf(dg_s[c], src + (long long)c * d.sw + c);
  }
  for (int j = 0; j < k; ++j) {
    float un[kSlots];                     // U's row j + 1, a step ahead
    const __nv_bfloat16* next = src + (long long)(j + 1) * d.sw;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      un[s] = (j + 1 < k && c > j + 1 && c < len) ? ldg_bf(next + c) : 0.f;
    }
    const int js = j >> 5, jl = j & 31;
    float xo = xv[0], ao = acc[0], dd = dg[0];
#pragma unroll
    for (int s = 1; s < kSlots; ++s)
      if (js == s) {
        xo = xv[s];
        ao = acc[s];
        dd = dg[s];
      }
    const float l = lts_bf16(xo, ao, dd, jl);
    if (len > kMaxK && lane == 0) lts_s[j] = __float2bfloat16_rn(l);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      if (c == j)
        xv[s] = l;
      else if (c > j && c < len)
        acc[s] = fmaf(l, u[s], acc[s]);
      u[s] = un[s];
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane + 32 * s;
    if (c < len)
      row[col[s]] = __float2bfloat16_rn(c < d.k ? xv[s]
                                                : trail(xv[s], acc[s], once));
  }
  if (len > kMaxK) {                      // the columns past 128
    __syncwarp();
    const long long* cme = cm + d.cm;
    for (int c0 = WIDE ? wide_blocks_bf16(row, src, cme, d, lts_s, once,
                                          lane)
                       : kMaxK;
         c0 < len; c0 += kMaxK) {
      int cc[kSlots];
      float y[kSlots], a[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = c0 + lane + 32 * s;
        cc[s] = c < len ? (int)__ldg(cme + c) : 0;
        y[s] = c < len ? bf2f(row[cc[s]]) : 0.f;
        a[s] = 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < d.k; ++j) {
        const float l = bf2f(lts_s[j]);
        const __nv_bfloat16* uj = src + (long long)j * d.sw;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = c0 + lane + 32 * s;
          if (c < len) a[s] = fmaf(l, ldg_bf(uj + c), a[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (c0 + lane + 32 * s < len)
          row[cc[s]] = __float2bfloat16_rn(trail(y[s], a[s], once));
    }
  }
  __syncwarp();               // the next edge reads what other lanes wrote
}

// a ring slot's element type: the value's, or for bfloat16 its 4-byte word
template <typename T>
using Staged = std::conditional_t<sizeof(T) == 2, unsigned, T>;

template <typename T>
__device__ __forceinline__ void stage_slot(const T* vs, const long long* cm,
                                           const EdgeDesc& d, long long* col,
                                           Staged<T>* u0, Staged<T>* dg,
                                           int lane) {
  if constexpr (sizeof(T) == 2)
    stage_edge_bf16(vs, cm, d, col, u0, dg, lane);
  else
    stage_edge<T>(vs, cm, d, col, u0, dg, lane);
}

// grid (nr, K), one warp a block: row blockIdx.x of the node's panel of
// system blockIdx.y.  The edges [e0, e1) of the descriptor table go in
// windows of kWindow: a window's descriptors are copied to shared memory,
// then each edge is staged kRing - 1 edges ahead into a ring of kRing
// slots by cp.async, so its loads fly while the edges before it run.  The
// WIDE instance keeps its lts in the dynamic shared memory past the row
// (past its first lts_off bytes).
template <typename T, bool SMEM, bool WIDE>
__global__ void __launch_bounds__(32)
node_edges_kernel(T* vals, long long ldv, long long off, int w, int lsize,
                  const long long* __restrict__ desc,
                  const long long* __restrict__ cm, int e0, int e1,
                  const T* __restrict__ eps, int* __restrict__ nper,
                  int perturb, int lts_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T lts_static[WIDE ? 1 : kMaxK];
  T* lts_s = WIDE ? reinterpret_cast<T*>(smem_raw + lts_off) : lts_static;
  __shared__ long long desc_s[kWindow * kDescFields];
  __shared__ long long col_s[kRing][kMaxK];
  __shared__ Staged<T> u0_s[kRing][kMaxK], dg_s[kRing][kMaxK];
  const int lane = threadIdx.x;
  const long long sys = blockIdx.y;
  const T* vs = vals + sys * ldv;
  T* grow = vals + sys * ldv + off + (long long)blockIdx.x * w;
  T* row = SMEM ? reinterpret_cast<T*>(smem_raw) : grow;
  if (SMEM)
    for (int c = lane; c < w; c += 32) row[c] = grow[c];
  for (int wb = e0; wb < e1; wb += kWindow) {
    const int n = min(e1 - wb, kWindow);
    for (int i = lane; i < n * kDescFields; i += 32)
      cp_async<8>(desc_s + i, desc + (long long)wb * kDescFields + i, 8);
    cp_commit();
    cp_wait<0>();
    __syncwarp();               // the window (and the row) for every lane
#pragma unroll
    for (int x = 0; x < kRing - 1; ++x) {
      if (x < n)
        stage_slot(vs, cm, read_desc(desc_s + x * kDescFields), col_s[x],
                   u0_s[x], dg_s[x], lane);
      cp_commit();
    }
    for (int i = 0; i < n; ++i) {
      const int x = i + kRing - 1, slot = x % kRing;
      if (x < n)                // into the slot edge i - 1 has finished with
        stage_slot(vs, cm, read_desc(desc_s + x * kDescFields), col_s[slot],
                   u0_s[slot], dg_s[slot], lane);
      cp_commit();
      cp_wait<kRing - 1>();     // edge i's stage has landed
      const int si = i % kRing;
      if constexpr (sizeof(T) == 2)
        edge_step_bf16<WIDE>(row, vs, cm, read_desc(desc_s + i * kDescFields),
                             col_s[si], u0_s[si], dg_s[si], lts_s, lane);
      else
        edge_step<T, WIDE>(row, vs, cm, read_desc(desc_s + i * kDescFields),
                           col_s[si], u0_s[si], dg_s[si], lts_s, lane);
    }
  }
  __syncwarp();
  if (perturb && lane == 0) {            // width 1: the pivot, row 0
    const auto d = to_acc(row[lsize]), ep = to_acc(eps[sys]);
    if (fabs(d) < ep) {
      row[lsize] = from_acc<T>(d >= 0 ? ep : -ep);
      atomicAdd(nper + sys, 1);
    }
  }
  if (SMEM) {
    __syncwarp();
    for (int c = lane; c < w; c += 32) grow[c] = row[c];
  }
}

// The WIDE instance's lts buffer may pass the default 48 KB of dynamic
// shared memory: raise the instance's limit to kMaxWideDynBytes once per
// device, not per launch.
template <typename T, bool SMEM>
cudaError_t allow_wide_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  rc = cudaFuncSetAttribute(node_edges_kernel<T, SMEM, true>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kMaxWideDynBytes);
  if (rc == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return rc;
}

template <typename T, bool SMEM, bool WIDE>
int launch_node_edges_kernel(const dim3& grid, int dyn, T* v, long long ldv,
                             long long off, int w, int lsize,
                             const long long* d, const long long* c, int e0,
                             int e1, const T* ep, int* np, int perturb,
                             int lts_off, cudaStream_t stream) {
  if (WIDE) {
    const cudaError_t rc = allow_wide_smem<T, SMEM>();
    if (rc != cudaSuccess) return (int)rc;
  }
  node_edges_kernel<T, SMEM, WIDE><<<grid, 32, dyn, stream>>>(
      v, ldv, off, w, lsize, d, c, e0, e1, ep, np, perturb, lts_off);
  return (int)cudaGetLastError();
}

// kmax: the widest edge source of the node (the WIDE instance's lts).
template <typename T, bool WIDE>
int launch_node_edges(void* vals, long long ldv, long long off, int nr,
                      int w, int lsize, const void* desc, const void* cm,
                      int e0, int e1, const void* eps, void* nper,
                      int perturb, int nsys, int kmax, void* stream) {
  if (nr < 1 || w < 1 || nsys < 1 || nsys > 65535 || e0 < 0 || e1 < e0 ||
      (perturb && (nr != 1 || lsize < 0 || lsize >= w)) ||
      (WIDE && (kmax < 1 ||
                (long long)kmax * sizeof(T) > kMaxWideLtsBytes)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nr, nsys);
  const long long row_bytes = (long long)w * sizeof(T);
  const bool smem = row_bytes <= kRowSmemBytes;
  // the row (when it fits), then, for WIDE, the lts at a 16-byte boundary
  const int lts_off = smem ? (int)((row_bytes + 15) / 16 * 16) : 0;
  const int dyn = WIDE ? lts_off + kmax * (int)sizeof(T)
                       : (smem ? (int)row_bytes : 0);
  T* v = static_cast<T*>(vals);
  const long long* d = static_cast<const long long*>(desc);
  const long long* c = static_cast<const long long*>(cm);
  const T* ep = static_cast<const T*>(eps);
  int* np = static_cast<int*>(nper);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem)
    return launch_node_edges_kernel<T, true, WIDE>(
        grid, dyn, v, ldv, off, w, lsize, d, c, e0, e1, ep, np, perturb,
        lts_off, st);
  return launch_node_edges_kernel<T, false, WIDE>(
      grid, dyn, v, ldv, off, w, lsize, d, c, e0, e1, ep, np, perturb,
      lts_off, st);
}

}  // namespace

// OUT[e] = C[e] - A[e] @ B[e]; each operand with its batch and row stride
// in elements; OUT may be C.
extern "C" int hylu_gemm_update_f64(const void* C, long long sc_b,
                                    long long sc_r, const void* A,
                                    long long sa_b, long long sa_r,
                                    const void* B, long long sb_b,
                                    long long sb_r, void* OUT,
                                    long long so_b, long long so_r, int batch,
                                    int nr, int k, int m, void* stream) {
  return launch_gemm_update<double>(C, sc_b, sc_r, A, sa_b, sa_r, B, sb_b,
                                    sb_r, OUT, so_b, so_r, batch, nr, k, m,
                                    stream);
}

extern "C" int hylu_gemm_update_f32(const void* C, long long sc_b,
                                    long long sc_r, const void* A,
                                    long long sa_b, long long sa_r,
                                    const void* B, long long sb_b,
                                    long long sb_r, void* OUT,
                                    long long so_b, long long so_r, int batch,
                                    int nr, int k, int m, void* stream) {
  return launch_gemm_update<float>(C, sc_b, sc_r, A, sa_b, sa_r, B, sb_b,
                                   sb_r, OUT, so_b, so_r, batch, nr, k, m,
                                   stream);
}

// One node step of the unrolled schedule in place: vals (K, ldv), the
// node's panel at `off` (nr rows of w), edges [e0, e1) of desc (E, 5) int64
// (source row offset soff + slsize, col_map offset, k, source width sw,
// len(col_map)) and cm (int64, every edge's col_map concatenated); eps and
// nper (K,); perturb (nr == 1 only): perturb the pivot at column lsize.
extern "C" int hylu_node_edges_f64(void* vals, long long ldv, long long off,
                                   int nr, int w, int lsize, const void* desc,
                                   const void* cm, int e0, int e1,
                                   const void* eps, void* nper, int perturb,
                                   int nsys, void* stream) {
  return launch_node_edges<double, false>(vals, ldv, off, nr, w, lsize, desc,
                                          cm, e0, e1, eps, nper, perturb,
                                          nsys, 0, stream);
}

extern "C" int hylu_node_edges_f32(void* vals, long long ldv, long long off,
                                   int nr, int w, int lsize, const void* desc,
                                   const void* cm, int e0, int e1,
                                   const void* eps, void* nper, int perturb,
                                   int nsys, void* stream) {
  return launch_node_edges<float, false>(vals, ldv, off, nr, w, lsize, desc,
                                         cm, e0, e1, eps, nper, perturb,
                                         nsys, 0, stream);
}

// The same node step for a node with an edge source of more than 128 rows
// (the WIDE instance): kmax, the node's widest source, sizes its lts.
extern "C" int hylu_node_edges_wide_f64(void* vals, long long ldv,
                                        long long off, int nr, int w,
                                        int lsize, const void* desc,
                                        const void* cm, int e0, int e1,
                                        const void* eps, void* nper,
                                        int perturb, int nsys, int kmax,
                                        void* stream) {
  return launch_node_edges<double, true>(vals, ldv, off, nr, w, lsize, desc,
                                         cm, e0, e1, eps, nper, perturb,
                                         nsys, kmax, stream);
}

extern "C" int hylu_node_edges_wide_f32(void* vals, long long ldv,
                                        long long off, int nr, int w,
                                        int lsize, const void* desc,
                                        const void* cm, int e0, int e1,
                                        const void* eps, void* nper,
                                        int perturb, int nsys, int kmax,
                                        void* stream) {
  return launch_node_edges<float, true>(vals, ldv, off, nr, w, lsize, desc,
                                        cm, e0, e1, eps, nper, perturb, nsys,
                                        kmax, stream);
}

extern "C" int hylu_gemm_update_bf16(const void* C, long long sc_b,
                                     long long sc_r, const void* A,
                                     long long sa_b, long long sa_r,
                                     const void* B, long long sb_b,
                                     long long sb_r, void* OUT,
                                     long long so_b, long long so_r,
                                     int batch, int nr, int k, int m,
                                     void* stream) {
  return launch_gemm_update<__nv_bfloat16>(C, sc_b, sc_r, A, sa_b, sa_r, B,
                                           sb_b, sb_r, OUT, so_b, so_r, batch,
                                           nr, k, m, stream);
}

extern "C" int hylu_node_edges_bf16(void* vals, long long ldv, long long off,
                                    int nr, int w, int lsize,
                                    const void* desc, const void* cm, int e0,
                                    int e1, const void* eps, void* nper,
                                    int perturb, int nsys, void* stream) {
  return launch_node_edges<__nv_bfloat16, false>(
      vals, ldv, off, nr, w, lsize, desc, cm, e0, e1, eps, nper, perturb,
      nsys, 0, stream);
}

extern "C" int hylu_node_edges_wide_bf16(void* vals, long long ldv,
                                         long long off, int nr, int w,
                                         int lsize, const void* desc,
                                         const void* cm, int e0, int e1,
                                         const void* eps, void* nper,
                                         int perturb, int nsys, int kmax,
                                         void* stream) {
  return launch_node_edges<__nv_bfloat16, true>(
      vals, ldv, off, nr, w, lsize, desc, cm, e0, e1, eps, nper, perturb,
      nsys, kmax, stream);
}
