// The correctly rounded division shared by K3 (csrc/trsm.cu), K5's node
// kernel (csrc/gemm_update.cu) and K6 (csrc/suprow.cu).  They decide pivots
// or solve from these quotients, so their bits must be a true division's,
// as the plain versions' are: one copy keeps the kernels alike.  Included
// by those sources; the build hashes this header with them
// (kernels/_build.py).
//
// a / b, correctly rounded, from the reciprocal rb = 1 / b (itself a true
// division in float64, made once per divisor off the dependent chain): the
// product q = a rb is within one ulp of a / b, so the remainder a - q b is
// exact under fma and q + rem rb rounds to the correctly rounded quotient
// (Markstein's theorem) -- the same bits as a / b, at a product and two fma
// on the chain instead of a full division, and with no branch.  A zero
// dividend gives q, exact, and so does a non-finite float32 one (an infinite
// dividend keeps its sign).  float32 operands run the same steps in float64
// and round the float64 quotient to float32, which is the correctly rounded
// float32 quotient (53 >= 2 * 24 + 2 bits: the double rounding is
// innocuous), so no float32 operand ever leaves the fast path (a float32
// fill entry below 2^-102 would, in float32 arithmetic).  The theorem needs
// no overflow or underflow: recip() gives NaN for a divisor outside
// [2^-400, 2^400], and ok turns false there and, in float64, where the
// quotient lies outside [2^-500, 2^500]; the caller then divides again by
// true_div.  (Short-circuit && and || here would compile to branches on the
// chain.)
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double recip(double b) {
  const double ab = fabs(b);
  return (ab >= 0x1p-400) & (ab <= 0x1p400)
             ? 1.0 / b : __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ double div_fast(double a, double b, double rb,
                                           bool& ok) {
  const double q = a * rb;
  const double q1 = fma(fma(-q, b, a), rb, q);
  const double aq = fabs(q);
  ok &= (rb == rb) & ((a == 0.0) | ((aq >= 0x1p-500) & (aq <= 0x1p500)));
  return a == 0.0 ? q : q1;
}

__device__ __forceinline__ float div_fast(float a, float b, double rb,
                                          bool& ok) {
  const double ad = a;
  const double q = ad * rb;
  const double q1 = fma(fma(-q, (double)b, ad), rb, q);
  ok &= rb == rb;
  // a zero or non-finite dividend: q is the quotient (inf / b keeps its
  // sign, where the correction step would turn it into NaN)
  return (float)((a == 0.f) | !(fabsf(a) <= 3.402823466e38f) ? q : q1);
}

// the true division, a call on the rare path
template <typename T>
__device__ __noinline__ T true_div(T a, T b) {
  return a / b;
}

}  // namespace
