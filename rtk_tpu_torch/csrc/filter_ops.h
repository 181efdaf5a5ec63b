// Scalar operations of a filter predicate captured by
// rtk_tpu_torch/ops/filter_capture.py::jit_filter, with torch's semantics
// on the plain version's dtypes (t, u, v float32; mesh, triangle and ray
// indices int32), so the compiled predicate agrees with the same callable
// evaluated on torch tensors:
//   * int32 +, -, *, unary - and abs wrap on overflow, as torch's do;
//   * // and % floor (torch.floor_divide, torch.remainder): the result of
//     % takes the divisor's sign; an int32 zero divisor gives 0 (torch
//     raises there);
//   * float // and % follow c10's div_floor_floating and remainder;
//   * comparisons involving NaN are false, except != (plain C++ rules).
// Included into csrc/packet_trace.cu's filter build (nvcc, -fmad=false)
// and into a host build by the CPU tests (g++, -ffp-contract=off).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define RTK_HD __host__ __device__ __forceinline__
#else
#define RTK_HD static inline
#endif

RTK_HD int rtk_iadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
RTK_HD int rtk_isub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
RTK_HD int rtk_imul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
RTK_HD int rtk_ineg(int a) { return (int)(0u - (unsigned)a); }
RTK_HD int rtk_iabs(int a) { return a < 0 ? rtk_ineg(a) : a; }

RTK_HD int rtk_ifloordiv(int a, int b) {
  if (b == 0) return 0;
  if (b == -1) return rtk_ineg(a);  // INT_MIN / -1 wraps
  const int q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

RTK_HD int rtk_imod(int a, int b) {
  if (b == 0 || b == -1) return 0;
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

RTK_HD float rtk_ffloordiv(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float fd = floorf(div);
  if (div - fd > 0.5f) fd += 1.0f;
  return fd;
}

RTK_HD float rtk_fmod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
