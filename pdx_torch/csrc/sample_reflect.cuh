// The reflect-101 bilinear fetch of ops/interp.sample_reflect_xy, shared by
// the kernels that sample a plane at fractional coordinates (farneback.cu,
// dis.cu): reflect-101 corners, and torch.lerp along the columns, then the
// rows, in the input's type.
#pragma once

#include <cuda_runtime.h>

namespace pdx {

// BORDER_REFLECT_101 index (ops/interp._fold101), any integer
__device__ __forceinline__ int fold101(long long i, int n) {
  const long long p = n > 1 ? 2LL * (n - 1) : 1;
  long long j = i % p;
  if (j < 0) j += p;
  return (int)(j >= n ? p - j : j);
}

// the two reflect-101 corners of floor(p) and floor(p) + 1 on an axis of n
template <typename T>
__device__ __forceinline__ void corners(T p, int n, int& j0, int& j1) {
  if (p >= T(0) && p <= T(n - 2)) {
    j0 = (int)p;
    j1 = j0 + 1;
    return;
  }
  const long long i = (long long)p;
  j0 = fold101(i, n);
  j1 = fold101(i + 1, n);
}

// torch.lerp's formula
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T w) {
  return fabs(w) < T(0.5) ? a + w * (b - a) : b - (b - a) * (T(1) - w);
}

// Where pixel (r, c) fetches a plane at x + d: its four reflect-101
// corners' offsets and the fractions (ops/interp.sample_reflect_xy).
template <typename T>
struct Fetch {
  long long o00, o01, o10, o11;
  T tr, tc;

  __device__ __forceinline__ Fetch(T fr, T fc, int r, int c, int H, int W) {
    const T xr = T(r) + fr, xc = T(c) + fc;
    const T pr = floor(xr), pc = floor(xc);
    tr = xr - pr;
    tc = xc - pc;
    int r0, r1, c0, c1;
    corners(pr, H, r0, r1);
    corners(pc, W, c0, c1);
    o00 = (long long)r0 * W + c0;
    o01 = (long long)r0 * W + c1;
    o10 = (long long)r1 * W + c0;
    o11 = (long long)r1 * W + c1;
  }
  // lerp along the columns, then the rows
  __device__ __forceinline__ T operator()(const T* p) const {
    return lerp(lerp(p[o00], p[o01], tc), lerp(p[o10], p[o11], tc), tr);
  }
};

}  // namespace pdx
