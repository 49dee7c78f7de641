// Shared pieces of the fused KS dictionary + Gram kernels (K1-K4).
//
// The kernels read aligned (T, H, W) float32 stacks U and Ut, compute
// periodic stencil terms in float32 (the TPU kernels' field precision) and
// accumulate sufficient statistics in float64. K1 and K3 take the terms
// [lap, bih, |grad u|^2] and accumulate 14 statistics:
//
//   0..5  G00 G01 G02 G11 G12 G22   (upper triangle of X^T X)
//   6..8  b0 b1 b2                  (X^T y)
//   9..11 sx0 sx1 sx2               (column sums)
//   12    sy                        (sum y)
//   13    syy                       (sum y^2)
//
// Each CTA writes one row of partial sums; reduce_rows_kernel sums the rows
// in a fixed order. No float atomics anywhere, so two runs give the same
// bits. K1 and K3 stage row bands at full frame width (band_common.cuh); K2
// and K4 take any term list, write rows of S statistics and stage square
// tiles with a wrapped halo (terms_common.cuh).
#pragma once

#include <cuda_runtime.h>

namespace pdx {

constexpr int kStats = 14;
constexpr int kThreads = 256;

struct Stencil {
  float dx2, dy2, two_dx, two_dy;  // dx*dx, dy*dy, 2*dx, 2*dy (rounded to f32)
};

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

// Add one sample row (f0, f1, f2; y) to the 14 running sums.
__device__ __forceinline__ void accumulate(double* acc, double f0, double f1, double f2,
                                           double y) {
  acc[0] += f0 * f0; acc[1] += f0 * f1; acc[2] += f0 * f2;
  acc[3] += f1 * f1; acc[4] += f1 * f2; acc[5] += f2 * f2;
  acc[6] += f0 * y;  acc[7] += f1 * y;  acc[8] += f2 * y;
  acc[9] += f0;      acc[10] += f1;     acc[11] += f2;
  acc[12] += y;      acc[13] += y * y;
}

// out[k] = sum over rows of part[row * cols + k], one CTA per column; the
// order of the additions depends only on the shape.
static __global__ void reduce_rows_kernel(const double* __restrict__ part, int rows,
                                          int cols, double* __restrict__ out) {
  __shared__ double s[kThreads];
  const int k = blockIdx.x;
  double v = 0.0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) v += part[(long long)r * cols + k];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = s[0];
}

}  // namespace pdx
