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
// A CTA owns a spatial tile of TH x TW points and loops over frames. Per
// frame it stages a (TH+4) x (TW+4) patch of u in shared memory, indices
// wrapped mod H and mod W of the true frame, then lap on the (TH+2) x (TW+2)
// ring, then bih and |grad u|^2 at the interior points. Each CTA writes one
// row of 14 partial sums; reduce_rows_kernel sums the rows in a fixed order.
// No float atomics anywhere, so two runs give the same bits. K2 and K4 take
// any term list and write rows of S statistics (terms_common.cuh).
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

// Stage u's (TH+4) x (TW+4) patch around tile origin (x0, y0) of frame `u`.
__device__ __forceinline__ void load_patch(const float* __restrict__ u, int H, int W,
                                           int x0, int y0, int TH, int TW,
                                           float* __restrict__ su) {
  const int PW = TW + 4, n = (TH + 4) * PW;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / PW, c = i - r * PW;
    su[i] = u[(long long)wrap(x0 - 2 + r, H) * W + wrap(y0 - 2 + c, W)];
  }
}

// 5-point Laplacian of the staged patch on the (TH+2) x (TW+2) ring.
__device__ __forceinline__ void patch_laplacian(const float* __restrict__ su, int TH, int TW,
                                                Stencil s, float* __restrict__ sl) {
  const int PW = TW + 4, LW = TW + 2, n = (TH + 2) * LW;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / LW, c = i - r * LW;
    const float* p = su + (r + 1) * PW + (c + 1);
    const float ctr = p[0];
    sl[i] = (p[PW] - 2.0f * ctr + p[-PW]) / s.dx2 + (p[1] - 2.0f * ctr + p[-1]) / s.dy2;
  }
}

// The three KS terms at interior tile point (r, c).
__device__ __forceinline__ void ks_terms(const float* __restrict__ su,
                                         const float* __restrict__ sl, int TW, int r,
                                         int c, Stencil s, float& lap, float& bih,
                                         float& gsq) {
  const int PW = TW + 4, LW = TW + 2;
  const float* l = sl + (r + 1) * LW + (c + 1);
  lap = l[0];
  bih = (l[LW] - 2.0f * lap + l[-LW]) / s.dx2 + (l[1] - 2.0f * lap + l[-1]) / s.dy2;
  const float* p = su + (r + 2) * PW + (c + 2);
  const float gx = (p[PW] - p[-PW]) / s.two_dx;
  const float gy = (p[1] - p[-1]) / s.two_dy;
  gsq = gx * gx + gy * gy;
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

// Sum every thread's acc[14] in a fixed order and write the CTA's row.
__device__ __forceinline__ void write_block_row(double* acc, double* __restrict__ row) {
  __shared__ double red[kThreads / 32][kStats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    double v = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += red[w][threadIdx.x];
    row[threadIdx.x] = v;
  }
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

// Patch + Laplacian ring, in floats.
__host__ __device__ inline size_t stencil_smem_floats(int TH, int TW) {
  return (size_t)(TH + 4) * (TW + 4) + (size_t)(TH + 2) * (TW + 2);
}

}  // namespace pdx
